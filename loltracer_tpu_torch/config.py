"""Render configuration.

A copy of `loltracer_tpu/config.py`: importing anything from `loltracer_tpu` runs its
package `__init__`, which imports jax. tests/test_torch_frontend.py holds
the two equal.

The reference hardcodes every render constant at compile time
(march: naive_renderer.c:49-51, shadows: naive_renderer.c:99,
normal h: naive_renderer.c:119, gamma: naive_renderer.c:231).
Here they are a single config dataclass, hashable so it can be a static
argument to jitted renderers.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """All render-time constants, defaulting to the reference's values."""

    # Sphere-trace march (naive_renderer.c:49-51)
    max_steps: int = 256
    epsilon: float = 1e-3
    max_dist: float = 100.0

    # Soft shadows (naive_renderer.c:92-100): 128 steps, sharpness w=50,
    # shadow-ray origin offset of a full unit toward the light
    # (naive_renderer.c:97 — a quirk we reproduce by default).
    shadow_steps: int = 128
    shadow_w: float = 50.0
    shadow_offset: float = 1.0
    shadow_epsilon: float = 1e-3  # declared but unused by the reference too

    # Normal estimation: tetrahedron taps at h = dist/100
    # (naive_renderer.c:114-125).
    normal_h_scale: float = 0.01

    # Output (naive_renderer.c:231)
    gamma: float = 1.0 / 2.2

    # Soft-coverage antialiasing (NOT in the reference; off by default for
    # pixel parity). When on, near-miss rays within ~aa_width pixels of a
    # silhouette blend the occluder's color by a differentiable coverage
    # alpha — both an image-quality feature and the source of silhouette
    # gradients for inverse rendering (render/march.py intersect_aa).
    antialias: bool = False
    aa_width: float = 1.0

    # Camera projection: the reference computes the half-height of the view
    # plane as atan(fov/2) instead of the standard tan(fov/2)
    # (naive_renderer.c:183). True reproduces the reference.
    atan_fov: bool = True

    # Tile shape for the compiled-tier Pallas kernels (None = auto).
    # Auto resolves to 64x128 on hardware and 8x128 under the interpreter:
    # values are tile-shape-INDEPENDENT (done lanes freeze individually),
    # but the march/shadow loops pay a serial scalar-control cost per loop
    # iteration per tile, so fewer/bigger tiles win despite more worst-
    # lane masked steps — measured on v5e (scene4 @1080p fwdbwd: 18.9M at
    # 8x128 -> 31.0M at 64x128; 128x128 exceeds the backward kernel's
    # VMEM). The height dimension is capped to the (padded) image/shard
    # height. Lane dim must stay a multiple of 128. Set explicitly for
    # exotic scenes (many lights -> more residual planes -> smaller tiles
    # to fit VMEM).
    tile_h: int = None
    tile_w: int = None

    # March backend for the differentiable render path's (stop-gradient'd)
    # sphere-trace: "auto" uses the fused Pallas kernel on TPU and the jnp
    # while_loop elsewhere; "jnp" / "pallas" force one;
    # "pallas-interpret" runs the kernel in the Pallas interpreter (CPU
    # equivalence tests). Gradients are identical across backends — the
    # march result is frozen and re-attached via the IFT either way
    # (render/march.py).
    march_backend: str = "auto"

    # Soft-shadow gradient estimator:
    #   "exact"    — reverse-mode AD through the full rematerialized
    #                128-step shadow scan: the exact gradient of the
    #                discretized forward computation (trajectory terms
    #                included). Backward cost: O(shadow_steps) SDF
    #                evaluations per light per pixel.
    #   "envelope" — the shadow march runs frozen (stop-gradient, Pallas
    #                kernel on TPU) recording the argmin step t*; the
    #                gradient is re-attached via ONE differentiable SDF
    #                evaluation at t* per light. By Danskin's theorem this
    #                is the exact gradient of the idealized penumbra
    #                min(1, min_t w·f(ro+t·rd)/t) — the same
    #                frozen-fixed-point principle as the march's IFT
    #                gradient (render/march.py). Forward values are
    #                bitwise identical to "exact"; backward cost drops
    #                from O(steps) to O(1) SDF evals.
    shadow_grad: str = "exact"

    # Shadow scratch gather (instanced Pallas tier, step-clamped mode
    # only): before each per-light shadow march, the micro-blocks within
    # (step clamp + bound radius) of the patch's swept shadow segment are
    # gathered ONCE into a compact VMEM scratch table, and the march
    # evaluates that table directly — no per-step eligibility pass or
    # best-first pick loop. Value-EXACT under the clamp: a sphere farther
    # than the clamp from an eval point can never win min(d, cut) (cut =
    # max(clamp, d_bbox) and d_bbox lower-bounds every sphere distance),
    # so the gathered set provably contains every sphere that can affect
    # any sampled value. Patches whose gather would overflow the scratch
    # fall back to the full traversal (lax.cond). The PRIMARY march uses
    # the same gather over the patch's view-frustum segments. Rows of
    # scratch capacity (multiple of 256); 0 disables. 8192 rows (256 KB
    # VMEM) measured best at the 10k/1080p config (4096: -2%, 2048: -15%
    # from overflow fallbacks).
    shadow_scratch: int = 8192

    # Moving chunk window over the scratch table (r5): blocks are gathered
    # in projection order along the row's mean ray and each march step
    # evaluates only the 256-row chunks whose projection interval overlaps
    # the live lanes' span +/- the clamp (pallas_scene.ScratchScene).
    # Value-exact by the same clamp-completeness argument as the gather
    # (projection is 1-Lipschitz, so the interval test is conservative
    # for every lane). The diagnosis that motivated it: a shadow
    # segment sweeps tens of units through the field, so the GATHERED set
    # stays at 800-1900 rows (3-8 chunks) however coherent the rays are —
    # but each individual step only ever needs the chunk(s) around the
    # current points. Off exists for A/B measurement.
    scratch_window: bool = True

    # Shadow-march segment culling: before each per-light shadow march, a
    # conservative segment bound (the JAX package's
    # pallas_scene.InstancedScene.segment_lit / ScalarScene.segment_lit;
    # here render/shading.py segment_lit, and the generated
    # Scene::segment_lit that the fused kernels K1 / K1r read for compiled
    # structures) marks rays whose penumbra value provably stays > 1 along
    # the whole ray; those lanes start the march pre-done with res = 1.0 /
    # t_star = 0 — bitwise what the march would have produced — and skip
    # it. Value-exact (the bound is one-sided), so this is purely a speed
    # knob; off builds the kernels without it, for A/B measurement and as
    # their bitwise check.
    shadow_cull: bool = True

    # Step clamp for INSTANCED scenes (None = exact full SDF): the march
    # evaluates the step-clamped scene distance min(d, step_clamp) instead
    # of d. Semantically simple (one extra min, reproduced identically by
    # the jnp/banded oracle paths and the Pallas traversal) and
    # conservative: steps never overshoot, hits land on the same surfaces
    # within epsilon, and every quantity that consumes small distances —
    # hit detection, penumbra minima (w*d/t < 1 requires d << clamp),
    # normal taps, coverage alpha (s ~ pixel_rad) — sits in the d <
    # step_clamp regime where the value is EXACT. What changes is only the
    # free-space step SIZE (clamped to step_clamp), i.e. more, shorter
    # steps across empty space. The payoff on TPU: the traversal's
    # candidate ball shrinks from (scene-dependent upper bound + block
    # radius) to (step_clamp + block radius), cutting window evaluations
    # several-fold (render/pallas_scene.py InstancedScene). Ignored for
    # compiled (non-instanced) structures.
    step_clamp: float = None

    # Separate step clamp for the per-light SHADOW marches of instanced
    # scenes (None = follow step_clamp). The primary march wants a small
    # clamp (it sets the traversal's candidate-ball radius, see above);
    # shadow marches are LONGER (up to the light distance) and their
    # penumbra values only need exact distances below light_dist/shadow_w
    # (val = w*d/t < 1 requires d < t/w <= light_dist/w, ~2 units at
    # w = 50), so they tolerate a much larger clamp — fewer, bigger steps
    # across the same field. Like step_clamp this is a documented
    # semantics knob reproduced identically by the jnp oracle path and the
    # fused kernels (penumbra res/t* depend on the sampled trajectory
    # either way); values below 1 are unchanged whenever
    # shadow-march t stays <= shadow_w * min(step_clamp, shadow_step_clamp).
    shadow_step_clamp: float = None

    def effective_shadow_clamp(self):
        return (
            self.shadow_step_clamp
            if self.shadow_step_clamp is not None
            else self.step_clamp
        )

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)


DEFAULT_CONFIG = RenderConfig()
