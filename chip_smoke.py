#!/usr/bin/env python3
"""Smoke check of the PyTorch / CUDA port (`loltracer_tpu_torch`) on one
NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each:

0. the card (nvidia-smi name and power limit) and the torch / CUDA versions;
1. build the fused forward kernel for the four example structures (nvcc,
   at first use, into loltracer_tpu_torch/_build/);
2. kernel vs its plain PyTorch version on the card: the four examples at
   97x161 (ragged edges), scene4 with antialiasing and scene2 with a custom
   config; |diff| <= 5e-5 on every pixel but at most max(2, 1e-4 * pixels);
3. the main path: `loltracer_tpu_torch.cli render examples/scene4.lol
   --size 1920x1080`, which must launch the kernel; its image must be
   finite, in [0, 1], and match the plain version at 1920x1080 to the
   tolerance of phase 2;
4. frame times at scene4 @1920x1080: the kernel (median of 10 warm frames)
   and the plain version (median of 3), CUDA events.

Then a JSON line with the kernel's launches, error and times, and last the
line {"ok": true, "device": {...}}. Any failure raises: the traceback is
printed, the exit code is not 0 and the last line is not printed. Without
CUDA, or without the package beside this file, it fails the same way.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
EXAMPLES = ROOT / "examples"
SCENES = ["scene.lol", "scene2.lol", "scene3.lol", "scene4.lol"]
ATOL = 5e-5
MAIN_W, MAIN_H = 1920, 1080


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0].strip()


def compare(kernel_img, plain_img, what: str):
    """(max |diff|, pixels over ATOL); raises beyond the tolerance."""
    import torch

    require(kernel_img.shape == plain_img.shape, f"{what}: shapes differ")
    require(bool(torch.isfinite(kernel_img).all()), f"{what}: non-finite pixels")
    diff = (kernel_img - plain_img).abs()
    max_err = float(diff.max())
    over = int((diff > ATOL).any(dim=-1).sum())
    pixels = kernel_img.shape[0] * kernel_img.shape[1]
    allowed = max(2, int(1e-4 * pixels))
    if over > allowed:
        bad = (diff > ATOL).any(dim=-1).nonzero()[:8].tolist()
        detail = "; ".join(
            f"(y={y}, x={x}) kernel {kernel_img[y, x].tolist()} plain {plain_img[y, x].tolist()}"
            for y, x in bad
        )
        raise RuntimeError(
            f"{what}: {over} pixels differ by more than {ATOL} (allowed {allowed}); "
            f"max |diff| {max_err:.3g}; first: {detail}"
        )
    return max_err, over


def time_ms(fn, reps: int) -> float:
    """Median of `reps` calls of fn, each timed with CUDA events."""
    import torch

    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main() -> int:
    import torch

    require(
        torch.cuda.is_available(),
        "torch.cuda.is_available() is false: this check needs a CUDA GPU",
    )
    require(
        (ROOT / "loltracer_tpu_torch" / "__init__.py").is_file(),
        f"loltracer_tpu_torch not found beside {Path(__file__).name}",
    )
    sys.path.insert(0, str(ROOT))
    import loltracer_tpu_torch
    from loltracer_tpu_torch import cli
    from loltracer_tpu_torch.config import RenderConfig
    from loltracer_tpu_torch.lol import parse_scene_file
    from loltracer_tpu_torch.render import fused_fwd
    from loltracer_tpu_torch.render.camera import camera_pack
    from loltracer_tpu_torch.render.cuda_scene import pack_fields
    from loltracer_tpu_torch.scene import build_scene
    from loltracer_tpu_torch.utils.image import image_to_u8, read_png

    require(
        Path(loltracer_tpu_torch.__file__).resolve().parent == ROOT / "loltracer_tpu_torch",
        f"imported loltracer_tpu_torch from {loltracer_tpu_torch.__file__}",
    )
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)

    # --- 0. card -----------------------------------------------------------
    card = card_line()
    print(card)
    print(f"[0] card: {card} | torch {torch.__version__} | CUDA {torch.version.cuda}"
          f" | {torch.cuda.device_count()} device(s)")

    scenes = {
        n: build_scene(parse_scene_file(str(EXAMPLES / n)), device=dev) for n in SCENES
    }
    cases = [(n, RenderConfig()) for n in SCENES] + [
        ("scene4.lol", RenderConfig(antialias=True)),
        ("scene2.lol", RenderConfig(max_steps=64, shadow_steps=32, gamma=1.0)),
    ]

    # --- 1. build ------------------------------------------------------------
    t0 = time.perf_counter()
    built = [fused_fwd.library(scenes[n].structure, cfg) for n, cfg in cases]
    build_s = time.perf_counter() - t0
    regs = [l.split(":", 1)[-1].strip() for l in built[3].log.splitlines()
            if "registers" in l or "spill" in l]
    print(f"[1] build: {len(built)} kernels ({len(SCENES)} structures + AA + custom "
          f"config) in {build_s:.1f} s; scene4 ptxas: {' | '.join(regs)}")

    # --- 2. kernel vs plain version on the card ------------------------------
    h, w = 97, 161
    for name, cfg in cases:
        s = scenes[name]
        cam = camera_pack(s.params, h, w, cfg)
        fields = pack_fields(s.structure, s.params)
        k_img = fused_fwd.fused_forward(s.structure, cfg, cam, fields, h, w)
        p_img = fused_fwd.fused_forward_reference(s.structure, cfg, cam, fields, h, w)
        torch.cuda.synchronize()
        err, over = compare(k_img, p_img, f"{name} antialias={cfg.antialias} max_steps={cfg.max_steps}")
        tag = ("aa" if cfg.antialias else
               "custom" if cfg.max_steps != RenderConfig().max_steps else "default")
        print(f"[2] {name} {tag} {h}x{w}: max |diff| {err:.3g}, {over} px over {ATOL}")

    # --- 3. main path --------------------------------------------------------
    s4 = scenes["scene4.lol"]
    cfg = RenderConfig()
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "out.png"
        fused_fwd.launches = 0
        cli.main(["render", str(EXAMPLES / "scene4.lol"),
                  "--size", f"{MAIN_W}x{MAIN_H}", "-o", str(out)])
        main_launches = fused_fwd.launches
        require(main_launches > 0, "the main path did not launch lol_render_fused")
        require(out.is_file(), f"{out} was not written")
        png = read_png(str(out))
    cam = camera_pack(s4.params, MAIN_H, MAIN_W, cfg)
    fields = pack_fields(s4.structure, s4.params)
    k_img = fused_fwd.fused_forward(s4.structure, cfg, cam, fields, MAIN_H, MAIN_W)
    p_img = fused_fwd.fused_forward_reference(s4.structure, cfg, cam, fields, MAIN_H, MAIN_W)
    torch.cuda.synchronize()
    require(tuple(k_img.shape) == (MAIN_H, MAIN_W, 3), f"image shape {tuple(k_img.shape)}")
    require(bool(((k_img >= 0) & (k_img <= 1)).all()), "image outside [0, 1]")
    require((image_to_u8(k_img.cpu().numpy()) == png).all(),
            "the CLI's PNG differs from the kernel's image")
    main_err, main_over = compare(k_img, p_img, "scene4 1920x1080")
    print(f"[3] main path: cli render scene4 {MAIN_W}x{MAIN_H} -> {main_launches} "
          f"launch(es); PNG = kernel image; vs plain: max |diff| {main_err:.3g}, "
          f"{main_over} px over {ATOL}")

    # --- 4. frame times ------------------------------------------------------
    def kernel():
        fused_fwd.fused_forward(s4.structure, cfg, cam, fields, MAIN_H, MAIN_W)

    def plain():
        fused_fwd.fused_forward_reference(s4.structure, cfg, cam, fields, MAIN_H, MAIN_W)

    for _ in range(3):
        kernel()
    k_ms = time_ms(kernel, 10)
    plain()
    p_ms = time_ms(plain, 3)
    rays = MAIN_W * MAIN_H
    print(f"[4] scene4 {MAIN_W}x{MAIN_H} on {card}: kernel {k_ms:.3f} ms/frame "
          f"({rays / k_ms / 1e3:.1f} M rays/s), plain {p_ms:.1f} ms/frame "
          f"({rays / p_ms / 1e3:.2f} M rays/s), kernel {p_ms / k_ms:.0f}x faster")

    print(json.dumps({"kernels": [{
        "name": "lol_render_fused",
        "route": "cuda",
        "source": "loltracer_tpu_torch/csrc/fused_fwd.cuh",
        "replaces": "loltracer_tpu/render/pallas_train.py:346",
        "launches": main_launches,
        "max_abs_err": main_err,
        "ms": k_ms,
        "plain_ms": p_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
