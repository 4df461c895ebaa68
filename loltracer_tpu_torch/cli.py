"""Command-line interface of the port (`loltracer_tpu/cli.py`: render, view,
fit, stats, bench, roofline, peak, info).

    python -m loltracer_tpu_torch.cli render examples/scene4.lol --backend pallas --size 1920x1080 -o out.png
    python -m loltracer_tpu_torch.cli render examples/scene4.lol --backend golden --size 64x48 -o gold.png
    python -m loltracer_tpu_torch.cli info examples/scene4.lol
    python -m loltracer_tpu_torch.cli render instanced:10000 --backend pallas --step-clamp 2 --size 1920x1080
    python -m loltracer_tpu_torch.cli view examples/scene4.lol --size 160x90
    python -m loltracer_tpu_torch.cli fit examples/scene4.lol --target t.npy --steps 3 -o fit.png
    python -m loltracer_tpu_torch.cli fit examples/scene4.lol --target t.npy --checkpoint fit.ckpt
    python -m loltracer_tpu_torch.cli stats examples/scene4.lol --size 320x240
    python -m loltracer_tpu_torch.cli bench examples/scene4.lol --mode fwd --size 1920x1080
    python -m loltracer_tpu_torch.cli roofline examples/scene4.lol --mode fwdbwd
    python -m loltracer_tpu_torch.cli peak

`render --backend pallas` goes through the fused CUDA kernel
(render/cuda_renderer.py; `instanced:N` is the procedural field of N
spheres, scenes.py, rendered by lol_instanced_render); `--backend jnp`,
the default as in the JAX package, through the differentiable renderer
(render/torch_renderer.py), whose marches run the march kernels K3 / K4 on
CUDA; `--backend golden` through the float64 NumPy oracle (golden/), on
the CPU whatever `--device` says. `--device cuda` is the
default and raises if CUDA is not available; `--device cpu` renders
through the plain PyTorch versions. `view` is the terminal viewer
(interactive.py): the fused kernel a frame on the card, the plain
renderer with `--device cpu`; an explicit `--size` is rendered exactly or
refused. `fit` is the JAX package's: inverse
rendering toward a target image (.png or .npy) with antialiasing on by
default, through opt.fit_scene (row-sharded over the ranks of the world;
`--checkpoint` resumes from and saves to that file). `stats` prints the
march-step statistics of utils/profiling.march_step_stats as JSON.
`bench` is the JAX package's: it takes bench.py's `BENCH_*` settings from
the environment (`--size` sets BENCH_W / BENCH_H; the scene and `--mode`
apply where BENCH_SCENE / BENCH_MODE are unset), times bench.py's route on
the port (bench.py in this package) and prints bench.py's record last.
`roofline` times the fused kernels (fwd: K1, or K5 for instanced scenes;
fwdbwd: the training pair with envelope shadows, one backward of
mean(img ** 2)) and prints utils/roofline.roofline_estimate's record. The
render flags are those of the JAX package's CLI. `render` and `fit` take
`--trace DIR`: the command runs under utils/profiling.trace(DIR), whose
Chrome trace shows the spans of utils/tracing.py over the kernels, and
DIR/spans.json gets the spans, their summary and the counters.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def _parse_size(s: str):
    w, h = s.lower().split("x")
    return int(w), int(h)


def _build_cfg(args):
    from loltracer_tpu_torch.config import RenderConfig

    kw = {}
    for field in (
        "max_steps",
        "epsilon",
        "max_dist",
        "shadow_steps",
        "shadow_w",
        "gamma",
    ):
        v = getattr(args, field, None)
        if v is not None:
            kw[field] = v
    if getattr(args, "aa", False):
        kw["antialias"] = True
    sc = getattr(args, "step_clamp", None)
    if sc is not None:
        kw["step_clamp"] = None if sc <= 0 else sc
    if getattr(args, "tan_fov", False):
        kw["atan_fov"] = False
    return RenderConfig(**kw)


def _load_scene(path, device):
    from loltracer_tpu_torch.lol import parse_scene_file
    from loltracer_tpu_torch.scene import build_scene

    if str(path).startswith("instanced:"):
        # procedural 10k+ primitive configuration, e.g. `instanced:10000`
        # (BASELINE config 5; scenes.instanced_spheres)
        from loltracer_tpu_torch.scenes import instanced_spheres

        return instanced_spheres(n=int(str(path).split(":")[1]), device=device)
    return build_scene(parse_scene_file(path), device=device)


def _add_render_flags(p):
    p.add_argument("--size", default="640x480", help="WxH (default 640x480)")
    p.add_argument("--aa", action="store_true", help="soft-coverage antialiasing")
    p.add_argument(
        "--step-clamp", type=float, default=None, dest="step_clamp",
        help="instanced scenes: sphere-set step clamp (config.py "
        "step_clamp; <=0 for exact; default exact)",
    )
    p.add_argument("--tan-fov", action="store_true",
                   help="standard tan() pinhole instead of the reference's atan quirk")
    p.add_argument("--max-steps", type=int, dest="max_steps")
    p.add_argument("--epsilon", type=float)
    p.add_argument("--max-dist", type=float, dest="max_dist")
    p.add_argument("--shadow-steps", type=int, dest="shadow_steps")
    p.add_argument("--shadow-w", type=float, dest="shadow_w")
    p.add_argument("--gamma", type=float)


def _add_device_flag(p):
    p.add_argument(
        "--device", choices=["cuda", "cpu"], default="cuda",
        help="cuda: the CUDA kernels (default); cpu: the plain PyTorch versions",
    )


def _add_trace_flag(p):
    p.add_argument("--trace", metavar="DIR",
                   help="write a Chrome trace with the spans over the kernels, and "
                   "DIR/spans.json (utils/tracing.py)")


def cmd_render(args):
    import numpy as np
    import torch

    from loltracer_tpu_torch.render.cuda_renderer import make_cuda_renderer
    from loltracer_tpu_torch.render.torch_renderer import make_renderer
    from loltracer_tpu_torch.utils.image import write_npy, write_png

    w, h = _parse_size(args.size)
    cfg = _build_cfg(args)
    golden = args.backend == "golden"
    where = "cpu" if golden else args.device  # the oracle never touches the card
    scene = _load_scene(args.scene, where)

    t0 = time.perf_counter()
    if golden:
        from loltracer_tpu_torch.golden import render_golden
        from loltracer_tpu_torch.scene import params_astype

        scene.params = params_astype(scene.params, np.float64)
        img = render_golden(scene, w, h, cfg)
    elif args.backend == "jnp":
        with torch.no_grad():
            img = make_renderer(scene.structure, h, w, cfg, device=args.device)(scene.params)
    else:
        renderer = make_cuda_renderer(scene.structure, h, w, cfg, device=args.device)
        img = renderer(scene.params)
    if not golden:
        if img.device.type == "cuda":
            torch.cuda.synchronize(img.device)
        img = img.cpu().numpy()
    dt = time.perf_counter() - t0

    out = args.output or "out.png"
    if out.endswith(".npy"):
        write_npy(out, img)
    else:
        write_png(out, img)
    print(f"rendered {args.scene} {w}x{h} on {where} in {dt:.2f}s -> {out}")
    return 0


def _traced(args):
    """args.fn(args) under utils/profiling.trace(args.trace); the spans,
    their summary and the counters to args.trace/spans.json."""
    import os

    from loltracer_tpu_torch.utils import tracing
    from loltracer_tpu_torch.utils.profiling import trace

    os.makedirs(args.trace, exist_ok=True)
    tracing.snapshot(reset=True)
    with trace(args.trace):
        rc = args.fn(args)
    snap = tracing.snapshot()
    with open(os.path.join(args.trace, "spans.json"), "w") as f:
        json.dump({"summary": tracing.summary(), "counters": snap["counters"],
                   "dropped": snap["dropped"], "spans": snap["spans"]}, f, indent=1)
    return rc


def cmd_view(args):
    from loltracer_tpu_torch.interactive import check_view_size, run_viewer

    # no --size: follow the live terminal size every frame (the
    # reference's per-frame surface re-fetch, main.c:182)
    w = h = None
    if args.size:
        w, h = _parse_size(args.size)
        try:
            check_view_size(w, h)
        except ValueError as e:
            print(f"view: {e}", file=sys.stderr)
            return 2
    run_viewer(_load_scene(args.scene, args.device), w, h, _build_cfg(args))
    return 0


def cmd_fit(args):
    import numpy as np
    import torch

    from loltracer_tpu_torch.opt import fit_scene
    from loltracer_tpu_torch.render.torch_renderer import make_renderer
    from loltracer_tpu_torch.utils.image import read_png, write_png

    scene = _load_scene(args.scene, args.device)
    cfg = _build_cfg(args)
    if args.target.endswith(".npy"):
        target = np.load(args.target)
    else:
        target = read_png(args.target).astype(np.float32) / 255.0

    trainable = tuple(args.trainable.split(",")) if args.trainable else None
    kw = {} if trainable is None else {"trainable": trainable}
    result = fit_scene(
        scene.structure,
        scene.params,
        target,
        steps=args.steps,
        learning_rate=args.lr,
        cfg=cfg,
        checkpoint_path=args.checkpoint,
        device=args.device,
        log_every=max(1, args.steps // 20),
        **kw,
    )
    print(f"final loss: {result.losses[-1]:.6g}")
    if args.output:
        h, w = target.shape[:2]
        with torch.no_grad():
            img = make_renderer(scene.structure, h, w, cfg, device=args.device)(result.params)
        write_png(args.output, img.cpu().numpy())
        print(f"fitted render -> {args.output}")
    return 0


def cmd_stats(args):
    """The march-step histogram and tile waste (utils/profiling.py)."""
    from loltracer_tpu_torch.utils.profiling import march_step_stats

    w, h = _parse_size(args.size)
    scene = _load_scene(args.scene, args.device)
    stats = march_step_stats(scene.structure, scene.params, h, w, _build_cfg(args))
    print(json.dumps(stats, indent=2))
    return 0


def cmd_bench(args):
    """bench.py's route for the BENCH_* settings, timed (bench.py)."""
    import os

    from loltracer_tpu_torch import bench

    env = dict(os.environ)
    env.setdefault("BENCH_SCENE", args.scene)
    if args.size:
        w, h = _parse_size(args.size)
        env["BENCH_W"], env["BENCH_H"] = str(w), str(h)
    env.setdefault("BENCH_MODE", args.mode)
    return bench.main(env=env, device=args.device)


def cmd_roofline(args):
    """Time the fused kernels and report the achieved fraction of the
    card's peak (utils/roofline.py: the operation model over the measured
    step counts)."""
    import torch

    from loltracer_tpu_torch.scene import SceneParams
    from loltracer_tpu_torch.utils.roofline import roofline_estimate

    w, h = _parse_size(args.size)
    cfg = _build_cfg(args)
    scene = _load_scene(args.scene, args.device)
    st, params = scene.structure, scene.params

    if args.mode == "fwdbwd":
        cfg = cfg.replace(shadow_grad="envelope")
        if st.instanced:
            from loltracer_tpu_torch.render.instanced_train import (
                make_instanced_training_renderer as _mk,
            )
        else:
            from loltracer_tpu_torch.render.fused_train import make_training_renderer as _mk
        r = _mk(st, h, w, cfg, device=args.device)
        leaves = SceneParams(**{
            f: v.detach().clone().requires_grad_(True) for f, v in vars(params).items()
        })

        def fn():
            for v in vars(leaves).values():
                v.grad = None
            loss = torch.mean(r(leaves) ** 2)
            loss.backward()
            return loss
    else:
        from loltracer_tpu_torch.render.cuda_renderer import make_cuda_renderer

        r = make_cuda_renderer(st, h, w, cfg, device=args.device)

        def fn():
            return torch.sum(r(params))

    def sync():
        if params.cam_point.device.type == "cuda":
            torch.cuda.synchronize(params.cam_point.device)

    fn()  # build + warm-up
    sync()
    times = []
    for _ in range(args.reps):
        t0 = time.perf_counter()
        fn()
        sync()
        times.append(time.perf_counter() - t0)

    est = roofline_estimate(st, params, h, w, min(times), cfg, mode=args.mode)
    est["measured_seconds"] = min(times)
    est["rays_per_s"] = h * w / min(times)
    print(json.dumps(
        {k: (v if isinstance(v, (str, list)) else float(v)) for k, v in est.items()},
        indent=2,
    ))
    return 0


def cmd_peak(args):
    """Measure the FP32 ceiling (utils/peak.py) and write its record."""
    import os

    from loltracer_tpu_torch.utils.peak import PEAK_ARTIFACT, measure_vpu_peak

    rec = measure_vpu_peak(reps=args.reps, device=args.device)
    out = args.out or (PEAK_ARTIFACT if args.device == "cuda" else None)
    if out:
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        with open(out, "w") as f:
            json.dump(rec, f, indent=2)
    print(json.dumps({k: v for k, v in rec.items() if k != "detail"}))
    return 0


def cmd_info(args):
    scene = _load_scene(args.scene, "cpu")  # the structure only
    st = scene.structure
    print(json.dumps(
        {
            "materials": st.num_materials,
            "lights": st.num_lights,
            "objects": st.num_objects,
            "spheres": st.num_spheres,
            "boxes": st.num_boxes,
            "planes": st.num_planes,
            "smooth_unions": st.num_unions,
            "object_exprs": [repr(o) for o in st.objects],
        },
        indent=2,
    ))
    return 0


def main(argv=None):
    # multi-process bootstrap, a no-op unless LOLTRACE_COORDINATOR or
    # LOLTRACE_DISTRIBUTED is set (parallel/distributed.py)
    from loltracer_tpu_torch.parallel.distributed import maybe_initialize

    maybe_initialize()
    parser = argparse.ArgumentParser(prog="loltrace-torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("render", help="render a scene to PNG/NPY")
    p.add_argument(
        "scene", nargs="?", default="-",
        help=".lol file; '-' or omitted reads stdin",
    )
    p.add_argument("-o", "--output")
    p.add_argument(
        "--backend", choices=["jnp", "pallas", "golden"], default="jnp",
        help="jnp: the differentiable renderer (march kernels K3 / K4 on CUDA; "
        "the default, as in the JAX package); pallas: the fused CUDA kernel; "
        "golden: the float64 NumPy oracle, on the CPU",
    )
    _add_device_flag(p)
    _add_render_flags(p)
    _add_trace_flag(p)
    p.set_defaults(fn=cmd_render)

    p = sub.add_parser("view", help="interactive terminal preview")
    p.add_argument("scene")
    _add_device_flag(p)
    _add_render_flags(p)
    p.set_defaults(fn=cmd_view, size=None)

    p = sub.add_parser("fit", help="inverse rendering toward a target image")
    p.add_argument("scene")
    p.add_argument("--target", required=True, help="target image (.png/.npy)")
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--lr", type=float, default=1e-2)
    p.add_argument("--trainable", help="comma-separated param fields")
    p.add_argument("--checkpoint")
    p.add_argument("-o", "--output", help="write fitted render")
    _add_device_flag(p)
    _add_render_flags(p)
    _add_trace_flag(p)
    p.set_defaults(fn=cmd_fit, aa=True)

    p = sub.add_parser("stats", help="march-step histogram / tile occupancy diagnostics")
    p.add_argument("scene")
    _add_device_flag(p)
    _add_render_flags(p)
    p.set_defaults(fn=cmd_stats, size="320x240")

    p = sub.add_parser("bench", help="throughput benchmark: bench.py's routes on the port")
    p.add_argument("scene")
    p.add_argument("--size", help="WxH (sets BENCH_W / BENCH_H; default 1920x1080)")
    p.add_argument("--mode", choices=["fwd", "fwdbwd"], default="fwdbwd")
    _add_device_flag(p)
    p.set_defaults(fn=cmd_bench)

    p = sub.add_parser(
        "roofline", help="measure the fused kernels' achieved fraction of the card's peak"
    )
    p.add_argument("scene")
    p.add_argument("--mode", choices=["fwd", "fwdbwd"], default="fwd")
    p.add_argument("--reps", type=int, default=3)
    _add_device_flag(p)
    _add_render_flags(p)
    p.set_defaults(fn=cmd_roofline, size="1920x1080")

    p = sub.add_parser("peak", help="measure the card's FP32 and sqrt rates")
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--out", help="record path (default artifacts/gpu_peak.json on cuda)")
    _add_device_flag(p)
    p.set_defaults(fn=cmd_peak)

    p = sub.add_parser("info", help="parsed scene summary")
    p.add_argument("scene", nargs="?", default="-")
    p.set_defaults(fn=cmd_info)

    args = parser.parse_args(argv)
    if getattr(args, "trace", None):
        return _traced(args)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
