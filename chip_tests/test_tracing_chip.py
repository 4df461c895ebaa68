"""The card's facts of utils/tracing.py (the CPU's are
tests/test_torch_tracing.py's): `python -m pytest chip_tests -q -m chip`.

- Under a CUDA-only `torch.profiler` session, as the benchmark's, a frame
  of instanced:10000 records `render.frame` over `render.pack`,
  `cell_grid.build` (over its `cell_grid.sync`s) and `render.launch`; the
  launch span holds its kernel's own `cudaLaunchKernel` and the kernel
  starts on the card after the span opens; the frame ran the counting twin
  (`instanced_render.*` counts its rays).
- Under CPU and CUDA activity, every span of a scene4 fit (K1r / K2) and
  of instanced frames lies within 50 us of its own event.
- K5's counting twin: its image bitwise K5's; its counts the same in two
  launches and equal to the sums over launches of 1- and 3-row bands, whose
  warps hold 8 and 24 rays of 32 (the warp-aggregated flush adds each warp
  of flushing threads exactly once); with spans off the renderer launches
  K5 and counts nothing, and only the first recorded frame of a recording
  is counted.
"""

from pathlib import Path

import pytest
import torch

from loltracer_tpu_torch.config import RenderConfig
from loltracer_tpu_torch.utils import tracing

EXAMPLES = Path(__file__).resolve().parent.parent / "examples"


@pytest.fixture(autouse=True)
def _clean():
    tracing.snapshot(reset=True)
    yield
    tracing.snapshot(reset=True)


def _instanced(dev):
    from loltracer_tpu_torch.scenes import instanced_spheres

    return instanced_spheres(n=10000, seed=0, device=dev)


def _by_name(spans):
    out = {}
    for s in spans:
        out.setdefault(s["name"], []).append(s)
    return out


def _ids(e):
    return {e.correlation_id(), e.linked_correlation_id()} - {0}


@pytest.mark.chip
def test_cuda_only_session_records_spans_over_the_launch(chip):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from loltracer_tpu_torch.render.cuda_renderer import make_cuda_renderer

    sc = _instanced(chip)
    H, W = 1080, 1920
    render = make_cuda_renderer(sc.structure, H, W, RenderConfig(step_clamp=2.0), chip)
    render(sc.params)
    torch.cuda.synchronize(chip)
    tracing.snapshot(reset=True)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        render(sc.params)
        torch.cuda.synchronize(chip)
    snap = tracing.snapshot(reset=True)
    by = _by_name(snap["spans"])
    assert {k: len(v) for k, v in by.items() if k != "cell_grid.sync"} == {
        "render.frame": 1, "render.pack": 1, "cell_grid.build": 1, "render.launch": 1}
    (frame,), (build,), (launch,) = by["render.frame"], by["cell_grid.build"], \
        by["render.launch"]
    assert len(by["cell_grid.sync"]) >= 3
    assert all(s["parent"] == build["id"] for s in by["cell_grid.sync"])
    assert build["parent"] == launch["parent"] == frame["id"]

    events = list(prof.profiler.kineto_results.events())
    kernels = [e for e in events
               if e.device_type() == DeviceType.CUDA and "instanced_fwd_kernel" in e.name()]
    assert len(kernels) == 1, [e.name() for e in kernels]
    k = kernels[0]
    runtime = [e for e in events if e.device_type() == DeviceType.CPU
               and "LaunchKernel" in e.name() and _ids(e) & _ids(k)]
    assert len(runtime) == 1, [(e.name(), _ids(e)) for e in runtime]
    rt = runtime[0]
    assert launch["start_ns"] <= rt.start_ns() <= rt.end_ns() <= launch["end_ns"], (
        launch["start_ns"], rt.start_ns(), rt.end_ns(), launch["end_ns"])
    assert k.start_ns() > launch["start_ns"]
    counts = snap["counters"]
    assert counts["instanced_render.rays"] == H * W
    assert counts["instanced_render.searches"] > H * W
    assert 0 < counts["instanced_render.entries_per_search"] < 1000


@pytest.mark.chip
def test_spans_lie_within_50us_of_their_events(chip):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from loltracer_tpu_torch.lol import parse_scene_file
    from loltracer_tpu_torch.opt import fit_scene
    from loltracer_tpu_torch.render.cuda_renderer import make_cuda_renderer
    from loltracer_tpu_torch.scene import build_scene

    s4 = build_scene(parse_scene_file(str(EXAMPLES / "scene4.lol")), device=chip)
    cfg = RenderConfig(antialias=True, shadow_grad="envelope")
    target = torch.full((270, 480, 3), 0.3, device=chip)
    fit_scene(s4.structure, s4.params, target, steps=1, cfg=cfg, device=chip)
    inst = _instanced(chip)
    render = make_cuda_renderer(inst.structure, 540, 960, RenderConfig(step_clamp=2.0), chip)
    render(inst.params)
    torch.cuda.synchronize(chip)
    tracing.snapshot(reset=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fit_scene(s4.structure, s4.params, target, steps=3, cfg=cfg, device=chip)
        for _ in range(2):
            render(inst.params)
        torch.cuda.synchronize(chip)
    spans = _by_name(tracing.snapshot(reset=True)["spans"])
    assert len(spans["fit_scene.step"]) == 3 and len(spans["render.frame"]) == 2
    events = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CPU and e.name() in spans:
            events.setdefault(e.name(), []).append((e.start_ns(), e.end_ns()))
    worst = 0
    for name, recorded in spans.items():
        got = sorted(events.get(name, []))
        assert len(got) == len(recorded), name
        for s, (a, b) in zip(sorted(recorded, key=lambda s: s["start_ns"]), got):
            worst = max(worst, abs(a - s["start_ns"]), abs(b - s["end_ns"]))
            assert abs(a - s["start_ns"]) < 50_000 and abs(b - s["end_ns"]) < 50_000, (
                name, a - s["start_ns"], b - s["end_ns"])
    print(f"largest gap between a span and its event: {worst / 1e3:.1f} us")


@pytest.mark.chip
def test_counting_twin_counts_every_warp_once(chip):
    from loltracer_tpu_torch.render import instanced_fwd
    from loltracer_tpu_torch.render.camera import camera_pack
    from loltracer_tpu_torch.render.cell_grid import grid_for
    from loltracer_tpu_torch.render.cuda_scene import pack_fields
    from loltracer_tpu_torch.render.cuda_renderer import make_cuda_renderer
    from loltracer_tpu_torch.render.instanced_pack import pack_instanced

    sc = _instanced(chip)
    st, params = sc.structure, sc.params
    cfg = RenderConfig(step_clamp=2.0)
    H, W = 48, 203  # a ragged right edge: part-filled warps there too
    fields = pack_fields(st, params)
    tables = pack_instanced(st, params)
    grid = grid_for(tables, cfg.step_clamp)

    def launch(rows, row0, stats):
        cam = camera_pack(params, H, W, cfg, row0=row0)
        return instanced_fwd.instanced_forward(st, cfg, cam, fields, tables, rows, W,
                                               full_height=H, grid=grid, stats=stats)

    def counts(band):
        acc = torch.zeros(3, dtype=torch.int64, device=chip)
        img = torch.cat([launch(band, y, acc) for y in range(0, H, band)])
        return img, acc.tolist()

    plain = launch(H, 0, None)
    img, full = counts(H)
    assert torch.equal(img, plain)
    assert counts(H)[1] == full
    for band in (1, 3):
        img_b, got = counts(band)
        assert torch.equal(img_b, plain)
        assert got == full, (band, got, full)
    searches, fallbacks, read = full
    assert searches > H * W and 0 <= fallbacks < searches and read > searches

    # spans off: K5 itself, nothing counted
    render = make_cuda_renderer(st, H, W, cfg, chip)
    before = instanced_fwd.launches
    assert torch.equal(render(params), plain)
    assert instanced_fwd.launches == before + 1
    assert not any(k.startswith("instanced_render.") for k in tracing.counters())
    with tracing.recording():
        for _ in range(2):  # the second recorded frame launches K5
            assert torch.equal(render(params), plain)
    c = tracing.counters()
    assert (c["instanced_render.rays"], c["instanced_render.searches"],
            c["instanced_render.fallbacks"], c["instanced_render.entries_read"]) == (
        H * W, searches, fallbacks, read)
