"""The port's spans and counters (loltracer_tpu_torch/utils/tracing.py), on
the CPU at tiny sizes:

- off (no profiler, no `recording()`), `span` is one shared null context
  and records nothing;
- inside a CPU `torch.profiler` session spans are recorded with their
  parents, self times and units, each within 50 us of its own
  `record_function` event among kineto's;
- a span opened in a backward is recorded from the thread that ran it,
  with the unit of the span open meanwhile on another thread; 16 threads
  lose no span and keep their own parents;
- a 3-step `fit_scene`: one `fit_scene.setup`, then three `fit_scene.step`s
  each over `step.forward`, `step.backward`, `step.update` and
  `fit_scene.loss_read`, and a save's `fit_scene.checkpoint`; path A's
  stages and the shadow loop's `shading.sync`s inside the forward;
- an instanced fit step through K5r / K6's plain twins (`fused="interpret"`):
  `instanced_train.forward` inside `step.forward`, `instanced_train.backward`
  inside `step.backward`, and the loss and gradients bitwise the same step's
  with spans off;
- `cell_grid.grid_for`: one `cell_grid.build` over its `cell_grid.sync`s,
  and `cell_grid.entries` grows by the grid's entries;
- K5's grid counts read out (`instanced_render.*`) and reset;
- `cli fit --trace` and `cli render --trace` write the Chrome trace and
  spans.json (`render.frame` over `render.pack` and `render.launch`).

The card's facts (a CUDA-only session, `render.launch` over its kernel's
launch, the counting twin) are chip_tests/test_tracing_chip.py's."""

import contextlib
import json
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from loltracer_tpu_torch.utils import tracing

torch.set_num_threads(1)  # one intra-op thread per pytest worker

EXAMPLES = Path(__file__).resolve().parent.parent / "examples"
# a small march: the spans, not the image, are under test
TINY = dict(max_steps=16, shadow_steps=8)


@pytest.fixture(autouse=True)
def _clean():
    tracing.snapshot(reset=True)
    yield
    tracing.snapshot(reset=True)


def _by_name(spans):
    out = {}
    for s in spans:
        out.setdefault(s["name"], []).append(s)
    return out


def test_off_is_one_shared_null_context():
    assert not tracing.on()
    a, b = tracing.span("a"), tracing.span("b", 3, 4)
    assert a is b
    with a, b:
        pass
    snap = tracing.snapshot()
    assert snap["spans"] == [] and snap["dropped"] == 0
    assert tracing.summary() == {}


def test_spans_under_a_cpu_profiler():
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert tracing.on()
        with tracing.span("t.outer", 5, 2):
            time.sleep(0.002)
            with tracing.span("t.inner"):
                time.sleep(0.003)
            with tracing.span("t.inner"):
                time.sleep(0.001)
    spans = _by_name(tracing.snapshot()["spans"])
    (outer,), inner = spans["t.outer"], spans["t.inner"]
    assert outer["parent"] is None and [s["parent"] for s in inner] == [outer["id"]] * 2
    assert all((s["unit"], s["index"]) == (5, 2) for s in inner + [outer])
    assert outer["thread"] == threading.get_native_id()
    for s in inner:
        assert outer["start_ns"] < s["start_ns"] < s["end_ns"] < outer["end_ns"]
    summ = tracing.summary()
    d = {k: (s["end_ns"] - s["start_ns"]) / 1e6 for k, s in
         (("outer", outer), ("a", inner[0]), ("b", inner[1]))}
    assert summ["t.inner"]["count"] == 2
    assert summ["t.inner"]["total_ms"] == pytest.approx(d["a"] + d["b"])
    assert summ["t.outer"]["self_ms"] == pytest.approx(d["outer"] - d["a"] - d["b"])
    assert summ["t.outer"]["self_ms"] >= 1.9

    # each span lies within 50 us of its own record_function event
    events = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("t."):
            events.setdefault(e.name(), []).append((e.start_ns(), e.start_ns() + e.duration_ns()))
    for name, recorded in spans.items():
        got = sorted(events[name])
        assert len(got) == len(recorded)
        for s, (a, b) in zip(sorted(recorded, key=lambda s: s["start_ns"]), got):
            assert abs(a - s["start_ns"]) < 50_000 and abs(b - s["end_ns"]) < 50_000, (
                name, a - s["start_ns"], b - s["end_ns"])


def test_span_in_a_backward_is_recorded_from_its_thread():
    ran_on = {}

    class Probe(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return x * 2

        @staticmethod
        def backward(ctx, g):
            with tracing.span("t.backward"):
                ran_on["thread"] = threading.get_native_id()
            return g * 2

    x = torch.ones(3, requires_grad=True)
    y = Probe.apply(x).sum()
    with tracing.recording(), tracing.span("t.step", 9, 1):
        worker = threading.Thread(target=y.backward)
        worker.start()
        worker.join()
    spans = _by_name(tracing.snapshot()["spans"])
    (bwd,), (step,) = spans["t.backward"], spans["t.step"]
    assert bwd["thread"] == ran_on["thread"] != step["thread"]
    assert bwd["parent"] is None  # the innermost span of its own thread: none
    assert (bwd["unit"], bwd["index"]) == (9, 1)
    assert step["start_ns"] < bwd["start_ns"] < bwd["end_ns"] < step["end_ns"]
    assert torch.equal(x.grad, torch.full((3,), 2.0))


def test_threads_record_every_span_with_their_own_parents():
    """More threads than cores, a short switch interval: no span lost, and
    each span's parent is the outer span of its own thread."""
    import sys

    n_threads, n_spans = 16, 100
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(n_spans):
                with tracing.span("t.outer"), tracing.span("t.inner"):
                    pass

        with tracing.recording():
            threads = [threading.Thread(target=work) for _ in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    spans = tracing.snapshot()["spans"]
    by_id = {s["id"]: s for s in spans}
    assert len(spans) == len(by_id) == 2 * n_threads * n_spans
    for s in spans:
        if s["name"] == "t.inner":
            outer = by_id[s["parent"]]
            assert outer["name"] == "t.outer" and outer["thread"] == s["thread"]
            assert outer["start_ns"] <= s["start_ns"] <= s["end_ns"] <= outer["end_ns"]
        else:
            assert s["parent"] is None


def test_fit_scene_spans(tmp_path):
    from loltracer_tpu_torch.config import RenderConfig
    from loltracer_tpu_torch.lol import parse_scene_file
    from loltracer_tpu_torch.opt import fit_scene, inverse
    from loltracer_tpu_torch.scene import build_scene

    sc = build_scene(parse_scene_file(str(EXAMPLES / "scene.lol")), device="cpu")
    job = inverse.jobs
    with tracing.recording():
        r = fit_scene(sc.structure, sc.params, torch.full((4, 6, 3), 0.3), steps=3,
                      cfg=RenderConfig(shadow_grad="envelope", **TINY), device="cpu",
                      checkpoint_path=str(tmp_path / "fit.ckpt"), checkpoint_every=2)
    assert len(r.losses) == 3 and inverse.jobs == job + 1
    spans = tracing.snapshot()["spans"]
    by = _by_name(spans)
    (setup,) = by["fit_scene.setup"]
    steps = by["fit_scene.step"]
    assert setup["parent"] is None and (setup["unit"], setup["index"]) == (job, None)
    assert [(s["unit"], s["index"], s["parent"]) for s in steps] == [(job, i, None)
                                                                    for i in range(3)]
    assert setup["end_ns"] <= steps[0]["start_ns"]
    phases = ["step.forward", "step.backward", "step.update", "fit_scene.loss_read"]
    for i, step in enumerate(steps):
        children = [s for s in spans if s["parent"] == step["id"]]
        names = [s["name"] for s in sorted(children, key=lambda s: s["start_ns"])]
        assert names == phases + (["fit_scene.checkpoint"] if i == 1 else []), names
        assert all((s["unit"], s["index"]) == (job, i) for s in children)
    # path A's stages inside each forward; the shadow loop's exit tests
    fwd_ids = {s["id"] for s in by["step.forward"]}
    assert len(by["lol_march"]) == 3 and all(s["parent"] in fwd_ids for s in by["lol_march"])
    shadow_ids = {s["id"] for s in by["lol_shadow_march"]}
    assert by["shading.sync"] and all(s["parent"] in shadow_ids for s in by["shading.sync"])
    summ = tracing.summary()
    assert summ["fit_scene.step"]["count"] == 3 and summ["fit_scene.checkpoint"]["count"] == 1


def test_instanced_fit_step_spans(monkeypatch):
    import functools

    from torch.optim.optimizer import register_optimizer_step_pre_hook

    from loltracer_tpu_torch.config import RenderConfig
    from loltracer_tpu_torch.opt import fit_scene, inverse
    from loltracer_tpu_torch.scenes import instanced_spheres

    monkeypatch.setattr(inverse, "make_sharded_train_step",
                        functools.partial(inverse.make_sharded_train_step, fused="interpret"))
    sc = instanced_spheres(n=24, seed=3, extent=6.0, device="cpu")
    cfg = RenderConfig(shadow_grad="envelope", step_clamp=2.0, **TINY)
    target = torch.full((16, 8, 3), 0.3)

    def step(record: bool):
        grads = []
        hook = register_optimizer_step_pre_hook(
            lambda opt, *_: grads.append([None if p.grad is None else p.grad.clone()
                                          for p in opt.param_groups[0]["params"]]))
        try:
            with tracing.recording() if record else contextlib.nullcontext():
                r = fit_scene(sc.structure, sc.params, target, steps=1, cfg=cfg, device="cpu")
        finally:
            hook.remove()
        return r, grads[0]

    plain, plain_grads = step(False)
    assert tracing.snapshot()["spans"] == []
    traced, traced_grads = step(True)
    assert plain.losses == traced.losses
    assert len(plain_grads) == len(traced_grads)
    for a, b in zip(plain_grads, traced_grads):
        assert (a is None and b is None) or torch.equal(a, b)
    assert any(g is not None and g.abs().sum() > 0 for g in traced_grads)
    for f in ("sphere_point", "sphere_radius", "light_point"):
        assert torch.equal(getattr(plain.params, f), getattr(traced.params, f))
    by = _by_name(tracing.snapshot()["spans"])
    (fwd,), (bwd,) = by["step.forward"], by["step.backward"]
    (ifwd,), (ibwd,) = by["instanced_train.forward"], by["instanced_train.backward"]
    assert ifwd["parent"] == fwd["id"] and ibwd["parent"] == bwd["id"]
    assert fwd["start_ns"] <= ifwd["start_ns"] <= ifwd["end_ns"] <= fwd["end_ns"]
    assert bwd["start_ns"] <= ibwd["start_ns"] <= ibwd["end_ns"] <= bwd["end_ns"]


def test_grid_build_spans_and_entries():
    from loltracer_tpu_torch.render import cell_grid
    from loltracer_tpu_torch.render.instanced_pack import pack_instanced
    from loltracer_tpu_torch.scenes import instanced_spheres

    sc = instanced_spheres(n=200, seed=2, device="cpu")
    tables = pack_instanced(sc.structure, sc.params)
    before = tracing.counters()
    with tracing.recording():
        grid = cell_grid.grid_for(tables, 2.0)
    after = tracing.counters()
    spans = tracing.snapshot()["spans"]
    by = _by_name(spans)
    (build,) = by["cell_grid.build"]
    syncs = by["cell_grid.sync"]
    # reach_for's radius, the box, the counts' prefix, each chunk's mask
    assert len(syncs) == 4 and all(s["parent"] == build["id"] for s in syncs)
    assert {s["name"] for s in spans} == {"cell_grid.build", "cell_grid.sync"}
    assert grid.cell_rows.numel() > 0
    assert after["cell_grid.entries"] - before["cell_grid.entries"] == grid.cell_rows.numel()
    assert after["cell_grid.builds"] - before["cell_grid.builds"] == 1
    # always on: a build with spans off counts its entries as well
    cell_grid.grid_for(tables, 2.0)
    assert tracing.counters()["cell_grid.entries"] - after["cell_grid.entries"] == \
        grid.cell_rows.numel()
    assert len(tracing.snapshot()["spans"]) == len(spans)


def test_grid_counts_read_out_and_reset():
    from loltracer_tpu_torch.render import instanced_fwd

    dev = torch.device("cpu")
    acc = instanced_fwd.grid_counts(dev, 100)
    assert instanced_fwd.grid_counts(dev, 60) is acc
    acc += torch.tensor([320, 16, 2880])  # what two counting launches added
    c = tracing.snapshot(reset=True)["counters"]
    assert (c["instanced_render.rays"], c["instanced_render.searches"],
            c["instanced_render.fallbacks"], c["instanced_render.entries_read"]) == \
        (160, 320, 16, 2880)
    assert c["instanced_render.searches_per_ray"] == 2.0
    assert c["instanced_render.entries_per_search"] == 9.0
    assert c["instanced_render.fallback_share"] == 0.05
    assert not any(k.startswith("instanced_render.") for k in tracing.counters())


def test_max_spans_counts_the_dropped(monkeypatch):
    monkeypatch.setattr(tracing, "MAX_SPANS", 2)
    with tracing.recording():
        for _ in range(3):
            with tracing.span("t.x"):
                pass
    snap = tracing.snapshot(reset=True)
    assert len(snap["spans"]) == 2 and snap["dropped"] == 1
    assert tracing.snapshot()["dropped"] == 0


def _trace_files(d):
    files = sorted(p.name for p in d.iterdir())
    chrome = [f for f in files if f.endswith(".json") and f != "spans.json"]
    assert "spans.json" in files and len(chrome) == 1, files
    return json.loads((d / "spans.json").read_text()), (d / chrome[0]).read_text()


def test_cli_fit_trace_writes_both_files(tmp_path, capsys):
    from loltracer_tpu_torch import cli

    target = tmp_path / "t.npy"
    np.save(target, np.full((4, 6, 3), 0.3, np.float32))
    out = tmp_path / "trace"
    assert cli.main(["fit", str(EXAMPLES / "scene.lol"), "--target", str(target), "--steps",
                     "2", "--max-steps", "16", "--shadow-steps", "8", "--device", "cpu",
                     "--trace", str(out)]) == 0
    spans, chrome = _trace_files(out)
    assert spans["summary"]["fit_scene.step"]["count"] == 2
    assert spans["summary"]["fit_scene.setup"]["count"] == 1
    assert {"cell_grid.builds", "cell_grid.entries"} <= set(spans["counters"])
    assert len(spans["spans"]) == sum(v["count"] for v in spans["summary"].values())
    for name in ("fit_scene.step", "step.backward", "lol_march"):
        assert f'"{name}"' in chrome, name


def test_cli_render_trace_writes_both_files(tmp_path, capsys):
    from loltracer_tpu_torch import cli

    out = tmp_path / "trace"
    assert cli.main(["render", str(EXAMPLES / "scene.lol"), "--backend", "pallas", "--size",
                     "12x8", "--device", "cpu", "-o", str(tmp_path / "o.npy"), "--trace",
                     str(out)]) == 0
    spans, chrome = _trace_files(out)
    by = _by_name(spans["spans"])
    (frame,), (pack,), (launch,) = by["render.frame"], by["render.pack"], by["render.launch"]
    assert frame["unit"] == 0 and frame["parent"] is None
    assert pack["parent"] == launch["parent"] == frame["id"]
    # on the CPU the launch is the plain version: path A's stages
    assert by["lol_march"][0]["parent"] == launch["id"]
    assert '"render.launch"' in chrome
