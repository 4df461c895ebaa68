"""The port's measured FP32 ceiling K8 (utils/peak.py, `cli peak`) on the
CPU, against the JAX package's `utils/peak.py`:

- the plain chains against JAX's `_build_kernel` in interpret mode at
  (8, 128) and 4 iterations, lane by lane: "fma" (rounded once per step;
  XLA on the CPU contracts JAX's a * c + d into one FMA) and "sqrt"
  bitwise, "muladd" (two roundings per step) within rtol 1e-5 of it;
- the plain "fma" step rounded once where rounding twice (to f64, then to
  f32) would not be;
- the record's arithmetic (flops, evaluations, the transcendental weight)
  on timings made up for the test;
- `load_measured_peak` on a record like artifacts/gpu_peak.json (the
  default path, under the repository's root); `cli peak --device cpu`.

The kernels themselves run only on the card (chip_smoke.py phase 25)."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from loltracer_tpu_torch import cli
from loltracer_tpu_torch.utils import peak

torch.set_num_threads(1)  # one intra-op thread per pytest worker


@pytest.fixture(scope="module")
def jax_lanes():
    """JAX's lol_peak_fma / lol_peak_sqrt lanes in interpret mode on seeded
    inputs: {kind: (x, lanes)}."""
    import jax.numpy as jnp
    from jax.experimental import pallas as pl

    from loltracer_tpu.utils.peak import _build_kernel

    x = np.random.default_rng(0).uniform(1.0, 2.0, (8, 128)).astype(np.float32)
    calls = {}
    mp = pytest.MonkeyPatch()
    orig = pl.pallas_call

    def keep(*a, **k):
        calls[k["name"]] = orig(*a, **k)
        return calls[k["name"]]

    mp.setattr(pl, "pallas_call", keep)
    try:
        for kind in ("fma", "sqrt"):
            _build_kernel(kind, (8, 128), 4, interpret=True)
    finally:
        mp.undo()
    return {kind: (x.reshape(-1), np.asarray(calls[f"lol_peak_{kind}"](jnp.asarray(x))).reshape(-1))
            for kind in ("fma", "sqrt")}


@pytest.mark.parametrize("kind", peak.KINDS)
def test_plain_chain_matches_jax_kernel(jax_lanes, kind):
    x, ref = jax_lanes["sqrt" if kind == "sqrt" else "fma"]
    ours = peak.peak_chain(torch.from_numpy(x.copy()), kind, 4).numpy()
    assert peak.launches == {"lol_peak_fma": 0, "lol_peak_sqrt": 0}
    if kind == "muladd":
        np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=0)
        assert not np.array_equal(ours, ref)
    else:
        np.testing.assert_array_equal(ours, ref)


def test_record_arithmetic(monkeypatch):
    """flops = lanes * iters * 16 * (2 for the FMA chains, 1 for sqrt) per
    best time; the record's weight is (fma flops / 2) / sqrt evaluations."""
    times = iter([0.5, 0.25, 0.125] * 10)
    monkeypatch.setattr(peak, "_timed", lambda fn, device: (fn(), next(times))[1])
    rec = peak.measure_peak("fma", lanes=1024, iters=3, reps=2, device="cpu")
    assert rec["iters"] == 3 and rec["best_seconds"] == 0.125
    assert rec["evals_per_s"] == 1024 * 3 * 16 / 0.125
    assert rec["flops_per_s"] == 2 * rec["evals_per_s"]
    sq = peak.measure_peak("sqrt", lanes=1024, iters=3, reps=2, device="cpu")
    assert sq["flops_per_s"] == sq["evals_per_s"]

    fake = {"fma": 60e12, "muladd": 31e12, "sqrt": 4e12}
    monkeypatch.setattr(peak, "measure_peak", lambda kind, reps, device: {
        "kind": kind, "flops_per_s": fake[kind],
        "evals_per_s": fake[kind] / (1 if kind == "sqrt" else 2)})
    rec = peak.measure_vpu_peak(reps=1, device="cpu")
    assert rec["platform"] == "cpu" and "device" not in rec
    assert rec["fma_flops_per_s"] == 60e12 and rec["muladd_flops_per_s"] == 31e12
    assert rec["sqrt_evals_per_s"] == 4e12
    assert rec["transcendental_weight"] == pytest.approx(7.5)
    assert set(rec["detail"]) == set(peak.KINDS)


def test_load_measured_peak(tmp_path):
    path = tmp_path / "gpu_peak.json"
    assert peak.load_measured_peak(str(path)) is None
    path.write_text(json.dumps({"platform": "gpu", "fma_flops_per_s": 6.1e13}))
    assert peak.load_measured_peak(str(path)) == 6.1e13
    path.write_text(json.dumps({"platform": "cpu", "fma_flops_per_s": 3e8}))
    assert peak.load_measured_peak(str(path)) is None
    path.write_text("{")
    assert peak.load_measured_peak(str(path)) is None
    root = Path(__file__).resolve().parent.parent
    assert Path(peak.PEAK_ARTIFACT) == root / "artifacts" / "gpu_peak.json"


def test_fma_reference_rounds_once():
    """a * c + d = (the midpoint of two f32) + 2**-60 exactly: rounded once it
    goes up; rounded to f64 first it lands on the midpoint, which then goes
    to the even neighbour, below."""
    a = torch.tensor([1 + 5 * 2.0**-23], dtype=torch.float32)
    c = torch.tensor(1 + 838861 * 2.0**-23, dtype=torch.float64)
    d = torch.tensor(-(2.0**-46 - 2.0**-60), dtype=torch.float64)
    assert float(d.float()) == float(d)  # d is an f32 value
    up = 1 + 838867 * 2.0**-23
    assert float(peak._fma_rn(a, c, d)) == up
    assert float((a.double() * c + d).float()) == up - 2.0**-23


def test_cli_peak_on_the_cpu(tmp_path, monkeypatch, capsys):
    """`cli peak --device cpu` prints the record without its detail and
    writes it only where --out says; it never writes the card's artifact.
    The default --device cuda raises without CUDA."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(peak, "measure_peak", lambda kind, reps, device: dict(
        kind=kind, flops_per_s=2.0e9, evals_per_s=1.0e9, device=str(device)))
    assert cli.main(["peak", "--device", "cpu", "--reps", "1"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["platform"] == "cpu" and "detail" not in line
    assert not (tmp_path / "artifacts").exists()
    out = tmp_path / "cpu_peak.json"
    assert cli.main(["peak", "--device", "cpu", "--reps", "1", "--out", str(out)]) == 0
    rec = json.loads(out.read_text())
    assert rec["detail"]["sqrt"]["device"] == "cpu" and rec["fma_flops_per_s"] == 2.0e9
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        cli.main(["peak"])


def test_measure_peak_times_the_plain_chain_on_the_cpu():
    """A short real run on the CPU: a finite sum and rate."""
    rec = peak.measure_peak("muladd", iters=2, reps=1, device="cpu")
    assert rec["iters"] == 2 and rec["lanes"] == peak.BLOCK * peak.CHAINS
    assert np.isfinite(rec["sum"]) and rec["flops_per_s"] > 0
