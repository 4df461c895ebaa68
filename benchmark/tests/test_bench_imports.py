"""No module of the benchmark imports JAX or the JAX package (top-level
names compared whole: `loltracer_tpu_torch` begins with `loltracer_tpu`
but is not it); the reference imports nothing of the program; only the
harness's port module imports the program; a run refuses to print a
result without a card, or when a forbidden module is loaded."""

import ast
import json
import subprocess
import sys

import pytest

from benchmark.harness import main as harness
from benchmark.tests.tiny import REPO

BENCH_DIR = REPO / "benchmark"
JAX = {"jax", "jaxlib", "flax", "loltracer_tpu"}


def imported_tops(path):
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            arg = node.args[0] if node.args else None
            if isinstance(arg, ast.Constant):
                tops.add(arg.value.split(".")[0])
    return tops


def sources():
    return sorted(p for p in BENCH_DIR.rglob("*.py") if "__pycache__" not in p.parts)


def test_top_level_names_are_compared_whole(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import loltracer_tpu_torch.opt\nfrom loltracer_tpu.scene import x\n")
    assert imported_tops(f) == {"loltracer_tpu_torch", "loltracer_tpu"}
    assert "loltracer_tpu_torch" not in JAX


@pytest.mark.parametrize("path", sources(), ids=lambda p: str(p.relative_to(BENCH_DIR)))
def test_no_jax_import(path):
    assert not imported_tops(path) & JAX


def test_reference_imports_nothing_of_the_program():
    for sub in ("reference", "scenes"):
        for path in (BENCH_DIR / sub).glob("*.py"):
            assert "loltracer_tpu_torch" not in imported_tops(path), path
    users = {p.relative_to(BENCH_DIR).as_posix() for p in sources()
             if "loltracer_tpu_torch" in imported_tops(p) and "tests" not in p.parts}
    assert users == {"harness/port.py"}


def test_forbidden_modules_compare_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "loltracer_tpu_torch_fake", object())
    assert "loltracer_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "loltracer_tpu.fake", object())
    assert "loltracer_tpu" in harness.forbidden_modules()


def test_no_card_no_result(capsys):
    rc = harness.main(["--workload", "scene4-fit-1080p", "--seed", "1", "--seconds", "1",
                       "--trace", "0"], 0.0)
    assert rc != 0 and capsys.readouterr().out == ""


def test_benchmark_files_alone_give_no_result(tmp_path):
    import shutil

    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    p = subprocess.run([sys.executable, *bench["command"][1:], "--workload",
                        "scene4-fit-1080p", "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""
