"""What the benchmark may import: the reference nothing of the program, and
no module of the benchmark JAX, jaxlib, flax or the JAX package, by whole
top-level names (`dvg_tpu_torch` is not `dvg_tpu`)."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import run

BENCH = Path(run.__file__).resolve().parent
ROOT = BENCH.parent


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def _sources(directory: Path):
    return sorted(p for p in directory.rglob("*.py")
                  if "tests" not in p.relative_to(BENCH).parts)


def test_the_reference_imports_nothing_of_the_program():
    for path in _sources(BENCH / "reference"):
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in ("dvg_tpu_torch", "dvg_tpu"), (path, name)
            if top == "benchmark":
                assert name.startswith("benchmark.reference"), (path, name)


def test_no_benchmark_module_imports_jax_or_the_jax_package():
    for path in _sources(BENCH):
        for name in _imports(path):
            assert name.split(".")[0] not in run.FORBIDDEN, (path, name)


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    for name in run.FORBIDDEN:
        monkeypatch.delitem(sys.modules, name, raising=False)
    monkeypatch.setitem(sys.modules, "dvg_tpu_torch.fake", object())
    monkeypatch.setitem(sys.modules, "jaxtyping_fake", object())
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jaxlib.fake", object())
    monkeypatch.setitem(sys.modules, "dvg_tpu", object())
    assert run.forbidden_modules() == ["dvg_tpu", "jaxlib"]


RUN_TINY = """
import sys
from benchmark import run
from benchmark.tests import cells
cell = cells.cell("dcgan64_smmnist.eval")
res, code = run.run_cell(cell, 7, 0.1, False, "cpu", overrides={
    "model": {"g_dim": 8, "rnn_size": 16, "num_inducing_points": 4},
    "nsample": 2, "n_eval": 8, "batch_size": 2, "warmup_calls": 1,
    "dtype": "float32"})
print(code, run.forbidden_modules())
"""


def test_a_run_loads_no_forbidden_module():
    out = subprocess.run([sys.executable, "-c", RUN_TINY], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "0 []"


@pytest.mark.parametrize("setting", ["no_card", "benchmark_only"])
def test_no_result_without_a_card_or_without_the_program(tmp_path,
                                                         setting):
    """Here there is no card; in a directory with only BENCHMARK.json and
    the benchmark there is no program either. Either way: no result line
    and a non-zero exit."""
    cwd = ROOT
    if setting == "benchmark_only":
        import shutil
        shutil.copytree(BENCH, tmp_path / "benchmark",
                        ignore=shutil.ignore_patterns("__pycache__",
                                                      ".cache"))
        shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
        cwd = tmp_path
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "dcgan64_smmnist.train", "--seed", "3", "--seconds", "1",
         "--trace", "0"], cwd=cwd, capture_output=True, text=True,
        timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
