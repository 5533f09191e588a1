"""Nothing the benchmark runs loads JAX or the JAX package ``repro``
(top-level names compared whole: ``repro_torch`` is the program), and the
reference loads not even the program."""
import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from perfbench import run, spec

ROOT = spec.ROOT
HERE = spec.HERE
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}

_LOADS = r"""
import json, sys, time
sys.path[:0] = [{src!r}, {root!r}]
{body}
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

_RUN_SMALL = """
import torch
from perfbench import harness, spec, run, calibrate, sweep
for w in ("t1_n2048_m200k.oneshot", "t1_n2048_m10k.slide"):
    cell = spec.resolve(w)
    cell.config.update(n=32, m=900)
    cell.traffic.update(rate_per_s=200, warm_queue=2)
    out = harness.run_cell(cell, 3, 0.2, trace=True,
                           device=torch.device("cpu"),
                           t_start=time.perf_counter())
    for m in cell.per_layer:
        spec.metric_reader(m["name"])(out.ctx)
"""


def _loaded(body: str) -> set:
    code = _LOADS.format(src=str(ROOT / "src"), root=str(ROOT), body=body)
    env = dict(os.environ, USE_FLAX="0")
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, env=env, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax_and_no_reference_package():
    mods = _loaded(_RUN_SMALL)
    assert "repro_torch" in mods and "perfbench" in mods
    assert not mods & FORBIDDEN


def test_the_reference_loads_not_even_the_program():
    mods = _loaded("from perfbench.reference import algorithm1")
    assert not mods & (FORBIDDEN | {"repro_torch", "perfbench.harness"})


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", "") == "import_module" and node.args \
                and isinstance(node.args[0], ast.Constant):
            names.add(node.args[0].value.split(".")[0])
    return names


def test_no_source_of_the_benchmark_names_them():
    for path in HERE.rglob("*.py"):
        assert not _imports(path) & FORBIDDEN, path
    # the reference stands on plain libraries alone
    plain = {"__future__", "math", "typing", "numpy", "torch"}
    for path in (HERE / "reference").rglob("*.py"):
        assert _imports(path) <= plain, path


def test_forbidden_modules_compares_whole_names(monkeypatch):
    assert run.forbidden_modules() == [] or "jax" in sys.modules
    monkeypatch.setitem(sys.modules, "repro_torch_extra", object())
    assert "repro" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.core", object())
    assert "repro" in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.xla", object())
    assert "jaxlib" in run.forbidden_modules()


def _run(cwd, workload="t1_n2048_m200k.oneshot"):
    return subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", workload,
         "--seed", str(2 ** 33 + 1), "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})


def test_no_card_no_result(cuda_absent):
    out = _run(ROOT)
    assert out.returncode == 2 and out.stdout == ""
    assert "needs 1 CUDA device" in out.stderr


def test_the_benchmark_alone_gives_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(HERE, tmp_path / HERE.name,
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0 and out.stdout == ""


@pytest.fixture
def cuda_absent():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
