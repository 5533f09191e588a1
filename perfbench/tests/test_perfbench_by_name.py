"""A configuration, a traffic mix, a driver, a per-layer metric and a cell
added as new files and new entries of ``BENCHMARK.json`` are found by name,
with no edit to a file that is there."""
import hashlib
import json
import shutil
import time

import torch

from perfbench import harness, spec

READER = '''"""queue_free_ms (ms): a new metric's reader."""


def read(ctx):
    if not getattr(ctx, "solves", 0):
        return None
    return 1e3 * ctx.window_s / ctx.solves
'''


DRIVER = '''"""twice: a new driver, which runs the oneshot driver's window
and reports its solves twice over in a metric of its own."""
from perfbench import spec


def run(cell, seed, seconds, **kw):
    out = spec.driver("oneshot", root=cell.root)(cell, seed, seconds, **kw)
    out.ctx.twice = 2 * out.ctx.solves
    return out
'''


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_new_files_are_found_by_name(tmp_path):
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    here = tmp_path / spec.HERE.name
    shutil.copytree(spec.HERE, here,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = _digests(tmp_path)

    (here / "configs" / "tiny_new.json").write_text(json.dumps(
        {"name": "tiny_new", "n": 24, "m": 700, "damping": 1e-2,
         "dtype": "float32", "reduced": []}))
    (here / "traffic" / "oneshot_deep.json").write_text(json.dumps(
        {"driver": "twice", "pool_bytes": 1, "pool_min": 3, "v_pool": 4,
         "in_flight": 2, "check_every": 3}))
    (here / "drivers" / "twice.py").write_text(DRIVER)
    # a bursty mix of the existing serve driver: data alone
    bursty = json.loads((here / "traffic" / "serve_m200k.json").read_text())
    bursty.update(burst=4, rate_per_s=400, warm_queue=4)
    (here / "traffic" / "bursty.json").write_text(json.dumps(bursty))
    (here / "limits" / "tiny_new.bursty.json").write_text(
        json.dumps({"x_err": 1e-4, "unanswered": 0}))
    (here / "metrics" / "queue_free_ms.py").write_text(READER)
    (here / "limits" / "tiny_new.oneshot_deep.json").write_text(
        json.dumps({"x_err": 1e-5}))
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny_new", "source": "a test",
                             "file": "perfbench/configs/tiny_new.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "tiny_new.oneshot_deep",
                               "config": "tiny_new",
                               "traffic": "oneshot_deep", "chips": 1,
                               "why": "a test"})
    bench["workloads"].append({"name": "tiny_new.bursty",
                               "config": "tiny_new", "traffic": "bursty",
                               "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "queue_free_ms", "unit": "ms",
                               "better": "lower", "source": "host_clock",
                               "layer": "load generator", "moves": "solve_ms",
                               "workloads": ["tiny_new.oneshot_deep"]})
    bench["end_to_end"][0]["workloads"].append("tiny_new.oneshot_deep")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = spec.resolve("tiny_new.oneshot_deep", root=tmp_path)
    assert cell.config["m"] == 700 and cell.traffic["pool_min"] == 3
    assert [m["name"] for m in cell.per_layer] == ["queue_free_ms"]
    assert {m["name"] for m in cell.end_to_end} == {"solve_ms", "setup_s"}
    out = harness.run_cell(cell, 5, 0.2, trace=False,
                           device=torch.device("cpu"),
                           t_start=time.perf_counter())
    assert out.correct and out.attempted > 0
    assert out.ctx.twice == 2 * out.ctx.solves
    value = spec.metric_reader("queue_free_ms", root=tmp_path)(out.ctx)
    assert value > 0
    cell = spec.resolve("tiny_new.bursty", root=tmp_path)
    trail = {}
    out = harness.run_cell(cell, 6, 0.3, trace=False,
                           device=torch.device("cpu"),
                           t_start=time.perf_counter(), trail=trail)
    assert out.correct and out.attempted == 120
    assert len(set(trail["due"])) == 30
    # every file that was there is as it was
    after = _digests(tmp_path)
    changed = {p for p in before if before[p] != after[p]}
    assert changed == {spec.Path("BENCHMARK.json")}
