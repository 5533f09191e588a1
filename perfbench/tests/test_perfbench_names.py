"""``BENCHMARK.json`` keeps to the form the benchmark's contract sets:
names and units of allowed characters only, the keys of each entry, and a
file for each thing named."""
import json
import re

import pytest

from perfbench import spec

BENCH = spec.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
E2E = {m["name"]: m for m in BENCH["end_to_end"]}
CELLS = {w["name"]: w for w in BENCH["workloads"]}


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and \
        "\n" not in text and "\t" not in text


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len((spec.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(_line(w) for w in BENCH["command"])
    assert all(PATH.match(p) and ".." not in p.split("/")
               for p in BENCH["paths"])


def test_names_and_units_use_allowed_characters():
    names = [e["name"] for key in ("configs", "workloads", "end_to_end",
                                   "per_layer") for e in BENCH[key]]
    names += [w[k] for w in BENCH["workloads"] for k in ("config", "traffic")]
    names += [r for c in BENCH["configs"] for r in c["reduced"]]
    bad = [n for n in names if not NAME.match(n)]
    assert not bad
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert all(UNIT.match(m["unit"]) for m in metrics)
    assert all(m["better"] in ("lower", "higher") for m in metrics)
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        got = [e["name"] for e in BENCH[key]]
        assert len(got) == len(set(got)), key


def test_entry_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"])
        assert len(c["reduced"]) <= 16
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _line(w["why"])
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert E2E["setup_s"]["bound"] == 0.25 and "workloads" not in E2E[
        "setup_s"]
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"]) and m["moves"] in E2E


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_each_cell_reports_and_has_its_files(cell):
    c = spec.resolve(cell)
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer
    for m in c.per_layer:
        # the metric's cells report the end-to-end metric it moves
        assert m["moves"] in e2e, (cell, m["name"])
        spec.metric_reader(m["name"])
    assert c.limits and all(v >= 0 for v in c.limits.values())


def test_configs_are_used_and_their_files_lie_under_paths():
    used = {w["config"] for w in BENCH["workloads"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert used == {c["name"] for c in BENCH["configs"]}
    assert len(files) == len(set(files))
    for c in BENCH["configs"]:
        assert any(c["file"].startswith(p + "/") for p in BENCH["paths"])
        data = json.loads((spec.ROOT / c["file"]).read_text())
        assert data["name"] == c["name"] and data["reduced"] == c["reduced"]


def test_files_under_paths_are_named_from_name_characters():
    for p in BENCH["paths"]:
        for f in (spec.ROOT / p).rglob("*"):
            if "__pycache__" in f.parts or f.suffix == ".pyc":
                continue
            assert PATH.match(str(f.relative_to(spec.ROOT))), f


def test_the_window_fits_a_check_of_24_cells():
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(CELLS) // 4)
