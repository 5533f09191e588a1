"""What a cell is made of, found by name.

``BENCHMARK.json`` (at the checkout's root) names each cell's
configuration and traffic mix and each metric. Everything that belongs
to one of them sits in files of its own:

* a configuration: the ``file`` its entry names (``configs/<name>.json``);
* a traffic mix: ``traffic/<traffic>.json``, the parameters of its
  arrivals and requests, and the name of the driver that runs them;
* a driver: ``drivers/<driver>.py``, with ``run(cell, seed, seconds,
  **kw) -> harness.Outcome`` (see ``harness.py``);
* a per-layer metric: ``metrics/<metric>.py``, a reader with
  ``read(ctx) -> float | None``;
* the limits of a cell's comparison: ``limits/<workload>.json``.

So a later change adds a configuration, a mix, a metric or a cell as new
files and new entries, and edits no file that is there.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Callable, List, Optional

__all__ = ["Cell", "HERE", "ROOT", "driver", "load_benchmark",
           "metric_reader", "resolve"]

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass
class Cell:
    workload: str
    config: dict
    traffic: dict
    limits: dict
    chips: int
    end_to_end: List[dict]
    per_layer: List[dict]
    root: Path = ROOT


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _json(path: Path) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    return json.loads(path.read_text())


def _for(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def resolve(workload: str, root: Path = ROOT,
            bench: Optional[dict] = None) -> Cell:
    """The cell named ``workload``, with its files read."""
    bench = load_benchmark(root) if bench is None else bench
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(has {', '.join(sorted(cells))})")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _json(root / configs[w["config"]]["file"])
    here = root / HERE.name
    traffic = _json(here / "traffic" / f"{w['traffic']}.json")
    limits = _json(here / "limits" / f"{workload}.json")
    e2e = [m for m in bench["end_to_end"] if _for(m, workload)]
    per_layer = [m for m in bench["per_layer"] if _for(m, workload)]
    return Cell(workload=workload, config=config, traffic=traffic,
                limits=limits, chips=int(w["chips"]), end_to_end=e2e,
                per_layer=per_layer, root=root)


def _load(kind: str, name: str, root: Path):
    """The module ``<kind>/<name>.py`` under the benchmark's folder,
    loaded by its path (names hold dots)."""
    path = root / HERE.name / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"perfbench_{kind}_" + name.replace(".", "_").replace("-", "_"),
        path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(f"no {path} for {kind[:-1]} {name!r}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, root: Path = ROOT) -> Callable:
    """``read`` of ``metrics/<name>.py``."""
    return _load("metrics", name, root).read


def driver(name: str, root: Path = ROOT) -> Callable:
    """``run`` of ``drivers/<name>.py``."""
    return _load("drivers", name, root).run

