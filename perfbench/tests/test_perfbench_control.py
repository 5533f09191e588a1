"""The control — the plain reference put in the program's place, computed
in TF32, the precision just below the configurations' float32 — comes out
not correct against each cell's limits, where the program comes out
correct on the same answers."""
import time

import pytest
import torch

from perfbench import harness, spec

CELLS = sorted(w["name"] for w in spec.load_benchmark()["workloads"])


def _readings(cell, seed, seconds, device):
    out = harness.run_cell(cell, seed, seconds, trace=False, device=device,
                           t_start=time.perf_counter(), control=True)
    fails = {k: v for k, v in out.control.items()
             if k in cell.limits and v > cell.limits[k]}
    return out, fails


@pytest.mark.parametrize("workload", CELLS)
def test_the_control_fails_where_the_program_passes(workload, small):
    cell = small(workload, n=64, m=3000, rate_per_s=300, warm_queue=4,
                 check_every=2)
    out, fails = _readings(cell, 2 ** 32 + 17, 0.4, torch.device("cpu"))
    assert out.correct, out.checks
    assert fails, (out.control, cell.limits)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_the_control_fails_on_the_card_at_the_cells_size(workload,
                                                          cuda_device):
    cell = spec.resolve(workload)
    for seed in (2 ** 31 + 1, 2 ** 31 + 2, 2 ** 31 + 3):
        out, fails = _readings(cell, seed, 1.0, cuda_device)
        assert out.correct, (seed, out.checks)
        assert fails, (seed, out.control, cell.limits)
        del out
        torch.cuda.empty_cache()
