"""The benchmark's own tests: on the CPU at small sizes, and marked
``cuda`` where they need the card (they decide inside the test).

    PYTHONPATH=src python -m pytest -q perfbench/tests
"""
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
for p in (os.path.join(ROOT, "src"), ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture
def small():
    """``small(workload, n, m, **traffic)``: the cell named ``workload``
    with its configuration cut to (n, m) and its traffic's parameters
    overridden, for a run on the CPU."""
    from perfbench import spec

    def make(workload, n=48, m=1500, **traffic):
        cell = spec.resolve(workload)
        cell.config.update(n=n, m=m)
        cell.traffic.update(traffic)
        return cell
    return make


@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
