"""The traffic is fixed by ``--seed``, and each request is timed from the
moment it was due."""
import time

import numpy as np
import pytest
import torch

from perfbench import harness

BIG = 2 ** 31 + 12345           # seeds run past 32 signed bits


@pytest.mark.parametrize("seed", [0, 7, BIG, 2 ** 63 + 5])
def test_arrivals_are_the_seeds(seed):
    a = harness.arrivals(400.0, 2.5, seed)
    assert np.array_equal(a, harness.arrivals(400.0, 2.5, seed))
    assert len(a) == 1000 and np.all(np.diff(a) > 0)
    other = harness.arrivals(400.0, 2.5, seed + 1)
    # every seed offers the same gaps, in its own order
    assert not np.array_equal(a, other)
    assert np.allclose(np.sort(np.diff(np.r_[0.0, a])),
                       np.sort(np.diff(np.r_[0.0, other])))
    assert a[-1] == pytest.approx(2.5, rel=0.01)


def test_device_draws_are_the_seeds():
    dev = torch.device("cpu")
    a = harness.normal((3, 50), dev, BIG, "windows", 0.5)
    assert torch.equal(a, harness.normal((3, 50), dev, BIG, "windows", 0.5))
    assert not torch.equal(a, harness.normal((3, 50), dev, BIG + 1,
                                             "windows", 0.5))
    assert not torch.equal(a, harness.normal((3, 50), dev, BIG, "rhs", 0.5))
    assert harness.substream(BIG, "x") != harness.substream(BIG, "y")
    # a configuration's dtype is the one its inputs are drawn in
    b = harness.normal((3, 50), dev, BIG, "windows", 0.5, "bfloat16")
    assert b.dtype == torch.bfloat16 and torch.equal(b, a.to(torch.bfloat16))


def test_a_dtype_no_driver_runs_is_refused():
    assert harness.dtype_of({"dtype": "bfloat16"},
                            ("float32", "bfloat16")) == "bfloat16"
    with pytest.raises(ValueError, match="float16"):
        harness.dtype_of({"dtype": "float16"}, ("float32", "bfloat16"))


@pytest.mark.parametrize("burst", [1, 4])
def test_bursts_offer_the_same_rate(burst):
    a = harness.arrivals(400.0, 2.5, BIG, burst=burst)
    assert len(a) == 1000 and np.all(np.diff(a) >= 0)
    # requests come in groups of ``burst`` due at one moment
    assert len(np.unique(a)) == 1000 // burst
    assert a[-1] == pytest.approx(2.5, rel=0.02)


@pytest.mark.parametrize("max_requests,widths", [
    (16, (1, 2, 4, 8, 16, 16)), (12, (1, 2, 4, 8, 12, 12)), (1, (1, 1))])
def test_warmup_widths_follow_max_requests(max_requests, widths):
    assert harness.warmup_widths(max_requests) == widths


@pytest.mark.parametrize("workload", ["t1_n2048_m200k.serve",
                                      "t1_n2048_m10k.slide"])
def test_requests_are_timed_from_their_due_times(workload, small):
    cell = small(workload, rate_per_s=300, warm_queue=4)
    trail = {}
    out = harness.run_cell(cell, BIG, 0.5, trace=False,
                           device=torch.device("cpu"),
                           t_start=time.perf_counter(), trail=trail)
    due, sub, done = trail["due"], trail["sub"], trail["done"]
    assert np.array_equal(due, harness.arrivals(300, 0.5, BIG))
    assert out.attempted == len(due) == 150
    # submitted once due, answered after submission
    assert np.all(sub >= due) and np.all(done >= sub)
    lat = (done - due) * 1e3
    assert out.e2e["request_p50_ms"] == pytest.approx(np.percentile(lat, 50))
    assert out.e2e["request_p95_ms"] == pytest.approx(np.percentile(lat, 95))
    assert out.correct, out.checks
