"""The operations and bytes each roofline and mfu reader counts, on known
shapes, and what the readers make of a known trace."""
from types import SimpleNamespace

import pytest

from perfbench import roofline as rf
from perfbench import spec
from perfbench.tracing import TraceData

F32 = "float32"


def test_work_on_known_shapes():
    n, m = 4, 10
    assert rf.gram_sv(n, m, F32) == (4 * 5 * 10 + 2 * 4 * 10,
                                     4 * 10 * 4 + 10 * 4 + 4 * 16 + 4 * 4)
    assert rf.gram_sv(n, m, "bfloat16").nbytes == 4 * 10 * 2 + 10 * 2 + 80
    assert rf.cholesky(6) == (6 ** 3 / 3, 2 * 4 * 21)
    assert rf.trisolve(6) == (2 * 36, 4 * 21 + 2 * 4 * 6)
    assert rf.trisolve(6, 3) == (2 * 36 * 3, 4 * 21 + 2 * 4 * 18)
    assert rf.ngd_apply(n, m, F32) == (2 * 40, 160 + 16 + 40 + 40)
    assert rf.algorithm1(n, m, F32) == (
        4 * 5 * 10 + 2 * 40 + 64 / 3 + 2 * 16 + 2 * 40, 160 + 40 + 40)
    assert rf.serve_solve(n, m, 3, F32) == (4 * 40 * 3 + 2 * 16 * 3,
                                            160 + 4 * 10 + 2 * 4 * 10 * 3)
    assert rf.fold(n, m, 2, F32) == (2 * 40 * 2 + 8 * 16 * 2,
                                     160 + 2 * 2 * 10 * 4 + 2 * 4 * 10 + 32)
    assert rf.refresh(n, m, F32) == (4 * 5 * 10 + 64 / 3, 160 + 64 + 40)


def test_peaks_and_bounds():
    # fp32 operands are held to the TF32 tensor-core rate, not the
    # CUDA cores' 67 TFLOP/s, which a 3xTF32 Gram passes
    assert rf.peak_flops(F32) == 494.7e12
    assert rf.peak_flops("bfloat16") == 989.4e12
    # Table 1's Gram at m = 200,000 is bound by its operations ...
    t, bound = rf.least_seconds(rf.gram_sv(2048, 200_000, F32), F32)
    assert bound == "ops" and t == pytest.approx(2048 * 2049 * 2e5 / 494.7e12,
                                                 rel=1e-3)
    # ... a serving microbatch of 16 by its bytes
    t, bound = rf.least_seconds(rf.serve_solve(2048, 200_000, 16, F32), F32)
    assert bound == "bytes"
    assert t == pytest.approx(2048 * 200_000 * 4 / 3.35e12, rel=0.05)
    assert rf.share(rf.Work(494.7e12, 0), 2.0, F32) == pytest.approx(50.0)


def _trace(ops, window=(0, 10_000_000)):
    return TraceData([(name, s, d, lab) for name, s, d, lab in ops], [],
                     window)


CFG = {"n": 2048, "m": 200_000, "dtype": F32}


def test_kernel_readers_on_a_known_trace():
    ops = [("gram_tc_kernel", 0, 4_000_000, "pb.gram_sv"),
           ("gram_reduce_kernel", 4_000_000, 500_000, "pb.gram_sv"),
           ("cholesky_kernel", 5_000_000, 700_000, "pb.cholesky"),
           ("trisolve_kernel<1>", 6_000_000, 200_000, "pb.trisolve"),
           ("ngd_apply_kernel", 7_000_000, 600_000, "pb.ngd_apply")]
    ctx = SimpleNamespace(config=CFG, trace=_trace(ops), solves=2,
                          layers={"pb.gram_sv": [(), ()],
                                  "pb.cholesky": [()] * 2,
                                  "pb.trisolve": [()] * 2,
                                  "pb.ngd_apply": [()] * 2})
    n, m = CFG["n"], CFG["m"]
    want = {
        "gram_roofline": rf.share(rf.gram_sv(n, m, F32).times(2), 4.5e-3, F32),
        "cholesky_roofline": rf.share(rf.cholesky(n).times(2), 0.7e-3, F32),
        "trisolve_roofline": rf.share(rf.trisolve(n).times(2), 0.2e-3, F32),
        "ngd_apply_roofline": rf.share(rf.ngd_apply(n, m, F32).times(2),
                                       0.6e-3, F32),
        "solve_mfu": 100 * 2 * rf.algorithm1(n, m, F32).flops
        / (10e-3 * 494.7e12),
        "device_idle.oneshot": 100 * (1 - 6.0 / 10.0),
    }
    for name, value in want.items():
        assert spec.metric_reader(name)(ctx) == pytest.approx(value), name
    # the Gram's share by hand: 2 × n(n+1)m(1 + 2/(n+1)) ops in 4.5 ms
    assert want["gram_roofline"] == pytest.approx(
        100 * 2 * (n * (n + 1) * m + 2 * n * m) / 494.7e12 / 4.5e-3)


def test_serve_readers_on_a_known_trace():
    cfg = {"n": 2048, "m": 10_000, "dtype": F32}
    ops = [("cross_partial_kernel", 0, 300_000, "pb.flush/pb.serve_solve"),
           ("trisolve_kernel<16>", 300_000, 200_000,
            "pb.flush/pb.serve_solve"),
           ("serve_apply_kernel", 500_000, 300_000, "pb.flush/pb.serve_solve"),
           ("getrf", 1_000_000, 2_000_000, "pb.flush/pb.fold"),
           ("gemm", 3_000_000, 1_000_000, "pb.flush/pb.maintain")]
    ctx = SimpleNamespace(
        config=cfg, traffic={"rows_per_request": 2}, trace=_trace(ops),
        layers={"pb.serve_solve": [(16,), (4,)]}, served=20, microbatches=2,
        folds=20, refreshes=1, lag_ms=[float(i) for i in range(101)],
        solve_spans_ms=[1.0, 3.0, 2.0])
    n, m = cfg["n"], cfg["m"]
    least = sum(rf.least_seconds(rf.serve_solve(n, m, k, F32), F32)[0]
                for k in (16, 4))
    assert spec.metric_reader("serve_solve_roofline")(ctx) == \
        pytest.approx(100 * least / 0.8e-3)
    least += 20 * rf.least_seconds(rf.fold(n, m, 2, F32), F32)[0] + \
        rf.least_seconds(rf.refresh(n, m, F32), F32)[0]
    assert spec.metric_reader("serve_mfu")(ctx) == \
        pytest.approx(100 * least / 10e-3)
    assert spec.metric_reader("fold_device_ms")(ctx) == pytest.approx(3.0 / 20)
    assert spec.metric_reader("microbatch_k")(ctx) == 10.0
    assert spec.metric_reader("microbatch_solve_ms")(ctx) == 2.0
    assert spec.metric_reader("gen_lag_p95_ms")(ctx) == pytest.approx(95.0)
    assert spec.metric_reader("device_idle.serve")(ctx) == pytest.approx(
        100 * (1 - 3.8 / 10))


def test_a_reader_with_nothing_to_read_returns_nothing():
    empty = SimpleNamespace(config=CFG, traffic={}, trace=None, layers={},
                            solves=0, served=0, microbatches=0, folds=0,
                            refreshes=0, lag_ms=[], solve_spans_ms=[])
    for m in spec.load_benchmark()["per_layer"]:
        assert spec.metric_reader(m["name"])(empty) is None, m["name"]
    # a layer that launched nothing in the capture is silent, never 0
    ctx = SimpleNamespace(config=CFG, trace=_trace([]), solves=1,
                          layers={"pb.gram_sv": [()]})
    assert spec.metric_reader("gram_roofline")(ctx) is None
