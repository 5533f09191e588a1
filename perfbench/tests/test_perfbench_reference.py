"""The plain reference against a float64 direct solve, and the sliding
window it replays against a fold-by-fold replay."""
import pytest
import torch

from perfbench.reference import algorithm1 as ref


def _problem(n, m, k, seed):
    g = torch.Generator().manual_seed(seed)
    S = torch.randn((n, m), generator=g) / m ** 0.5
    V = torch.randn((m, k), generator=g)
    return S, V


def _direct(S, V, lam):
    S64 = S.double()
    A = S64.T @ S64 + lam * torch.eye(S.shape[1], dtype=torch.float64)
    return torch.linalg.solve(A, V.double())


@pytest.mark.parametrize("n,m,lam,seed", [(8, 30, 1e-3, 0), (16, 200, 1e-3, 1),
                                          (24, 90, 1e-1, 2), (5, 70000, 1e-3, 3)])
def test_float64_reference_is_the_direct_solve(n, m, lam, seed):
    # (5, 70000) crosses the reference's column blocks
    if m > 1000:
        S, V = _problem(n, m, 2, seed)
        S64 = S.double()
        A = S64 @ S64.T + lam * torch.eye(n, dtype=torch.float64)
        want = (V.double() - S64.T @ torch.linalg.solve(A, S64 @ V.double())) / lam
    else:
        S, V = _problem(n, m, 3, seed)
        want = _direct(S, V, lam)
    got = ref.solve(S, V, lam)
    assert got.dtype == torch.float64
    assert ref.rel_err(got, want) < 1e-10
    assert ref.rel_err(ref.solve(S, V[:, 0], lam), want[:, 0]) < 1e-10


def test_control_sits_in_tf32_not_float64():
    S, V = _problem(32, 4000, 4, 5)
    x64 = ref.solve(S, V, 1e-3)
    err = ref.rel_err(ref.solve(S, V, 1e-3, "tf32"), x64)
    # TF32 keeps 10 mantissa bits: its error is far above float32's
    assert 1e-6 < err < 1e-2
    with pytest.raises(ValueError):
        ref.solve(S, V, 1e-3, "bfloat16")


def test_tf32_round_keeps_ten_mantissa_bits():
    # the last bit kept is 2**-10 in [1, 2), 2**-9 in [2, 4)
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -10 + 2 ** -12,
                      -3.0 - 2 ** -9 - 2 ** -11, -3.0 - 2 ** -10,
                      1.0 + 2 ** -12])
    y = ref.tf32_round(x)
    assert (y.view(torch.int32) & 0x1FFF).eq(0).all()
    # ties away from zero, others to nearest
    assert y.tolist() == [1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -10,
                          -3.0 - 2 ** -9, -3.0 - 2 ** -9, 1.0]


def _fold_by_fold(S0, rows, count):
    S = S0.clone()
    n, k = S.shape[0], rows.shape[1]
    cursor = 0
    for r in range(count):
        for i in range(k):
            S[cursor % n] = rows[r, i]
            cursor += 1
    return S


@pytest.mark.parametrize("count", [0, 1, 5, 12, 13, 40])
def test_replayed_slide_is_fold_by_fold(count):
    g = torch.Generator().manual_seed(count)
    n, k, m = 24, 2, 50
    S0 = torch.randn((n, m), generator=g)
    rows = torch.randn((40, k, m), generator=g)
    assert torch.equal(ref.fifo_window(S0, rows, count),
                       _fold_by_fold(S0, rows, count))
    assert ref.fifo_slots(23, 2, n) == [23, 0]


def test_microbatch_starts_follow_fifo_chunks():
    starts = ref.microbatch_starts([[0, 1, 2], [3, 4, 5, 6, 7]], 2)
    assert starts == {0: 0, 1: 0, 2: 2, 3: 3, 4: 3, 5: 5, 6: 5, 7: 7}


def test_factor_resid_separates_a_stale_factor():
    S, _ = _problem(32, 500, 1, 7)
    lam = 1e-3
    f = ref.factor(S, lam)
    assert ref.factor_resid(f.L, f.W, lam) < 1e-14
    S2 = S.clone()
    S2[:4] = torch.randn((4, 500), generator=torch.Generator().manual_seed(8)) / 500 ** 0.5
    W2 = ref.factor(S2, lam).W
    assert ref.factor_resid(f.L, W2, lam) > 1e-2
    # only the lower triangle is read
    assert ref.factor_resid(f.L + torch.triu(torch.ones_like(f.L), 1), f.W,
                            lam) < 1e-14


def test_perp_is_outside_the_row_space():
    S, V = _problem(16, 300, 2, 9)
    f = ref.factor(S, 1e-3)
    P = f.perp(V)
    assert float((S.double() @ P).abs().max()) < 1e-10
    # the part in the row space is gone, the rest kept
    assert ref.rel_err(f.perp(P), P) < 1e-10
