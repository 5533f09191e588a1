"""Serve-path kernels of the torch port: each wrapper's plain path on the
CPU against the JAX package (its Pallas kernels in interpret mode and its
``ref`` oracles), the dispatch rules, and — on a machine with CUDA — each
hand-written kernel against its plain version.

Tolerances are those of ``tests/test_kernels_serve.py``: 5e-6 relative
for the cross, apply and fold passes, 5e-5 for the whole serve solve
(two fp32 reductions over m and two triangular solves, summed in a
different order)."""
import numpy as np
import pytest
import torch

from _torch_parity import pair, rel
from repro_torch.core import BlockedScores
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels.serve_solve import cross_split, sv_cross_cuda

try:
    import jax.numpy as jnp
    from repro.core.operator import BlockedScores as JBlocked
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
except ImportError:     # the GPU machine has no JAX; it runs `-m cuda` only
    jnp = JBlocked = jops = jref = None

torch.set_num_threads(1)

SHAPES = [(8, 128), (32, 300), (100, 1000), (130, 515)]
DTYPES = ["float32", "bfloat16"]
PASS_TOL, SOLVE_TOL = 5e-6, 5e-5


def _window(rng, shape, dtype, lam=0.2):
    """(S, L) pairs: a window and the factor of its stored values."""
    n, m = shape
    Sj, St = pair(rng.normal(size=shape) / np.sqrt(m), dtype)
    S32 = np.asarray(Sj, np.float32)
    L = np.linalg.cholesky(S32.astype(np.float64) @ S32.T
                           + lam * np.eye(n)).astype(np.float32)
    return Sj, St, pair(L)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("k", [1, 5])
def test_plain_passes_match_jax(shape, dtype, k):
    rng = np.random.default_rng([*shape, k, DTYPES.index(dtype)])
    n, m = shape
    Sj, St = pair(rng.normal(size=shape), dtype)
    Vj, Vt = pair(rng.normal(size=(m, k)))
    wj, wt = pair(rng.normal(size=(n, k)))
    rj, rt = pair(rng.normal(size=(k, m)), dtype)
    u = ops.sv_cross(St, Vt)
    assert u.dtype == torch.float32 and u.shape == (n, k)
    assert rel(u, jref.sv_cross_ref(Sj, Vj)) < PASS_TOL
    x = ops.serve_apply(St, wt, Vt, 0.37)
    assert rel(x, jref.serve_apply_ref(Sj, wj, Vj, 0.37)) < PASS_TOL
    cols, corner = ops.fold_cols(St, rt)
    cr, kr = jref.fold_cols_ref(Sj, rj)
    assert cols.shape == (n, k) and corner.shape == (k, k)
    assert rel(cols, cr) < PASS_TOL and rel(corner, kr) < PASS_TOL


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("k", [1, 5])
def test_plain_serve_solve_matches_jax(shape, dtype, k):
    rng = np.random.default_rng([*shape, k, DTYPES.index(dtype), 1])
    Sj, St, (Lj, Lt) = _window(rng, shape, dtype)
    Vj, Vt = pair(rng.normal(size=(shape[1], k)))
    x = ops.serve_solve(St, Lt, Vt, 0.2)
    assert x.dtype == torch.float32 and x.shape == (shape[1], k)
    assert rel(x, jref.serve_solve_ref(Sj, Lj, Vj, 0.2)) < SOLVE_TOL
    w = ops.trisolve(Lt, ops.sv_cross(St, Vt))
    u = jref.sv_cross_ref(Sj, Vj)
    w_ref = np.linalg.solve(np.asarray(Lj, np.float64).T,
                            np.linalg.solve(np.asarray(Lj, np.float64),
                                            np.asarray(u, np.float64)))
    assert rel(w, w_ref) < SOLVE_TOL


@pytest.mark.parametrize("shape", [(32, 300), (130, 515)])
def test_plain_matches_jax_interpret_kernels(shape):
    """The JAX Pallas kernels themselves (interpret mode) as the oracle."""
    rng = np.random.default_rng(3)
    Sj, St, (Lj, Lt) = _window(rng, shape, "float32")
    Vj, Vt = pair(rng.normal(size=(shape[1], 4)))
    rj, rt = pair(rng.normal(size=(2, shape[1])) / 10)
    x = jops.serve_solve(Sj, Lj, Vj, 0.2, mode="interpret")
    assert rel(ops.serve_solve(St, Lt, Vt, 0.2), x) < SOLVE_TOL
    u = jops.sv_cross(Sj, Vj, mode="interpret")
    assert rel(ops.sv_cross(St, Vt), u) < PASS_TOL
    xa = jops.serve_apply(Sj, u, Vj, 0.3, mode="interpret")
    assert rel(ops.serve_apply(St, ops.sv_cross(St, Vt), Vt, 0.3), xa) \
        < PASS_TOL
    cols, corner = jops.fold_cols(Sj, rj, mode="interpret")
    tc, tk = ops.fold_cols(St, rt)
    assert rel(tc, cols) < PASS_TOL and rel(tk, corner) < PASS_TOL


@pytest.mark.parametrize("flat", [True, False], ids=["flat_v", "tuple_v"])
def test_blocked_serve_solve_matches_jax(flat):
    rng = np.random.default_rng(4)
    n, widths, k = 24, (130, 75, 300), 3
    parts = [pair(rng.normal(size=(n, w)) / 10) for w in widths]
    Sj, St = JBlocked([p[0] for p in parts]), BlockedScores([p[1] for p in parts])
    W = np.asarray(Sj.gram(), np.float64)
    Lj, Lt = pair(np.linalg.cholesky(W + 0.2 * np.eye(n)))
    Vj, Vt = pair(rng.normal(size=(sum(widths), k)))
    offs = np.cumsum((0,) + widths)
    if not flat:
        Vj = tuple(Vj[offs[i]:offs[i + 1]] for i in range(3))
        Vt = tuple(Vt[offs[i]:offs[i + 1]] for i in range(3))
    x = ops.serve_solve(St, Lt, Vt, 0.2)
    xj = jops.serve_solve(Sj, Lj, Vj, 0.2, mode="interpret")
    if not flat:
        assert isinstance(x, tuple) and len(x) == 3
        x, xj = torch.cat(x), jnp.concatenate(xj)
    assert rel(x, xj) < SOLVE_TOL


def test_blocked_fold_cols_matches_jax():
    rng = np.random.default_rng(5)
    n, widths, k = 16, (90, 515), 4
    S = [pair(rng.normal(size=(n, w))) for w in widths]
    R = [pair(rng.normal(size=(k, w))) for w in widths]
    cols, corner = ops.fold_cols(BlockedScores([s[1] for s in S]),
                                 tuple(r[1] for r in R))
    cj, kj = jops.fold_cols(JBlocked([s[0] for s in S]),
                            tuple(r[0] for r in R), mode="interpret")
    assert rel(cols, cj) < PASS_TOL and rel(corner, kj) < PASS_TOL


def test_complex_routes_to_plain():
    """Complex operands take the plain version under every mode — even
    "kernel" — as the JAX wrappers route them to the reference."""
    rng = np.random.default_rng(6)
    n, m, k = 20, 256, 2
    S = ((rng.normal(size=(n, m)) + 1j * rng.normal(size=(n, m)))
         / np.sqrt(m)).astype(np.complex64)
    Sj, St = pair(S, "complex64")
    W = S.astype(np.complex128) @ S.conj().T.astype(np.complex128)
    Lj, Lt = pair(np.linalg.cholesky(W + 0.3 * np.eye(n)), "complex64")
    Vj, Vt = pair(rng.normal(size=(m, k)))
    x = ops.serve_solve(St, Lt, Vt, 0.3, mode="kernel")
    assert torch.equal(x, ref.serve_solve_ref(St, Lt, Vt, 0.3))
    assert rel(x, jref.serve_solve_ref(Sj, Lj, Vj, 0.3)) < SOLVE_TOL
    rj, rt = pair(rng.normal(size=(2, m)), "complex64")
    cols, corner = ops.fold_cols(St, rt, mode="kernel")
    cr, kr = ref.fold_cols_ref(St, rt)
    assert torch.equal(cols, cr) and torch.equal(corner, kr)
    assert rel(cols, jref.fold_cols_ref(Sj, rj)[0]) < PASS_TOL


def test_dispatch_modes_on_cpu():
    S, V = torch.randn(8, 40), torch.randn(40, 2)
    assert torch.equal(ops.sv_cross(S, V), ops.sv_cross(S, V, mode="ref"))
    with pytest.raises(RuntimeError, match="CUDA"):
        ops.sv_cross(S, V, mode="kernel")
    with pytest.raises(ValueError, match="mode"):
        ops.sv_cross(S, V, mode="interpret")
    # the launch wrapper itself never runs the plain version
    with pytest.raises(ValueError, match="CUDA"):
        sv_cross_cuda(S, V)


def test_launch_checks():
    cpu = torch.device("cpu")
    t = torch.zeros(4, 6)
    _build.check("t", t, device=cpu, dtypes=(torch.float32,), shape=(4, 6))
    with pytest.raises(ValueError, match="contiguous"):
        _build.check("t", t.T, device=cpu, dtypes=(torch.float32,))
    with pytest.raises(TypeError, match="dtype"):
        _build.check("t", t.double(), device=cpu, dtypes=(torch.float32,))
    with pytest.raises(ValueError, match="shape"):
        _build.check("t", t, device=cpu, dtypes=(torch.float32,), shape=(6, 4))


@pytest.mark.parametrize("rows,m", [(8, 128), (130, 515), (1024, 100_000),
                                    (2048, 200_000), (8, 100_000)])
def test_cross_split_covers_m(rows, m):
    P, chunk = cross_split(rows, m)
    assert chunk % 128 == 0 and P >= 1
    assert (P - 1) * chunk < m <= P * chunk


# ---------------------------------------------------------------------------
# on the card: every kernel against its plain version
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("k", [1, 5, 16])
def test_cuda_kernels_match_plain(shape, dtype, k):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the H100 via chip_smoke "
                    "and `pytest -m cuda`)")
    g = torch.Generator(device="cuda").manual_seed(0)
    n, m = shape
    S = (torch.randn(shape, generator=g, device="cuda") / m ** 0.5).to(dtype)
    S32 = S.float()
    L = torch.linalg.cholesky(S32 @ S32.T
                              + 0.2 * torch.eye(n, device="cuda")).contiguous()
    V = torch.randn((m, k), generator=g, device="cuda")
    w = torch.randn((n, k), generator=g, device="cuda")
    rows = torch.randn((k, m), generator=g, device="cuda").to(dtype)
    cases = [
        (lambda mode: ops.sv_cross(S, V, mode=mode), PASS_TOL),
        (lambda mode: ops.serve_apply(S, w, V, 0.37, mode=mode), PASS_TOL),
        (lambda mode: ops.trisolve(L, w, mode=mode), SOLVE_TOL),
        (lambda mode: ops.serve_solve(S, L, V, 0.2, mode=mode), SOLVE_TOL),
        (lambda mode: torch.cat(ops.fold_cols(S, rows, mode=mode)), PASS_TOL),
    ]
    for fn, tol in cases:
        got, again = fn("kernel"), fn("kernel")
        torch.cuda.synchronize()
        assert torch.equal(got, again)
        assert rel(got, fn("ref")) < tol
