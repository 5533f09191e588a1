"""Algorithm 1 in the torch port against the JAX package: the plain twins
of the gram, gram_acc, gram_sv, cholesky and ngd_apply kernels (against
the JAX Pallas kernels in interpret mode and its ``ref`` oracles),
``chol_solve_fused`` dense and blocked, every solver of ``SOLVERS`` plus
``minsr_solve``, ``gram_chunked``, ``center_scores`` and
``LazyBlockedScores``; and — on a machine with CUDA — each hand-written
kernel against its plain version (the Gram on both of its routes, the
apply kernel at ragged and misaligned windows).

Tolerances are those of ``tests/test_kernels.py`` and
``tests/test_solvers.py``: 5e-6 relative for the Gram and apply passes,
1e-5 for the Cholesky factor, rtol 1e-3 / atol 1e-4 for the composed
solve; the solvers, whose fp32 factorizations sum in other orders on the
two sides, 1e-4 (1e-3 for CG, which stops at a residual threshold).
"""
import numpy as np
import pytest
import torch

from _torch_parity import pair, rel
from repro_torch.core import (SOLVERS, BlockedScores, LazyBlockedScores,
                              center_scores, chol_solve, get_solver,
                              gram_chunked, minsr_solve)
from repro_torch.kernels import ops, ref
from repro_torch.kernels.cholesky import cholesky_cuda
from repro_torch.kernels.gram import (ROUTES, gram_cuda, gram_split,
                                      tensor_core_route)
from repro_torch.kernels.ngd_apply import ngd_apply_cuda

try:
    import jax.numpy as jnp
    from repro import core as jcore
    from repro.core.operator import BlockedScores as JBlocked
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
except ImportError:     # the GPU machine has no JAX; it runs `-m cuda` only
    jnp = jcore = JBlocked = jops = jref = None

torch.set_num_threads(1)

SHAPES = [(8, 128), (32, 300), (100, 1000), (128, 2048), (130, 515)]
DTYPES = ["float32", "bfloat16"]
PASS_TOL, CHOL_TOL = 5e-6, 1e-5


def _spd(rng, n):
    A = rng.normal(size=(n, n))
    return pair((A @ A.T / n + np.eye(n)).astype(np.float32))


@pytest.mark.parametrize("shape", [(32, 300), (130, 515)])
def test_plain_twins_match_jax_interpret_kernels(shape):
    """The JAX Pallas kernels themselves (interpret mode) as the oracle."""
    rng = np.random.default_rng(list(shape))
    n, m = shape
    Sj, St = pair(rng.normal(size=shape))
    vj, vt = pair(rng.normal(size=(m,)))
    wj, wt = pair(rng.normal(size=(n,)))
    assert rel(ops.gram(St), jops.gram(Sj, mode="interpret")) < PASS_TOL
    W, u = ops.gram_sv(St, vt)
    Wj, uj = jops.gram_sv(Sj, vj, mode="interpret")
    assert W.shape == (n, n) and u.shape == (n,)
    assert rel(W, Wj) < PASS_TOL and rel(u, uj) < PASS_TOL
    x = ops.ngd_apply(St, wt, vt, 0.37)
    assert x.dtype == torch.float32 and x.shape == (m,)
    assert rel(x, jops.ngd_apply(Sj, wj, vj, 0.37, mode="interpret")) < PASS_TOL
    Cj, Ct = _spd(rng, n)
    L = ops.cholesky(Ct)
    assert rel(L, jops.cholesky(Cj, mode="interpret")) < CHOL_TOL
    # gram_blocks threads one accumulator through gram → gram_acc
    widths = (m // 3, m - m // 3)
    Bj = JBlocked([Sj[:, :widths[0]], Sj[:, widths[0]:]])
    Bt = BlockedScores.from_dense(St, widths)
    assert rel(ops.gram_blocks(Bt), jops.gram_blocks(Bj, mode="interpret")) \
        < PASS_TOL
    assert rel(ops.gram(Bt), jops.gram(Bj, mode="interpret")) < PASS_TOL


@pytest.mark.parametrize("dtype", DTYPES)
def test_gram_acc_matches_jax_interpret_kernel(dtype):
    """``ops.gram_acc`` adds into the buffer it is given, in place, as
    ``gram_acc_pallas`` into its donated W_in."""
    from repro.kernels.gram import gram_acc_pallas
    rng = np.random.default_rng([7, DTYPES.index(dtype)])
    n, m = 128, 512                  # the Pallas kernel's tile multiples
    Sj, St = pair(rng.normal(size=(n, m)), dtype)
    W0j, W0t = pair(rng.normal(size=(n, n)))
    W = W0t.clone()
    out = ops.gram_acc(St, W)
    assert out.data_ptr() == W.data_ptr()
    assert rel(out, gram_acc_pallas(Sj, W0j, interpret=True)) < PASS_TOL


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_plain_twins_match_jax_ref(shape, dtype):
    rng = np.random.default_rng([*shape, DTYPES.index(dtype)])
    n, m = shape
    Sj, St = pair(rng.normal(size=shape), dtype)
    vj, vt = pair(rng.normal(size=(m,)), dtype)
    wj, wt = pair(rng.normal(size=(n,)))
    W = ops.gram(St)
    assert W.dtype == torch.float32
    assert rel(W, jref.gram_ref(Sj)) < PASS_TOL
    W, u = ops.gram_sv(St, vt)
    Wr, ur = jref.gram_sv_ref(Sj, vj)
    assert rel(W, Wr) < PASS_TOL and rel(u, ur) < PASS_TOL
    x = ops.ngd_apply(St, wt, vt, 0.37)
    assert rel(x, jref.ngd_apply_ref(Sj, wj, vj, 0.37)) < PASS_TOL


@pytest.mark.parametrize("n", [16, 48, 100, 130, 160])
def test_cholesky_matches_jax(n):
    rng = np.random.default_rng(n)
    Wj, Wt = _spd(rng, n)
    L = ops.cholesky(Wt)
    assert rel(L, jref.cholesky_ref(Wj)) < CHOL_TOL
    assert torch.equal(torch.triu(L, 1), torch.zeros_like(L))
    assert rel(L @ L.T, Wt) < 1e-5
    # not positive definite: NaN on the plain route, as jnp.linalg.cholesky
    bad = Wt.clone()
    bad[n // 2, n // 2] = -1.0
    assert torch.isnan(ops.cholesky(bad)).all()
    assert np.isnan(np.asarray(jref.cholesky_ref(jnp.asarray(bad.numpy())))).any()


def test_gram_sv_plain_route_keeps_v_precision():
    """The reference's CPU route keeps an fp32 v against a bf16 window
    (``ref.gram_sv_ref``); its TPU kernel rounds v to bf16 first. The
    port's plain route copies the former, its kernel the latter."""
    rng = np.random.default_rng(11)
    Sj, St = pair(rng.normal(size=(16, 200)), "bfloat16")
    vj, vt = pair(rng.normal(size=(200,)))
    _, u = ops.gram_sv(St, vt)
    assert rel(u, jref.gram_sv_ref(Sj, vj)[1]) < PASS_TOL
    _, u_rounded = ops.gram_sv(St, vt.to(torch.bfloat16))
    assert rel(u, u_rounded) > 1e-4


@pytest.mark.parametrize("shape", [(16, 100), (64, 777), (128, 1024)])
def test_chol_solve_fused_matches_jax(shape):
    rng = np.random.default_rng(list(shape))
    n, m = shape
    Sj, St = pair(rng.normal(size=shape))
    vj, vt = pair(rng.normal(size=(m,)))
    x = ops.chol_solve_fused(St, vt, 0.2)
    xj = jops.chol_solve_fused(Sj, vj, 0.2, mode="interpret") if n <= 64 \
        else jops.chol_solve_fused(Sj, vj, 0.2)
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), rtol=1e-3,
                               atol=1e-4)
    np.testing.assert_allclose(x.numpy(), np.asarray(jcore.chol_solve(Sj, vj, 0.2)),
                               rtol=1e-3, atol=1e-4)
    assert rel(x, ref.chol_solve_ref(St, vt, 0.2)) < 1e-5


@pytest.mark.parametrize("flat", [True, False], ids=["flat_v", "tuple_v"])
def test_chol_solve_fused_blocked_matches_jax(flat):
    rng = np.random.default_rng(12)
    n, widths = 24, (130, 75, 300)
    parts = [pair(rng.normal(size=(n, w))) for w in widths]
    Sj = JBlocked([p[0] for p in parts])
    St = BlockedScores([p[1] for p in parts])
    vj, vt = pair(rng.normal(size=(sum(widths),)))
    if not flat:
        offs = np.cumsum((0,) + widths)
        vj = tuple(vj[offs[i]:offs[i + 1]] for i in range(3))
        vt = tuple(vt[offs[i]:offs[i + 1]] for i in range(3))
    x = ops.chol_solve_fused(St, vt, 0.2)
    xj = jops.chol_solve_fused(Sj, vj, 0.2, mode="interpret")
    if not flat:
        assert isinstance(x, tuple) and len(x) == 3
        x, xj = torch.cat(x), jnp.concatenate(xj)
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), rtol=1e-3,
                               atol=1e-4)
    # the lazy operator routes the same way
    lazy = LazyBlockedScores(lambda: St)
    x_lazy = ops.chol_solve_fused(lazy, vt, 0.2)
    assert rel(torch.cat(x_lazy) if not flat else x_lazy, x) < 1e-6


# ---------------------------------------------------------------------------
# the solver library
# ---------------------------------------------------------------------------

N, M, LAM = 8, 40, 0.3
WIDTHS = (15, 25)
SOLVER_TOL = {"chol": 1e-4, "eigh": 1e-4, "svd": 1e-4, "direct": 1e-4,
              "cg": 1e-3}


def _problem(mode, seed, k=None):
    rng = np.random.default_rng(seed)
    S = rng.normal(size=(N, M)) / np.sqrt(M)
    shape = (M,) if k is None else (M, k)
    v = rng.normal(size=shape)
    if mode == "real":
        return pair(S), pair(v)
    S = S + 1j * rng.normal(size=(N, M)) / np.sqrt(M)
    if mode == "complex":
        v = v + 1j * rng.normal(size=shape)
        return pair(S, "complex64"), pair(v, "complex64")
    return pair(S, "complex64"), pair(v)


def _blocked(Sj, St):
    w0 = WIDTHS[0]
    return (JBlocked([Sj[:, :w0], Sj[:, w0:]]),
            BlockedScores([St[:, :w0].contiguous(), St[:, w0:].contiguous()]))


@pytest.mark.parametrize("name", sorted(SOLVERS))
@pytest.mark.parametrize("mode", ["real", "complex", "real_part"])
@pytest.mark.parametrize("blocked", [False, True], ids=["dense", "blocked"])
def test_solvers_match_jax(name, mode, blocked):
    (Sj, St), (vj, vt) = _problem(mode, seed=sorted(SOLVERS).index(name))
    if blocked:
        Sj, St = _blocked(Sj, St)
    x = get_solver(name)(St, vt, LAM, mode=mode)
    xj = jcore.get_solver(name)(Sj, vj, LAM, mode=mode)
    assert x.shape == tuple(xj.shape)
    assert rel(x, xj) < SOLVER_TOL[name]


@pytest.mark.parametrize("name", ["chol", "eigh", "cg"])
def test_solvers_batched_rhs_blocked_form_match_jax(name):
    """(m, k) right-hand sides given as per-block pieces come back blocked."""
    (Sj, St), (vj, vt) = _problem("real", seed=7, k=3)
    Sj, St = _blocked(Sj, St)
    w0 = WIDTHS[0]
    x = get_solver(name)(St, (vt[:w0], vt[w0:]), LAM)
    xj = jcore.get_solver(name)(Sj, (vj[:w0], vj[w0:]), LAM)
    assert isinstance(x, tuple) and len(x) == 2
    assert rel(torch.cat(x), jnp.concatenate(xj)) < SOLVER_TOL[name]


@pytest.mark.parametrize("mode", ["real", "complex", "real_part"])
@pytest.mark.parametrize("blocked", [False, True], ids=["dense", "blocked"])
def test_minsr_matches_jax_and_appendix_b(mode, blocked):
    (Sj, St), _ = _problem(mode, seed=21)
    rng = np.random.default_rng(22)
    nf = 2 * N if mode == "real_part" else N
    f = rng.normal(size=(nf,))
    if mode == "complex":
        f = f + 1j * rng.normal(size=(nf,))
    fj, ft = pair(f, "complex64" if mode == "complex" else "float32")
    if blocked:
        Sj, St = _blocked(Sj, St)
    x = minsr_solve(St, ft, LAM, mode=mode)
    xj = jcore.minsr_solve(Sj, fj, LAM, mode=mode)
    if blocked:
        assert isinstance(x, tuple)
        x, xj = torch.cat(x), jnp.concatenate(xj)
    assert rel(x, xj) < 1e-4
    if mode == "real" and not blocked:
        # Appendix B: minSR equals chol_solve(S, Sᵀf, λ)
        assert rel(x, chol_solve(St, St.T @ ft, LAM)) < 1e-4


@pytest.mark.parametrize("m,chunk", [(300, 64), (300, 100), (257, 300)])
@pytest.mark.parametrize("mode", ["real", "complex"])
def test_gram_chunked_matches_jax(m, chunk, mode):
    rng = np.random.default_rng(m + chunk)
    S = rng.normal(size=(12, m))
    if mode == "complex":
        S = S + 1j * rng.normal(size=(12, m))
    Sj, St = pair(S, "complex64" if mode == "complex" else "float32")
    W = gram_chunked(St, chunk, mode=mode)
    Wj = jcore.gram_chunked(Sj, chunk, mode=mode)
    assert W.dtype == (torch.complex64 if mode == "complex" else torch.float32)
    assert rel(W, Wj) < 1e-5
    fac = jcore.chol_factorize(Sj, LAM, gram_chunk=chunk, mode=mode)
    from repro_torch.core import chol_factorize
    tfac = chol_factorize(St, LAM, gram_chunk=chunk, mode=mode)
    assert rel(tfac.L, fac.L) < 1e-5


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "complex64"])
def test_center_scores_matches_jax(weighted, dtype):
    rng = np.random.default_rng(31)
    O = rng.normal(size=(16, 30))
    if dtype == "complex64":
        O = O + 1j * rng.normal(size=(16, 30))
    Oj, Ot = pair(O, dtype)
    kw_j, kw_t = {}, {}
    if weighted:
        p = rng.random(16)
        wj, wt = pair(p / p.sum())
        kw_j, kw_t = {"weights": wj}, {"weights": wt}
    assert rel(center_scores(Ot, **kw_t), jcore.center_scores(Oj, **kw_j)) \
        < 1e-6


def test_chol_solve_gram_fn_and_registry():
    (Sj, St), (vj, vt) = _problem("real", seed=41)
    x = chol_solve(St, vt, LAM, gram_fn=ops.gram, return_stats=True)
    xj = jcore.chol_solve(Sj, vj, LAM, gram_fn=jops.gram, return_stats=True)
    assert rel(x[0], xj[0]) < 1e-5
    assert float(x[1].residual_norm) < 1e-5
    with pytest.raises(KeyError, match="unknown solver"):
        get_solver("qr")
    assert sorted(SOLVERS) == sorted(jcore.SOLVERS)


def test_lazy_blocked_scores_and_from_grads_pytree():
    rng = np.random.default_rng(51)
    tree = {"w1": rng.normal(size=(6, 4, 3)), "b1": rng.normal(size=(6, 3)),
            "sub": {"z": rng.normal(size=(6, 2))}}
    jt = {k: (jnp.asarray(v, jnp.float32) if not isinstance(v, dict) else
              {"z": jnp.asarray(v["z"], jnp.float32)}) for k, v in tree.items()}
    tt = {k: (torch.tensor(v, dtype=torch.float32) if not isinstance(v, dict)
              else {"z": torch.tensor(v["z"], dtype=torch.float32)})
          for k, v in tree.items()}
    B, Bj = BlockedScores.from_grads_pytree(tt), JBlocked.from_grads_pytree(jt)
    assert B.names == Bj.names and B.block_widths == Bj.block_widths
    assert rel(B.to_dense(), Bj.to_dense()) == 0.0
    calls = []

    def build():
        calls.append(1)
        return tt

    lazy = LazyBlockedScores(build)
    assert not calls
    assert lazy.shape == (6, 17) and len(calls) == 1
    assert rel(lazy.gram(), Bj.gram()) < 1e-6 and len(calls) == 1
    v = torch.randn(17)
    assert rel(chol_solve(lazy, v, LAM), chol_solve(B, v, LAM)) < 1e-6


# ---------------------------------------------------------------------------
# dispatch rules and the launch wrappers' checks, on the CPU
# ---------------------------------------------------------------------------

def test_dispatch_modes_on_cpu():
    S, v, w = torch.randn(8, 40), torch.randn(40), torch.randn(8)
    assert torch.equal(ops.gram(S), ops.gram(S, mode="ref"))
    for fn in (lambda mode: ops.gram(S, mode=mode),
               lambda mode: ops.gram_sv(S, v, mode=mode),
               lambda mode: ops.ngd_apply(S, w, v, 0.1, mode=mode),
               lambda mode: ops.cholesky(S @ S.T + torch.eye(8), mode=mode),
               lambda mode: ops.chol_solve_fused(S, v, 0.1, mode=mode)):
        with pytest.raises(RuntimeError, match="CUDA"):
            fn("kernel")
        with pytest.raises(ValueError, match="mode"):
            fn("interpret")
    # the launch wrappers themselves never run the plain version
    with pytest.raises(ValueError, match="CUDA"):
        gram_cuda(S)
    with pytest.raises(ValueError, match="CUDA"):
        ngd_apply_cuda(S, w, v, 0.1)
    with pytest.raises(ValueError, match="CUDA"):
        cholesky_cuda(torch.eye(8))
    # complex operands take the plain version under every mode
    Sc = torch.randn(8, 40, dtype=torch.complex64)
    assert torch.equal(ops.gram(Sc, mode="kernel"), ref.gram_ref(Sc))


def test_gram_sv_accumulates_into_w():
    """``gram_sv(W=)`` adds into the running Gram in place, as the blocked
    ``chol_solve_fused`` threads one accumulator through its blocks."""
    g = torch.Generator().manual_seed(0)
    S, v = torch.randn(6, 50, generator=g), torch.randn(50, generator=g)
    W0 = torch.randn(6, 6, generator=g)
    W = W0.clone()
    Wo, u = ops.gram_sv(S, v, W=W)
    assert Wo is W
    Wr, ur = ref.gram_sv_ref(S, v)
    assert rel(W, W0 + Wr) < 1e-6 and torch.equal(u, ur)


@pytest.mark.parametrize("n,m", [(8, 128), (256, 100_000), (1024, 100_000),
                                 (2048, 200_000), (130, 515)])
def test_gram_split_covers_m(n, m):
    tiles, P, chunk = gram_split(n, m)
    t = -(-n // 128)
    assert tiles == t * (t + 1) // 2
    assert chunk % 16 == 0 and (P - 1) * chunk < m <= P * chunk
    # scratch: P partial tiles of 64 KB stay near 1056 blocks' worth
    assert P * tiles * 128 * 128 * 4 <= 80e6


# ---------------------------------------------------------------------------
# on the card: every kernel against its plain version
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_cuda_kernels_match_plain(shape, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the H100 via chip_smoke "
                    "and `pytest -m cuda`)")
    g = torch.Generator(device="cuda").manual_seed(0)
    n, m = shape
    S = (torch.randn(shape, generator=g, device="cuda") / m ** 0.5).to(dtype)
    v = torch.randn((m,), generator=g, device="cuda")
    w = torch.randn((n,), generator=g, device="cuda")
    A = torch.randn((n, n), generator=g, device="cuda")
    W = A @ A.T / n + torch.eye(n, device="cuda")
    B = BlockedScores.from_dense(S, (m // 2, m - m // 2))
    cases = [
        (lambda mode: ops.gram(S, mode=mode), PASS_TOL),
        (lambda mode: ops.gram_blocks(B, mode=mode), PASS_TOL),
        # the kernel rounds v to S's dtype: feed the plain version that v
        (lambda mode: torch.cat([t.reshape(-1) for t in ops.gram_sv(
            S, v.to(dtype) if mode == "ref" else v, mode=mode)]), PASS_TOL),
        (lambda mode: ops.ngd_apply(S, w, v.to(dtype), 0.37, mode=mode),
         PASS_TOL),
        (lambda mode: ops.cholesky(W, mode=mode), CHOL_TOL),
    ]
    for fn, tol in cases:
        got, again = fn("kernel"), fn("kernel")
        torch.cuda.synchronize()
        assert torch.equal(got, again)
        assert rel(got, fn("ref")) < tol


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 15, 16, 17, 64, 65, 100, 1024, 2048, 4096])
def test_cuda_cholesky_matches_plain_beyond_reference_cap(n):
    """The reference gives XLA n > 1024; the port's kernel takes every n:
    one ragged 64-wide tile (1, 15, 17), exactly one (16, 64), a ragged
    second (65, 100), and many (one cooperative launch either way)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the H100 via chip_smoke "
                    "and `pytest -m cuda`)")
    g = torch.Generator(device="cuda").manual_seed(1)
    A = torch.randn((n, n), generator=g, device="cuda")
    W = A @ A.T / n + torch.eye(n, device="cuda")
    ops.reset_launch_counts()
    got, again = ops.cholesky(W), ops.cholesky(W)
    torch.cuda.synchronize()
    assert ops.launch_counts()["cholesky"] == 2
    assert torch.equal(got, again)
    assert rel(got, ops.cholesky(W, mode="ref")) < CHOL_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype", [
    ((256, 4096), torch.float32), ((256, 4096), torch.bfloat16),
    ((130, 515), torch.float32), ((32, 300), torch.bfloat16)],
    ids=["wgmma-f32", "wgmma-bf16", "cuda_cores-f32", "cuda_cores-bf16"])
def test_cuda_gram_routes_match_plain(shape, dtype):
    """Both routes of the Gram (``tensor_core_route``: wgmma + TMA where the
    window's row stride is 16-byte aligned, else the CUDA cores) against
    the plain version, counted by route, repeats bit-identical."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the H100 via chip_smoke "
                    "and `pytest -m cuda`)")
    g = torch.Generator(device="cuda").manual_seed(2)
    n, m = shape
    S = (torch.randn(shape, generator=g, device="cuda") / m ** 0.5).to(dtype)
    v = torch.randn((m,), generator=g, device="cuda").to(dtype)
    route = "wgmma" if tensor_core_route(n, m, dtype) else "cuda_cores"
    assert route == ("wgmma" if m == 4096 else "cuda_cores")
    ops.reset_launch_counts()
    W, again = ops.gram(S), ops.gram(S)
    Wsv, u = ops.gram_sv(S, v)
    torch.cuda.synchronize()
    assert ROUTES[route] == 3 and sum(ROUTES.values()) == 3
    assert torch.equal(W, again) and torch.equal(W, Wsv)
    assert rel(W, ops.gram(S, mode="ref")) < PASS_TOL
    assert rel(u, ops.gram_sv(S, v, mode="ref")[1]) < PASS_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(100, 1001), (64, 4098), (3000, 5000)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_cuda_ngd_apply_edges_match_plain(shape, dtype):
    """The k = 1 apply kernel at a ragged m, rows that are not 16-byte
    aligned (a view one element in) and n past its staged w tile (2048)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the H100 via chip_smoke "
                    "and `pytest -m cuda`)")
    g = torch.Generator(device="cuda").manual_seed(3)
    n, m = shape
    flat = torch.randn((n * m + 1,), generator=g, device="cuda").to(dtype)
    w = torch.randn((n,), generator=g, device="cuda")
    v = torch.randn((m,), generator=g, device="cuda").to(dtype)
    for off in (0, 1):
        S = flat[off:off + n * m].view(n, m)
        got, again = ops.ngd_apply(S, w, v, 0.37), ops.ngd_apply(S, w, v, 0.37)
        torch.cuda.synchronize()
        assert torch.equal(got, again)
        assert rel(got, ops.ngd_apply(S, w, v, 0.37, mode="ref")) < PASS_TOL
