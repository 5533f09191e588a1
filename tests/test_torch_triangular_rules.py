"""The two triangular chains of the torch port, their orders emulated on the
CPU against the JAX package:

* ``ref.cholupdate_rotations_ref`` — the rank-k rotation kernel's
  arithmetic (chunks of 32 columns of X, the warp scan's r_t², c = r_prev/r_t
  and s = b/r_t from a reciprocal square root and one Newton step, ±0
  columns skipped) against ``cholupdate_pallas`` in interpret mode, update
  and downdate, to ``CHOLUP_TOL`` = 1e-5; its zero, −0.0 and upper-triangle
  invariants;
* ``ref.trisolve_panels_ref`` — the substitution kernel's order (panels of
  64, reciprocal pivots in a diagonal block, one tile product a panel)
  against the TPU kernel's in-kernel ``_trisolve``, to 1e-4;
* the shape rules the launches take: ``serve_solve.trisolve_columns`` (the
  columns a cluster of the substitution takes) and
  ``cholupdate.chunk_columns``; the substitution has one route, so there
  is no route rule to hold.

Inputs come from fixed numpy seeds; no threads, no servers."""
import numpy as np
import pytest
import torch

from _torch_parity import rel
from repro_torch.kernels import ref
from repro_torch.kernels.cholupdate import chunk_columns
from repro_torch.kernels.serve_solve import MAX_TRISOLVE_N, trisolve_columns

try:
    import jax
    import jax.numpy as jnp
    from repro.kernels.cholupdate import cholupdate_pallas
    from repro.kernels.serve_solve import _trisolve
except ImportError:     # the GPU machine has no JAX
    jax = None

torch.set_num_threads(1)

CHOLUP_TOL = 1e-5       # tests/test_kernels.py:64, chip_smoke.py's CHOLUP_TOL
PASS_TOL = 1e-4         # chip_smoke.py's PASS_TOL


def _factor(rng, n, k, sign):
    """(L, X) fp32 with L = chol(A·Aᵀ + n·I (+ X·Xᵀ for a downdate)), as
    tests/test_kernels.py:52-60 builds them."""
    A = rng.normal(size=(n, n))
    X = rng.normal(size=(n, k))
    W = A @ A.T + n * np.eye(n)
    if sign < 0:
        W = W + X @ X.T
    return np.linalg.cholesky(W).astype(np.float32), X.astype(np.float32)


@pytest.mark.parametrize("n", [16, 24, 64, 100])
def test_rotations_match_pallas(n):
    """Every k of the chip sweep (1, 3, 16, 32: one chunk) and 40 (two
    chunks composed in t order), update and downdate."""
    rng = np.random.default_rng([19, n])
    for k in (1, 3, 16, 32, 40):
        for sign in (1, -1):
            L, X = _factor(rng, n, k, sign)
            want = cholupdate_pallas(jnp.asarray(L), jnp.asarray(X),
                                     sign=sign, interpret=True)
            got = ref.cholupdate_rotations_ref(torch.from_numpy(L),
                                               torch.from_numpy(X), sign)
            assert rel(got, np.asarray(want)) < CHOLUP_TOL, (k, sign)


def test_rotations_invariants():
    """A zero X returns L bit for bit; a −0.0 (or +0) column changes nothing;
    the strict upper triangle is exactly 0 even where L's is not; a NaN r²
    stays NaN; a downdate past positive definiteness clamps r² at 1e-30."""
    rng = np.random.default_rng(7)
    L, X = _factor(rng, 24, 3, 1)
    Lt, Xt = torch.from_numpy(L), torch.from_numpy(X)
    zero = ref.cholupdate_rotations_ref(Lt, torch.zeros_like(Xt))
    assert torch.equal(zero.view(torch.int32), Lt.view(torch.int32))
    got = ref.cholupdate_rotations_ref(Lt, Xt, -1)
    for pad in (-torch.zeros(24, 1), torch.zeros(24, 1)):
        again = ref.cholupdate_rotations_ref(Lt, torch.cat([pad, Xt, pad], 1),
                                             -1)
        assert torch.equal(again.view(torch.int32), got.view(torch.int32))
    dirty = Lt + torch.triu(torch.ones_like(Lt), 1)
    up = ref.cholupdate_rotations_ref(dirty, Xt)
    assert torch.equal(torch.triu(up, 1), torch.zeros_like(up))
    assert torch.equal(up, ref.cholupdate_rotations_ref(Lt, Xt))
    one = torch.zeros_like(Xt[:, :1])
    one[0] = 2 * Lt[0, 0]
    assert float(ref.cholupdate_rotations_ref(Lt, one, -1)[0, 0]) \
        == pytest.approx(1e-15, rel=1e-6)
    nan = Lt.clone()
    nan[3, 3] = float("nan")
    assert torch.isnan(ref.cholupdate_rotations_ref(nan, Xt)[3, 3])


@pytest.mark.parametrize("n", [8, 100, 130])
def test_panels_match_jax_trisolve(n):
    """The substitution's order against the TPU kernel's _trisolve, k = 1
    and 8, on a factor of the chip sweep's kind (a damped Gram); panels of
    64 (the kernel's) and 32 (the previous kernel's) alike."""
    rng = np.random.default_rng([19, 2, n])
    S = rng.normal(size=(n, 3 * n)) / np.sqrt(3 * n)
    L = np.linalg.cholesky(S @ S.T + 1e-3 * np.eye(n)).astype(np.float32)
    solve = jax.jit(_trisolve)
    for k in (1, 8):
        U = rng.normal(size=(n, k)).astype(np.float32)
        want = np.asarray(solve(jnp.asarray(L), jnp.asarray(U)))
        for panel in (64, 32):
            got = ref.trisolve_panels_ref(torch.from_numpy(L),
                                          torch.from_numpy(U), panel)
            assert rel(got, want) < PASS_TOL, (k, panel)
        assert rel(ref.trisolve_ref(torch.from_numpy(L), torch.from_numpy(U)),
                   want) < PASS_TOL


def test_trisolve_columns_rule():
    """1, 4, 8 or 16 columns a cluster, the least holding k; halved only
    where a block's shared memory (227 KB) cannot hold n/8 rows of them —
    at the kernel's limit n = 32,768 the cluster takes 8; a pure function
    of (n, k), the same for the shapes of CPU and meta tensors."""
    assert [trisolve_columns(1024, k) for k in (1, 2, 4, 5, 8, 9, 16, 40)] \
        == [1, 4, 4, 8, 8, 16, 16, 16]
    assert trisolve_columns(16_896, 16) == 16     # 33 panels of 64 a block
    assert trisolve_columns(16_897, 16) == 8
    assert trisolve_columns(MAX_TRISOLVE_N, 40) == 8
    assert trisolve_columns(MAX_TRISOLVE_N, 1) == 1
    for n in (1, 8, 63, 64, 65, 4096, MAX_TRISOLVE_N):
        for k in (1, 3, 8, 16, 17):
            kt = trisolve_columns(n, k)
            slots = -(-(-(-n // 64)) // 8)
            smem = 4 * ((slots + 2) * 64 * kt + 64 * 65 + 64 + 4 * 64 * 68)
            assert kt in (1, 4, 8, 16) and smem <= 232_448 - 1024, (n, k)
            for dev in ("cpu", "meta"):
                U = torch.empty((n, k), device=dev)
                assert trisolve_columns(*U.shape) == kt


def test_cholupdate_chunk_rule():
    """The rotation kernel's chunk of X: 8, 16 or 32 columns, the least
    that holds k (32 beyond: chunks of 32 compose in t order)."""
    assert [chunk_columns(k) for k in (1, 8, 9, 16, 17, 32, 33, 1000)] \
        == [8, 8, 16, 16, 32, 32, 32, 32]
