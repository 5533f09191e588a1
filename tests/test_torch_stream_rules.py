"""The window's two streaming passes in the torch port — the cross pass
(``csrc/cross.cuh``: ``sv_cross``, ``serve_solve``'s first launch,
``fold_cols``) and the apply pass (``csrc/apply.cuh``: ``serve_apply``,
``serve_solve``'s third launch) — on the CPU:

* ``serve_solve.stream_route``, the rule that sends a window to 16-byte
  loads or to scalar loads: fp32 and bf16, aligned and ragged m, views at
  an offset, CPU and meta tensors alike; and ``cross_tensor_cores``, which
  sends a bf16 window's cross pass at 8 or 16 right-hand sides a block to
  the tensor cores;
* the splits: ``cross_split`` at ``cross_tile`` and ``apply_split``
  (strips cover m, at most 264 blocks, the shape alone decides);
* the passes' summation orders on the CUDA cores, emulated
  (``ref.sv_cross_tiles_ref``, ``ref.serve_apply_warps_ref``; the card
  matches them bit for bit, ``tools/stream_ab.py``), against the JAX
  package's Pallas kernels
  in interpret mode (``sv_cross_pallas``, ``serve_apply_pallas``,
  ``fold_cols_pallas``) to ``PASS_TOL`` = 5e-6 of the largest output,
  the cross, apply and fold passes' tolerance in
  ``tests/test_torch_kernels.py`` (fp32 sums in another order);
* the serving CLI's reference flags ``--ckpt-dir``, ``--tenant-rank`` and
  ``--tenant-budget-mb``: parsed, none of them refused (all ported);

and, on the card only (``cuda``, skipped elsewhere), the passes over
unaligned windows against their plain twins, the kernels each call
launched (as the libraries count them) held to the rules, and the tensor
cores' cross pass of an aligned bf16 window held to the float64 product.

Inputs come from fixed numpy seeds; no threads, no servers."""
import numpy as np
import pytest
import torch

from _torch_parity import pair, rel
from repro_torch.kernels import ops, ref
from repro_torch.kernels.serve_solve import (ROUTES, apply_split,
                                             cross_split, cross_tensor_cores,
                                             cross_tile, kernels_launched,
                                             stream_route)
from repro_torch.serve import main as serve_main_module
from repro_torch.serve.main import _parser

try:
    import jax.numpy as jnp
    from repro.kernels import ops as jops
except ImportError:     # the GPU machine has no JAX
    jnp = jops = None

torch.set_num_threads(1)

PASS_TOL = 5e-6
DTYPES = (torch.float32, torch.bfloat16)
# shapes with more than one chunk of the cross pass in fp32, ragged m and
# ragged row tiles among them
ORDER_SHAPES = [(8, 128, 1), (32, 300, 5), (40, 1000, 8), (33, 515, 16)]


def _route(*tensors) -> str:
    S = tensors[0]
    return stream_route(S.shape[1], S.dtype, *(
        t.storage_offset() * t.element_size() for t in tensors))


def test_stream_route_aligned_and_ragged():
    """16-byte rows take the vector route (m % 4 == 0 in fp32, m % 8 == 0
    in bf16); the rule answers the same for a CPU and a meta tensor, and
    other dtypes are not windows."""
    for dtype, vec in ((torch.float32, 4), (torch.bfloat16, 8)):
        for m in (1, 3, 4, 8, 12, 128, 300, 515, 1000, 1004, 100_000):
            want = "vector" if m % vec == 0 else "scalar"
            assert stream_route(m, dtype) == want, (dtype, m)
            assert stream_route(m, dtype, 0, 0) == want
            for device in ("cpu", "meta"):
                S = torch.empty((3, m), dtype=dtype, device=device)
                assert _route(S) == want, (dtype, m, device)
    for dtype in (torch.float16, torch.float64, torch.complex64):
        assert stream_route(128, dtype) == "scalar"
    assert stream_route(0, torch.float32) == "scalar"
    # the cross pass takes the tensor cores for a bf16 window on the vector
    # route at 8 or 16 right-hand sides a block, never otherwise
    for dtype in DTYPES:
        for route in ("vector", "scalar"):
            for k in (1, 4, 5, 8, 9, 16, 40):
                assert cross_tensor_cores(dtype, k, route) is (
                    dtype == torch.bfloat16 and route == "vector" and k > 4)


def test_stream_route_column_offset_views():
    """A contiguous view whose data starts off a 16-byte boundary takes the
    scalar route, one 16 bytes in the vector route; the fold needs the rows
    aligned too."""
    n, m = 6, 256
    for dtype, es in ((torch.float32, 4), (torch.bfloat16, 2)):
        for device in ("cpu", "meta"):
            flat = torch.zeros(n * m + 64, dtype=dtype, device=device)
            rows = torch.zeros((2, m), dtype=dtype, device=device)
            for off in range(0, 40):
                S = flat[off:off + n * m].view(n, m)
                assert S.is_contiguous()
                want = "vector" if (off * es) % 16 == 0 else "scalar"
                assert _route(S) == want, (dtype, off)
                assert _route(rows, S) == want
                assert _route(S, rows) == want


def test_cross_split_at_the_stage_tile():
    """The stage is 128 columns × 1, 2 or 4 (so every chunk is a multiple
    of 128, the split's contract); the chunks of the stage's width cover
    m, and the grid stays near 8 blocks an SM of an H100."""
    for dtype in DTYPES:
        for k in (1, 4, 5, 8, 9, 16, 40):
            tile = cross_tile(dtype, k)
            assert tile % 128 == 0 and tile in (128, 256, 512)
            for rows, m in ((8, 128), (130, 515), (1024, 100_000),
                            (1032, 100_000), (2048, 200_000),
                            (10, 595_344_384)):
                P, chunk = cross_split(rows, m, tile)
                assert chunk % tile == 0 and P >= 1
                assert (P - 1) * chunk < m <= P * chunk
                assert -(-rows // 32) * P <= 2 * 1056
    assert cross_tile(torch.float32, 8) == 256
    assert cross_tile(torch.bfloat16, 8) == 512
    assert cross_tile(torch.bfloat16, 16) == 256
    assert cross_tile(torch.float32, 16) == 128
    assert cross_split(1024, 100_000, 256) == (33, 3072)


def test_apply_split_covers_m():
    """Strips of 128 columns cover m; at most 264 blocks (≤ 528), each a
    run of ``per`` consecutive strips, the last one possibly shorter; the
    split is a function of m alone."""
    for m in (1, 127, 128, 129, 300, 33_792, 33_920, 100_000, 200_000,
              296_448, 595_344_384):
        strips, per, blocks = apply_split(m)
        assert strips == -(-m // 128) and 1 <= blocks <= 264
        assert (blocks - 1) * per < strips <= blocks * per
        assert per == -(-strips // 264)
    assert apply_split(100_000) == (782, 3, 261)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_cross_order_matches_pallas(dtype):
    """``sv_cross_tiles_ref`` (chunks, lanes of 16 bytes, butterfly) against
    ``sv_cross_pallas`` in interpret mode."""
    rng = np.random.default_rng([21, DTYPES.index(dtype)])
    for n, m, k in ORDER_SHAPES:
        Sj, St = pair(rng.normal(size=(n, m)) / np.sqrt(m),
                      str(dtype)[6:])
        Vj, Vt = pair(rng.normal(size=(m, k)))
        U = ref.sv_cross_tiles_ref(St, Vt)
        assert U.dtype == torch.float32 and U.shape == (n, k)
        assert rel(U, jops.sv_cross(Sj, Vj, mode="interpret")) < PASS_TOL


def test_apply_order_matches_pallas():
    """``serve_apply_warps_ref`` (row groups dealt to 8 warps, the warps'
    sums in warp order) against ``serve_apply_pallas`` in interpret
    mode."""
    rng = np.random.default_rng(22)
    for dtype, (n, m, k) in ((d, s) for d in DTYPES for s in ORDER_SHAPES):
        Sj, St = pair(rng.normal(size=(n, m)) / np.sqrt(m),
                      str(dtype)[6:])
        wj, wt = pair(rng.normal(size=(n, k)))
        Vj, Vt = pair(rng.normal(size=(m, k)))
        X = ref.serve_apply_warps_ref(St, wt, Vt, 0.37)
        assert X.dtype == torch.float32 and X.shape == (m, k)
        want = jops.serve_apply(Sj, wj, Vj, 0.37, mode="interpret")
        assert rel(X, want) < PASS_TOL


def test_fold_order_matches_pallas():
    """The fold's cross pass is the same kernel over [S; rows] against the
    k-major rows: the emulation of that against ``fold_cols_pallas``."""
    rng = np.random.default_rng(23)
    for dtype in ("float32", "bfloat16"):
        for n, m, k in ((16, 300, 2), (40, 1000, 8)):
            Sj, St = pair(rng.normal(size=(n, m)) / np.sqrt(m), dtype)
            rj, rt = pair(rng.normal(size=(k, m)) / np.sqrt(m), dtype)
            out = ref.sv_cross_tiles_ref(torch.cat([St, rt]), rt.T)
            cols, corner = jops.fold_cols(Sj, rj, mode="interpret")
            assert rel(out[:n], cols) < PASS_TOL
            assert rel(out[n:], corner) < PASS_TOL


def test_orders_against_the_plain_twins_over_many_chunks():
    """At a wider m (many chunks, several row tiles and warp groups) the
    emulated orders stay within PASS_TOL of the plain twins, and the fp32
    emulation of a bf16 window reads its values exactly."""
    rng = np.random.default_rng(24)
    n, m, k = 70, 20_000, 8
    for dtype in DTYPES:
        S = torch.from_numpy(rng.normal(size=(n, m)) / np.sqrt(m)).to(dtype)
        V = torch.from_numpy(rng.normal(size=(m, k))).float()
        w = torch.from_numpy(rng.normal(size=(n, k))).float()
        assert cross_split(n, m, cross_tile(dtype, k))[0] > 1
        U64 = S.double() @ V.double()
        assert rel(ref.sv_cross_tiles_ref(S, V), U64) < PASS_TOL
        X64 = (V.double() - S.double().T @ w.double()) / 0.37
        assert rel(ref.serve_apply_warps_ref(S, w, V, 0.37), X64) < PASS_TOL
        assert rel(ops.serve_apply(S, w, V, 0.37), X64) < PASS_TOL


def test_routes_reset_and_plain_route_uncounted():
    """``ops.reset_launch_counts`` zeroes the counts by route; the plain
    route on the CPU launches nothing and counts nothing, by route or by
    kernel."""
    ROUTES["vector"] += 3
    ops.reset_launch_counts()
    assert ROUTES == {"vector": 0, "scalar": 0, "tensor_cores": 0}
    S, V = torch.randn(8, 128), torch.randn(128, 2)
    seen, _ = _launched(lambda: (ops.serve_solve(S, torch.eye(8), V, 0.5),
                                 ops.fold_cols(S, torch.randn(2, 128))))
    assert ROUTES == {"vector": 0, "scalar": 0, "tensor_cores": 0}
    assert seen == {}


@pytest.mark.parametrize("flag", [["--ckpt-dir", "ck"],
                                  ["--tenant-rank", "2"],
                                  ["--tenant-budget-mb", "64"]])
def test_reference_serve_flags_raise_away_from_defaults(flag):
    """The reference CLI's checkpoint and tenant flags parse. The
    checkpoint directory and the tenant flags are ported (the tenants
    with ROADMAP A5), so any value of them asks for no later slice."""
    args = _parser().parse_args(flag)
    dest = flag[0].lstrip("-").replace("-", "_")
    assert str(getattr(args, dest)) == {"--ckpt-dir": "ck",
                                        "--tenant-rank": "2",
                                        "--tenant-budget-mb": "64.0"}[flag[0]]
    assert not hasattr(serve_main_module, "_later_flags")


def test_reference_serve_flags_at_their_defaults_are_not_refused():
    """The reference's defaults, given or left out, ask for no later
    slice (``repro/serve/main.py:110-119``)."""
    for argv in ([], ["--ckpt-dir", "artifacts/serve_ckpt",
                      "--tenant-rank", "4"]):
        args = _parser().parse_args(argv)
        assert (args.ckpt_dir, args.tenant_rank, args.tenant_budget_mb) \
            == ("artifacts/serve_ckpt", 4, None)
        assert not hasattr(serve_main_module, "_later_flags")


# (n, m, offset): m ragged in fp32 (m % 4 ≠ 0), ragged in bf16 only
# (m % 8 ≠ 0), and an aligned m in a view one element into its storage
UNALIGNED = [(64, 1001, 0), (48, 1004, 0), (40, 512, 1)]
SOLVE_TOL = 5e-5      # serve_solve's in tests/test_torch_kernels.py


# a bf16 cross pass on the tensor cores from the float64 product: V split
# exactly into three bf16 terms lands ≈ 3e-7 of the largest output away,
# a lossy two-term split ≈ 3e-6 (tools/stream_ab.py)
TC_TOL = 1e-6


def _launched(fn):
    """(the streaming kernels one call of ``fn`` launched, {kernel:
    launches} as the libraries count them where each kernel is launched;
    its result)."""
    before = kernels_launched()
    out = fn()
    after = kernels_launched()
    return {key: after[key] - before[key] for key in after
            if after[key] != before[key]}, out


def _wanted(dtype, k, route, cross, apply) -> dict:
    """The streaming kernels a call launches by the rules."""
    vec = "vector" if route == "vector" else "scalar"
    want = {}
    if cross:
        want["cross_tensor_cores" if cross_tensor_cores(dtype, k, route)
             else f"cross_{vec}"] = 1
    if apply:
        want[f"apply_{vec}"] = 1
    return want


@pytest.mark.cuda
def test_cuda_unaligned_windows_match_plain():
    """On the card, in fp32 and bf16: the streaming passes over unaligned
    windows launch the scalar-load kernels as the rule says, repeat bit
    for bit and agree with their plain twins."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the H100 via chip_smoke "
                    "and `pytest -m cuda`)")
    g = torch.Generator(device="cuda").manual_seed(0)
    for dtype, (n, m, offset) in ((d, u) for d in DTYPES for u in UNALIGNED):
        flat = torch.randn((n * m + offset,), generator=g, device="cuda")
        S = (flat / m ** 0.5).to(dtype)[offset:].view(n, m)
        S32 = S.float()
        L = torch.linalg.cholesky(S32 @ S32.T + 0.2 * torch.eye(
            n, device="cuda")).contiguous()
        route = stream_route(m, dtype, offset * S.element_size())
        assert route == ("vector" if offset == 0 and m % (
            16 // S.element_size()) == 0 else "scalar")
        for k in (1, 5, 16):
            V = torch.randn((m, k), generator=g, device="cuda")
            w = torch.randn((n, k), generator=g, device="cuda")
            rows = torch.randn((k, m), generator=g, device="cuda").to(dtype)
            cases = [
                (lambda mode: ops.sv_cross(S, V, mode=mode), PASS_TOL,
                 True, False),
                (lambda mode: ops.serve_apply(S, w, V, 0.37, mode=mode),
                 PASS_TOL, False, True),
                (lambda mode: ops.serve_solve(S, L, V, 0.2, mode=mode),
                 SOLVE_TOL, True, True),
                (lambda mode: torch.cat(ops.fold_cols(S, rows, mode=mode)),
                 PASS_TOL, True, False),
            ]
            for fn, tol, cross, apply in cases:
                seen, got = _launched(lambda: fn("kernel"))
                again = fn("kernel")
                torch.cuda.synchronize()
                assert torch.equal(got, again), (dtype, n, m, offset, k)
                assert rel(got, fn("ref")) < tol, (dtype, n, m, offset, k)
                assert seen == _wanted(dtype, k, route, cross, apply), (
                    dtype, n, m, offset, k, seen)


@pytest.mark.cuda
def test_cuda_tensor_core_cross_near_float64():
    """On the card: the cross pass of an aligned bf16 window at 8 and 16
    right-hand sides launches the tensor cores' kernel, repeats bit for
    bit, and stays within TC_TOL of the float64 product — V split into
    three bf16 terms, not fewer — in ``sv_cross`` and ``fold_cols``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the H100 via chip_smoke "
                    "and `pytest -m cuda`)")
    g = torch.Generator(device="cuda").manual_seed(0)
    n, m = 256, 20_000
    S = (torch.randn((n, m), generator=g, device="cuda")
         / m ** 0.5).to(torch.bfloat16)
    Sd = S.double()
    for k in (8, 16):
        V = torch.randn((m, k), generator=g, device="cuda")
        rows = (torch.randn((k, m), generator=g, device="cuda")
                / m ** 0.5).to(torch.bfloat16)
        assert cross_tensor_cores(S.dtype, k, _route(S, rows))
        Rd = rows.double()
        cases = [(lambda: ops.sv_cross(S, V, mode="kernel"), Sd @ V.double()),
                 (lambda: torch.cat(ops.fold_cols(S, rows, mode="kernel")),
                  torch.cat([Sd, Rd]) @ Rd.T)]
        for fn, exact in cases:
            seen, got = _launched(fn)
            assert seen == {"cross_tensor_cores": 1}, (k, seen)
            assert torch.equal(got, fn()), k
            assert rel(got, exact) < TC_TOL, k
