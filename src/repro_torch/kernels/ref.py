"""Plain PyTorch versions of the kernels.

Port of ``repro/kernels/ref.py``, plus ``trisolve_ref`` (the substitution
that the TPU serve kernel runs in-kernel as ``_trisolve``). The CPU path
of ``ops``, the oracle of the CUDA kernels on the card, and the reference
the tests compare with. Accumulation is fp32 or wider whatever the storage dtype;
fp32 matmuls run without TF32.
"""
from __future__ import annotations

import torch

from repro_torch.core.operator import acc_dtype
from repro_torch.core.solvers import _upcast_chunks, cholesky
from repro_torch.curvature.update import chol_downdate, chol_update

__all__ = ["gram_ref", "gram_sv_ref", "gram_tf32_ref", "tf32_split",
           "ngd_apply_ref", "cholesky_ref", "cholupdate_ref",
           "cholupdate_rotations_ref", "chol_solve_ref", "sv_cross_ref",
           "serve_apply_ref", "serve_solve_ref", "trisolve_ref",
           "trisolve_panels_ref", "sv_cross_tiles_ref",
           "serve_apply_warps_ref", "fold_cols_ref", "flash_attention_ref"]


def _f32(t: torch.Tensor) -> torch.Tensor:
    """fp32 as the reference's ``astype(float32)`` (a complex operand
    loses its imaginary part there too)."""
    return (t.real if t.is_complex() else t).to(torch.float32)


def gram_ref(S: torch.Tensor) -> torch.Tensor:
    """W = S @ Sᵀ in fp32."""
    S32 = _f32(S)
    return S32 @ S32.T


def gram_sv_ref(S: torch.Tensor, v: torch.Tensor):
    """(W, u) = (S @ Sᵀ, S @ v) in fp32; v keeps its own precision (the CUDA
    kernel, like the TPU one, rounds it to S's dtype first)."""
    S32 = _f32(S)
    return S32 @ S32.T, S32 @ _f32(v)


def tf32_split(S: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(big, small) of an fp32 window as the tensor cores read them in the
    Gram's 3xTF32 route: big is S rounded to the nearest TF32 value, ties
    away from zero (``cvt.rna.tf32.f32``); small = S − big (exact in fp32,
    either sign) as TF32 reads it, its low 13 mantissa bits dropped."""
    S32 = _f32(S).contiguous()
    bits = S32.view(torch.int32)
    big = ((bits + 0x1000) & -8192).view(torch.float32)
    small = (S32 - big).view(torch.int32) & -8192
    return big, small.view(torch.float32)


def gram_tf32_ref(S: torch.Tensor, passes: int = 3) -> torch.Tensor:
    """The arithmetic of the Gram's tensor-core route on an fp32 window, for
    the tests: big·bigᵀ + big·smallᵀ + small·bigᵀ (``passes=3``), exact
    products summed in fp32. ``passes=1`` is one TF32 pass over the window
    as it lies, each word's low 13 mantissa bits ignored, which the route
    never takes: ≈ 7e-4 off, where the three passes are ≈ 3e-7."""
    if passes == 1:
        bits = _f32(S).contiguous().view(torch.int32)
        t = (bits & -8192).view(torch.float32)
        return t @ t.T
    big, small = tf32_split(S)
    return big @ big.T + (big @ small.T + small @ big.T)


def ngd_apply_ref(S: torch.Tensor, w: torch.Tensor, v: torch.Tensor,
                  lam) -> torch.Tensor:
    """x = (v − Sᵀ @ w) / λ in fp32."""
    lam32 = torch.tensor(float(lam), dtype=torch.float32, device=S.device)
    return (_f32(v) - _f32(S).T @ _f32(w)) / lam32


def cholesky_ref(W: torch.Tensor) -> torch.Tensor:
    """Lower L = chol(W) in fp32, row-major; NaN when W is not positive
    definite (the kernel clamps pivots at 1e-30 instead)."""
    return cholesky(_f32(W))


def cholupdate_ref(L: torch.Tensor, X: torch.Tensor,
                   sign: int = 1) -> torch.Tensor:
    """L' with L'·L'† = L·L† + sign·X·X† by the composed method of
    ``repro_torch.curvature.update`` (complex-aware), in L's and X's
    promoted dtype, at least fp32. NaN where a downdate leaves a matrix
    that is not positive definite (the kernel clamps r² at 1e-30)."""
    fn = chol_update if sign > 0 else chol_downdate
    tgt = torch.promote_types(torch.promote_types(L.dtype, X.dtype),
                              torch.float32)
    return fn(L.to(tgt), X.to(tgt))


def _warp_scan(sq: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sums along the last axis (≤ 32 wide) in the order
    of a warp's shuffle scan: offsets 1, 2, 4, ... added in turn."""
    off = 1
    while off < sq.shape[-1]:
        sq = torch.cat([sq[..., :off], sq[..., off:] + sq[..., :-off]], -1)
        off <<= 1
    return sq


def cholupdate_rotations_ref(L: torch.Tensor, X: torch.Tensor,
                             sign: int = 1, eps: float = 1e-30
                             ) -> torch.Tensor:
    """The rank-k rotation kernel's arithmetic (``csrc/cholupdate.cu``),
    emulated in fp32 for the tests, as ``tf32_split`` emulates the Gram's:
    columns of X in chunks of 32; per factor column j, with a = L[j, j] and
    b the chunk's entries of row j of X after columns < j,

        r_t² = max(a² ± Σ_{s≤t} b_s², eps)   (the warp scan's order)
        c_t = r_prev / r_t,  s_t = b_t / r_t   (1/r_t: rsqrt + one Newton
                                               step; r_prev the r of the last
                                               live rotation before t, or a)

    a b of ±0 skipped; rows below apply the pairs in t order, l ← c·l ± s·x,
    x ← c·x − s·l; the new diagonal is the last live r. The strict upper
    triangle comes back 0. No fused multiply-add here, so the result is
    within a few ulps of the kernel's, not bit for bit."""
    f32 = torch.float32
    sgn = 1.0 if sign > 0 else -1.0
    Lw = torch.tril(_f32(L)).clone()
    n = Lw.shape[0]
    Xf = _f32(X).reshape(n, -1)
    for c0 in range(0, Xf.shape[1], 32):
        x = Xf[:, c0:c0 + 32].clone()
        for j in range(n):
            a = Lw[j, j].clone()
            b = x[j].clone()
            p = a * a + _warp_scan(sgn * b * b)
            p = torch.where(torch.isnan(p), p,
                            torch.clamp_min(p, torch.tensor(eps, dtype=f32)))
            y = torch.rsqrt(p)
            y = y * ((-0.5 * p * y) * y + 1.5)
            r = p * y
            live = b != 0
            col = Lw[j + 1:, j]
            xs = x[j + 1:]
            r_prev = a
            for t in torch.nonzero(live).flatten().tolist():
                c_t, s_t = r_prev * y[t], b[t] * y[t]
                xt = xs[:, t].clone()
                xs[:, t] = c_t * xt - s_t * col
                col = c_t * col + sgn * s_t * xt
                r_prev = r[t]
            Lw[j + 1:, j] = col
            x[j + 1:] = xs
            Lw[j, j] = r_prev
    return Lw


def chol_solve_ref(S: torch.Tensor, v: torch.Tensor, lam) -> torch.Tensor:
    """Full Algorithm 1 in fp32 — the oracle of the kernel-composed
    solver."""
    W, u = gram_sv_ref(S, v)
    lam32 = torch.tensor(float(lam), dtype=torch.float32, device=W.device)
    L = cholesky(W + lam32 * torch.eye(W.shape[0], device=W.device))
    w = trisolve_ref(L, u[:, None])[:, 0] if u.ndim == 1 else trisolve_ref(L, u)
    return ngd_apply_ref(S, w, v, lam)


def _ct(A: torch.Tensor) -> torch.Tensor:
    """Conjugate transpose (plain transpose for real dtypes)."""
    return A.mH if A.is_complex() else A.mT


def _acc(*tensors) -> torch.dtype:
    return acc_dtype(*(t.dtype for t in tensors))


def sv_cross_ref(S: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
    """U = S @ V — the serve cross pass."""
    tgt = _acc(S, V)
    return S.to(tgt) @ V.to(tgt)


def serve_apply_ref(S: torch.Tensor, w: torch.Tensor, V: torch.Tensor,
                    lam) -> torch.Tensor:
    """X = (V − S† @ w) / λ — the multi-RHS serve apply pass."""
    tgt = _acc(S, V, w)
    rdtype = torch.empty((), dtype=tgt).real.dtype
    lam_r = torch.as_tensor(lam, dtype=rdtype, device=S.device)
    return (V.to(tgt) - _ct(S.to(tgt)) @ w.to(tgt)) / lam_r


def trisolve_ref(L: torch.Tensor, U: torch.Tensor) -> torch.Tensor:
    """w = L⁻† L⁻¹ U against a lower-triangular L."""
    w = torch.linalg.solve_triangular(L, U, upper=False)
    return torch.linalg.solve_triangular(_ct(L), w, upper=True)


def trisolve_panels_ref(L: torch.Tensor, U: torch.Tensor,
                        panel: int = 64) -> torch.Tensor:
    """w = L⁻ᵀ L⁻¹ U in the substitution kernel's order
    (``csrc/trisolve.cuh``), emulated in fp32 for the tests: panels of
    ``panel`` rows; in a diagonal block, row t is scaled by its reciprocal
    pivot once final and taken off the rows after it; each solved panel is
    then taken from the rows still to go as one tile product (forward
    L[rows, panel]·y, backward L[panel, rows]ᵀ·w), panels top to bottom,
    then bottom to top. L (n, n) lower, U (n, k)."""
    Lf = _f32(L)
    r = _f32(U).reshape(L.shape[0], -1).clone()
    n = Lf.shape[0]
    starts = list(range(0, n, panel))
    dinv = 1.0 / torch.diagonal(Lf)
    for p0 in starts:                       # forward, L y = u
        p1 = min(p0 + panel, n)
        for t in range(p0, p1):
            r[t] = r[t] * dinv[t]
            r[t + 1:p1] -= Lf[t + 1:p1, t:t + 1] * r[t]
        r[p1:] -= Lf[p1:, p0:p1] @ r[p0:p1]
    for p0 in reversed(starts):             # backward, Lᵀ w = y
        p1 = min(p0 + panel, n)
        for t in range(p1 - 1, p0 - 1, -1):
            r[t] = r[t] * dinv[t]
            r[p0:t] -= Lf[t, p0:t, None] * r[t]
        r[:p0] -= Lf[p0:p1, :p0].T @ r[p0:p1]
    return r


def serve_solve_ref(S: torch.Tensor, L: torch.Tensor, V: torch.Tensor,
                    lam) -> torch.Tensor:
    """X = (V − S† L⁻† L⁻¹ S V)/λ against a resident L (the exact
    ``CholFactorization.solve`` algebra)."""
    return serve_apply_ref(S, trisolve_ref(L, sv_cross_ref(S, V)), V, lam)


def fold_cols_ref(S: torch.Tensor, rows: torch.Tensor):
    """(cols, corner) = (S·rows†, rows·rows†) — the fold cross columns. A
    low-precision window is widened a column chunk at a time
    (``core.solvers.UPCAST_CHUNK``)."""
    tgt = _acc(S, rows)
    cols = corner = None
    for a, b in _upcast_chunks(S, tgt):
        s, r = S[:, a:b].to(tgt), rows[:, a:b].to(tgt)
        c, k = s @ _ct(r), r @ _ct(r)
        cols, corner = (c, k) if cols is None else (cols + c, corner + k)
    return cols, corner


def _fma(x: torch.Tensor, y: torch.Tensor, acc: torch.Tensor) -> torch.Tensor:
    """fmaf in fp32, emulated: the exact product and the sum in float64,
    rounded once more to fp32 (a tie of the two roundings aside, fmaf's
    bits)."""
    return (x.double() * y.double() + acc.double()).float()


def sv_cross_tiles_ref(S: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
    """U = S·V in the cross pass's order (``csrc/cross.cuh``), emulated in
    fp32 for the tests. m is split as the kernel splits it
    (``serve_solve.cross_split`` at ``cross_tile``); in a chunk, lane l of
    32 owns the runs of 16 bytes l, l + 32, … of S's row (4 fp32 or 8 bf16
    columns each) and adds its columns in ascending order by fmaf into one
    sum a (row, column of V); the lanes' sums are added by the butterfly
    of offsets 16, 8, 4, 2, 1 (lane 0's result), and the chunks' partials
    in ascending order from 0. S (rows, m) fp32|bf16 — the fold passes
    [S; rows] — and V (m, k). This is the CUDA cores' order; a bf16 window
    at 8 or 16 right-hand sides a block on the vector route takes the
    tensor cores (``serve_solve.cross_tensor_cores``), whose sums within
    a 16-column step no emulation here reproduces bit for bit."""
    from repro_torch.kernels.serve_solve import cross_split, cross_tile
    rows, m = S.shape
    k = V.shape[1]
    vec = 16 // S.element_size()
    P, chunk = cross_split(rows, m, cross_tile(S.dtype, k))
    pad = P * chunk - m
    X = torch.nn.functional.pad(_f32(S), (0, pad))
    Y = torch.nn.functional.pad(_f32(V).T, (0, pad))              # (k, m)
    q = chunk // (32 * vec)
    # (rows, P, lane, the lane's columns in ascending order)
    X = X.reshape(rows, P, q, 32, vec).permute(0, 1, 3, 2, 4).reshape(
        rows, P, 32, q * vec)
    Y = Y.reshape(k, P, q, 32, vec).permute(1, 3, 2, 4, 0).reshape(
        P, 32, q * vec, k)
    acc = torch.zeros((rows, P, 32, k), dtype=torch.float32)
    for t in range(q * vec):
        acc = _fma(X[:, :, :, t, None], Y[None, :, :, t, :], acc)
    lanes = torch.arange(32)
    for off in (16, 8, 4, 2, 1):
        acc = acc + acc[:, :, lanes ^ off]
    U = torch.zeros((rows, k), dtype=torch.float32)
    for p in range(P):
        U = U + acc[:, p, 0]
    return U


def serve_apply_warps_ref(S: torch.Tensor, w: torch.Tensor, V: torch.Tensor,
                          lam) -> torch.Tensor:
    """X = (V − Sᵀw)/λ in the apply pass's order (``csrc/apply.cuh``),
    emulated in fp32 for the tests: the rows come in groups of the rows one
    16-byte load of a lane covers (1 fp32, 2 bf16); warp v of 8 takes the
    groups v, v + 8, … and adds its rows in ascending order by fmaf into
    one sum an output; the 8 warps' sums are added in warp order, then
    x = (v − sum)/λ in fp32. S (n, m) fp32|bf16; w (n, k); V (m, k)."""
    n, m = S.shape
    group = 16 // S.element_size() // 4     # a load's columns / a lane's 4
    X = _f32(S)
    W_ = _f32(w)
    warp = (torch.arange(n) // group) % 8
    sums = []
    for v in range(8):
        acc = torch.zeros((m, W_.shape[1]), dtype=torch.float32)
        for i in torch.nonzero(warp == v).flatten().tolist():
            acc = _fma(X[i, :, None], W_[i][None, :], acc)
        sums.append(acc)
    total = sums[0]
    for acc in sums[1:]:
        total = total + acc
    lam32 = torch.tensor(float(lam), dtype=torch.float32)
    return (_f32(V) - total) / lam32


NEG = -0.7 * float(torch.finfo(torch.float32).max)
FLASH_BK = 64            # the CUDA kernels' KV tile (kBK, csrc/flash_attention.cu),
FLASH_BK_WGMMA = 128     # and the wgmma kernel's (fa3::kBN, csrc/flash_wgmma.cuh)
WGMMA_HEAD_DIMS = (64, 128)


def flash_kv_tile(dtype: torch.dtype, hd: int) -> int:
    """The KV tile of the kernel that takes q of ``dtype`` at head dim
    ``hd``: 128 keys for bf16 at hd 64 and 128 (wgmma), else 64."""
    return FLASH_BK_WGMMA if dtype == torch.bfloat16 and \
        hd in WGMMA_HEAD_DIMS else FLASH_BK


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window=None,
                        scale=None) -> torch.Tensor:
    """The flash-attention kernel's function in plain PyTorch: KV tiles of
    the kernel's size (``flash_kv_tile``) in ascending order, s =
    (q·kᵀ)·scale in fp32, masked scores at NEG, running max and sum in fp32, p = exp(s − m) (0 for a masked
    key) rounded to v's dtype before P·V, o = acc / max(l, 1e-30) in q's
    dtype. q (B, Tq, H, hd); k, v (B, Tk, KH, hd), H % KH == 0; query
    positions start at 0 (the TPU kernel's layout), ragged Tk is fine."""
    B, Tq, H, hd = q.shape
    _, Tk, KH, _ = k.shape
    g = H // KH
    scale = hd ** -0.5 if scale is None else float(scale)
    dev = q.device
    f32 = torch.float32
    qh = q.to(f32).reshape(B, Tq, KH, g, hd).permute(0, 2, 1, 3, 4) \
        .reshape(B, KH, Tq * g, hd)
    q_pos = torch.arange(Tq, device=dev)
    m = torch.full((B, KH, Tq, g), NEG, dtype=f32, device=dev)
    l = torch.zeros((B, KH, Tq, g), dtype=f32, device=dev)
    acc = torch.zeros((B, KH, Tq, g, hd), dtype=f32, device=dev)
    bk = flash_kv_tile(q.dtype, hd)
    for k0 in range(0, Tk, bk):
        if causal and k0 > Tq - 1:
            break                    # wholly above the diagonal, as later ones
        k1 = min(k0 + bk, Tk)
        kj = k[:, k0:k1].to(f32).permute(0, 2, 1, 3)           # (B, KH, bk, hd)
        vj = v[:, k0:k1].permute(0, 2, 1, 3)
        s = (qh @ kj.transpose(-1, -2)).reshape(B, KH, Tq, g, k1 - k0) * scale
        k_pos = torch.arange(k0, k1, device=dev)
        live = torch.ones((Tq, k1 - k0), dtype=torch.bool, device=dev)
        if causal:
            live &= k_pos[None, :] <= q_pos[:, None]
        if window is not None:
            live &= k_pos[None, :] > q_pos[:, None] - window
        live = live[None, None, :, None, :]
        s = torch.where(live, s, NEG)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.where(live, torch.exp(s - m_new[..., None]), 0.0)
        corr = torch.exp(m - m_new)
        l = corr * l + p.sum(-1)
        pv = p.to(v.dtype).to(f32).reshape(B, KH, Tq * g, k1 - k0) \
            @ vj.to(f32)
        acc = corr[..., None] * acc + pv.reshape(B, KH, Tq, g, hd)
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.permute(0, 2, 1, 3, 4).reshape(B, Tq, H, hd).to(q.dtype)
