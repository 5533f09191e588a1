"""CUDA launch wrappers: the uniform-λ serve request path.

Replaces ``repro/kernels/serve_solve.py`` (``serve_solve_pallas``,
``sv_cross_pallas``, ``serve_apply_pallas`` and the in-kernel
``_trisolve``); the kernels are in ``csrc/serve_solve.cu`` and the shared
cross pass in ``csrc/cross.cuh``. Each wrapper checks its operands,
allocates outputs and scratch with ``torch.empty``, launches on the
current stream, raises on a CUDA error, and counts its launches in
``LAUNCHES``. The substitution (``csrc/trisolve.cuh``) is one launch of
clusters of 8 blocks, each cluster taking ``trisolve_columns(n, k)``
columns of the right-hand side at once.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import F, I, P

__all__ = ["LAUNCHES", "MAX_TRISOLVE_N", "WINDOW_DTYPES", "check_window",
           "cross_split", "trisolve_columns",
           "serve_apply_cuda", "serve_solve_cuda", "sv_cross_cuda",
           "trisolve_cuda"]

LAUNCHES = {"serve_solve": 0, "sv_cross": 0, "serve_apply": 0, "trisolve": 0}

WINDOW_DTYPES = (torch.float32, torch.bfloat16)
_F32 = (torch.float32,)

# The substitution keeps the right-hand side in the shared memory of a
# cluster of 8 blocks: n/8 rows of up to 16 columns a block (fewer columns
# for the largest n). Mirrors tri::kCluster, tri::kB and tri::smem_floats in
# csrc/trisolve.cuh.
MAX_TRISOLVE_N = 32768
_CLUSTER, _PANEL, _PITCH = 8, 64, 68
_SMEM_BYTES = 232448 - 1024     # of the 227 KB a block may use on an H100

# Mirrors kRowsPerBlock / kTileJ in csrc/cross.cuh. The split over m aims at
# a fixed number of blocks (4 per SM of an H100), independent of the card,
# so the reduction order — and the result bits — depend on the shape only.
_ROWS_PER_BLOCK = 32
_TILE_J = 128
_TARGET_BLOCKS = 528

_SIGNATURES = {
    "sv_cross_launch": [P, I, P, P, P, I, I, I, I, I, P],
    "serve_apply_launch": [P, I, P, P, P, I, I, I, F, P],
    "trisolve_launch": [P, P, I, I, I, I, P, P],
    "serve_solve_launch": [P, I, P, P, P, P, P, I, I, I, I, I, I, F, P],
}


def _lib():
    return _build.library("serve_solve", _SIGNATURES)


def cross_split(rows: int, m: int) -> tuple[int, int]:
    """(P, chunk): the cross pass's split of m into P chunks of ``chunk``
    columns (a multiple of the kernel's column tile)."""
    tiles = -(-rows // _ROWS_PER_BLOCK)
    P_ = max(1, min(-(-_TARGET_BLOCKS // tiles), -(-m // _TILE_J)))
    chunk = -(-(-(-m // P_)) // _TILE_J) * _TILE_J
    return -(-m // chunk), chunk


def trisolve_columns(n: int, k: int) -> int:
    """Columns of the right-hand side one cluster of the substitution takes
    (its KT): 1, 4, 8 or 16, the least that holds k, halved while a block's
    shared memory cannot hold its rows of them. A pure rule on (n, k); the
    launch takes ⌈k/KT⌉ clusters."""
    panels = -(-n // _PANEL)
    slots = -(-panels // _CLUSTER)
    fixed = _PANEL * (_PANEL + 1) + _PANEL + 4 * _PANEL * _PITCH
    kt = 1 if k <= 1 else 4 if k <= 4 else 8 if k <= 8 else 16
    while kt > 1 and 4 * ((slots + 2) * _PANEL * kt + fixed) > _SMEM_BYTES:
        kt = 4 if kt == 8 else kt // 2 if kt == 16 else 1
    return kt


def check_window(S: torch.Tensor, name: str = "S") -> tuple[int, int]:
    """(n, m) of a window the kernels take: 2-D, contiguous, fp32|bf16, CUDA."""
    if S.ndim != 2:
        raise ValueError(f"{name} must be a 2-D (n, m) window")
    _build.check(name, S, device=S.device, dtypes=WINDOW_DTYPES)
    if S.device.type != "cuda":
        raise ValueError(f"{name} is on {S.device}; the kernel needs CUDA")
    n, m = S.shape
    if n < 1 or m < 1:
        raise ValueError(f"empty window {tuple(S.shape)}")
    return n, m


def _width(V: torch.Tensor, rows: int, name: str) -> int:
    if V.ndim != 2 or V.shape[0] != rows:
        raise ValueError(f"{name} must be ({rows}, k), got {tuple(V.shape)}")
    return V.shape[1]


def sv_cross_cuda(S: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
    """U = S·V (n, k) fp32. S (n, m) fp32|bf16; V (m, k) fp32."""
    n, m = check_window(S)
    k = _width(V, m, "V")
    _build.check("V", V, device=S.device, dtypes=_F32)
    Pn, chunk = cross_split(n, m)
    part = torch.empty((Pn, n, k), dtype=torch.float32, device=S.device)
    U = torch.empty((n, k), dtype=torch.float32, device=S.device)
    _build.call(_lib(), "sv_cross_launch", S.device, S.data_ptr(),
                int(S.dtype == torch.bfloat16), V.data_ptr(),
                part.data_ptr(), U.data_ptr(), n, m, k, Pn, chunk,
                _build.stream_of(S))
    LAUNCHES["sv_cross"] += 1
    return U


def serve_apply_cuda(S: torch.Tensor, w: torch.Tensor, V: torch.Tensor,
                     lam: float) -> torch.Tensor:
    """X = (V − Sᵀw)/λ (m, k) fp32. S (n, m) fp32|bf16; w (n, k), V (m, k)
    fp32."""
    n, m = check_window(S)
    k = _width(V, m, "V")
    _build.check("V", V, device=S.device, dtypes=_F32)
    _build.check("w", w, device=S.device, dtypes=_F32, shape=(n, k))
    X = torch.empty((m, k), dtype=torch.float32, device=S.device)
    _build.call(_lib(), "serve_apply_launch", S.device, S.data_ptr(),
                int(S.dtype == torch.bfloat16), w.data_ptr(),
                V.data_ptr(), X.data_ptr(), n, m, k, float(lam),
                _build.stream_of(S))
    LAUNCHES["serve_apply"] += 1
    return X


def _check_factor(L: torch.Tensor, n: int, device: torch.device) -> None:
    _build.check("L", L, device=device, dtypes=_F32, shape=(n, n))
    if n > MAX_TRISOLVE_N:
        raise ValueError(f"n={n} exceeds the substitution kernel's limit "
                         f"{MAX_TRISOLVE_N} (the right-hand side in a "
                         f"cluster's shared memory)")


def trisolve_cuda(L: torch.Tensor, U: torch.Tensor) -> torch.Tensor:
    """w = L⁻ᵀ L⁻¹ U (n, k) fp32. L (n, n) lower fp32; U (n, k) fp32."""
    if L.ndim != 2 or L.device.type != "cuda":
        raise ValueError("L must be a 2-D CUDA tensor")
    n = L.shape[0]
    _check_factor(L, n, L.device)
    k = _width(U, n, "U")
    _build.check("U", U, device=L.device, dtypes=_F32)
    w = torch.empty((n, k), dtype=torch.float32, device=L.device)
    # U is passed as the single partial of the fixed-order reduction
    _build.call(_lib(), "trisolve_launch", L.device, L.data_ptr(),
                U.data_ptr(), 1, n, k, trisolve_columns(n, k), w.data_ptr(),
                _build.stream_of(L))
    LAUNCHES["trisolve"] += 1
    return w


def serve_solve_cuda(S: torch.Tensor, L: torch.Tensor, V: torch.Tensor,
                     lam: float) -> torch.Tensor:
    """X = (V − Sᵀ L⁻ᵀ L⁻¹ S V)/λ (m, k) fp32: cross pass, substitution and
    apply pass as three launches on one stream. S (n, m) fp32|bf16; L (n, n)
    lower fp32; V (m, k) fp32."""
    n, m = check_window(S)
    k = _width(V, m, "V")
    _build.check("V", V, device=S.device, dtypes=_F32)
    _check_factor(L, n, S.device)
    Pn, chunk = cross_split(n, m)
    part = torch.empty((Pn, n, k), dtype=torch.float32, device=S.device)
    w = torch.empty((n, k), dtype=torch.float32, device=S.device)
    X = torch.empty((m, k), dtype=torch.float32, device=S.device)
    _build.call(_lib(), "serve_solve_launch", S.device, S.data_ptr(),
                int(S.dtype == torch.bfloat16), L.data_ptr(),
                V.data_ptr(), part.data_ptr(), w.data_ptr(), X.data_ptr(),
                n, m, k, Pn, chunk, trisolve_columns(n, k), float(lam),
                _build.stream_of(S))
    LAUNCHES["serve_solve"] += 1
    return X
