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

The two streaming passes over the window — the cross pass (``cross.cuh``)
and the apply pass (``apply.cuh``) — read it 16 bytes a lane where
``stream_route`` allows, else by scalar loads of the same columns (the
same sums, bit for bit, on the CUDA cores). On the vector route the cross
pass of a bf16 window with 8 or 16 right-hand sides a block runs on the
tensor cores (``cross_tensor_cores``), so there the two routes give
different bits. ``ROUTES`` counts each launch, by these wrappers and by
``fold.fold_cols_cuda``, under the route the rule chose;
``kernels_launched`` reads which kernels ran, as the libraries count them
where each kernel is launched.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import F, I, P

__all__ = ["LAUNCHES", "MAX_TRISOLVE_N", "ROUTES", "WINDOW_DTYPES",
           "apply_split", "check_window", "cross_split", "cross_tensor_cores",
           "cross_tile", "kernels_launched", "STREAM_KERNELS", "stream_route",
           "stream_route_of", "trisolve_columns",
           "serve_apply_cuda", "serve_solve_cuda", "sv_cross_cuda",
           "trisolve_cuda"]

LAUNCHES = {"serve_solve": 0, "sv_cross": 0, "serve_apply": 0, "trisolve": 0}
# launches of the streaming passes by the load route the rule chose:
# "vector" (16 bytes a lane) or "scalar", one count a wrapper call
# (serve_solve's two passes share one route); "tensor_cores" counts those
# of the vector launches whose cross pass the rule sends to the tensor
# cores
ROUTES = {"vector": 0, "scalar": 0, "tensor_cores": 0}
# the streaming kernels in the order the libraries count their launches
# (stream::Kernel in csrc/stream.cuh): the CUDA-core cross kernel on scalar
# or 16-byte loads, the tensor cores' cross kernel, the apply kernel on
# scalar or 16-byte loads
STREAM_KERNELS = ("cross_scalar", "cross_vector", "cross_tensor_cores",
                  "apply_scalar", "apply_vector")

WINDOW_DTYPES = (torch.float32, torch.bfloat16)
_F32 = (torch.float32,)

# The substitution keeps the right-hand side in the shared memory of a
# cluster of 8 blocks: n/8 rows of up to 16 columns a block (fewer columns
# for the largest n). Mirrors tri::kCluster, tri::kB and tri::smem_floats in
# csrc/trisolve.cuh.
MAX_TRISOLVE_N = 32768
_CLUSTER, _PANEL, _PITCH = 8, 64, 68
_SMEM_BYTES = 232448 - 1024     # of the 227 KB a block may use on an H100

# Mirrors kRowsPerBlock and CrossCfg in csrc/cross.cuh. The split over m
# aims at a fixed number of blocks (8 per SM of an H100, four waves of two),
# independent of the card, so the reduction order — and the result bits —
# depend on the shape only.
_ROWS_PER_BLOCK = 32
_TILE_J = 128
_TARGET_BLOCKS = 1056
# The apply pass's strips of 128 columns (kApplyStrip in csrc/apply.cuh)
# and its blocks, at most 264 (2 per SM of an H100, one wave; the kernel
# refuses more).
_APPLY_STRIP = 128
_APPLY_MAX_BLOCKS = 264

_SIGNATURES = {
    "sv_cross_launch": [P, I, P, P, P, I, I, I, I, I, I, P],
    "serve_apply_launch": [P, I, P, P, P, I, I, I, F, I, I, P],
    "trisolve_launch": [P, P, I, I, I, I, P, P],
    "serve_solve_launch": [P, I, P, P, P, P, P, I, I, I, I, I, I, F, I, I,
                           P],
    "repro_stream_launches": [P],
}


def _lib():
    return _build.library("serve_solve", _SIGNATURES)


def _k_tile(k: int) -> int:
    """Mirrors ``k_tile`` in csrc/common.cuh: right-hand sides a block."""
    return 1 if k <= 1 else 4 if k <= 4 else 8 if k <= 8 else 16


def _itemsize(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def cross_tile(dtype: torch.dtype, k: int) -> int:
    """Columns of m one stage of the cross pass covers: 32 lanes × 16 bytes
    of the window's ``dtype`` × the stage's warp-steps (2, or 1 at 16
    right-hand sides a block) — 256 or 128 fp32, 512 or 256 bf16. A
    multiple of 128; ``cross_split`` takes it as its tile. Mirrors
    ``CrossCfg`` in csrc/cross.cuh."""
    return 32 * (16 // _itemsize(dtype)) * (1 if _k_tile(k) == 16 else 2)


def cross_split(rows: int, m: int, tile: int = _TILE_J) -> tuple[int, int]:
    """(P, chunk): the cross pass's split of m into P chunks of ``chunk``
    columns, a multiple of ``tile`` (128 by default; the kernels pass
    ``cross_tile``, itself a multiple of 128)."""
    tiles = -(-rows // _ROWS_PER_BLOCK)
    P_ = max(1, min(-(-_TARGET_BLOCKS // tiles), -(-m // tile)))
    chunk = -(-(-(-m // P_)) // tile) * tile
    return -(-m // chunk), chunk


def stream_route(m: int, dtype: torch.dtype, *byte_offsets: int) -> str:
    """The load route of the streaming passes over an (n, m) row-major
    window of ``dtype`` whose operands start ``byte_offsets`` bytes into
    their storage (the window's, and for the fold the rows' too):
    ``"vector"`` — 16 bytes a lane — where every row starts 16-byte
    aligned, that is m·itemsize a multiple of 16 and every offset too (the
    storage itself is allocated aligned); else ``"scalar"``. A pure rule on
    the shape, the dtype and the offsets — the same answer for a tensor on
    any device."""
    if dtype not in WINDOW_DTYPES or m < 1:
        return "scalar"
    aligned = (m * _itemsize(dtype)) % 16 == 0 and \
        all(off % 16 == 0 for off in byte_offsets)
    return "vector" if aligned else "scalar"


def cross_tensor_cores(dtype: torch.dtype, k: int, route: str) -> bool:
    """Whether the cross pass over a window of ``dtype`` against ``k``
    right-hand sides runs on the tensor cores (``mma.sync``, bf16
    products, fp32 sums; V split exactly into three bf16 terms): a bf16
    window on the vector route with 8 or 16 right-hand sides a block,
    where the CUDA cores' FMAs, not the bytes, would bind. Mirrors
    ``launch_cross`` in csrc/cross.cuh."""
    return route == "vector" and dtype == torch.bfloat16 and _k_tile(k) >= 8


def _count(route: str, dtype: torch.dtype, k: int, cross: bool) -> None:
    ROUTES[route] += 1
    if cross and cross_tensor_cores(dtype, k, route):
        ROUTES["tensor_cores"] += 1


def kernels_launched() -> dict:
    """{kernel of ``STREAM_KERNELS``: launches so far in this process}, as
    the libraries that hold the streaming passes (serve_solve, fold) count
    them on the host where each kernel is launched — which kernels the
    calls ran, where ``ROUTES`` holds what the rule chose. A library not
    loaded yet has launched nothing."""
    out = dict.fromkeys(STREAM_KERNELS, 0)
    for name in ("serve_solve", "fold"):
        lib = _build._loaded.get(name)
        if lib is None:
            continue
        counts = (ctypes.c_longlong * len(STREAM_KERNELS))()
        lib.repro_stream_launches(ctypes.addressof(counts))
        for key, n in zip(STREAM_KERNELS, counts):
            out[key] += n
    return out


def stream_route_of(*tensors: torch.Tensor) -> str:
    """``stream_route`` of these operands, the (n, m) window first."""
    S = tensors[0]
    return stream_route(S.shape[1], S.dtype, *(
        t.storage_offset() * t.element_size() for t in tensors))


def apply_split(m: int) -> tuple[int, int, int]:
    """(strips, per, blocks): the apply pass's strips of 128 columns of m
    and its blocks, at most 264, each walking ``per`` consecutive strips.
    Follows from m alone."""
    strips = -(-m // _APPLY_STRIP)
    per = -(-strips // _APPLY_MAX_BLOCKS)
    return strips, per, -(-strips // per)


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
    if not _build.on_card(S):
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
    Pn, chunk = cross_split(n, m, cross_tile(S.dtype, k))
    route = stream_route_of(S)
    part = torch.empty((Pn, n, k), dtype=torch.float32, device=S.device)
    U = torch.empty((n, k), dtype=torch.float32, device=S.device)
    if _build.would_launch(S.device, "sv_cross", flops=2 * n * m * k,
                           nbytes=_build.nbytes(S, V, U)):
        return U
    _build.call(_lib(), "sv_cross_launch", S.device, S.data_ptr(),
                int(S.dtype == torch.bfloat16), V.data_ptr(),
                part.data_ptr(), U.data_ptr(), n, m, k, Pn, chunk,
                int(route == "vector"), _build.stream_of(S))
    LAUNCHES["sv_cross"] += 1
    _count(route, S.dtype, k, cross=True)
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
    if _build.would_launch(S.device, "serve_apply", flops=2 * n * m * k,
                           nbytes=_build.nbytes(S, w, V, X)):
        return X
    route = stream_route_of(S)
    _build.call(_lib(), "serve_apply_launch", S.device, S.data_ptr(),
                int(S.dtype == torch.bfloat16), w.data_ptr(),
                V.data_ptr(), X.data_ptr(), n, m, k, float(lam),
                apply_split(m)[1], int(route == "vector"), _build.stream_of(S))
    LAUNCHES["serve_apply"] += 1
    _count(route, S.dtype, k, cross=False)
    return X


def _check_factor(L: torch.Tensor, n: int, device: torch.device) -> None:
    _build.check("L", L, device=device, dtypes=_F32, shape=(n, n))
    if n > MAX_TRISOLVE_N:
        raise ValueError(f"n={n} exceeds the substitution kernel's limit "
                         f"{MAX_TRISOLVE_N} (the right-hand side in a "
                         f"cluster's shared memory)")


def trisolve_cuda(L: torch.Tensor, U: torch.Tensor) -> torch.Tensor:
    """w = L⁻ᵀ L⁻¹ U (n, k) fp32. L (n, n) lower fp32; U (n, k) fp32."""
    if L.ndim != 2 or not _build.on_card(L):
        raise ValueError("L must be a 2-D CUDA tensor")
    n = L.shape[0]
    _check_factor(L, n, L.device)
    k = _width(U, n, "U")
    _build.check("U", U, device=L.device, dtypes=_F32)
    w = torch.empty((n, k), dtype=torch.float32, device=L.device)
    if _build.would_launch(L.device, "trisolve", flops=2 * n * n * k,
                           nbytes=_build.nbytes(L, U, w)):
        return w
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
    Pn, chunk = cross_split(n, m, cross_tile(S.dtype, k))
    part = torch.empty((Pn, n, k), dtype=torch.float32, device=S.device)
    w = torch.empty((n, k), dtype=torch.float32, device=S.device)
    X = torch.empty((m, k), dtype=torch.float32, device=S.device)
    # the window twice: the apply pass needs all of u = S·V first
    if _build.would_launch(S.device, "serve_solve",
                           flops=4 * n * m * k + 2 * n * n * k,
                           nbytes=_build.nbytes(S, S, L, V, X)):
        return X
    route = stream_route_of(S)
    _build.call(_lib(), "serve_solve_launch", S.device, S.data_ptr(),
                int(S.dtype == torch.bfloat16), L.data_ptr(),
                V.data_ptr(), part.data_ptr(), w.data_ptr(), X.data_ptr(),
                n, m, k, Pn, chunk, trisolve_columns(n, k), float(lam),
                apply_split(m)[1], int(route == "vector"), _build.stream_of(S))
    LAUNCHES["serve_solve"] += 1
    _count(route, S.dtype, k, cross=True)
    return X
