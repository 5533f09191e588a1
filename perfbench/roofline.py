"""Peaks of the card and the work each kernel's inputs need.

Work is counted from the shapes, whatever implements it: each input byte
read once, each output byte written once, and the operations the
mathematics needs (a triangle where only a triangle is needed). A
kernel's share of its roofline is the least time the card could take for
that work — the larger of operations over the peak and bytes over the
memory's rate — over the time the kernel took.

The peak is the tensor-core rate of the narrowest arithmetic that the
configuration's operands allow: TF32 for float32 operands (an
implementation that passes the comparison cannot beat it, while the
67 TFLOP/s float32 rate of the CUDA cores is beaten by a 3xTF32 Gram),
bf16 for bf16 operands.
"""
from __future__ import annotations

from typing import Tuple

__all__ = ["HBM_BYTES_PER_S", "PEAK_FLOPS", "Work", "algorithm1",
           "cholesky", "fold", "gram_sv", "least_seconds", "ngd_apply",
           "peak_flops", "refresh", "serve_solve", "share", "trisolve"]

# NVIDIA H100 SXM5 data sheet, dense rates without sparsity, at 700 W
PEAK_FLOPS = {"float32": 494.7e12,      # TF32 on the tensor cores
              "bfloat16": 989.4e12}
HBM_BYTES_PER_S = 3.35e12

ITEMSIZE = {"float32": 4, "bfloat16": 2}


class Work(Tuple[float, float]):
    """(operations, bytes) of one call."""

    def __new__(cls, flops: float, nbytes: float):
        return super().__new__(cls, (float(flops), float(nbytes)))

    @property
    def flops(self) -> float:
        return self[0]

    @property
    def nbytes(self) -> float:
        return self[1]

    def __add__(self, other):
        return Work(self[0] + other[0], self[1] + other[1])

    def times(self, count: float) -> "Work":
        return Work(self[0] * count, self[1] * count)


def peak_flops(dtype: str) -> float:
    return PEAK_FLOPS[dtype]


def least_seconds(work: Work, dtype: str) -> Tuple[float, str]:
    """The least time of ``work`` on the card, and what bounds it
    ("ops" or "bytes")."""
    t_ops = work.flops / peak_flops(dtype)
    t_bytes = work.nbytes / HBM_BYTES_PER_S
    return (t_ops, "ops") if t_ops >= t_bytes else (t_bytes, "bytes")


def share(work: Work, seconds: float, dtype: str) -> float:
    """Percent of the roofline that ``work`` done in ``seconds`` reaches."""
    return 100.0 * least_seconds(work, dtype)[0] / seconds


def _tri(n: int) -> int:
    return n * (n + 1) // 2


def gram_sv(n: int, m: int, dtype: str) -> Work:
    """(W, u) = (S Sᵀ, S v): the lower triangle's products and u's; reads
    S and v, writes W (n, n) and u, fp32."""
    b = ITEMSIZE[dtype]
    return Work(n * (n + 1) * m + 2 * n * m,
                n * m * b + m * b + 4 * n * n + 4 * n)


def cholesky(n: int) -> Work:
    """L = chol(W + λI): n³/3 operations; reads W's lower triangle,
    writes L's, fp32."""
    return Work(n ** 3 / 3, 2 * 4 * _tri(n))


def trisolve(n: int, k: int = 1) -> Work:
    """w = L⁻ᵀ L⁻¹ u for k columns: 2n² operations a column; reads L's
    lower triangle and u, writes w, fp32."""
    return Work(2 * n * n * k, 4 * _tri(n) + 2 * 4 * n * k)


def ngd_apply(n: int, m: int, dtype: str) -> Work:
    """x = (v − Sᵀw)/λ: 2nm operations; reads S, w, v, writes x (fp32)."""
    return Work(2 * n * m, n * m * ITEMSIZE[dtype] + 4 * n + 4 * m + 4 * m)


def algorithm1(n: int, m: int, dtype: str) -> Work:
    """One whole solve: the Gram and u, the Cholesky, the substitution and
    the apply — each input byte once (S is read twice by any
    implementation that does not hold W and S v at once; counted once)."""
    flops = (gram_sv(n, m, dtype).flops + cholesky(n).flops
             + trisolve(n).flops + ngd_apply(n, m, dtype).flops)
    nbytes = n * m * ITEMSIZE[dtype] + 4 * m + 4 * m
    return Work(flops, nbytes)


def serve_solve(n: int, m: int, k: int, dtype: str) -> Work:
    """X = (V − Sᵀ L⁻ᵀ L⁻¹ S V)/λ for k columns against a resident factor:
    4nmk + 2n²k operations; reads S once, L's lower triangle and V,
    writes X."""
    return Work(4 * n * m * k + 2 * n * n * k,
                n * m * ITEMSIZE[dtype] + 4 * _tri(n) + 2 * 4 * m * k)


def fold(n: int, m: int, k: int, dtype: str) -> Work:
    """One FIFO fold of k rows into the window and its factor: the new
    Gram columns (2nmk operations, reading S and the rows), the k rows
    written into S, the factor's rank-2k update and downdate (2·2·n²·2k
    operations, reading and writing L's lower triangle)."""
    b = ITEMSIZE[dtype]
    return Work(2 * n * m * k + 8 * n * n * k,
                n * m * b + 2 * k * m * b + 2 * 4 * _tri(n) + 4 * n * k)


def refresh(n: int, m: int, dtype: str) -> Work:
    """A refactorization of the resident window: W = S Sᵀ and its
    Cholesky factor."""
    b = ITEMSIZE[dtype]
    return Work(n * (n + 1) * m + n ** 3 / 3,
                n * m * b + 4 * n * n + 4 * _tri(n))
