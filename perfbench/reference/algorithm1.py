"""The plain reference of the damped-Fisher solve, in plain PyTorch.

    x = (SᵀS + λI)⁻¹ v = (v − Sᵀ (SSᵀ + λI)⁻¹ S v) / λ

computed through the n×n dual Gram, column block by column block so that
a window of any width fits beside the program's inputs. Nothing of the
program under test is imported or taken: the reference reads only the
inputs the benchmark drew (windows, right-hand sides, fold rows) and,
to judge them, the program's outputs.

``precision``:

* ``"float64"`` — every product and factorization in float64: the
  reference the program is judged against;
* ``"tf32"`` — the control: the same steps with every operand of a
  product rounded to TF32 (10 mantissa bits, round to nearest, ties away,
  as the tensor cores' conversion does) and float32 accumulation, float32
  factorization and substitution. It is what the reference would give in
  the precision just below the configuration's float32;
* ``"fp8"`` — the control of a bfloat16 configuration: every operand of
  a product scaled by its block's largest magnitude, rounded to FP8
  (E4M3), with float32 accumulation and float32 factorization and
  substitution.

``CONTROL`` maps a configuration's dtype to its control's precision.
"""
from __future__ import annotations

from typing import Iterable, List, Sequence, Tuple

import torch

__all__ = ["CONTROL", "PRECISIONS", "Factor", "apply", "factor",
           "factor_resid", "fifo_window", "fifo_slots", "fp8_round", "gram",
           "microbatch_starts", "rel_err", "solve", "tf32_round"]

PRECISIONS = ("float64", "tf32", "fp8")
CONTROL = {"float32": "tf32", "bfloat16": "fp8"}
FP8_MAX = 448.0          # the largest finite E4M3 magnitude
BLOCK = 1 << 15          # columns of the window widened at a time


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """float32 ``t`` rounded to TF32: the low 13 mantissa bits cleared,
    rounding to nearest with ties away from zero."""
    bits = t.to(torch.float32).contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    """``t`` scaled so that its largest magnitude is E4M3's, rounded to
    E4M3 and scaled back, in float32."""
    t = t.to(torch.float32)
    amax = float(t.abs().max()) if t.numel() else 0.0
    if amax == 0.0:
        return t.clone()
    s = amax / FP8_MAX
    return (t / s).to(torch.float8_e4m3fn).to(torch.float32) * s


def _dtype(precision: str) -> torch.dtype:
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}")
    return torch.float64 if precision == "float64" else torch.float32


def _operand(t: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "float64":
        return t.to(torch.float64)
    return tf32_round(t) if precision == "tf32" else fp8_round(t)


def _blocks(m: int) -> Iterable[Tuple[int, int]]:
    return ((a, min(a + BLOCK, m)) for a in range(0, m, BLOCK))


def gram(S: torch.Tensor, V: torch.Tensor, precision: str
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(W, U) = (S Sᵀ, S V): S (n, m), V (m, k)."""
    n, m = S.shape
    dt = _dtype(precision)
    W = torch.zeros((n, n), dtype=dt, device=S.device)
    U = torch.zeros((n, V.shape[1]), dtype=dt, device=S.device)
    for a, b in _blocks(m):
        Sb = _operand(S[:, a:b], precision)
        W += Sb @ Sb.T
        U += Sb @ _operand(V[a:b], precision)
    return W, U


class Factor:
    """The factor of W + λI of one window, and the window, so that any
    number of right-hand sides can be solved against it."""

    def __init__(self, S: torch.Tensor, lam: float, precision: str):
        n = S.shape[0]
        self.S, self.lam, self.precision = S, float(lam), precision
        W, _ = gram(S, S.new_zeros((S.shape[1], 0)), precision)
        self.W = W
        eye = torch.eye(n, dtype=W.dtype, device=W.device)
        self.L = torch.linalg.cholesky(W + self.lam * eye)

    def perp(self, X: torch.Tensor) -> torch.Tensor:
        """The part of each column of X (m, k) outside the window's row
        space: X − Sᵀ W⁻¹ S X, in the factor's precision."""
        if not hasattr(self, "Lw"):
            self.Lw = torch.linalg.cholesky(self.W)
        dt = self.W.dtype
        X = X.to(dt)
        _, U = gram(self.S, X, self.precision)
        Y = torch.cholesky_solve(U, self.Lw)
        out = torch.empty_like(X)
        for a, b in _blocks(self.S.shape[1]):
            out[a:b] = X[a:b] - _operand(self.S[:, a:b], self.precision).T @ Y
        return out

    def solve(self, V: torch.Tensor) -> torch.Tensor:
        """X (m, k) for V (m, k): cross, substitution, apply."""
        _, U = gram(self.S, V, self.precision)
        w = torch.cholesky_solve(U, self.L)
        return apply(self.S, w, V, self.lam, self.precision)


def apply(S: torch.Tensor, w: torch.Tensor, V: torch.Tensor, lam: float,
          precision: str) -> torch.Tensor:
    """X = (V − Sᵀ w) / λ, block by block of columns."""
    dt = _dtype(precision)
    wo = w.to(dt) if precision == "float64" \
        else _operand(w.to(torch.float32), precision)
    X = torch.empty((S.shape[1], V.shape[1]), dtype=dt, device=S.device)
    for a, b in _blocks(S.shape[1]):
        Sb = _operand(S[:, a:b], precision)
        X[a:b] = (V[a:b].to(dt) - Sb.T @ wo) / lam
    return X


def factor(S: torch.Tensor, lam: float, precision: str = "float64") -> Factor:
    return Factor(S, lam, precision)


def solve(S: torch.Tensor, V: torch.Tensor, lam: float,
          precision: str = "float64") -> torch.Tensor:
    """x = (SᵀS + λI)⁻¹ v for each column of V (m, k), or v (m,)."""
    flat = V.ndim == 1
    X = Factor(S, lam, precision).solve(V[:, None] if flat else V)
    return X[:, 0] if flat else X


def rel_err(x: torch.Tensor, ref: torch.Tensor) -> float:
    """‖x − ref‖ / ‖ref‖ in float64."""
    ref = ref.to(torch.float64)
    return float(torch.linalg.vector_norm(x.to(torch.float64) - ref)
                 / torch.linalg.vector_norm(ref))


def factor_resid(L: torch.Tensor, W: torch.Tensor, lam: float) -> float:
    """‖L Lᵀ − (W + λI)‖_F / ‖W + λI‖_F in float64: how far a factor L
    (its lower triangle) is from factoring the window's Gram W as the
    reference has it — the backward error of L, which rounding in the
    factor's updates moves far less than its forward error."""
    L = torch.tril(L.to(torch.float64))
    A = W.to(torch.float64) + lam * torch.eye(
        W.shape[0], dtype=torch.float64, device=W.device)
    return float(torch.linalg.matrix_norm(L @ L.T - A)
                 / torch.linalg.matrix_norm(A))


# ---------------------------------------------------------------------------
# the sliding window: requests' rows folded FIFO, as the serving contract
# states it
# ---------------------------------------------------------------------------

def fifo_slots(first_row: int, k: int, n: int) -> List[int]:
    """The window rows that the k rows of a fold replace, the fold being
    the one that brings the window's ``first_row``-th folded row."""
    return [(first_row + i) % n for i in range(k)]


def fifo_window(S0: torch.Tensor, rows: torch.Tensor, count: int
                ) -> torch.Tensor:
    """S0 with the first ``count`` requests' rows folded in, FIFO, in
    request order: request r's k rows (``rows[r]``, (k, m)) replace window
    rows (r·k + i) mod n. Returns a new tensor."""
    S = S0.clone()
    n = S.shape[0]
    if count == 0:
        return S
    k = rows.shape[1]
    flat = rows[:count].reshape(count * k, -1)
    if count * k >= n:
        # only the last n folded rows remain; row j sits in slot j mod n
        first = count * k - n
        idx = torch.arange(first, count * k, device=S.device)
        S[idx % n] = flat[first:].to(S.dtype)
    else:
        S[:count * k] = flat.to(S.dtype)
    return S


def microbatch_starts(flushes: Sequence[Sequence[int]], max_requests: int
                      ) -> dict:
    """{request: the first request of its microbatch}: each flush drains
    its queue FIFO in microbatches of at most ``max_requests`` requests
    (one token each, far under the token budget)."""
    out = {}
    for queue in flushes:
        for a in range(0, len(queue), max_requests):
            chunk = queue[a:a + max_requests]
            for r in chunk:
                out[r] = chunk[0]
    return out
