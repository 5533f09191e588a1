"""The flash-attention kernel of the torch port: its plain twin
(``ref.flash_attention_ref``, the CPU route of ``ops.flash_attention``)
against the JAX package's Pallas kernel in interpret mode and its
blockwise model attention, the dispatch rules, and — on a machine with
CUDA — the hand-written kernel against the plain twin.

Tolerances: fp32 2e-4 (rtol and atol), as ``tests/test_kernels.py``'s
flash-attention tests use. bf16 outputs are rounded to bf16 after fp32
sums taken in another order, so they may differ by one bf16 ulp of the
output: at most 2^-7 of the largest |o|, gated at 1e-2 of it. Against
the JAX blockwise attention (which keeps p in fp32 where the kernel
rounds it to bf16) bf16 is gated at 2e-2 of the largest |o|."""
import numpy as np
import pytest
import torch

from _torch_parity import pair, rel
from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_attention import flash_attention_cuda

try:
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    from repro.models import layers as jlayers
except ImportError:     # the GPU machine has no JAX; it runs `-m cuda` only
    jnp = jops = jlayers = None

torch.set_num_threads(1)

GQA = [(2, 1), (2, 2), (1, 4), (2, 3)]                 # (KH, group)
MASKS = [(True, None), (True, 64), (False, None)]      # (causal, window)
F32_TOL, BF16_TOL, BF16_VS_BLOCKWISE = 2e-4, 1e-2, 2e-2


def _qkv(seed, B, Tq, Tk, KH, g, hd, dtype="float32"):
    rng = np.random.default_rng(seed)
    q = pair(rng.normal(size=(B, Tq, KH * g, hd)), dtype)
    k = pair(rng.normal(size=(B, Tk, KH, hd)), dtype)
    v = pair(rng.normal(size=(B, Tk, KH, hd)), dtype)
    return [x[0] for x in (q, k, v)], [x[1] for x in (q, k, v)]


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("gqa", GQA)
@pytest.mark.parametrize("causal,window", MASKS)
def test_plain_matches_blockwise(gqa, causal, window):
    KH, g = gqa
    (qj, kj, vj), (q, k, v) = _qkv([KH, g, int(causal), window or 0],
                                   1, 128, 128, KH, g, 32)
    out = ops.flash_attention(q, k, v, causal=causal, window=window)
    assert out.shape == q.shape and out.dtype == torch.float32
    _close(out, jlayers.flash_attention(qj, kj, vj, causal=causal,
                                        window=window), F32_TOL)


@pytest.mark.parametrize("gqa,causal,window", [
    (gqa, True, None) for gqa in GQA] + [((2, 3), True, 64),
                                         ((2, 3), False, None)])
def test_plain_matches_pallas_interpret(gqa, causal, window):
    KH, g = gqa
    (qj, kj, vj), (q, k, v) = _qkv([KH, g, int(causal), window or 0, 1],
                                   1, 128, 128, KH, g, 32)
    out = ops.flash_attention(q, k, v, causal=causal, window=window)
    _close(out, jops.flash_attention(qj, kj, vj, causal=causal, window=window,
                                     mode="interpret", bq=64, bk=64), F32_TOL)


def test_plain_padded_q_matches_pallas():
    """Tq not a tile multiple against Tk = 256 (tests/test_kernels.py:134)."""
    (qj, kj, vj), (q, k, v) = _qkv(7, 1, 200, 256, 2, 2, 32)
    out = ops.flash_attention(q, k, v, causal=True)
    _close(out, jops.flash_attention(qj, kj, vj, causal=True,
                                     mode="interpret", bq=128, bk=128),
           F32_TOL)


@pytest.mark.parametrize("causal,window", MASKS)
def test_plain_ragged_t_matches_blockwise(causal, window):
    """T = 200 keys: the plain version masks the ragged tile, the JAX
    blockwise attention pads it (the Pallas kernel asserts Tk % bk == 0)."""
    (qj, kj, vj), (q, k, v) = _qkv(8, 2, 200, 200, 2, 3, 32)
    out = ops.flash_attention(q, k, v, causal=causal, window=window)
    _close(out, jlayers.flash_attention(qj, kj, vj, causal=causal,
                                        window=window), F32_TOL)


@pytest.mark.parametrize("causal,window", MASKS)
def test_plain_bf16_rounds_p_like_pallas(causal, window):
    (qj, kj, vj), (q, k, v) = _qkv(9, 1, 256, 256, 2, 3, 32, "bfloat16")
    out = ops.flash_attention(q, k, v, causal=causal, window=window)
    assert out.dtype == torch.bfloat16
    pallas = jops.flash_attention(qj, kj, vj, causal=causal, window=window,
                                  mode="interpret", bq=128, bk=64)
    assert rel(out, pallas.astype(jnp.float32)) < BF16_TOL
    blockwise = jlayers.flash_attention(qj, kj, vj, causal=causal,
                                        window=window)
    assert rel(out, blockwise.astype(jnp.float32)) < BF16_VS_BLOCKWISE


def test_plain_scale_and_fully_masked_rows():
    (qj, kj, vj), (q, k, v) = _qkv(10, 1, 96, 96, 1, 2, 16)
    out = ops.flash_attention(q, k, v, causal=True, scale=0.3)
    _close(out, jlayers.flash_attention(qj, kj, vj, causal=True, scale=0.3),
           F32_TOL)
    # rows 55.. of a window-16 causal pass over 40 keys see no key: 0, not NaN
    short = ref.flash_attention_ref(q, k[:, :40], v[:, :40], causal=True,
                                    window=16)
    assert torch.isfinite(short).all()
    assert short[:, 55:].eq(0).all() and short[:, :55].abs().sum() > 0


def test_dispatch_rules():
    (_, _, _), (q, k, v) = _qkv(11, 1, 16, 16, 1, 2, 16)
    want = ref.flash_attention_ref(q, k, v)
    assert torch.equal(ops.flash_attention(q, k, v), want)
    assert torch.equal(ops.flash_attention(q, k, v, mode="ref", bq=8, bk=8),
                       want)
    with pytest.raises(RuntimeError, match="CUDA"):
        ops.flash_attention(q, k, v, mode="kernel")
    with ops.default_mode("ref"):
        assert not ops._use_kernel(None, q)
        with pytest.raises(RuntimeError):
            ops.flash_attention(q, k, v, mode="kernel")
    with pytest.raises(ValueError):
        with ops.default_mode("tpu"):
            pass
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(q, k, v)
    assert "flash_attention" in ops.launch_counts()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [32, 64, 128])
def test_cuda_kernel_matches_plain(dtype, hd):
    """bf16 at hd 64 and 128 is the wgmma + TMA kernel (128-row q tiles,
    128-key tiles): T = 1000 and the ragged (Tq, Tk) pairs cross its tile
    edges; B = 2 keeps a box from reading the next batch's rows."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: chip_smoke.py "
                    "and `pytest -m cuda`)")
    g = torch.Generator(device="cuda").manual_seed(hd)
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    for KH, grp in GQA + [(8, 3)]:
        for Tq, Tk in ((16, 16), (200, 200), (256, 256), (1000, 1000),
                       (300, 1000), (1000, 300), (129, 255)):
            q = torch.randn((2, Tq, KH * grp, hd), generator=g,
                            device="cuda").to(dtype)
            k, v = (torch.randn((2, Tk, KH, hd), generator=g,
                                device="cuda").to(dtype) for _ in range(2))
            for causal, window in MASKS:
                got = ops.flash_attention(q, k, v, causal=causal,
                                          window=window, mode="kernel")
                again = ops.flash_attention(q, k, v, causal=causal,
                                            window=window, mode="kernel")
                want = ops.flash_attention(q, k, v, causal=causal,
                                           window=window, mode="ref")
                torch.cuda.synchronize()
                assert torch.equal(got, again)
                assert rel(got, want) < tol, (KH, grp, Tq, Tk, causal, window)
    # rows past every key of their window: 0 across 128-row q tiles
    q, k, v = (torch.randn((1, T, 4, hd), generator=g,
                           device="cuda").to(dtype) for T in (600, 200, 200))
    out = ops.flash_attention(q, k[:, :, :2], v[:, :, :2], causal=True,
                              window=32, mode="kernel")
    torch.cuda.synchronize()
    assert torch.isfinite(out).all() and out[:, 231:].eq(0).all()
