"""The kernels' shape rules and parity arguments in the torch port, on the
CPU:

* ``flash_attention.supported`` is a rule on shapes and dtypes alone (the
  same answer for tensors on any device, meta tensors included), with its
  edge at B·H = 65,536; the kernel wrapper refuses a tensor off the card
  first, and ``mode="kernel"`` still raises on the CPU;
* ``ops.cholesky`` takes the reference's ``panel=`` and ignores it.

Inputs come from fixed numpy seeds. The Cholesky is compared with the
JAX package's plain route at 1e-5 (fp32 sums in another order over
n = 40)."""
import numpy as np
import pytest
import torch

from _torch_parity import rel
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import (HEAD_DIMS, MAX_BH,
                                                 flash_attention_cuda,
                                                 supported)

try:
    import jax.numpy as jnp
    from repro.kernels import ops as jops
except ImportError:     # the GPU machine has no JAX
    jnp = jops = None

torch.set_num_threads(1)


def _qk(B=1, T=8, H=4, KH=2, hd=16, dtype=torch.float32, device="cpu",
        Tk=None):
    q = torch.zeros((B, T, H, hd), dtype=dtype, device=device)
    k = torch.zeros((B, T if Tk is None else Tk, KH, hd), dtype=dtype,
                    device=device)
    return q, k


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_supported_is_a_rule_on_shapes_and_dtypes(dtype):
    for hd in HEAD_DIMS + (8, 48, 96, 512):
        for H, KH in ((4, 2), (4, 4), (3, 2), (6, 4)):
            for Tq, Tk in ((8, 8), (1, 300), (129, 1)):
                want = hd in HEAD_DIMS and H % KH == 0
                # the same answer for tensors without storage (meta) as
                # for CPU tensors: shapes and dtypes decide, not the device
                for device in ("cpu", "meta"):
                    q, k = _qk(H=H, KH=KH, hd=hd, dtype=dtype, T=Tq, Tk=Tk,
                               device=device)
                    assert supported(q, k) is want, (hd, H, KH, Tq, Tk)
    q, k = _qk(dtype=dtype)
    assert not supported(q, k.to(torch.float16))
    assert not supported(q.to(torch.float16), k.to(torch.float16))
    assert not supported(q[0], k)
    assert not supported(q, k[:, :, :, :8])
    assert not supported(q[:, :0], k)
    assert not supported(q, k[:, :0])


@pytest.mark.parametrize("B,H,want", [(1, MAX_BH, True), (2, 32767, True),
                                      (2, 32768, False), (1, 65536, False),
                                      (4, 16384, False)])
def test_supported_edge_at_bh_65536(B, H, want):
    """B·H = 65,535 is the last the kernels take (the grid's y extent of
    the 64-row-tile kernels); 65,536 goes blockwise. Meta tensors: no
    memory is touched."""
    q, k = _qk(B=B, T=1, H=H, KH=1, hd=16, dtype=torch.bfloat16,
               device="meta")
    assert supported(q, k) is want
    assert (B * H <= 65535) is want
    # the wrapper refuses a CPU tensor first, whatever its shape
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(torch.empty_like(q, device="cpu"),
                             torch.empty_like(k, device="cpu"),
                             torch.empty_like(k, device="cpu"))
    # a meta operand takes the wrapper's meta route (the dry run): its
    # output on meta where the rule holds, the rule's reason where not
    if want:
        assert flash_attention_cuda(q, k, k).is_meta
    else:
        with pytest.raises(ValueError, match="unsupported shape"):
            flash_attention_cuda(q, k, k)


def test_kernel_mode_still_raises_off_the_card():
    """The route's rule does not turn ``mode="kernel"`` into a quiet plain
    call: on the CPU it raises, for supported shapes and others alike."""
    for hd in (16, 48):
        q, k = _qk(hd=hd)
        with pytest.raises(RuntimeError, match="CUDA"):
            ops.flash_attention(q, k, k, mode="kernel")
        with pytest.raises(ValueError, match="CUDA"):
            flash_attention_cuda(q, k, k)


@pytest.mark.parametrize("panel", [8, 16, 32, 64])
def test_cholesky_panel_is_taken_for_parity(panel):
    """``panel=`` leaves the plain result unchanged (bit for bit) and the
    reference's plain route (its ``panel=`` only pads the Pallas kernel)
    agrees at 1e-5."""
    rng = np.random.default_rng(panel)
    A = rng.normal(size=(40, 40))
    W = torch.from_numpy((A @ A.T / 40 + np.eye(40)).astype(np.float32))
    L = ops.cholesky(W)
    assert torch.equal(ops.cholesky(W, panel=panel), L)
    assert torch.equal(ops.cholesky(W, mode="ref", panel=panel), L)
    jL = jops.cholesky(jnp.asarray(W.numpy()), mode="ref", panel=panel)
    assert rel(L, jL) < 1e-5
