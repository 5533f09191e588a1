"""The prefill's attention route in the torch port, on the CPU:

* the prefill takes ``ops.flash_attention`` exactly when the layer has no
  softcap, asks no ``attn_bf16`` rounding of fp32 operands, and has shapes
  ``flash_attention.supported`` accepts; everything else runs the
  blockwise attention, as the reference's model does everywhere;
* an fp32 model with ``attn_bf16=True`` rounds its prefill attention
  operands as the reference's ``bf16_operands`` does, and a head_dim the
  kernels lack (48, 96) runs: both match the JAX model's prefill.

(``tests/test_torch_kernel_rules.py`` holds the shape rule itself.)

Inputs come from fixed numpy seeds and the JAX params are carried across,
so both packages see the same numbers. Tolerances (max-abs over max-abs of
the logits below the vocab; past it both mask to −0.7·FLT_MAX): fp32
through the blockwise attention, 1e-4 (``tests/test_torch_models.py``'s
trunk tolerance: fp32 sums in another order through two layers); with
``attn_bf16``, 1e-2 — q·scale, k, v and p are rounded to bf16 in both
packages, and inputs a few fp32 ulps apart may round one bf16 ulp (2⁻⁸)
apart."""
import numpy as np
import pytest
import torch

from _torch_parity import rel
from repro_torch import configs as tconfigs
from repro_torch.core.pytree import params_from_arrays
from repro_torch.kernels.flash_attention import HEAD_DIMS
from repro_torch.models import get_api
from repro_torch.models import lm as tlm

try:
    import dataclasses

    import jax
    import jax.numpy as jnp
    from repro import configs as jconfigs
    from repro.models import lm as jlm
except ImportError:     # the GPU machine has no JAX
    jax = None

torch.set_num_threads(1)

TRUNK_TOL, BF16_TOL = 1e-4, 1e-2


def _spy(monkeypatch):
    calls = []
    real = tlm.ops.flash_attention

    def spy(*args, **kwargs):
        calls.append(kwargs)
        return real(*args, **kwargs)
    monkeypatch.setattr(tlm.ops, "flash_attention", spy)
    return calls


@pytest.mark.parametrize("arch,overrides,expect", [
    ("llama3.2-3b", {}, 2),                               # hd 16: the kernel
    ("llama3.2-3b", {"head_dim": 64}, 2),
    ("llama3.2-3b", {"head_dim": 48}, 0),                 # no kernel at hd 48
    ("llama3.2-3b", {"head_dim": 24, "n_heads": 2}, 0),
    ("llama3.2-3b", {"attn_bf16": True}, 0),              # fp32: rounds as the ref
    ("llama3.2-3b", {"attn_bf16": True, "dtype": "bfloat16"}, 2),
    ("gemma2-2b", {}, 0),                                 # softcap
    ("gemma2-2b", {"attn_softcap": None}, 4),
])
def test_prefill_routes_by_softcap_bf16_and_shape(monkeypatch, arch,
                                                  overrides, expect):
    cfg = tconfigs.get_smoke(arch).scaled(**overrides)
    calls = _spy(monkeypatch)
    p = get_api(cfg).init_params(torch.Generator().manual_seed(0))
    toks = torch.from_numpy(
        np.random.default_rng(0).integers(3, cfg.vocab, (1, 10)))
    logits, _, idx = tlm.prefill(p, cfg, toks, max_len=12)
    assert idx == 10 and torch.isfinite(logits.float()).all()
    assert len(calls) == expect


def _prefill_pair(overrides, seed):
    """(port logits, JAX logits) of one prefill of the llama smoke model
    with ``overrides``, the JAX params carried across."""
    jcfg = dataclasses.replace(jconfigs.get_smoke("llama3.2-3b"), **overrides)
    tcfg = tconfigs.get_smoke("llama3.2-3b").scaled(**overrides)
    jp = jlm.init_params(jax.random.key(seed), jcfg)
    tp = params_from_arrays(jax.device_get(jp), device="cpu")
    prompt = np.random.default_rng(seed).integers(3, jcfg.vocab, (2, 12))
    logits, _, idx = tlm.prefill(tp, tcfg, torch.from_numpy(prompt),
                                 max_len=16)
    jlogits, _, jidx = jax.jit(lambda p, t: jlm.prefill(
        p, jcfg, t, max_len=16))(jp, jnp.asarray(prompt))
    assert idx == int(jidx) == 12
    V = tcfg.vocab
    return logits[..., :V], np.asarray(jlogits)[..., :V]


@pytest.mark.parametrize("seed", [5, 6])
def test_attn_bf16_fp32_prefill_matches_jax(monkeypatch, seed):
    """C3: the reference passes ``bf16_operands=cfg.attn_bf16``; the port's
    fp32 model with the flag takes the blockwise attention with the same
    rounding, not the kernel."""
    calls = _spy(monkeypatch)
    logits, jlogits = _prefill_pair({"attn_bf16": True}, seed)
    assert not calls
    assert logits.dtype == torch.float32
    assert rel(logits, jlogits) < BF16_TOL
    # the flag acts: the same model without it gives other logits
    plain, _ = _prefill_pair({}, seed)
    assert not torch.equal(logits, plain)


@pytest.mark.parametrize("head_dim", [48, 96])
def test_head_dim_without_kernel_prefill_matches_jax(monkeypatch, head_dim):
    """C4: a head_dim outside ``HEAD_DIMS`` runs the blockwise attention on
    every device (on CUDA the kernel would raise) and matches the JAX
    model."""
    assert head_dim not in HEAD_DIMS
    calls = _spy(monkeypatch)
    logits, jlogits = _prefill_pair({"head_dim": head_dim}, 7)
    assert not calls
    assert rel(logits, jlogits) < TRUNK_TOL
