"""The port's spec functions against the reference's ``jax.eval_shape``:
``param_specs`` of all ten architectures at published widths, the cache
and input specs of a few cells, and the dry run's ``active_params`` and
``model_flops``. Every spec is a meta tensor: nothing allocated, nothing
drawn."""
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro.models import api as ref_api  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core.pytree import leaves_with_path  # noqa: E402
from repro_torch.models import api as port_api  # noqa: E402
from _torch_parity import reference_dryrun  # noqa: E402

@pytest.fixture
def ref_dryrun():
    with reference_dryrun() as dryrun:
        yield dryrun


def _ref_leaves(tree):
    return [("/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                      for k in path), tuple(x.shape), str(x.dtype))
            for path, x in jax.tree_util.tree_leaves_with_path(tree)]


def _port_leaves(tree):
    out = []
    for path, x in leaves_with_path(tree):
        assert x.is_meta, path
        out.append(("/".join(str(k) for _, k in path), tuple(x.shape),
                    str(x.dtype).replace("torch.", "")))
    return out


@pytest.mark.parametrize("arch", configs.list_archs())
def test_param_specs_match_the_reference(arch):
    state = torch.random.get_rng_state()
    got = port_api.get_api(configs.get_config(arch)).param_specs()
    assert torch.equal(torch.random.get_rng_state(), state)
    want = ref_api.get_api(ref_configs.get_config(arch)).param_specs()
    assert _port_leaves(got) == _ref_leaves(want)


CELLS = {"train_prefill": [("llama3.2-3b", "train", 4096, 8),
                           ("whisper-base", "train", 4096, 2),
                           ("pixtral-12b", "prefill", 512, 2)],
         "decode": [("whisper-base", "decode", 32768, 4),
                    ("jamba-v0.1-52b", "decode", 4096, 2),
                    ("gemma2-2b", "decode", 8192, 1)]}


@pytest.mark.parametrize("group", sorted(CELLS))
def test_input_and_cache_specs_match_the_reference(group):
    for arch, kind, seq, batch in CELLS[group]:
        cfg, rcfg = configs.get_config(arch), ref_configs.get_config(arch)
        got = port_api.make_input_specs(cfg, kind=kind, seq=seq, batch=batch)
        want = ref_api.make_input_specs(rcfg, kind=kind, seq=seq,
                                        batch=batch)
        assert _port_leaves(got) == _ref_leaves(want), (arch, kind)
        if kind == "decode":
            enc = cfg.enc_seq if cfg.family in ("encdec", "audio") else 0
            assert _port_leaves(port_api.lm.cache_specs(
                cfg, batch, 64, enc_len=enc)) == _ref_leaves(
                    ref_api.lm.cache_specs(rcfg, batch, 64, enc_len=enc))


def test_active_params_and_model_flops_match_the_reference(ref_dryrun):
    from repro_torch.configs.shapes import SHAPES
    from repro_torch.launch import dryrun
    for arch in configs.list_archs():
        got = dryrun.active_params(
            port_api.get_api(configs.get_config(arch)).param_specs(),
            configs.get_config(arch))
        want = ref_dryrun.active_params(
            ref_api.get_api(ref_configs.get_config(arch)).param_specs(),
            ref_configs.get_config(arch))
        assert got == want, arch
    total, active = dryrun.active_params(
        port_api.get_api(configs.get_config("qwen3-moe-235b-a22b"))
        .param_specs(), configs.get_config("qwen3-moe-235b-a22b"))
    assert 2.1e11 < total < 2.5e11 and 1.5e10 < active < 3.0e10
    for arch in ("whisper-base", "llama3-8b", "qwen3-moe-30b-a3b"):
        for shape in SHAPES.values():
            got = dryrun.model_flops(configs.get_config(arch), shape.kind,
                                     shape.seq, shape.batch, 123_456_789)
            want = ref_dryrun.model_flops(ref_configs.get_config(arch),
                                          shape.kind, shape.seq, shape.batch,
                                          123_456_789)
            assert np.float64(got) == np.float64(want), (arch, shape.name)
