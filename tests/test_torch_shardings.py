"""The port's sharding rules (``launch/shardings.py``) against the
reference's: every parameter rule of ``tests/test_shardings.py``, the
EP-over-data layout, and the batch, input and cache specs over small
meshes. The reference's functions build ``NamedSharding``s, which need
as many JAX devices as mesh positions; the tests swap in a stand-in that
returns the spec, so its rules run as they are on any mesh shape."""
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import torch  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro.launch import shardings as ref  # noqa: E402
from repro.models import api as ref_api  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core.pytree import leaves, leaves_with_path  # noqa: E402
from repro_torch.launch import shardings as port  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import api as port_api  # noqa: E402
from test_shardings import CASES  # noqa: E402


class SpecMesh:
    """What the reference's rules read of a mesh: its axis names."""

    def __init__(self, axis_names):
        self.axis_names = tuple(axis_names)


@pytest.fixture
def ref_specs(monkeypatch):
    monkeypatch.setattr(ref, "NamedSharding", lambda mesh, spec: tuple(spec))


def _port_specs(tree):
    return [tuple(s.spec) for s in leaves(tree)]


def _ref_specs(tree):
    return jax.tree_util.tree_leaves(
        tree, is_leaf=lambda x: isinstance(x, tuple))


def test_param_rules():
    """The 16 cases of ``tests/test_shardings.py``: attention, dense and
    MoE MLP, router, Mamba2, embeddings, norms."""
    for path, shape, fsdp, expected in CASES:
        got = port.param_pspec(path, shape, fsdp=fsdp)
        assert got == tuple(expected), (path, shape, fsdp)
        assert got == tuple(ref.param_pspec(path, shape, fsdp=fsdp))


def test_ep_over_data_expert_layout():
    for path, shape in (("blocks/0/w_gate", (32, 16, 4096, 14336)),
                        ("blocks/0/w_down", (32, 16, 14336, 4096)),
                        ("blocks/0/w_gate", (32, 4096, 14336))):
        got = port.param_pspec(path, shape, fsdp=False, ep_over_data=True)
        want = ref.param_pspec(path, shape, fsdp=False, ep_over_data=True)
        assert got == tuple(want), path


MESHES = [((2, 4), ("data", "model")), ((2, 2, 2), ("pod", "data", "model")),
          ((4,), ("data",))]


@pytest.mark.parametrize("shape,axes", MESHES, ids=["2d", "pod", "dp"])
def test_batch_and_input_specs(shape, axes, ref_specs):
    mesh = make_mesh(shape, axes, device="meta")
    assert port.batch_spec(mesh) == tuple(ref.batch_spec(SpecMesh(axes)))
    for arch, kind, batch in (("llama3.2-3b", "train", 8),
                              ("pixtral-12b", "prefill", 4),
                              ("mamba2-1.3b", "decode", 1)):
        ispecs = port_api.make_input_specs(configs.get_smoke(arch),
                                           kind=kind, seq=32, batch=batch)
        ispecs.pop("cache", None)
        got = port.input_shardings(ispecs, mesh)
        want = ref.input_shardings(ispecs, SpecMesh(axes))
        assert _port_specs(got) == _ref_specs(want), (arch, kind)
        for (_, x), s in zip(leaves_with_path(ispecs), leaves(got)):
            assert s.shard_shape == port.shard_shape(tuple(x.shape), s.spec,
                                                     mesh)


def test_cache_specs(ref_specs):
    """Attention k/v, a gemma2 ring, Mamba2 conv/ssm states and whisper's
    cross-attention ck/cv, batch 4 and 1."""
    mesh = make_mesh((2, 2), ("data", "model"), device="meta")
    for arch in ("gemma2-2b", "jamba-v0.1-52b", "whisper-base"):
        for batch in (4, 1):
            cfg = configs.get_smoke(arch)
            enc = cfg.enc_seq if cfg.family in ("encdec", "audio") else 0
            ours = port_api.lm.cache_specs(cfg, batch, 64, enc_len=enc)
            theirs = ref_api.lm.cache_specs(ref_configs.get_smoke(arch),
                                            batch, 64, enc_len=enc)
            got = port.cache_shardings(ours, mesh)
            want = ref.cache_shardings(theirs, SpecMesh(("data", "model")))
            assert _port_specs(got) == _ref_specs(want), (arch, batch)


def test_param_and_opt_state_shardings(ref_specs):
    """A full-width tree (2 layers): the rules with FSDP, and without it
    under "auto" (5.95e8 parameters, below 1e9), each leaf's shard shape,
    and the AdamW and NGD states following their parameters (steps and
    the NGD's damping replicated)."""
    from repro_torch.optim import AdamW, NaturalGradient

    cfg = configs.get_config("llama3.2-3b").scaled(n_layers=2)
    params = port_api.get_api(cfg).param_specs()
    mesh = make_mesh((4, 8), ("data", "model"), device="meta")
    got = port.param_shardings(params, mesh)
    ref_params = ref_api.get_api(
        ref_configs.get_config("llama3.2-3b")).param_specs()
    # the reference's rules read paths and shapes; its 28-layer tree has
    # the 2-layer tree's paths, and fsdp is on for both (> 1e9 parameters
    # at 28 layers; the 2-layer tree has 5.95e8, so pass it explicitly)
    want = ref.param_shardings(ref_params, SpecMesh(("data", "model")),
                               fsdp=True)
    got_fsdp = port.param_shardings(params, mesh, fsdp=True)
    assert _port_specs(got_fsdp) == _ref_specs(want)
    assert port.tree_size(params) < 1e9
    assert all(s.spec == port.param_pspec(
        "/".join(str(k) for _, k in path), tuple(x.shape), fsdp=False)
        for (path, x), s in zip(leaves_with_path(params), leaves(got)))
    embed = params["embed"]
    assert got_fsdp["embed"].shard_shape == (embed.shape[0] // 8,
                                             embed.shape[1] // 4)
    for opt in (AdamW(3e-4), NaturalGradient(1e-3)):
        state = opt.init(params)
        osh = port.opt_state_shardings(state, got_fsdp, mesh)
        moments = (osh.mu, osh.nu) if isinstance(opt, AdamW) \
            else (osh.momentum,)
        for tree in moments:
            assert _port_specs(tree) == _port_specs(got_fsdp)
        assert osh.step.spec == ()
        # every moment leaf is fp32: a position holds 4 bytes an element
        # of its shards
        shards = sum(port.tree_size([torch.empty(s.shard_shape,
                                                 device="meta")])
                     for s in leaves(got_fsdp))
        scalars = 0 if isinstance(opt, AdamW) else 8   # NGD's λ and ratio
        assert port.sharded_bytes(state, osh) == \
            4 * len(moments) * shards + scalars
