"""Checkpoints and the supervisor of the torch port: the step directory's
round trip, staging and pruning, its refusals, checkpoints exchanged with
the JAX package in both directions (bf16 included), the trainer's own
state, and ``train_main`` restarting from a checkpoint after an injected
failure. Restored leaves are compared bit for bit."""
import json
from typing import NamedTuple

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import ml_dtypes
from repro import checkpoint as jckpt
from repro import configs as jconfigs
from repro.models.api import get_api as jget_api
from repro_torch import configs as tconfigs
from repro_torch.checkpoint import all_steps, latest_step, restore, save
from repro_torch.core.pytree import leaves, params_from_arrays
from repro_torch.launch.supervisor import StragglerWatchdog
from repro_torch.launch.trainer import build_trainer, train_main

torch.set_num_threads(1)

ARCH = "llama3.2-3b"


class Pair(NamedTuple):
    first: torch.Tensor
    second: object = None


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "w": torch.randn((3, 5), generator=g),
        "h": torch.randn((7,), generator=g).to(torch.bfloat16),
        "blocks": [Pair(torch.arange(6, dtype=torch.int32).reshape(2, 3),
                        {"b": torch.randn((2,), generator=g), "n": None}),
                   Pair(torch.tensor(4, dtype=torch.int64))],
        "step": 11,
    }


def _bit_equal(a, b) -> bool:
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
            a.view(torch.int16) if a.dtype == torch.bfloat16 else a,
            b.view(torch.int16) if b.dtype == torch.bfloat16 else b)
    return type(a) is type(b) and a == b


def test_round_trip_nested_tree(tmp_path):
    tree = _tree()
    path = save(tmp_path, 7, tree, metadata={"arch": "x"})
    manifest = json.loads((path / "MANIFEST.json").read_text())
    assert path.name == "step_000000007"
    assert manifest["n_leaves"] == 6 and manifest["metadata"] == {"arch": "x"}
    assert manifest["treedef"].startswith("PyTreeDef({'blocks': [CustomNode(")
    assert [d["dtype"] for d in manifest["leaves"]][:3] == [
        "int32", "float32", "int64"]
    like = _tree(seed=1)
    got, meta = restore(tmp_path, 7, like)
    assert meta == {"arch": "x"}
    assert isinstance(got["blocks"][0], Pair) and got["blocks"][1].second is None
    assert all(_bit_equal(a, b) for a, b in zip(leaves(got), leaves(tree)))


def test_staging_dirs_are_ignored(tmp_path):
    save(tmp_path, 1, _tree())
    (tmp_path / "step_000000002.tmp").mkdir()     # a save cut mid-write
    (tmp_path / "step_000000003").mkdir()         # no manifest yet
    assert all_steps(tmp_path) == [1] and latest_step(tmp_path) == 1
    assert latest_step(tmp_path / "absent") is None


def test_keeps_the_last_three(tmp_path):
    for s in range(6):
        save(tmp_path, s, _tree(s))
    assert all_steps(tmp_path) == [3, 4, 5]
    got, _ = restore(tmp_path, 4, _tree())
    assert _bit_equal(got["w"], _tree(4)["w"])


def test_mismatched_tree_is_refused(tmp_path):
    save(tmp_path, 0, _tree())
    like = _tree()
    like["extra"] = torch.zeros(1)
    with pytest.raises(ValueError, match="leaves"):
        restore(tmp_path, 0, like)


def _jax_params():
    api = jget_api(jconfigs.get_smoke(ARCH))
    params = api.init_params(jax.random.key(3))
    # the embedding in bf16, as the published configs keep their params
    params["embed"] = params["embed"].astype(jnp.bfloat16)
    return jax.device_get(params)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_params_checkpoint_restores_in_the_other_package(writer, tmp_path):
    arrays = _jax_params()
    tp = params_from_arrays(arrays, device="cpu")
    if writer == "jax":
        jckpt.save(tmp_path, 2, arrays, metadata={"arch": ARCH})
        got, meta = restore(tmp_path, 2, params_from_arrays(
            jax.tree.map(np.zeros_like, arrays), device="cpu"))
        assert got["embed"].dtype == torch.bfloat16
        assert all(_bit_equal(a, b) for a, b in zip(leaves(got), leaves(tp)))
    else:
        save(tmp_path, 2, tp, metadata={"arch": ARCH})
        got, meta = jckpt.restore(tmp_path, 2,
                                  jax.tree.map(jnp.zeros_like, arrays))
        assert got["embed"].dtype == jnp.bfloat16
        for a, b in zip(jax.tree.leaves(jax.device_get(got)),
                        jax.tree.leaves(arrays)):
            assert a.dtype == b.dtype
            if b.dtype == ml_dtypes.bfloat16:
                a, b = a.view(np.uint16), b.view(np.uint16)
            np.testing.assert_array_equal(a, b)
    assert meta == {"arch": ARCH}


def test_trainer_state_round_trip(tmp_path):
    """``build_trainer``'s save/restore of the whole NGD state — params,
    momentum, damping and the streaming curvature's W and counters."""
    init_state, step_fn, save_state, restore_state, _ = build_trainer(
        tconfigs.get_smoke(ARCH), optimizer_name="ngd", lr=0.05,
        damping=0.1, batch=4, seq=16, total_steps=4, curvature="streaming",
        curvature_refresh=3, device="cpu")
    state = init_state()
    for s in range(2):
        state, _ = step_fn(state, s)
    save_state(tmp_path, 1, state)
    got = restore_state(tmp_path, 1)
    assert got["opt"].curvature.stats == state["opt"].curvature.stats
    assert (got["opt"].step, got["opt"].curvature.age) == (2, 2)
    assert all(_bit_equal(a, b) for a, b in zip(leaves(got), leaves(state)))
    _, m1 = step_fn(state, 2)
    _, m2 = step_fn(got, 2)
    assert float(m1["loss"]) == float(m2["loss"])
    assert m1["curvature_hits"] == m2["curvature_hits"] == 2


def test_supervisor_restarts_from_the_last_checkpoint(tmp_path, capsys):
    argv = ["--arch", ARCH, "--smoke", "--device", "cpu", "--optimizer",
            "ngd", "--steps", "6", "--ckpt-every", "2", "--log-every", "1"]
    losses, report = train_main(argv + [
        "--inject-failure-at", "3", "--ckpt-dir", str(tmp_path / "a")])
    clean, clean_report = train_main(argv + ["--ckpt-dir",
                                             str(tmp_path / "b")])
    assert report["restarts"] == 1 and report["completed"]
    assert clean_report["restarts"] == 0
    # steps 0–2, then step 2 again from the checkpoint after step 1, 3–5
    assert len(losses) == 7 and losses[2] == losses[3]
    np.testing.assert_array_equal(losses[:3] + losses[4:], clean)
    assert all_steps(tmp_path / "a") == [1, 3, 5]
    assert "report={'restarts': 1" in capsys.readouterr().out


def test_straggler_watchdog_flags_slow_steps():
    wd = StragglerWatchdog(factor=3.0)
    for step in range(8):
        wd.observe(step, 0.01)
    wd.observe(8, 0.02)
    wd.observe(9, 0.05)
    assert wd.straggler_steps == [9]
