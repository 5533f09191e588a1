"""Every subpackage of the port exports what the reference's exports.

Each port subpackage's ``__all__`` is held to the reference's: equal to it
less the names that are TPU-only by design (``*_pallas``,
``MAX_SINGLE_BLOCK_N``, ``on_tpu``, ``pad_to``, the ``jit_*`` wrappers)
and those of the launch tooling still to come (ROADMAP A9), plus the
port's own additions, listed here by name. A reference package without an
``__all__`` is held by its public names. Every exported name resolves.
``launch`` has no ``__init__`` in the reference, so its modules are held
one by one, in one case.
"""
import importlib
import types

import pytest

pytest.importorskip("jax")

SUBPACKAGES = ("checkpoint", "configs", "core", "curvature", "data", "dist",
               "fleet", "kernels", "models", "obs", "optim", "serve",
               "tenants")
LAUNCH = ("launch.mesh", "launch.supervisor", "launch.train",
          "launch.trainer")

# the launch tooling's names (configs/paper.py, the spec functions)
A9 = {"TABLE1_SHAPES", "TABLE1_TIMES_MS", "DAMPING", "param_specs",
      "cache_specs", "make_input_specs", "param_shardings",
      "input_shardings", "cache_shardings"}

# names the port exports beyond the reference's
PORT_ADDS = {
    "data": {"split_leading"},
    "dist": {"ShardedWindow", "shard_window", "sharded_serve_mode"},
    "kernels": {"default_mode", "gram_acc", "gram_blocks", "launch_counts",
                "reset_launch_counts", "trisolve"},
    "models": {"ModelAPI", "encdec", "get_api"},
    "optim": {"global_norm", "params_from_arrays", "params_to_arrays"},
    "serve": {"serve_state_arrays", "serve_state_from_arrays"},
    "launch.mesh": {"Mesh", "all_gather", "mesh_from_shape", "ppermute",
                    "psum"},
    "launch.train": {"batch_to", "make_prefill", "make_serve_step"},
}


def _tpu_only(name: str) -> bool:
    return (name.endswith("_pallas") or name.startswith("jit_")
            or name in ("MAX_SINGLE_BLOCK_N", "on_tpu", "pad_to"))


def _exports(mod) -> set:
    if hasattr(mod, "__all__"):
        return set(mod.__all__)
    return {k for k, v in vars(mod).items()
            if not k.startswith("_") and not isinstance(v, types.ModuleType)}


@pytest.mark.parametrize("package", SUBPACKAGES + ("launch",))
def test_all_matches_the_reference(package):
    for name in LAUNCH if package == "launch" else (package,):
        ref = importlib.import_module(f"repro.{name}")
        port = importlib.import_module(f"repro_torch.{name}")
        want = {n for n in _exports(ref) if not _tpu_only(n) and n not in A9}
        want |= PORT_ADDS.get(name, set())
        assert set(port.__all__) == want, name
        missing = [n for n in port.__all__ if not hasattr(port, n)]
        assert not missing, (name, missing)


def test_sharded_solvers_and_layouts_import():
    """C12: the sharded solvers from ``repro_torch.core``, the layouts
    from ``repro_torch.dist.cholupdate``, as the reference has them."""
    from repro.dist import cholupdate as ref_cholupdate
    from repro_torch.core import (make_sharded_solver,
                                  sharded_blocked_chol_solve,
                                  sharded_chol_solve, sharded_chol_solve_2d)
    from repro_torch.core import distributed
    from repro_torch.dist import cholupdate

    assert sharded_chol_solve is distributed.sharded_chol_solve
    assert sharded_chol_solve_2d is distributed.sharded_chol_solve_2d
    assert sharded_blocked_chol_solve is \
        distributed.sharded_blocked_chol_solve
    assert make_sharded_solver is distributed.make_sharded_solver
    assert cholupdate.LAYOUTS == tuple(ref_cholupdate.LAYOUTS)
