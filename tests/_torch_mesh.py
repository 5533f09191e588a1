"""Shared settings of the sharded-trainer parity tests
(``test_torch_mesh_train.py``, ``test_torch_mesh_trainer.py``): the SMOKE
LM, its batch and the tolerances of ``tests/test_torch_trainer.py`` —
losses 1e-4 relative, params after 3 steps ``rtol = atol = 5e-3`` (exact
NGD at λ = 1e-2) — and the solver tests' rtol 1e-4 / atol 1e-5 for a
bare solve. JAX is imported on use, as in ``_torch_parity``."""
import numpy as np

LOSS_TOL = 1e-4
PARAM_RTOL = PARAM_ATOL = 5e-3
RTOL, ATOL = 1e-4, 1e-5
ARCH, BATCH, SEQ, STEPS, SEED, LAM, LR = "llama3.2-3b", 4, 16, 3, 0, 1e-2, 0.1


def jax_smoke_params():
    """The JAX SMOKE LM's params drawn from SEED, on the host."""
    import jax
    from repro import configs as jconfigs
    from repro.models.api import get_api as jget_api
    api = jget_api(jconfigs.get_smoke(ARCH))
    return jax.device_get(api.init_params(jax.random.key(SEED)))


def check(got, want):
    """(losses, param leaves) of the port against the reference's."""
    np.testing.assert_allclose(got[0], want[0], rtol=LOSS_TOL)
    assert len(got[1]) == len(want[1])
    for a, b in zip(got[1], want[1]):
        np.testing.assert_allclose(a, b, rtol=PARAM_RTOL, atol=PARAM_ATOL)
