"""The port's ``launch/hlo_analysis.py`` against the reference's: the same
HLO text gives the same collectives, FLOPs and HBM bytes, and the same
roofline once both take one hardware model; the port's own model is the
H100 SXM's."""
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.launch import hlo_analysis as ref  # noqa: E402
from repro_torch.launch import hlo_analysis as port  # noqa: E402
from test_dryrun import FAKE_HLO  # noqa: E402


def _matmul_chain():
    A = jax.ShapeDtypeStruct((128, 128), jnp.float32)
    return jax.jit(lambda x: (x @ x) @ x).lower(A).compile().as_text()


def _scan():
    A = jax.ShapeDtypeStruct((64, 64), jnp.float32)

    def loop(x):
        def body(c, _):
            return c @ c, None
        y, _ = jax.lax.scan(body, x, None, length=7)
        return y
    return jax.jit(loop).lower(A).compile().as_text()


def test_parse_collectives_equals_the_reference():
    assert port.parse_collectives(FAKE_HLO) == ref.parse_collectives(FAKE_HLO)
    assert port.analyze_module(FAKE_HLO) == ref.analyze_module(FAKE_HLO)


@pytest.mark.parametrize("module", [_matmul_chain, _scan],
                         ids=["scan_free", "scan"])
def test_analyze_module_equals_the_reference(module):
    txt = module()
    got, want = port.analyze_module(txt), ref.analyze_module(txt)
    assert got == want
    assert got["flops"] > 0


ROOFLINE_INPUTS = [
    dict(flops=197e12, hbm_bytes=819e9, wire_bytes=0.0, model_flops=100e12,
         chips=1),
    dict(flops=1e12, hbm_bytes=1e9, wire_bytes=500e9),
    dict(flops=3.2e15, hbm_bytes=2.5e12, wire_bytes=4.0e10,
         model_flops=1.4e17, chips=256),
]


@pytest.mark.parametrize("kw", ROOFLINE_INPUTS, ids=["balanced", "wire",
                                                     "pod"])
def test_roofline_equals_the_reference_on_its_hardware(kw, monkeypatch):
    monkeypatch.setattr(port, "HW", dict(ref.HW))
    assert port.roofline(**kw) == ref.roofline(**kw)


def test_hardware_model_is_the_h100_sxm():
    """NVIDIA's H100 SXM data sheet: 989 TFLOP/s dense bf16, 3.35 TB/s,
    NVLink 4 at 450 GB/s each way; the roofline's keys are the
    reference's."""
    assert port.HW["peak_flops"] == 989e12
    assert port.HW["hbm_bw"] == 3.35e12
    assert port.HW["ici_bw"] == 450e9
    kw = ROOFLINE_INPUTS[0]
    got = port.roofline(**kw)
    assert set(got) == set(ref.roofline(**kw))
    assert got["t_memory_s"] == pytest.approx(819e9 / 3.35e12)
    assert got["t_compute_s"] == pytest.approx(197e12 / 989e12)
    assert port.DTYPE_BYTES == ref.DTYPE_BYTES
