"""The Gram's routes and arithmetic in the torch port, on the CPU:

* ``gram.tensor_core_route`` — the rule that sends a window to the
  ``wgmma`` + TMA kernel (fp32 or bf16, row stride and base 16-byte
  aligned) or to the CUDA-core kernel: on the chip script's sweep shapes,
  for CPU and meta tensors alike, and on a view at a misaligned offset;
* the 3xTF32 split (``ref.gram_tf32_ref``, the tensor-core route's
  arithmetic emulated): big rounded to nearest, so S − big carries no
  bias; three passes hold the JAX package's plain Gram at 1e-5, one TF32
  pass over the window as it lies misses the card's 1e-4 gate;
* ``gram.gram_split`` at the tensor-core route's depth: every chunk but
  the last is a whole number of TMA boxes, and the CUDA-core route's split
  is unchanged.

Inputs come from fixed numpy seeds; no threads, no servers."""
import numpy as np
import pytest
import torch

from _torch_parity import pair, rel
from repro_torch.kernels import ops, ref
from repro_torch.kernels.gram import (ROUTES, box_columns, gram_split,
                                      tensor_core_route)

try:
    import jax.numpy as jnp  # noqa: F401  (pair() hands arrays to JAX)
    from repro.kernels import ops as jops
except ImportError:     # the GPU machine has no JAX
    jops = None

torch.set_num_threads(1)

# chip_smoke.py's SWEEP_SHAPES, with the route each takes
SWEEP = {(8, 128): (True, True), (32, 300): (True, False),
         (100, 1000): (True, True), (130, 515): (False, False),
         (1024, 100_000): (True, True), (2048, 200_000): (True, True)}
DTYPES = (torch.float32, torch.bfloat16)
# the split's shapes: the sweep, path A's Table-1 rows, path B's MLP
# blocks (examples/ngd_mlp_train.py --big: 64·512, 512, 512·512, 512, 512)
SPLIT_SHAPES = [*SWEEP, (256, 100_000), (1024, 50_000), (256, 32_768),
                (256, 512), (256, 262_144), (8, 595_344_384)]


def _route_of(S: torch.Tensor) -> bool:
    n, m = S.shape
    return tensor_core_route(n, m, S.dtype,
                             S.storage_offset() * S.element_size())


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_tensor_core_route_on_sweep_shapes(dtype):
    """The sweep covers both routes; the rule answers the same for a CPU
    tensor and a meta tensor (it never reads the device)."""
    for (n, m), want in SWEEP.items():
        expect = want[DTYPES.index(dtype)]
        assert tensor_core_route(n, m, dtype) is expect, (n, m)
        assert _route_of(torch.empty((n, m), dtype=dtype, device="meta")) \
            is expect
        if n * m <= 1 << 20:
            assert _route_of(torch.zeros((n, m), dtype=dtype)) is expect


def test_tensor_core_route_refuses_misaligned_views_and_other_dtypes():
    """A contiguous view whose data starts off a 16-byte boundary takes the
    CUDA cores, one 16 bytes in takes the tensor cores; fp16 and fp64 are
    not window dtypes."""
    n, m = 16, 256
    for dtype, es in ((torch.float32, 4), (torch.bfloat16, 2)):
        for device in ("cpu", "meta"):
            flat = torch.zeros(n * m + 64, dtype=dtype, device=device)
            for off in range(0, 64, 1):
                S = flat[off:off + n * m].view(n, m)
                assert S.is_contiguous()
                assert _route_of(S) is ((off * es) % 16 == 0), (dtype, off)
    for dtype in (torch.float16, torch.float64, torch.complex64):
        assert not tensor_core_route(n, m, dtype)
    assert not tensor_core_route(0, m, torch.float32)
    assert not tensor_core_route(n, 0, torch.float32)


def test_tf32_split_is_exact_and_unbiased():
    """big is S rounded to the nearest TF32 value (low 13 bits zero), S −
    big is exact, and TF32's reading of it leaves less than 2⁻²⁰ of |S|
    behind. What big drops has either sign: over many words it averages to
    about 0 of S, where truncating (TF32's reading of S itself) drops
    ≈ 2⁻¹² of S, always the same way — the bias that shrinks the
    diagonal."""
    rng = np.random.default_rng(5)
    S = torch.from_numpy(rng.normal(size=(40, 333)).astype(np.float32))
    S[0, :4] = torch.tensor([0.0, -0.0, 1e-30, -3.5e30])
    big, small = ref.tf32_split(S)
    for t in (big, small):
        assert torch.equal(t.view(torch.int32) & 0x1FFF,
                           torch.zeros_like(t, dtype=torch.int32))
    rest = S.double() - big.double() - small.double()
    assert float((rest.abs() - S.double().abs() * 2.0 ** -20).max()) <= 0
    live = S != 0
    drop = ((S.double() - big.double()) / S.double())[live]
    assert abs(float(drop.mean())) < 2.0 ** -16
    assert bool((drop > 0).any()) and bool((drop < 0).any())
    trunc = (S.view(torch.int32) & -8192).view(torch.float32)
    tdrop = ((S.double() - trunc.double()) / S.double())[live]
    assert float(tdrop.mean()) > 2.0 ** -13 and bool((tdrop >= 0).all())


@pytest.mark.parametrize("shape", [(64, 4000), (130, 515)])
def test_3xtf32_gram_matches_jax_plain_gram(shape):
    """The tensor-core route's fp32 arithmetic, emulated, against the JAX
    package's plain Gram (the TPU's Precision.HIGHEST): within 1e-5."""
    rng = np.random.default_rng([11, *shape])
    n, m = shape
    Sj, St = pair(rng.normal(size=shape) / np.sqrt(m))
    Wj = jops.gram(Sj, mode="ref")
    assert rel(ref.gram_tf32_ref(St), Wj) < 1e-5
    assert rel(ops.gram(St), Wj) < 1e-5


def test_one_tf32_pass_misses_the_gate():
    """One TF32 pass over the window as it lies (the tensor cores ignore
    each word's low 13 mantissa bits): ≈ 7e-4 from the plain Gram, over the
    card's 1e-4 gate (chip_smoke.py PASS_TOL), while three passes stay
    under 1e-5 on the same window."""
    rng = np.random.default_rng(13)
    Sj, St = pair(rng.normal(size=(96, 3000)) / np.sqrt(3000))
    Wj = jops.gram(Sj, mode="ref")
    assert rel(ref.gram_tf32_ref(St, passes=1), Wj) > 1e-4
    assert rel(ref.gram_tf32_ref(St, passes=3), Wj) < 1e-5


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_gram_split_whole_boxes(dtype):
    """At the tensor-core route's depth every chunk but the last is a whole
    number of TMA boxes (32 fp32 or 64 bf16 columns), so no box reads into
    the next chunk; the chunks cover m exactly once."""
    box = box_columns(dtype)
    assert box == 128 // torch.empty((), dtype=dtype).element_size()
    for n, m in SPLIT_SHAPES:
        tiles, P, chunk = gram_split(n, m, box)
        t = -(-n // 128)
        assert tiles == t * (t + 1) // 2
        assert chunk % box == 0 and (P - 1) * chunk < m <= P * chunk
        assert P * tiles * 128 * 128 * 4 <= 80e6


def test_cuda_core_split_is_unchanged():
    """The CUDA-core route keeps its stage depth of 16 and its split, so its
    bits do not move: pinned at path A's Table-1 shapes."""
    assert gram_split(1024, 100_000) == (36, 30, 3344)
    assert gram_split(256, 100_000) == (3, 348, 288)
    assert gram_split(2048, 100_000) == (136, 8, 12512)
    assert gram_split(130, 515) == gram_split(130, 515, 16) == (3, 33, 16)


def test_reset_launch_counts_clears_the_routes():
    ROUTES["wgmma"], ROUTES["cuda_cores"] = 3, 2
    ops.reset_launch_counts()
    assert ROUTES == {"wgmma": 0, "cuda_cores": 0}
    assert all(v == 0 for v in ops.launch_counts().values())
