"""The port's dry run (``launch/dryrun.py``), in process on meta tensors:
the solver cell's argument bytes, its peak as the kernel wrappers'
allocations, its would-be launches, the collectives of an NGD cell over
a mesh, the record's keys against the reference's record, and the CLI's
file names. A meta operand takes each kernel's wrapper (its outputs and
scratch on meta) and launches nothing."""
import json

import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs.shapes import WorkloadShape  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels.cholesky import PANEL  # noqa: E402
from repro_torch.kernels.gram import (box_columns, gram_split,  # noqa: E402
                                      tensor_core_route)
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from _torch_parity import reference_dryrun  # noqa: E402

META = torch.device("meta")
ONE = ((1, 1), ("data", "model"))


def _mesh(shape, axes):
    return make_mesh(shape, axes, device="meta")


def _solver(n, m, shape=ONE):
    mesh = _mesh(*shape)
    return dryrun.analyze_cell(dryrun.build_solver_cell(n, m, mesh), mesh)


def test_solver_argument_bytes_are_the_window_and_v():
    for n, m in ((256, 100_000), (2048, 100_000), (64, 3001)):
        rec = _solver(n, m)
        assert rec["memory"]["argument_bytes"] == n * m * 4 + m * 4
        assert rec["memory"]["resident_bytes"] == \
            rec["memory"]["argument_bytes"] + rec["memory"]["peak_bytes"]
        assert rec["chips"] == 1 and rec["collectives"]["total_bytes"] == 0


def _wrapper_peak(n: int, m: int) -> int:
    """The live bytes of ``chol_solve_fused`` over one slab, from the
    wrappers' own allocations: gram_sv's W, u and its partials; then the
    one-position psums' copies of W and u with the Cholesky's L and
    scratch; then the substitution's w and the apply's x."""
    f4 = 4
    tc = tensor_core_route(n, m, torch.float32)
    tiles, parts, _ = gram_split(n, m, box_columns(torch.float32) if tc
                                 else 16)
    W, u = n * n * f4, n * f4
    gram_sv = W + u + parts * tiles * 128 * 128 * f4 \
        + parts * -(-n // 128) * 128 * f4
    panels = -(-n // PANEL)
    chol = 2 * W + 2 * u + panels * PANEL * f4 + (panels + 2) * 4 + W
    apply = 3 * W + 2 * u + n * f4 + m * f4
    return max(gram_sv, chol, apply)


@pytest.mark.parametrize("n,m", [(256, 100_000), (1024, 100_000)])
def test_solver_peak_is_the_wrappers_allocations(n, m):
    assert _solver(n, m)["memory"]["peak_bytes"] == _wrapper_peak(n, m)


@pytest.mark.parametrize("shape", [ONE, ((1, 4), ("data", "model"))],
                         ids=["one", "model4"])
def test_solver_launches_are_chol_solve_fused(shape):
    """One gram_sv and one ngd_apply a column slab, one Cholesky and one
    substitution; the same as ``ops.chol_solve_fused`` on a whole meta S,
    and no launch counted anywhere."""
    n, m = 128, 10_000
    ops.reset_launch_counts()
    rec = _solver(n, m, shape)
    slabs = shape[0][1]
    got = {k: c["launches"] for k, c in rec["cost"]["kernels"].items()}
    assert got == {"gram_sv": slabs, "cholesky": 1, "trisolve": 1,
                   "ngd_apply": slabs}
    _build.reset_would_launch()
    x = ops.chol_solve_fused(torch.empty((n, m), device=META),
                             torch.empty((m,), device=META), 1e-3)
    assert x.is_meta and x.shape == (m,)
    whole = {k: c["launches"] for k, c in
             _build.would_launch_counts().items()}
    assert whole == {"gram_sv": 1, "cholesky": 1, "trisolve": 1,
                     "ngd_apply": 1}
    assert not any(ops.launch_counts().values())
    # the plain versions on meta allocate their own temporaries and record
    # no would-be launch
    _build.reset_would_launch()
    ops.chol_solve_fused(torch.empty((n, m), device=META),
                         torch.empty((m,), device=META), 1e-3, mode="ref")
    assert _build.would_launch_counts() == {}


def test_ngd_cell_over_a_mesh_counts_the_collectives():
    """One layer of llama3.2-3b at its widths, NGD over a (2, 2) meta mesh:
    the gradient's DP all-reduce and the Gram's and S·v's psums over the
    model axis; the score rows gathered into column slabs."""
    mesh = _mesh((2, 2), ("data", "model"))
    cell = dryrun.build_cell("llama3.2-3b",
                             WorkloadShape("tiny", "train", 32, 4), mesh,
                             optimizer="ngd", overrides={"n_layers": "1"})
    rec = dryrun.analyze_cell(cell, mesh)
    coll = rec["collectives"]
    assert coll["all-reduce"]["count"] == 3
    n = 4
    # the psums of W (n², fp32) and u (n) over two positions: 2·B·(k−1)/k
    m_grad = rec["params_total"] * 4
    assert coll["all-reduce"]["wire_bytes"] == m_grad + n * n * 4 + n * 4
    assert coll["all-gather"]["count"] >= 2
    assert coll["total_wire_bytes"] > 0
    kernels = rec["cost"]["kernels"]
    assert kernels["gram_sv"]["launches"] == 2
    assert kernels["ngd_apply"]["launches"] == 2
    assert kernels["cholesky"]["launches"] == 1
    assert rec["cost"]["flops"] > rec["model_flops"] / rec["chips"]
    assert rec["memory"]["peak_bytes"] > 0


@pytest.fixture
def ref_dryrun():
    with reference_dryrun() as dryrun:
        yield dryrun


def test_record_keys_are_the_reference_record_keys(ref_dryrun):
    """The reference's solver cell on a one-device mesh, compiled as its
    ``run_cell`` does, against the port's: the same top-level keys, every
    nested key of the reference's, and the same argument bytes."""
    n, m = 64, 512
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    lowered, meta = ref_dryrun.build_solver_lowered(n, m, mesh)
    want = ref_dryrun.compile_and_analyze(lowered, meta, mesh)
    want.update(mesh="single", variant="baseline")
    got = _solver(n, m)
    got.update(mesh="single", variant="baseline")
    assert set(got) == set(want)
    for key in ("memory", "cost", "collectives", "roofline"):
        assert set(want[key]) <= set(got[key]), key
    assert got["memory"]["argument_bytes"] == \
        want["memory"]["argument_bytes"]
    assert {k: got[k] for k in meta} == meta
    assert got["memory"]["layout"] == "replicated"
    assert got["cost"]["xla_flops_lower_bound"] is None
    json.dumps(got)


def test_cli_writes_the_reference_file_names(tmp_path, capsys):
    dryrun.main(["--solver", "64", "2048", "--mesh", "both", "--out",
                 str(tmp_path)])
    dryrun.main(["--arch", "whisper-base", "--shape", "decode_32k",
                 "--mesh", "multi", "--out", str(tmp_path)])
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "solver_n64_m2048__paper__multi.json",
        "solver_n64_m2048__paper__single.json",
        "whisper-base__decode_32k__multi.json"]
    rec = json.loads((tmp_path / "whisper-base__decode_32k__multi.json")
                     .read_text())
    assert rec["chips"] == 512 and rec["mesh"] == "multi"
    assert rec["memory"]["peak_bytes"] < 80 * 2 ** 30
    assert rec["roofline"]["dominant"] in ("compute", "memory", "collective")
    assert "whisper-base__decode_32k__multi: compile=" in \
        capsys.readouterr().out
