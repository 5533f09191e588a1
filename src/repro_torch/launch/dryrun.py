"""Dry run of the port's own steps (port of ``repro/launch/dryrun.py``):
every (arch × shape × mesh) cell, and the paper-scale solver, run once on
``meta`` tensors, and the record the reference writes — memory, cost,
collectives, roofline — filled from what the trace allocates, computes,
moves and exchanges. Nothing is allocated on any device and no kernel is
built: it runs on a machine without a card.

Where the reference lowers and compiles each cell with XLA on 512
placeholder devices and reads ``memory_analysis()`` and the HLO text, the
port runs its own step (``launch/train.py``'s factories, or
``ops.chol_solve_fused`` over a ``ShardedScores``) with every tensor on
the meta device and every mesh position on it too, and watches it:

* memory — ``argument_bytes``: what one position holds as the step's
  arguments under the port's layout (``"layout": "replicated"``: every
  parameter and the optimizer state on each position, the batch split
  over the DP positions where the step splits it, a solver's column slab
  of S and v); beside it ``sharded_argument_bytes``, what the rules of
  ``launch/shardings.py`` would give one position. ``peak_bytes``: the
  high-water mark of the live bytes the step allocates beyond its
  arguments (a ``TorchDispatchMode`` over each output's storage, freed
  when the storage dies). One process drives every position, so this is
  all positions' allocations on one device: exact for a mesh of one
  position, an upper bound for one position of a larger mesh.
  ``resident_bytes`` = argument + peak, as the reference's. ``temp_bytes``:
  every byte the step allocates, without liveness; ``output_bytes``: the
  step's results;
* cost — ``flops``: ``torch.utils.flop_counter.FlopCounterMode`` plus
  the operations each kernel's wrapper records on the meta route
  (``kernels._build.would_launch``: the counts of the kernels' bounds);
  ``hbm_bytes``: each op's operand and result bytes (views and bare
  allocations move nothing), plus each kernel's. Both are the trace's
  totals over the positions: the mean a position. ``kernels``: the
  would-be launches, operations and bytes by wrapper. XLA's own totals
  (``xla_*_lower_bound``) have no counterpart: ``None``;
* collectives — the port's ``psum``, ``all_gather`` and ``ppermute``
  (and the train step's DP gradient sum), counted by
  ``launch.mesh.counting_collectives`` with the reference's ring rule;
* ``compile_s`` — the seconds the meta trace took.

Usage:
  python -m repro_torch.launch.dryrun --arch gemma2-9b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --arch whisper-base --shape train_4k --optimizer ngd
  python -m repro_torch.launch.dryrun --solver 4096 1000000 --mesh multi
  python -m repro_torch.launch.dryrun --all --mesh both     # every cell, in process
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import pathlib
import re
import sys
import time
import weakref
from typing import Any, Callable, NamedTuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import configs
from repro_torch.configs.paper import DAMPING
from repro_torch.configs.shapes import SHAPES, applicable
from repro_torch.core.distributed import ShardedScores
from repro_torch.core.pytree import leaves, leaves_with_path
from repro_torch.kernels import _build, ops
from repro_torch.launch import hlo_analysis
from repro_torch.launch.mesh import (MODEL, Mesh, counting_collectives,
                                     dp_axes, make_production_mesh)
from repro_torch.launch.shardings import (P, cache_shardings,
                                          input_shardings,
                                          opt_state_shardings,
                                          param_shardings, sharded_bytes,
                                          shard_shape, tree_size)
from repro_torch.models.api import get_api, make_input_specs

__all__ = ["ART", "MODEL", "P", "SHAPES", "active_params", "analyze_cell",
           "applicable", "build_cell", "build_solver_cell", "get_api",
           "main", "make_input_specs", "make_production_mesh", "model_flops",
           "param_shardings", "run_cell", "tree_size"]

ART = pathlib.Path(os.environ.get("REPRO_ART", "artifacts")) / "dryrun"
META = torch.device("meta")


def active_params(param_specs, cfg) -> tuple[int, int]:
    """(total, active) parameter counts; MoE experts scaled by top_k/E."""
    total = active = 0
    for path, leaf in leaves_with_path(param_specs):
        n = leaf.numel()
        total += n
        key = "/".join(str(k) for _, k in path)
        if leaf.ndim == 4 and re.search(r"w_(gate|up|down)$", key):
            n = int(n * cfg.top_k / max(cfg.n_experts, 1))
        active += n
    return total, active


def model_flops(cfg, kind: str, seq: int, batch: int, n_active: int) -> float:
    tokens = batch * (seq if kind in ("train", "prefill") else 1)
    if cfg.family in ("encdec", "audio"):
        tokens = batch * (min(seq, cfg.max_target_positions)
                          if kind in ("train", "prefill") else 1)
    mult = 6 if kind == "train" else 2
    return float(mult) * n_active * tokens


def _apply_overrides(cfg, overrides: dict):
    if not overrides:
        return cfg
    typed = {}
    for k, v in overrides.items():
        cur = getattr(cfg, k)
        if isinstance(cur, bool):
            typed[k] = v in ("1", "true", "True")
        elif isinstance(cur, int):
            typed[k] = int(v)
        elif isinstance(cur, float):
            typed[k] = float(v)
        else:
            typed[k] = v
    return dataclasses.replace(cfg, **typed)


# ---------------------------------------------------------------------------
# the cells
# ---------------------------------------------------------------------------

class Cell(NamedTuple):
    """One cell ready to trace: ``run()`` takes one step on ``args`` (the
    meta tensors the step holds as arguments); ``argument_bytes`` and
    ``sharded_argument_bytes`` are one position's under the replicated
    layout and under ``launch/shardings.py``'s rules."""
    run: Callable[[], Any]
    args: Any
    meta: dict
    argument_bytes: int
    sharded_argument_bytes: int


def _bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in leaves(tree)
               if isinstance(t, torch.Tensor))


def _dp_size(mesh: Mesh) -> int:
    count = 1
    for a in dp_axes(mesh):
        count *= mesh.shape[a]
    return count


def build_cell(arch: str, shape, mesh: Mesh, *, optimizer="adamw",
               overrides=None, ngd_opts=None, variant="baseline") -> Cell:
    """One (arch × shape) cell of the port's step over ``mesh``, its
    arguments on the meta device. ``shape`` is a name of ``SHAPES`` or a
    ``WorkloadShape``. Train cells run ``make_train_step`` (AdamW) or
    ``make_ngd_train_step`` (NGD, Algorithm 1 on the kernels); prefill
    ``make_prefill``; decode ``make_serve_step`` at the cache's last
    position. A mesh of one position is the one-device path."""
    overrides = dict(overrides or {})
    fsdp = overrides.pop("fsdp", "auto")      # the rules' knob, not cfg
    if fsdp != "auto":
        fsdp = fsdp in ("1", "true", "True")
    overrides.pop("donate", None)             # no donation in eager PyTorch
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    base = configs.get_tuned(arch, kind=shape.kind) \
        if variant == "tuned" else configs.get_config(arch)
    if variant == "tuned" and base.moe_ep_over_data and fsdp == "auto":
        fsdp = False            # EP-over-data pairs with replicated attn
    cfg = _apply_overrides(base, overrides)
    api = get_api(cfg)
    params = api.param_specs()
    ispecs = make_input_specs(cfg, kind=shape.kind, seq=shape.seq,
                              batch=shape.batch)
    n_total, n_active = active_params(params, cfg)
    meta = {"arch": arch, "shape": shape.name, "kind": shape.kind,
            "seq": shape.seq, "batch": shape.batch, "optimizer": optimizer,
            "params_total": n_total, "params_active": n_active,
            "model_flops": model_flops(cfg, shape.kind, shape.seq,
                                       shape.batch, n_active)}
    pshard = param_shardings(params, mesh, fsdp=fsdp,
                             ep_over_data=cfg.moe_ep_over_data)
    sharded = sharded_bytes(params, pshard)
    step_mesh = mesh if mesh.size > 1 else None

    from repro_torch.launch import train as T
    if shape.kind == "train":
        if optimizer == "ngd":
            from repro_torch.optim import NaturalGradient
            opt = NaturalGradient(1e-3, damping=DAMPING,
                                  solver=ops.chol_solve_fused)
            ngd_opts = ngd_opts or {}
            dtype = ngd_opts.get("score_dtype")
            step = T.make_ngd_train_step(
                api, opt, step_mesh, score_chunk=min(32, shape.batch),
                score_dtype=getattr(torch, dtype) if dtype else None,
                score_sharding=ngd_opts.get("score_sharding", "1d"),
                flat_scores=bool(ngd_opts.get("replicate_model")))
        else:
            from repro_torch.optim import AdamW
            opt = AdamW(3e-4)
            step = T.make_train_step(api, opt, mesh=step_mesh)
        opt_state = opt.init(params)
        args = (params, opt_state, ispecs)
        # the step splits the batch over the DP positions (a MoE model's
        # gradient takes it whole on the first)
        split = step_mesh is not None and not cfg.n_experts
        held = _bytes(params) + _bytes(opt_state) \
            + _bytes(ispecs) // (_dp_size(mesh) if split else 1)
        sharded += sharded_bytes(opt_state, opt_state_shardings(
            opt_state, pshard, mesh))
        sharded += sharded_bytes(ispecs, input_shardings(ispecs, mesh))

        def run():
            return step(*args)
    elif shape.kind == "prefill":
        prefill = T.make_prefill(api)
        batch = dict(ispecs)
        if cfg.family == "vlm":
            # the port's prefill raises unless max_len counts the prefix
            batch["max_len"] = cfg.n_patches + shape.seq + 1
        args = (params, batch)
        held = _bytes(params) + _bytes(ispecs)
        sharded += sharded_bytes(ispecs, input_shardings(ispecs, mesh))

        def run():
            return prefill(*args)
    else:
        serve_step = T.make_serve_step(api)
        cache = ispecs["cache"]
        # the step at the cache's last position (a Python int in the port)
        index = (min(shape.seq, cfg.max_target_positions)
                 if cfg.family in ("encdec", "audio") else shape.seq) - 1
        args = (params, cache, index, ispecs["tokens"])
        held = _bytes(params) + _bytes(cache) + _bytes(ispecs["tokens"])
        sharded += sharded_bytes(cache, cache_shardings(cache, mesh))
        sharded += sharded_bytes(ispecs["tokens"], input_shardings(
            ispecs["tokens"], mesh))

        def run():
            return serve_step(*args)
    return Cell(run, args, meta, held, sharded)


def build_solver_cell(n: int, m: int, mesh: Mesh) -> Cell:
    """Paper-scale solver: Algorithm 1 (``ops.chol_solve_fused``) on an
    (n, m) fp32 score matrix held as column slabs over the model axis
    (``ShardedScores``, the RVB+23 layout), v split the same way."""
    cols = mesh.shape.get(MODEL, 1)
    S = torch.empty((n, m), dtype=torch.float32, device=META)
    v = torch.empty((m,), dtype=torch.float32, device=META)
    slabs = torch.tensor_split(S, cols, dim=1) if cols > 1 else (S,)
    scores = ShardedScores([[s.contiguous()] for s in slabs], blocked=False)
    meta = {"arch": f"solver_n{n}_m{m}", "shape": "paper", "kind": "solver",
            "seq": n, "batch": m, "optimizer": "chol",
            "params_total": m, "params_active": m,
            "model_flops": float(n) * n * m + n ** 3 / 3 + 2.0 * n * m}
    widest = -(-m // cols)
    held = n * widest * 4 + widest * 4
    sharded = 4 * (n * shard_shape((n, m), P(None, MODEL), mesh)[1]
                   + shard_shape((m,), P(MODEL), mesh)[0])

    def run():
        return ops.chol_solve_fused(scores, v, DAMPING)
    return Cell(run, (scores.slabs, v), meta, held, sharded)


# ---------------------------------------------------------------------------
# the trace
# ---------------------------------------------------------------------------

class _Watch(TorchDispatchMode):
    """Live and total bytes of the meta storages the ops create (the
    arguments' are known beforehand and not counted), and the operand and
    result bytes of each op that moves data."""

    _FREE = {"empty", "empty_strided", "empty_like", "new_empty",
             "new_empty_strided", "detach", "lift_fresh"}

    def __init__(self, args):
        super().__init__()
        self.known = {id(t.untyped_storage()) for t in leaves(args)
                      if isinstance(t, torch.Tensor)}
        self.live = self.peak = self.total = 0
        self.hbm = 0.0

    def _gone(self, key, nbytes):
        self.known.discard(key)
        self.live -= nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)
                and t.is_meta]
        for t in outs:
            st = t.untyped_storage()
            key = id(st)
            if key in self.known:
                continue
            self.known.add(key)
            n = st.nbytes()
            self.live += n
            self.total += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._gone, key, n)
        name = func.overloadpacket.__name__
        if not (func.is_view or name in self._FREE):
            ins = [t for t in tree_leaves((args, kwargs))
                   if isinstance(t, torch.Tensor) and t.is_meta]
            self.hbm += sum(t.numel() * t.element_size() for t in ins + outs)
        return out


def analyze_cell(cell: Cell, mesh: Mesh) -> dict:
    """Trace ``cell`` once on the meta device; the reference's record."""
    chips = mesh.size
    _build.reset_would_launch()
    t0 = time.time()
    with counting_collectives() as coll, FlopCounterMode(display=False) as fc:
        watch = _Watch(cell.args)
        with watch:
            out = cell.run()
        out_bytes = _bytes(out)
        del out
    trace_s = time.time() - t0
    kernels = _build.would_launch_counts()
    flops = (fc.get_total_flops()
             + sum(k["flops"] for k in kernels.values())) / chips
    hbm = (watch.hbm + sum(k["bytes"] for k in kernels.values())) / chips
    for c in list(coll):
        coll[c] = {"count": coll[c]["count"], "bytes": int(coll[c]["bytes"]),
                   "wire_bytes": int(coll[c]["wire_bytes"])}
    coll["total_bytes"] = sum(c["bytes"] for c in coll.values())
    coll["total_wire_bytes"] = sum(c["wire_bytes"] for c in coll.values()
                                   if isinstance(c, dict))
    roof = hlo_analysis.roofline(
        flops=flops, hbm_bytes=hbm,
        wire_bytes=float(coll["total_wire_bytes"]),
        model_flops=cell.meta["model_flops"], chips=chips)
    return {
        **cell.meta,
        "mesh_shape": dict(mesh.shape),
        "chips": chips,
        "compile_s": round(trace_s, 2),
        "memory": {
            "argument_bytes": cell.argument_bytes,
            "output_bytes": out_bytes,
            "temp_bytes": watch.total,
            "peak_bytes": watch.peak,
            "resident_bytes": cell.argument_bytes + watch.peak,
            "layout": "replicated",
            "sharded_argument_bytes": cell.sharded_argument_bytes,
        },
        "cost": {"flops": flops, "hbm_bytes": hbm,
                 "xla_flops_lower_bound": None,
                 "xla_bytes_lower_bound": None,
                 "kernels": kernels},
        "collectives": coll,
        "roofline": roof,
    }


def _meta_mesh(mesh_kind: str) -> Mesh:
    return make_production_mesh(multi_pod=(mesh_kind == "multi"),
                                device=META)


def run_cell(arch, shape_name, mesh_kind, optimizer="adamw",
             solver_nm=None, overrides=None, ngd_opts=None,
             variant="baseline") -> dict:
    mesh = _meta_mesh(mesh_kind)
    if solver_nm:
        cell = build_solver_cell(*solver_nm, mesh)
    else:
        cell = build_cell(arch, shape_name, mesh, optimizer=optimizer,
                          overrides=overrides, ngd_opts=ngd_opts,
                          variant=variant)
    rec = analyze_cell(cell, mesh)
    rec["mesh"] = mesh_kind
    rec["variant"] = variant
    if overrides:
        rec["overrides"] = overrides
    if ngd_opts:
        rec["ngd_opts"] = ngd_opts
    return rec


def _cell_id(rec):
    tag = f"{rec['arch']}__{rec['shape']}__{rec['mesh']}"
    if rec["optimizer"] == "ngd":
        tag += "__ngd"
    return tag


def _write(rec, out: pathlib.Path, tag: str) -> None:
    (out / f"{tag}.json").write_text(json.dumps(rec, indent=1))
    m = rec["memory"]
    r = rec["roofline"]
    print(f"{tag}: compile={rec['compile_s']}s "
          f"peak/dev={m['peak_bytes'] / 2**30:.2f}GiB "
          f"args/dev={m['argument_bytes'] / 2**30:.2f}GiB "
          f"flops/dev={rec['cost']['flops']:.3e} "
          f"roofline=[{r['t_compute_s']:.4f}, {r['t_memory_s']:.4f}, "
          f"{r['t_collective_s']:.4f}]s dominant={r['dominant']}",
          flush=True)


def _tuned_args(optname: str) -> dict:
    """The tuned variant's NGD schedule, as the reference's ``--all``."""
    if optname != "ngd":
        return {}
    return {"ngd_opts": {"score_sharding": "2d", "score_dtype": None,
                         "replicate_model": True},
            "overrides": {"attn_seq_shard": "false", "attn_bf16": "false"}}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=configs.list_archs())
    ap.add_argument("--shape", choices=sorted(SHAPES))
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--optimizer", choices=["adamw", "ngd"],
                    default="adamw")
    ap.add_argument("--solver", nargs=2, type=int, metavar=("N", "M"))
    ap.add_argument("--all", action="store_true",
                    help="run every applicable cell, one after another in "
                    "this process")
    ap.add_argument("--out", default=str(ART))
    ap.add_argument("--override", action="append", default=[],
                    metavar="K=V", help="ModelConfig field override "
                    "(perf levers, e.g. remat=full ssd_factored=true)")
    ap.add_argument("--ngd-score-sharding", choices=["1d", "2d"],
                    default="1d")
    ap.add_argument("--ngd-score-dtype", default=None,
                    choices=[None, "bfloat16", "float32"])
    ap.add_argument("--ngd-replicate-model", action="store_true")
    ap.add_argument("--tag", default="",
                    help="suffix for the output JSON (hillclimb variants)")
    ap.add_argument("--variant", choices=["baseline", "tuned"],
                    default="baseline",
                    help="tuned = CONFIG + confirmed levers")
    args = ap.parse_args(argv)
    out = pathlib.Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    if args.all:
        cells = []
        for arch in configs.list_archs():
            cfg = configs.get_config(arch)
            for sname in SHAPES:
                if applicable(cfg, sname):
                    for mk in meshes:
                        cells.append((arch, sname, mk, "adamw"))
        # the NGD showcase cells: whisper-base train
        for mk in meshes:
            cells.append(("whisper-base", "train_4k", mk, "ngd"))
        failures = []
        t_all = time.time()
        for arch, sname, mk, optname in cells:
            tag = f"{arch}__{sname}__{mk}" + ("__ngd" if optname == "ngd"
                                              else "")
            kw = {}
            if args.variant == "tuned":
                tag += "__tuned"
                kw = _tuned_args(optname)
            if (out / f"{tag}.json").exists():
                print(f"[skip cached] {tag}")
                continue
            print(f"[run] {tag}", flush=True)
            t0 = time.time()
            try:
                rec = run_cell(arch, sname, mk, optimizer=optname,
                               variant=args.variant, **kw)
            except Exception as e:      # report the cell, go on to the next
                failures.append((tag, repr(e)))
                print(f"[FAIL] {tag}: {e!r}", flush=True)
                continue
            _write(rec, out, tag)
            print(f"[done] {tag} in {time.time() - t0:.1f} s", flush=True)
        print(f"\n{len(cells) - len(failures)}/{len(cells)} cells OK in "
              f"{time.time() - t_all:.1f} s")
        if failures:
            sys.exit(1)
        return

    overrides = dict(kv.split("=", 1) for kv in args.override)
    ngd_opts = {"score_sharding": args.ngd_score_sharding,
                "score_dtype": args.ngd_score_dtype,
                "replicate_model": args.ngd_replicate_model}
    for mk in meshes:
        rec = run_cell(args.arch, args.shape, mk, optimizer=args.optimizer,
                       solver_nm=tuple(args.solver) if args.solver else None,
                       overrides=overrides, ngd_opts=ngd_opts,
                       variant=args.variant)
        tag = _cell_id(rec) + (f"__{args.tag}" if args.tag else "")
        _write(rec, out, tag)


if __name__ == "__main__":
    main()
