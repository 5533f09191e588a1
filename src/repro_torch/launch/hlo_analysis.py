"""HLO text analysis: trip-count-aware FLOP / HBM / collective accounting
and the roofline terms (port of ``repro/launch/hlo_analysis.py``).

The parsers are the reference's, unchanged (pure ``re``): they read the
optimized HLO text the reference's dry run writes, and the port's own dry
run (``launch/dryrun.py``) fills the same record from a meta-tensor trace
and hands its totals to ``roofline``.

How the text is read (the reference's method):

1. split the module into computations; build a symbol table (op → shape);
2. build the call graph; every computation reached through a while body
   or condition multiplies its cost by that loop's trip count (extracted
   from the loop condition's comparison constant — jax scans always lower
   to ``i < trip_count`` with i starting at 0); nested loops multiply;
3. FLOPs   = Σ dot ops: 2 · prod(result shape) · prod(contracted dims),
   × multiplier (elementwise flops are ignored — dots dominate compute);
4. HBM bytes = Σ top-level ops: output + operand bytes (fusions are the
   unit of HBM traffic; their internals stay on chip), × multiplier;
5. collective bytes by op type, × multiplier, with ring wire-traffic
   adjustment from the replica-group size.

Hardware model (``HW``): one NVIDIA H100 SXM, from NVIDIA's H100 data
sheet — 989 TFLOP/s dense bf16 on the tensor cores, 3.35 TB/s of HBM3,
and NVLink 4 at 900 GB/s both ways, 450 GB/s each way. ``roofline``
reads the first three keys; the fp32 and TF32 rates stand beside them
for the kernels' bounds (``chip_smoke.py``).
"""
from __future__ import annotations

import re
from typing import Optional

__all__ = ["analyze_module", "parse_collectives", "roofline", "HW",
           "DTYPE_BYTES"]

HW = {
    # NVIDIA H100 SXM data sheet (dense, no sparsity)
    "peak_flops": 989e12,      # bf16 FLOP/s on the tensor cores
    "hbm_bw": 3.35e12,         # bytes/s of HBM3
    "ici_bw": 450e9,           # bytes/s one way over NVLink 4 (900 GB/s both)
    "fp32_flops": 67e12,       # fp32 FLOP/s on the CUDA cores
    "tf32_flops": 494.7e12,    # dense TF32 FLOP/s on the tensor cores
}

DTYPE_BYTES = {
    "f64": 8, "f32": 4, "f16": 2, "bf16": 2, "f8e4m3fn": 1, "f8e5m2": 1,
    "s64": 8, "u64": 8, "s32": 4, "u32": 4, "s16": 2, "u16": 2,
    "s8": 1, "u8": 1, "pred": 1, "c64": 8, "c128": 16, "s4": 1, "u4": 1,
}

_COLL = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
         "collective-permute")

_COMP_HDR = re.compile(r"^(?:ENTRY\s+)?%?([\w.\-]+)\s*\(.*\)\s*->.*\{")
_OP_LINE = re.compile(r"^\s*(?:ROOT\s+)?%([\w.\-]+)\s*=\s*(.+)$")
_SHAPE = re.compile(r"\b([a-z]\d*[a-z0-9]*)\[([0-9,]*)\]")
_OPND = re.compile(r"%([\w.\-]+)")
_CALLS = re.compile(r"calls=%?([\w.\-]+)")
_WHILE = re.compile(r"condition=%?([\w.\-]+),\s*body=%?([\w.\-]+)")
_CONST_INT = re.compile(r"\b[su]\d+\[\]\s+constant\((\d+)\)")

# ops that never touch HBM themselves (plumbing / control flow / accounted
# through their callees or callers)
_FREE_OPS = {"parameter", "constant", "tuple", "get-tuple-element", "while",
             "call", "conditional", "bitcast", "after-all", "iota",
             "partition-id", "replica-id", "custom-call"}


def _shape_bytes(type_str: str) -> int:
    """Total bytes of a (possibly tuple) HLO type string."""
    total = 0
    for dt, dims in _SHAPE.findall(type_str):
        n = 1
        for d in dims.split(","):
            if d.strip():
                n *= int(d)
        total += n * DTYPE_BYTES.get(dt, 4)
    return total


class _Op:
    __slots__ = ("name", "kind", "result_type", "operands", "line")

    def __init__(self, name, kind, result_type, operands, line):
        self.name, self.kind = name, kind
        self.result_type, self.operands, self.line = result_type, operands, line


def _split_top(s: str) -> list[str]:
    """Split on top-level commas (respecting parens/brackets)."""
    parts, depth, cur = [], 0, []
    for ch in s:
        if ch in "([{":
            depth += 1
        elif ch in ")]}":
            depth -= 1
        if ch == "," and depth == 0:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    if cur:
        parts.append("".join(cur))
    return parts


def _parse_computations(txt: str):
    """-> ({comp_name: [Op]}, {op_name: result_type_str}, entry_name)."""
    comps: dict[str, list[_Op]] = {}
    symbols: dict[str, str] = {}
    entry: Optional[str] = None
    cur: Optional[str] = None
    for raw in txt.splitlines():
        line = raw.rstrip()
        hdr = _COMP_HDR.match(line.strip())
        if hdr and line.rstrip().endswith("{"):
            cur = hdr.group(1)
            comps[cur] = []
            if line.strip().startswith("ENTRY"):
                entry = cur
            # parameter shapes from the signature (tuple types contain
            # commas — split at top level only)
            sig = line[line.find("(") + 1:line.rfind(")")]
            for part in _split_top(sig):
                if ":" in part:
                    pname, ptype = part.split(":", 1)
                    symbols[pname.strip().lstrip("%")] = ptype.strip()
            continue
        if cur is None:
            continue
        if line.strip() == "}":
            cur = None
            continue
        m = _OP_LINE.match(line)
        if not m:
            continue
        name, rhs = m.group(1), m.group(2)
        # result type = leading type tokens up to the op kind word
        km = re.match(r"((?:\([^)]*\)|[a-z]\d*[a-z0-9]*\[[0-9,]*\](?:\{[^}]*\})?)\s+)([\w\-]+)\(", rhs)
        if not km:
            continue
        result_type, kind = km.group(1), km.group(2)
        # operand segment: inside the op's parentheses
        start = rhs.find(kind + "(") + len(kind) + 1
        depth, i = 1, start
        while i < len(rhs) and depth:
            if rhs[i] == "(":
                depth += 1
            elif rhs[i] == ")":
                depth -= 1
            i += 1
        opnd_str = rhs[start:i - 1]
        operands = _OPND.findall(opnd_str)
        symbols[name] = result_type
        comps[cur].append(_Op(name, kind, result_type, operands, rhs))
    if entry is None and comps:
        entry = next(iter(comps))
    return comps, symbols, entry


def _trip_count(cond_ops: list[_Op]) -> int:
    """Max scalar-int constant in the loop condition ≈ trip count (jax
    scans lower to ``i < N`` with i from 0)."""
    best = 1
    for op in cond_ops:
        for m in _CONST_INT.finditer(op.line):
            best = max(best, int(m.group(1)))
    return best


def _multipliers(comps, entry) -> dict[str, float]:
    """comp name → product of enclosing while trip counts."""
    mult = {name: 0.0 for name in comps}
    mult[entry] = 1.0
    # iterate to fixpoint (call graph is a DAG; a few passes suffice)
    for _ in range(len(comps)):
        changed = False
        for cname, ops in comps.items():
            base = mult.get(cname, 0.0)
            if base == 0.0:
                continue
            for op in ops:
                targets = []
                wm = _WHILE.search(op.line)
                if op.kind == "while" and wm:
                    cond, body = wm.group(1), wm.group(2)
                    t = _trip_count(comps.get(cond, []))
                    targets = [(cond, base * t), (body, base * t)]
                else:
                    cm = _CALLS.search(op.line)
                    if cm and cm.group(1) in comps:
                        targets = [(cm.group(1), base)]
                for tgt, val in targets:
                    if val > mult.get(tgt, 0.0):
                        mult[tgt] = val
                        changed = True
        if not changed:
            break
    return mult


def _dot_flops(op: _Op, symbols) -> float:
    out_elems = 0
    for dt, dims in _SHAPE.findall(op.result_type):
        n = 1
        for d in dims.split(","):
            if d.strip():
                n *= int(d)
        out_elems += n
    # contracted dims from the lhs operand shape
    lhs_type = symbols.get(op.operands[0], "") if op.operands else ""
    lm = _SHAPE.search(lhs_type)
    cm = re.search(r"lhs_contracting_dims=\{([0-9,]*)\}", op.line)
    k = 1
    if lm and cm:
        dims = [int(d) for d in lm.group(2).split(",") if d.strip()]
        for idx in cm.group(1).split(","):
            if idx.strip() and int(idx) < len(dims):
                k *= dims[int(idx)]
    return 2.0 * out_elems * k


def _group_size(line: str) -> int:
    g = re.search(r"replica_groups=\{\{([0-9, ]+)\}", line)
    if g:
        return len(g.group(1).split(","))
    g = re.search(r"replica_groups=\[(\d+),(\d+)\]", line)
    if g:
        return int(g.group(2))
    return 2


def analyze_module(txt: str) -> dict:
    """Trip-count-aware totals for one SPMD-partitioned module (per-device).

    Returns {"flops", "hbm_bytes", "collectives": {...}}.
    """
    comps, symbols, entry = _parse_computations(txt)
    mult = _multipliers(comps, entry)

    flops = 0.0
    hbm = 0.0
    coll = {c: {"count": 0, "bytes": 0.0, "wire_bytes": 0.0} for c in _COLL}

    fusion_comps = set()
    for ops in comps.values():
        for op in ops:
            if op.kind == "fusion":
                cm = _CALLS.search(op.line)
                if cm:
                    fusion_comps.add(cm.group(1))

    for cname, ops in comps.items():
        w = mult.get(cname, 0.0)
        if w == 0.0:
            continue
        inside_fusion = cname in fusion_comps
        for op in ops:
            if op.kind == "dot":
                flops += w * _dot_flops(op, symbols)
            if inside_fusion:
                continue            # fusion internals: no HBM traffic
            if op.kind in _FREE_OPS:
                continue
            out_b = _shape_bytes(op.result_type)
            in_b = sum(_shape_bytes(symbols.get(o, ""))
                       for o in op.operands)
            hbm += w * (out_b + in_b)

            base = op.kind.replace("-start", "")
            if base in _COLL and not op.kind.endswith("-done"):
                k = _group_size(op.line)
                nbytes = out_b
                if base == "all-reduce":
                    wire = 2 * nbytes * (k - 1) / k
                elif base in ("all-gather", "reduce-scatter", "all-to-all"):
                    wire = nbytes * (k - 1) / k
                else:
                    wire = nbytes
                coll[base]["count"] += int(w)
                coll[base]["bytes"] += w * nbytes
                coll[base]["wire_bytes"] += w * wire

    coll_total = sum(coll[c]["bytes"] for c in _COLL)
    wire_total = sum(coll[c]["wire_bytes"] for c in _COLL)
    for c in _COLL:
        coll[c]["bytes"] = int(coll[c]["bytes"])
        coll[c]["wire_bytes"] = int(coll[c]["wire_bytes"])
    coll["total_bytes"] = int(coll_total)
    coll["total_wire_bytes"] = int(wire_total)
    return {"flops": flops, "hbm_bytes": hbm, "collectives": coll}


def parse_collectives(hlo_text: str) -> dict:
    """Collective accounting only (trip-count aware)."""
    return analyze_module(hlo_text)["collectives"]


def roofline(*, flops: float, hbm_bytes: float, wire_bytes: float,
             model_flops: Optional[float] = None, chips: int = 1) -> dict:
    """Three roofline terms in seconds (inputs are PER-DEVICE quantities
    from the partitioned module, so no further division by chips).

    ``model_flops`` is the analytic 6·N·D (global) — the useful-compute
    yardstick; its ratio against compiled FLOPs exposes remat/redundancy.
    """
    t_compute = flops / HW["peak_flops"]
    t_memory = hbm_bytes / HW["hbm_bw"]
    t_coll = wire_bytes / HW["ici_bw"]
    dominant = max(
        (("compute", t_compute), ("memory", t_memory),
         ("collective", t_coll)), key=lambda kv: kv[1])[0]
    out = {
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_coll,
        "dominant": dominant,
        "bound_s": max(t_compute, t_memory, t_coll),
    }
    if model_flops is not None:
        per_dev_useful = model_flops / chips
        out["model_flops_global"] = model_flops
        out["useful_flops_ratio"] = per_dev_useful / max(flops, 1.0)
        out["mfu_at_bound"] = (per_dev_useful / max(t_compute, t_memory,
                                                    t_coll)) / HW["peak_flops"]
    return out
