"""Incident forensics — deterministic offline replay + first-bad-event
bisection of a flight-recorder bundle (torch port of
``repro/obs/forensics.py``; it reads the bundles of either package).

A bundle (``repro_torch.obs.recorder.FlightRecorder``) holds a last-good
``ServeState`` snapshot and the fold-journal tail that advanced it to
the live head at capture time. Because folds and refreshes are
deterministic functions of the state they act on (the property
``FoldJournal.replay`` already trades on), replaying that tail from the
snapshot reproduces the incident's factor *bit for bit* — which turns a
production alarm into a reproducible offline experiment — on the device
that captured it: the card's kernels and the CPU's plain versions round
differently, so a card bundle replays bit for bit on the card only.

1. **replay** — drive the snapshot through the tail with the same
   ``OnlineAdaptation.fold`` / ``maybe_refresh(force=True)`` calls the
   live server made, verifying every recorded
   ``ServeState.fingerprint()`` seq by seq and the final state against
   the live fingerprint at capture.
2. **bisect** — during the same pass, re-run what the live path could
   not afford per event: the downdate margins
   drain after *every* fold, the factor audit (condest + Hutchinson
   residual) runs at ``audit_every`` (default: every event), and a
   fresh ``HealthMonitor`` evaluates the rules on each post-event
   state. The first event whose application moves the verdict off
   ``ok`` is the first bad event; the postmortem names its seq, origin
   (and tenant, when a recorded request digest matches), the offending
   value, and the rule crossed.

CLI::

    python -m repro_torch.obs.forensics <bundle.npz> [--device cpu] \
        [--json out.json]

``--device`` is where the replay runs: the card's kernels by default
(it raises without a GPU), ``--device cpu`` the plain versions. Replay
a bundle on the kind of device that captured it.

Exit status 0 when the replay is bit-identical to the live state at
capture, 1 otherwise (a non-deterministic replay means the bundle does
not explain the incident — usually a snapshot/journal version skew).
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.device import resolve_device

__all__ = ["IncidentBundle", "load_bundle", "analyze", "format_postmortem",
           "main"]


class IncidentBundle(NamedTuple):
    """One loaded incident bundle: capture metadata, the reconstructed
    last-good state, and the journal tail (absolute seqs)."""
    path: str
    meta: dict
    state: object          # ServeState at meta["snap_seq"]
    journal: object        # FoldJournal tail, base == snap_seq


def load_bundle(path, *, device=None) -> IncidentBundle:
    """Read one recorder npz (of either package) back into live objects;
    the state goes to ``device`` (CUDA by default), the journal's rows
    stay on the host until a fold places them."""
    from repro_torch.checkpoint.fleet import load_npz_bundle
    from repro_torch.serve.journal import FoldEvent, FoldJournal
    from repro_torch.serve.state import serve_state_from_arrays

    arrays, meta = load_npz_bundle(path)
    snap = {k[len("snap_"):]: v for k, v in arrays.items()
            if k.startswith("snap_")}
    state = serve_state_from_arrays(snap, meta["state"], device=device)

    events: List[FoldEvent] = []
    for e in meta["journal"]["events"]:
        blocks = []
        for b in range(int(e["n_blocks"])):
            a = np.array(arrays[f"ev{e['seq']}_b{b}"])
            if e.get("dtypes", [None] * (b + 1))[b] == "bfloat16":
                blocks.append(torch.from_numpy(a.view(np.int16))
                              .view(torch.bfloat16))
            else:
                blocks.append(torch.from_numpy(a))
        rows = None if not blocks else \
            (blocks[0] if len(blocks) == 1 else tuple(blocks))
        events.append(FoldEvent(seq=int(e["seq"]), kind=e["kind"],
                                slots=tuple(int(s) for s in e["slots"]),
                                rows=rows, origin=e.get("origin")))
    journal = FoldJournal(events, base=int(meta["journal"]["base"]),
                          base_k=int(meta.get("base_k", 0)))
    return IncidentBundle(path=str(path), meta=meta, state=state,
                          journal=journal)


def analyze(bundle: IncidentBundle, *, audit_every: int = 1,
            rules=None) -> dict:
    """Replay + verify + bisect in one pass, on the bundle's state's
    device; returns the postmortem.

    ``audit_every``: factor-audit cadence in replayed events (offline we
    default to every event — the O(n²) audit the live path rations is
    free here). ``rules``: optional HealthRule override (default:
    ``obs.health.default_rules``)."""
    from repro_torch.obs.health import HealthMonitor
    from repro_torch.obs.metrics import MetricsRegistry
    from repro_torch.serve.adapt import OnlineAdaptation

    meta = bundle.meta
    reg = MetricsRegistry()
    mon = HealthMonitor(reg, rules=rules)
    ad = OnlineAdaptation(refresh_every=10 ** 9, drift_tol=None,
                          drift_frac=None,
                          jitter=float(meta.get("jitter", 0.0)),
                          registry=reg, health=mon,
                          audit_every=max(int(audit_every), 0))
    if meta.get("fifo_n") is not None:
        # a window padded in its sample axis: fold at the logical modulus
        ad.fifo_n = int(meta["fifo_n"])

    # request digests let the postmortem name the tenant behind an event
    # origin ("req<uid>" — the dispatcher's fold-event tag)
    tenant_of = {}
    for d in meta.get("requests", []) or []:
        tenant_of[f"req{d['uid']}"] = d.get("tenant")

    fps = {int(f["seq"]): f for f in meta.get("fingerprints", [])
           if int(f["seq"]) >= int(meta["snap_seq"])}
    state = bundle.state
    timeline: List[dict] = []
    first_bad: Optional[dict] = None
    fp_checked = fp_ok = 0

    def check_fp(seq: int, st) -> Optional[bool]:
        nonlocal fp_checked, fp_ok
        rec = fps.get(seq)
        if rec is None:
            return None
        ok = st.fingerprint(full=rec.get("full", True)) == rec["digest"]
        fp_checked += 1
        fp_ok += bool(ok)
        return ok

    check_fp(int(meta["snap_seq"]), state)
    for ev in bundle.journal.events:
        if ev.kind == "fold":
            state = ad.fold(state, ev.rows, slots=ev.slots, record=False)
        else:
            state, _ = ad.maybe_refresh(state, force=True, record=False)
        if state.L.is_cuda:
            torch.cuda.synchronize(state.L.device)
        if ev.kind == "fold":
            # the maintenance boundary the live loop runs after folds:
            # drains the downdate aux (ready after the sync above),
            # ticks the audit cadence, evaluates the rules. force=False
            # with the thresholds disabled above — pure observation.
            state, _ = ad.maybe_refresh(state, record=False)
        verdict = mon.verdict()
        gauges = reg.snapshot().get("gauges", {})
        row = {"seq": ev.seq, "kind": ev.kind, "origin": ev.origin,
               "verdict": verdict,
               "margin": gauges.get("curvature.downdate_margin"),
               "condest": gauges.get("curvature.condest")}
        ok = check_fp(ev.seq + 1, state)
        if ok is not None:
            row["fingerprint_ok"] = bool(ok)
        if first_bad is None and verdict != "ok":
            rep = mon.report()
            rule_name, rule_ev = _worst_active(rep["active"])
            first_bad = {"seq": int(ev.seq), "kind": ev.kind,
                         "origin": ev.origin,
                         "tenant": tenant_of.get(ev.origin),
                         "verdict": verdict, "rule": rule_name,
                         "series": rule_ev.get("series"),
                         "value": rule_ev.get("value"),
                         "bound": rule_ev.get("bound"),
                         "recommendation": rule_ev.get("recommendation")}
        timeline.append(row)

    replay_fp = state.fingerprint()
    return {
        "bundle": bundle.path,
        "reason": meta.get("reason"),
        "captured_verdict": meta.get("verdict"),
        "origin": meta.get("origin"),
        "snap_seq": int(meta["snap_seq"]),
        "head_seq": int(meta["head_seq"]),
        "events_replayed": len(bundle.journal.events),
        "fingerprints_checked": fp_checked,
        "fingerprints_ok": fp_ok,
        "bit_identical": replay_fp == meta.get("live_fingerprint"),
        "live_fingerprint": meta.get("live_fingerprint"),
        "replay_fingerprint": replay_fp,
        "first_bad": first_bad,
        "timeline": timeline,
    }


def _worst_active(active: dict) -> tuple:
    """The active rule that best explains a non-ok verdict: highest
    severity, margin/downdate rules first within a severity (they name
    the event; condest/residual describe the aftermath)."""
    from repro_torch.obs.health import _RANK

    def key(item):
        name, ev = item
        return (_RANK.get(ev.get("severity"), 0),
                1 if name.startswith("downdate") else 0)

    name, ev = max(active.items(), key=key)
    return name, ev


def format_postmortem(pm: dict) -> str:
    lines = [
        f"bundle: {pm['bundle']}",
        f"capture: reason={pm['reason']} verdict={pm['captured_verdict']}"
        + (f" origin={pm['origin']}" if pm.get("origin") else ""),
        f"replay: {pm['events_replayed']} events "
        f"(seq {pm['snap_seq']} -> {pm['head_seq']}), "
        f"fingerprints {pm['fingerprints_ok']}/{pm['fingerprints_checked']}"
        f" ok, bit_identical={pm['bit_identical']}",
    ]
    fb = pm.get("first_bad")
    if fb is not None:
        val = fb.get("value")
        bound = fb.get("bound")
        lines.append(
            f"first bad event: seq={fb['seq']} kind={fb['kind']} "
            f"rule={fb['rule']} series={fb['series']} "
            f"value={'n/a' if val is None else format(val, '.6e')} "
            f"bound={'n/a' if bound is None else format(bound, '.3e')} "
            f"origin={fb.get('origin')} tenant={fb.get('tenant')} "
            f"verdict={fb['verdict']}")
        if fb.get("recommendation"):
            lines.append(f"recommendation: {fb['recommendation']}")
    else:
        lines.append("first bad event: none "
                     "(no health rule crossed during replay)")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.forensics",
        description="replay + bisect one flight-recorder incident bundle")
    ap.add_argument("bundle", help="incident_*.npz written by the recorder")
    ap.add_argument("--audit-every", type=int, default=1,
                    help="factor-audit cadence in replayed events "
                         "(default 1: every event)")
    ap.add_argument("--device", default=None,
                    help="where to replay (default: cuda, the card's "
                         "kernels; 'cpu' runs the plain versions)")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="also write the full postmortem (with the "
                         "per-event timeline) as JSON")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    pm = analyze(load_bundle(args.bundle, device=device),
                 audit_every=args.audit_every)
    print(format_postmortem(pm))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(pm, f, indent=1)
        print(f"postmortem json: {args.json}")
    return 0 if pm["bit_identical"] else 1


if __name__ == "__main__":
    sys.exit(main())
