"""End-to-end trainer CLI and the serving front (port of
``repro/launch/trainer.py``): config → data → optimizer → supervised loop
with checkpoint/restart, and config → model → seeded curvature window →
``SolveServer``.

    PYTHONPATH=src python -m repro_torch.launch.trainer --arch llama3.2-3b \
        --smoke --device cpu --optimizer ngd --steps 6

``--smoke`` selects the reduced config (CPU-runnable); ``--optimizer
ngd`` is the paper's damped natural gradient (Algorithm 1) end to end.
Entry points run on CUDA unless given ``device="cpu"`` / ``--device
cpu``, where the kernels' plain versions run.

``build_server`` is the reference's: the eager replicated server, or
with ``async_`` the concurrent ``AsyncSolveServer``, its window sharded
over a mesh with ``layout``; with its observability hooks, audit and
tenant manager. ``build_fleet`` is its multi-process twin: the same front,
the window shipped to ``repro_torch.fleet`` worker processes behind a
``Dispatcher``. ``build_trainer(mesh=)`` and ``train_main --mesh-shape``
train over a mesh driven from this one process (``launch.train``): a
mesh of one position is the one-device path.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.core.device import resolve_device
from repro_torch.core.pytree import leaves, params_from_arrays, tree_map
from repro_torch.data import SyntheticLM
from repro_torch.launch import train as T
from repro_torch.launch.mesh import mesh_from_shape
from repro_torch.launch.supervisor import SupervisorConfig, run_supervised
from repro_torch.models.api import get_api
from repro_torch.optim import AdamW, NaturalGradient, warmup_cosine
from repro_torch.optim.scores import flatten_like, per_sample_scores

__all__ = ["train_main", "build_trainer", "build_server", "build_fleet",
           "ServeHandles"]


def _place_params(params, dev: torch.device):
    """A parameter tree of tensors or numpy arrays (e.g. the JAX LM's,
    through ``params_from_arrays``) on ``dev``."""
    if all(isinstance(t, torch.Tensor) for t in leaves(params)):
        return tree_map(lambda t: t.to(dev), params)
    return params_from_arrays(params, device=dev)


def build_trainer(cfg, *, mesh=None, optimizer_name: str, lr: float,
                  damping: float, batch: int, seq: int, total_steps: int,
                  solver="chol", momentum: float = 0.9, score_chunk=None,
                  blocked: bool = False, curvature: str = "exact",
                  curvature_refresh: int = 10, curvature_drift_tol=None,
                  curvature_drift_frac=None, seed: int = 0, params=None,
                  device=None):
    """Returns (init_state, step_fn, save_state, restore_state, data).

    ``solver``: a name in ``repro_torch.core.SOLVERS`` or any
    ``f(S, v, λ) -> x`` — ``repro_torch.kernels.ops.chol_solve_fused``
    runs Algorithm 1 on the hand-written kernels.

    ``blocked``: NGD keeps S as per-layer BlockedScores blocks — no flat
    (n, m) score buffer is ever materialized (the paper-scale memory
    ceiling of the dense path).

    ``curvature``: "exact" re-solves the damped Fisher from scratch every
    step (the paper; the default); "streaming" carries the n×n Gram
    across steps with a full refresh every ``curvature_refresh`` steps
    (and on residual drift past ``curvature_drift_tol`` — or, when
    ``curvature_drift_frac`` is set instead, past the threshold autotuned
    from the damping schedule's trust-region ratio; the static tol
    overrides the autotune) — the O(n²·m) pass is skipped on cache-hit
    steps.

    ``mesh`` (a ``launch.mesh.Mesh``; None: one position, the one-device
    path): both steps run over it — the gradient data-parallel over its
    DP axes, and for NGD S held as column slabs over its ``model`` axis,
    Algorithm 1 (or the streaming policy) per slab on the kernels
    (``launch.train``). The parameters and the optimizer state live on
    the mesh's first device; ``device`` then must name that device or be
    None.

    ``params``: a parameter tree (tensors, or numpy arrays such as the JAX
    LM's) that ``init_state`` starts from in place of one drawn from
    ``seed``. ``device``: CUDA by default (raises without a GPU); "cpu"
    runs the plain versions. ``step_fn`` has no ``jitted``/``shardings``
    (PyTorch runs eagerly).
    """
    if mesh is not None:
        home = mesh.device()
        if device is not None and T._canonical(device) != T._canonical(home):
            raise ValueError(f"device={device!r} is not the mesh's first "
                             f"device {home}")
        device = home
    dev = resolve_device(device)
    api = get_api(cfg)
    data = SyntheticLM(cfg, batch=batch, seq=seq, seed=seed)
    sched = warmup_cosine(lr, warmup_steps=max(total_steps // 20, 1),
                          total_steps=total_steps)

    if curvature not in ("exact", "streaming", None):
        raise ValueError(f"unknown curvature mode {curvature!r}")
    if curvature == "streaming":
        if optimizer_name != "ngd":
            raise ValueError(
                "curvature='streaming' maintains the NGD damped-Fisher "
                f"factorization; it has no meaning for {optimizer_name!r}")
        if solver != "chol":
            raise ValueError(
                "curvature='streaming' replaces the Cholesky dual solve "
                f"and cannot honor solver={solver!r}; use solver='chol' "
                "or curvature='exact'")

    if optimizer_name == "ngd":
        if curvature == "streaming":
            from repro_torch.curvature import StreamingCurvature
            policy = StreamingCurvature(batch,
                                        refresh_every=curvature_refresh,
                                        drift_tol=curvature_drift_tol,
                                        drift_frac=curvature_drift_frac,
                                        device=dev)
        else:
            policy = None
        opt = NaturalGradient(sched, damping=damping, solver=solver,
                              momentum=momentum, curvature=policy)
        tstep = T.make_ngd_train_step(api, opt, mesh,
                                      score_chunk=score_chunk,
                                      blocked=blocked)
    else:
        opt = AdamW(sched)
        tstep = T.make_train_step(api, opt, mesh=mesh)

    def init_state():
        p = api.init_params(torch.Generator().manual_seed(seed), dev) \
            if params is None else _place_params(params, dev)
        return {"params": p, "opt": opt.init(p)}

    def step_fn(state, step):
        b = data.batch_at(step) if mesh is not None \
            else T.batch_to(data.batch_at(step), dev)
        new_params, opt_state, metrics = tstep(state["params"], state["opt"],
                                               b)
        return {"params": new_params, "opt": opt_state}, metrics

    def save_state(d, step, state):
        ckpt.save(d, step, state, metadata={"arch": cfg.name})

    def restore_state(d, step):
        state, _ = ckpt.restore(d, step, init_state())
        return state

    return init_state, step_fn, save_state, restore_state, data


class ServeHandles:
    """Everything the serving loop needs besides the ``SolveServer``: the
    model api, live params, the score-grad pass for adaptation batches,
    the prefill and greedy serve steps, the data source seeding synthetic
    traffic, and the parameter unravel for applying flat natural-gradient
    updates."""

    def __init__(self, *, api, params, data, score_grads, unravel):
        self.api = api
        self.params = params
        self.data = data
        self.score_grads = score_grads     # (params, batch) -> (loss, v, S)
        self.unravel = unravel             # flat (m,) -> params-shaped tree
        self.device = leaves(params)[0].device
        self._prefill = T.make_prefill(api)
        self._step = T.make_serve_step(api)

    def loss(self, batch) -> float:
        """The adaptation loss of ``batch`` under the live params (the
        value ``score_grads`` returns, without its gradients)."""
        with torch.no_grad():
            loss, _ = self.api.loss(self.params,
                                    T.batch_to(batch, self.device))
        return float(loss)

    def apply_update(self, x_flat, *, lr: float):
        """θ ← θ − lr·x for a flat natural-gradient solve result, rounded
        to each leaf's dtype as the reference does."""
        delta = self.unravel(x_flat.to(self.device))
        self.params = tree_map(
            lambda p, d: (p - lr * d.to(p.dtype)).to(p.dtype),
            self.params, delta)
        return self.params

    def decode(self, prompt, *, new_tokens: int, return_logits: bool = False):
        """Prefill + greedy one-token decode of ``prompt`` (b, T); returns
        (b, new_tokens) generated ids, and with ``return_logits`` also the
        (b, new_tokens, V) fp32 logits each id was taken from."""
        prompt = torch.as_tensor(np.asarray(prompt), dtype=torch.int32)
        b, plen = prompt.shape
        with torch.no_grad():
            logits, cache, _ = self._prefill(
                self.params, {"tokens": prompt, "max_len": plen + new_tokens})
            last = logits[:, -1]
            out = [torch.argmax(last, dim=-1).to(torch.int32)[:, None]]
            steps = [last]
            for t in range(new_tokens - 1):
                nxt, cache, last = self._step(self.params, cache, plen + t,
                                              out[-1])
                out.append(nxt[:, None])
                steps.append(last)
        ids = torch.cat(out, dim=1)
        return (ids, torch.stack(steps, dim=1)) if return_logits else ids


def _build_serve_front(cfg, *, window: int, seq: int, score_chunk=None,
                       seed: int = 0, params=None, device=None):
    """The model-side half of serving: api + params + score-grad pass +
    seeded window S0 (n = ``window`` synthetic examples). S0 is the score
    rows alone, ``score_chunk`` samples at a time: the mean gradient over
    the window's batch, which the reference computes beside them and
    drops, would hold the whole batch's activations for one backward
    (≈ 1.4 GB a Mamba2 layer for every two 1,024-token examples on an
    H100: mamba2-1.3b's 16 layers at 8 examples ran out of memory)."""
    dev = resolve_device(device)
    api = get_api(cfg)
    data = SyntheticLM(cfg, batch=window, seq=seq, seed=seed)
    if params is None:
        params = api.init_params(torch.Generator().manual_seed(seed), dev)
    else:
        params = _place_params(params, dev)
    _, unravel = flatten_like(params)
    # request rows carry the window's 1/√n normalization so folds are
    # exchangeable with the seeded rows
    score_grads = T.make_score_grads(api, score_chunk=score_chunk,
                                     scale=1.0 / np.sqrt(window))
    S0 = per_sample_scores(api.sample_logp, params,
                           T.batch_to(data.batch_at(0), dev),
                           chunk=score_chunk, scale=1.0 / np.sqrt(window))
    handles = ServeHandles(api=api, params=params, data=data,
                           score_grads=score_grads, unravel=unravel)
    return handles, S0


def build_server(cfg, *, window: int, seq: int, damping: float = 1e-3,
                 max_tokens: int = 4096, max_requests: int = 8,
                 refresh_every: int = 64, drift_tol=None, drift_frac=0.25,
                 jitter: float = 0.0, score_chunk=None, policy: str = "cached",
                 layout=None, async_: bool = False, oversize: str = "split",
                 window_dtype=None, tenant_rank=None, tenant_budget_mb=None,
                 seed: int = 0, audit_every: int = 0, audit_probes: int = 2,
                 registry=None, tracer=None, profile=None, health=None,
                 recorder=None, record_dir=None, params=None, device=None,
                 mesh=None):
    """Config → model → resident curvature window → server.

    Builds the score-grad pass, the prefill and the greedy serve step,
    seeds an n=``window`` sample score window from synthetic data,
    factorizes it once, and wraps it in a request-driven server with
    token-budget batching and the age/drift online-adaptation policy.
    Returns ``(server, handles)``.

    ``async_=True`` returns the concurrent ``repro_torch.dist.
    AsyncSolveServer`` in place of the eager ``SolveServer``; ``layout``
    ("1d" | "2d") also shards the window over ``mesh`` (default: a (1, 1)
    ("data", "model") mesh on the window's device), so the requests and
    the folds run per slab. A sharded window needs the async server (the
    eager one is the replicated baseline).

    ``params``: a parameter tree to serve (tensors, or numpy arrays such
    as the JAX LM's, through ``params_from_arrays``) in place of one drawn
    from ``seed``. ``device``: CUDA by default; ``"cpu"`` runs the plain
    versions. ``window_dtype`` (e.g. "bfloat16"): low-precision window
    storage, every S pass still accumulating fp32.

    ``tenant_rank`` (int): attach a ``repro_torch.tenants.TenantManager``
    so ``submit(..., tenant=...)`` serves per-tenant rank-r deltas over
    the shared base factor; ``tenant_budget_mb`` caps resident tenant
    bytes (LRU spill past it).

    ``registry`` / ``tracer`` / ``profile`` / ``health`` / ``recorder``
    (``repro_torch.obs``) thread the observability fabric through the
    server; ``audit_every`` runs the factor audit (``audit_probes``
    probes) every that many maintenance passes (0: off; it needs a
    registry); ``record_dir`` is the shorthand that builds a
    ``FlightRecorder`` rooted there.
    """
    from repro_torch.serve import (OnlineAdaptation, SolveServer,
                                   TokenBudgetBatcher, init_serve_state)

    if layout is not None and not async_:
        raise ValueError(
            f"layout={layout!r} shards the resident window, which only the "
            "async server serves; pass async_=True (the eager SolveServer "
            "is the replicated baseline)")
    handles, S0 = _build_serve_front(cfg, window=window, seq=seq,
                                     score_chunk=score_chunk, seed=seed,
                                     params=params, device=device)
    if recorder is None and record_dir is not None:
        from repro_torch.obs import FlightRecorder
        recorder = FlightRecorder(str(record_dir))
    adaptation = OnlineAdaptation(refresh_every=refresh_every,
                                  drift_tol=drift_tol, drift_frac=drift_frac,
                                  jitter=jitter, audit_every=audit_every,
                                  audit_probes=audit_probes)
    batcher = TokenBudgetBatcher(max_tokens=max_tokens,
                                 max_requests=max_requests, oversize=oversize)
    tenants = None
    if tenant_rank is not None:
        from repro_torch.tenants import TenantManager
        tenants = TenantManager(
            int(tenant_rank),
            budget_bytes=None if tenant_budget_mb is None
            else int(float(tenant_budget_mb) * 2**20),
            registry=registry)
    if layout is not None:
        from repro_torch.dist import DistSpec, init_sharded_serve_state
        from repro_torch.launch.mesh import make_mesh
        if mesh is None:
            mesh = make_mesh((1, 1), ("data", "model"), device=S0.device)
        state = init_sharded_serve_state(S0, damping,
                                         spec=DistSpec(mesh, layout),
                                         jitter=jitter,
                                         window_dtype=window_dtype)
    else:
        state = init_serve_state(S0, damping, jitter=jitter,
                                 window_dtype=window_dtype)
    del S0
    kw = dict(batcher=batcher, adaptation=adaptation, policy=policy,
              jitter=jitter, tenants=tenants, registry=registry,
              tracer=tracer, profile=profile, health=health,
              recorder=recorder)
    if async_:
        from repro_torch.dist import AsyncSolveServer
        return AsyncSolveServer(state, **kw), handles
    return SolveServer(state, **kw), handles


def fleet_init_frame(cfg, *, window: int, seq: int, damping: float = 1e-3,
                     max_tokens: int = 4096, max_requests: int = 8,
                     refresh_every: int = 64, drift_tol=None,
                     drift_frac=0.25, jitter: float = 0.0, score_chunk=None,
                     policy: str = "cached", async_workers: bool = False,
                     worker_layout=None, window_dtype=None, tenant_rank=None,
                     tenant_budget_mb=None, seed: int = 0,
                     trace: bool = False, audit_every: int = 0,
                     profile_dir=None, record_dir=None, params=None,
                     device=None):
    """The front and the init frame of ``build_fleet``: returns
    ``(handles, meta, arrays)`` — the serving front (``ServeHandles``, on
    ``device``) and the inline init frame every worker receives, the
    seeded window shipped as ``S0`` (blocked: ``S0.i``) with the
    reference's init meta. A window on the card crosses to the host once,
    in ``put_blocks``."""
    from repro_torch.core.operator import is_blocked
    from repro_torch.fleet.wire import put_blocks

    handles, S0 = _build_serve_front(cfg, window=window, seq=seq,
                                     score_chunk=score_chunk, seed=seed,
                                     params=params, device=device)
    if window_dtype is not None and not isinstance(window_dtype, str):
        window_dtype = str(window_dtype).removeprefix("torch.")
    meta = {"mode": "inline", "damping": float(damping),
            "jitter": float(jitter), "policy": policy,
            "max_tokens": int(max_tokens), "max_requests": int(max_requests),
            "refresh_every": int(refresh_every), "drift_tol": drift_tol,
            "drift_frac": drift_frac, "async": bool(async_workers),
            "layout": worker_layout, "window_dtype": window_dtype,
            "tenant_rank": None if tenant_rank is None else int(tenant_rank),
            "tenant_budget_mb": tenant_budget_mb,
            "obs": True, "trace": bool(trace),
            "audit_every": int(audit_every),
            "profile_dir": None if profile_dir is None else str(profile_dir),
            "record_dir": None if record_dir is None else str(record_dir)}
    arrays = {}
    put_blocks(arrays, meta, "S0",
               tuple(S0.blocks) if is_blocked(S0) else S0)
    return handles, meta, arrays


def build_fleet(cfg, *, mesh=None, n_workers: int = 2,
                route: str = "round_robin", reconcile: bool = True,
                window: int, seq: int, damping: float = 1e-3,
                max_tokens: int = 4096, max_requests: int = 8,
                refresh_every: int = 64, drift_tol=None, drift_frac=0.25,
                jitter: float = 0.0, score_chunk=None, policy: str = "cached",
                async_workers: bool = False, worker_layout=None,
                window_dtype=None, tenant_rank=None, tenant_budget_mb=None,
                seed: int = 0, trace: bool = False, registry=None,
                audit_every: int = 0, profile_dir=None, record_dir=None,
                device=None):
    """Config → model → seeded window → N-process serving fleet.

    The fleet twin of ``build_server``: the model (score-grad pass,
    decode, live params) stays on this side as the traffic source, while
    the resident curvature window is shipped — as bytes, over the init
    frame (``fleet_init_frame``) — to ``n_workers`` local worker processes
    that each factorize the *identical* window (the precondition for
    gossip convergence). Returns ``(dispatcher, handles)``; drive it like
    a server (``submit``/``flush``), plus ``reconcile()``/``probe()``/
    ``checkpoint()``.

    ``route``: "round_robin" | "least_loaded" | "by_adapter" (pass
    ``adapter=`` at submit for sticky routing). ``reconcile=True`` gossips
    every request's fold columns fleet-wide through the dispatcher's
    ``GossipLog`` so all windows converge; ``False`` partitions folds —
    each worker's window sees only its own requests' rows.
    ``async_workers``/``worker_layout`` select the inner server flavour
    each worker wraps (eager replicated by default; async; async + window
    sharded over the worker's own devices).

    ``tenant_rank``/``tenant_budget_mb``: give every worker a
    ``TenantManager`` so ``submit(..., tenant=...)`` rides the
    consistent-hash ``by_adapter`` ring as tenant placement.

    ``trace=True`` turns on per-request span tracing in every worker —
    spans ride result frames back and land in ``dispatcher.tracer``.
    ``registry``: dispatcher-side ``repro_torch.obs.MetricsRegistry``
    (routing latency under the ``fleet.*`` prefix); worker registries are
    always on and merge via ``dispatcher.fleet_metrics()``.
    ``audit_every``: each worker's factor audit cadence (0: off).
    ``profile_dir``: each worker captures a ``torch.profiler`` trace into
    ``<dir>/worker<i>/``. ``record_dir``: each worker runs a flight
    recorder rooted at ``<dir>/worker<i>/``.

    ``device``: the front's device and the workers' (default: CUDA;
    "cpu" runs the plain versions everywhere). ``mesh`` is the
    reference's argument, taken and unused: the port's front holds its
    model on one device, and each worker lays its own mesh.
    """
    from repro_torch.fleet import launch_fleet

    handles, meta, arrays = fleet_init_frame(
        cfg, window=window, seq=seq, damping=damping, max_tokens=max_tokens,
        max_requests=max_requests, refresh_every=refresh_every,
        drift_tol=drift_tol, drift_frac=drift_frac, jitter=jitter,
        score_chunk=score_chunk, policy=policy, async_workers=async_workers,
        worker_layout=worker_layout, window_dtype=window_dtype,
        tenant_rank=tenant_rank, tenant_budget_mb=tenant_budget_mb,
        seed=seed, trace=trace, audit_every=audit_every,
        profile_dir=profile_dir, record_dir=record_dir, device=device)
    dispatcher = launch_fleet(n_workers, init_meta=meta, init_arrays=arrays,
                              route=route, gossip=reconcile,
                              registry=registry, device=device)
    return dispatcher, handles


def train_main(argv=None):
    ap = argparse.ArgumentParser(
        description="NGD / AdamW training of a model of the zoo under the "
                    "checkpointing supervisor")
    ap.add_argument("--arch", choices=configs.list_archs(), required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "plain versions of the kernels)")
    ap.add_argument("--optimizer", choices=["adamw", "ngd"], default="adamw")
    ap.add_argument("--solver", default="chol",
                    choices=["chol", "eigh", "svd", "cg"])
    ap.add_argument("--blocked", action="store_true",
                    help="per-layer BlockedScores NGD path (no flat S)")
    ap.add_argument("--curvature", choices=["exact", "streaming"],
                    default="exact",
                    help="per-step exact factorization (paper) or the "
                         "cross-step streaming curvature cache")
    ap.add_argument("--curvature-refresh", type=int, default=10,
                    help="streaming: full Gram refresh period (steps)")
    ap.add_argument("--curvature-drift-tol", type=float, default=None,
                    help="streaming: refresh when the solve's relative "
                         "residual exceeds this (static; overrides "
                         "--curvature-drift-frac)")
    ap.add_argument("--curvature-drift-frac", type=float, default=None,
                    help="streaming: autotune the drift threshold as this "
                         "fraction of the damping schedule's trust-region "
                         "ratio (repro_torch.core.auto_drift_tol)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=None)
    ap.add_argument("--damping", type=float, default=1e-3)
    ap.add_argument("--mesh-shape", default="1,1",
                    help="the mesh, as 4 ('data'), 2,2 ('data', 'model') or "
                         "2,1,2 ('pod', 'data', 'model'): a card a "
                         "position, or every position on --device")
    ap.add_argument("--ckpt-dir", default="artifacts/ckpt")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--inject-failure-at", type=int, default=None)
    args = ap.parse_args(argv)
    # one position is the one-device path
    mesh = None if all(int(x) == 1 for x in args.mesh_shape.split(",")) \
        else mesh_from_shape(args.mesh_shape, args.device)

    cfg = configs.get_smoke(args.arch) if args.smoke \
        else configs.get_config(args.arch)
    lr = args.lr if args.lr is not None else \
        (0.05 if args.optimizer == "ngd" else 3e-3)

    init_state, step_fn, save_state, restore_state, _ = build_trainer(
        cfg, mesh=mesh, optimizer_name=args.optimizer, lr=lr,
        damping=args.damping,
        batch=args.batch, seq=args.seq, total_steps=args.steps,
        solver=args.solver, blocked=args.blocked, curvature=args.curvature,
        curvature_refresh=args.curvature_refresh,
        curvature_drift_tol=args.curvature_drift_tol,
        curvature_drift_frac=args.curvature_drift_frac,
        device=None if mesh is not None else args.device)

    losses = []

    def logging_step(state, step):
        t0 = time.time()
        state, metrics = step_fn(state, step)
        loss = float(metrics["loss"])          # waits for the step
        losses.append(loss)
        if step % args.log_every == 0:
            print(f"step {step:5d} loss {loss:8.4f} "
                  f"({(time.time() - t0) * 1e3:.0f} ms)", flush=True)
        return state, metrics

    sup = SupervisorConfig(total_steps=args.steps, ckpt_dir=args.ckpt_dir,
                           ckpt_every=args.ckpt_every,
                           inject_failure_at=args.inject_failure_at)
    state, report = run_supervised(sup, init_state=init_state,
                                   step_fn=logging_step,
                                   save_state=save_state,
                                   restore_state=restore_state)
    print(f"done: final loss {losses[-1]:.4f} "
          f"(first {losses[0]:.4f}); report={report}")
    return losses, report


if __name__ == "__main__":
    train_main()
