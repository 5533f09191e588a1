"""Serving example on the PyTorch port: batched prefill + greedy decode
**plus online natural-gradient adaptation** through the serving
subsystem.

A resident curvature window is factorized once, requests coalesce
through the token-budget batcher, the ``SolveServer`` answers each with a
damped-Fisher solve off the cached factor (per-request λ included — no
Gram on the request path), updates are applied to the live params, and
each request's score rows fold back into the window via the rank-k
algebra before its response is decoded. On the card (the default) the
solves, folds and prefill take the hand-written kernels; ``--device
cpu`` runs their plain versions.

    PYTHONPATH=src python examples_torch/serve_lm.py [--arch gemma2-2b] [--new 8] [--device cpu]
"""
import argparse
import time

import numpy as np


def main(argv=None, emit=print):
    from repro_torch import configs
    from repro_torch.launch.trainer import build_server

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2-2b")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--window", type=int, default=6)
    ap.add_argument("--seq", type=int, default=16)
    ap.add_argument("--new", type=int, default=8, help="tokens decoded")
    ap.add_argument("--damping", type=float, default=1e-2)
    ap.add_argument("--lr", type=float, default=0.02)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                    "plain versions)")
    args = ap.parse_args(argv)

    cfg = configs.get_smoke(args.arch)

    t0 = time.perf_counter()
    server, h = build_server(cfg, window=args.window, seq=args.seq,
                             damping=args.damping, max_tokens=4 * args.seq,
                             max_requests=4, device=args.device)
    emit(f"window factorized: n={args.window} m={server.state.S.shape[1]} "
         f"({(time.perf_counter() - t0) * 1e3:.0f} ms)")

    results = {}
    for r in range(args.requests):
        ex = {k: x[:2] for k, x in h.data.batch_at(r + 1).items()}
        loss, v, rows = h.score_grads(h.params, ex)
        uid = server.submit(v, tokens=2 * args.seq, rows=rows,
                            payload=ex["inputs"][:1])
        results[uid] = float(loss)

    for res in server.flush():
        h.apply_update(res.x, lr=args.lr)
        emit(f"req {res.uid} loss {results[res.uid]:.4f} "
             f"solve {res.latency_s * 1e3:.1f} ms")

    # decode the last request's prompt with the adapted params
    prompt = h.data.batch_at(args.requests)["inputs"][:1, :args.seq]
    t0 = time.perf_counter()
    gen = h.decode(prompt, new_tokens=args.new)
    dt = time.perf_counter() - t0
    emit(f"decoded {args.new} tokens in {dt * 1e3:.0f} ms "
         f"({dt / max(args.new, 1) * 1e3:.1f} ms/tok)")
    emit(f"sample token ids: {np.asarray(gen[0][:12].cpu()).tolist()}")

    s = server.metrics.summary()
    emit(f"served {s['served']}: p50 {s['p50_ms']:.1f} ms "
         f"p99 {s['p99_ms']:.1f} ms ({s['rps']:.1f} req/s)")
    return server, s


if __name__ == "__main__":
    main()
