"""End-to-end driver: train an LM with the paper's damped NGD for a few
hundred steps, with checkpointing and restart supervision — the port's
trainer CLI in library form.

    PYTHONPATH=src python examples_torch/lm_ngd_train.py \
        [--arch llama3.2-3b] [--steps 300] [--optimizer ngd] [--device cpu]

Uses the reduced (smoke) config so the run completes on the CPU; the
same code path drives the full configs on the card (see
``repro_torch.launch.dryrun`` for what a full-size step holds and does).
"""
import argparse

from repro_torch.launch.trainer import train_main


def main(argv=None, emit=print):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-3b")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--optimizer", default="ngd", choices=["ngd", "adamw"])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-dir", default="artifacts/ckpt_example")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                    "plain versions)")
    args = ap.parse_args(argv)

    losses, report = train_main([
        "--arch", args.arch, "--smoke",
        "--optimizer", args.optimizer,
        "--steps", str(args.steps),
        "--batch", str(args.batch),
        "--seq", str(args.seq),
        "--ckpt-dir", args.ckpt_dir,
        "--log-every", "25",
    ] + ([] if args.device is None else ["--device", args.device]))
    emit(f"trained {args.steps} steps; loss {losses[0]:.3f} → "
         f"{losses[-1]:.3f}; restarts={report['restarts']}")
    return losses, report


if __name__ == "__main__":
    main()
