"""CLI for the seeded reasoning eval harness (docs/EVAL.md).

    python -m repro_torch.eval --smoke --out eval-smoke.json

Prints an accuracy-vs-throughput table per compression budget and, with
``--out``, writes the byte-deterministic ``zipage-eval/v1`` JSON. Trains
and serves on the card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.eval.runner import render_report, run_eval, summary_table


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.eval",
        description="Seeded reasoning eval across compression budgets.")
    ap.add_argument("--smoke", action="store_true",
                    help="CI-sized run (default when --full is absent)")
    ap.add_argument("--full", action="store_true",
                    help="larger eval set plus window-8 budget rows")
    ap.add_argument("--out", default=None,
                    help="write the zipage-eval/v1 JSON report here")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--requests", type=int, default=None,
                    help="eval-set size (default: 18 smoke / 48 full)")
    ap.add_argument("--train-steps", type=int, default=None,
                    help="tiny-lm training steps (default: 300 smoke / "
                         "600 full)")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    full = args.full and not args.smoke
    n_requests = args.requests if args.requests is not None else (
        48 if full else 18)
    train_steps = args.train_steps if args.train_steps is not None else (
        600 if full else 300)

    report = run_eval(seed=args.seed, n_requests=n_requests,
                      train_steps=train_steps, full=full, smoke=not full,
                      device=args.device)
    print("\n".join(summary_table(report)))
    if args.out:
        with open(args.out, "w") as f:
            f.write(render_report(report))
        print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
