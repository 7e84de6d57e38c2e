"""Serving launcher of the port: builds a Zipage facade and runs a
synthetic workload (the JAX package's ``repro.launch.serve``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch tiny-lm \
      --workload amc --n-requests 16 --budget 24

It serves on the card; ``--device cpu`` runs the kernels' plain versions.
Every architecture but tiny-lm runs at its ``reduced()`` widths, and the
prompts are drawn from the vocabulary of the model that serves them.
``--full-kv`` turns compression off (the paper's full-KV baseline).
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np

from repro_torch.api import SamplingParams, Zipage


def synth_workload(kind, n, vocab, rng):
    """Paper's three workload shapes (§5.2): amc = short-in/long-out,
    gsm = short/short, long = long-in/short-out, mix = amc+gsm."""
    reqs = []
    for i in range(n):
        if kind == "amc":
            p, o = rng.integers(8, 24), int(rng.integers(48, 96))
        elif kind == "gsm":
            p, o = rng.integers(8, 24), int(rng.integers(8, 24))
        elif kind == "long":
            p, o = rng.integers(64, 120), int(rng.integers(8, 24))
        else:  # mix
            if i % 2:
                p, o = rng.integers(8, 24), int(rng.integers(48, 96))
            else:
                p, o = rng.integers(8, 24), int(rng.integers(8, 24))
        prompt = rng.integers(0, vocab, size=int(p)).tolist()
        reqs.append((prompt, o))
    return reqs


def run_engine(arch, reqs, *, reduce=False, device=None, **opts):
    base = dict(block_size=8, n_total_blocks=192, max_batch=12, m_qslots=6,
                n_max=4, window=4, max_model_len=256, prefill_rows=4,
                prefill_len=128)
    base.update(opts)
    z = Zipage.from_config(arch, device=device, reduce=reduce, **base)
    t0 = time.monotonic()
    outs = z.generate([p for p, _o in reqs],
                      [SamplingParams(max_new_tokens=o) for _p, o in reqs],
                      max_steps=5000)
    dt = time.monotonic() - t0
    toks = sum(o.usage.completion_tokens for o in outs)
    return {"engine": z, "tps": toks / dt, "wall_s": dt,
            "tokens": toks, "steps": z.step_count,
            "outputs": {o.request_id: o.token_ids for o in outs}}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tiny-lm")
    ap.add_argument("--workload", default="amc",
                    choices=["amc", "gsm", "long", "mix"])
    ap.add_argument("--n-requests", type=int, default=16)
    ap.add_argument("--budget", type=int, default=24,
                    help="KV budget in tokens ((n_max-1)*block_size)")
    ap.add_argument("--full-kv", action="store_true",
                    help="disable compression (nano-vllm baseline)")
    ap.add_argument("--no-async", dest="asyncc", action="store_false")
    ap.add_argument("--scheduling", default="hybrid",
                    choices=["hybrid", "constrained"])
    ap.add_argument("--no-prefix", dest="prefix", action="store_false")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="device of the engine (default: cuda, which "
                         "raises without a card)")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config
    reduce = args.arch != "tiny-lm"
    cfg = get_config(args.arch)
    # the served model's vocabulary: a reduced config's is 256 tokens, and
    # an id beyond it has no embedding row
    vocab = (cfg.reduced() if reduce else cfg).vocab_size
    rng = np.random.default_rng(args.seed)
    reqs = synth_workload(args.workload, args.n_requests, vocab, rng)
    n_max = None if args.full_kv else (args.budget // 8 + 1)
    res = run_engine(args.arch, reqs, reduce=reduce, device=args.device,
                     n_max=n_max, async_compression=args.asyncc,
                     scheduling=args.scheduling,
                     prefix_caching=args.prefix)
    z = res.pop("engine")
    res.pop("outputs")
    res["compressions"] = sum(m["n_compressing"] for m in z.metrics)
    res["peak_running"] = max(m["n_running"] for m in z.metrics)
    res["mean_block_util"] = float(np.mean([m["block_util"]
                                            for m in z.metrics]))
    res["device"] = str(z.engine.device)
    print(json.dumps(res, indent=1))
    return res


if __name__ == "__main__":
    main()
