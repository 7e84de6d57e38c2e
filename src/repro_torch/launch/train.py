"""Training launcher of the port: init, checkpoint/restart, train loop on
one device (the JAX package's ``repro.launch.train``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch tiny-lm \
      --steps 50 --seq-len 64 --global-batch 8 --ckpt-dir /tmp/ck \
      --ckpt-every 20 --device cpu

It trains on the card unless ``--device cpu`` is given, at the config's
dtype (bf16 for the registered configs), as the reference: fp32 master
params, gradients and optimizer state, the forward and backward in bf16
with the params cast at each use. The data step is saved with each checkpoint, so a
restarted run regenerates the batches a never-stopped run would see.
Only ``--mesh host`` (one device) is ported; the pod meshes belong to
distribution and raise. The last line printed is a JSON summary:
device, per-step losses, timings and peak device memory.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.models import lm
from repro_torch.training import checkpoint as ckpt
from repro_torch.training import optimizer as opt
from repro_torch.training.data import DataConfig, batch_at
from repro_torch.training.train_loop import build_train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tiny-lm")
    ap.add_argument("--reduced", action="store_true",
                    help="use the family-preserving reduced config")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--vocab-chunk", type=int, default=128)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--mesh", default="host",
                    choices=["host", "pod1", "pod2"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    if args.mesh != "host":
        raise NotImplementedError(
            f"--mesh {args.mesh} is not ported to repro_torch yet: the "
            "pod meshes belong to distribution; --mesh host trains on one "
            "device")
    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    adamw = opt.AdamWConfig(lr=args.lr, warmup_steps=max(2, args.steps // 10),
                            total_steps=args.steps)
    dc = DataConfig(seq_len=args.seq_len, global_batch=args.global_batch,
                    vocab_size=cfg.vocab_size, seed=args.seed)
    step_fn = build_train_step(cfg, adamw, accum_steps=args.accum,
                               vocab_chunk=args.vocab_chunk)

    params = lm.init(cfg, torch.Generator(device=dev).manual_seed(args.seed),
                     dev, dtype=torch.float32)
    opt_state = opt.init_opt_state(params)
    tree = {"params": params, "opt": opt_state}

    start_step = 0
    if args.ckpt_dir:
        os.makedirs(args.ckpt_dir, exist_ok=True)
        last = ckpt.latest_step(args.ckpt_dir)
        if last is not None:
            _, extra = ckpt.restore(args.ckpt_dir, last, tree)
            start_step = extra["data_step"]
            print(f"[train] restored step {start_step} from {args.ckpt_dir} "
                  f"(digest {ckpt.digest(tree)})", flush=True)

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    losses, step_s, saves = {}, [], {}
    m = None
    t0 = time.time()
    for i in range(start_step, args.steps):
        ts = time.time()
        params, opt_state, _, m = step_fn(params, opt_state, None,
                                          batch_at(dc, i))
        loss = float(m["loss"])             # waits for the step
        step_s.append(time.time() - ts)
        losses[i + 1] = loss
        if m["loss"].device.type != dev.type:
            raise RuntimeError(f"step {i + 1} left {dev}")
        if (i + 1) % args.log_every == 0 or i == start_step:
            print(f"[train] step {i + 1} loss {loss!r} "
                  f"gnorm {float(m['grad_norm']):.3f} "
                  f"lr {m['lr']:.2e} "
                  f"({(time.time() - t0) / (i - start_step + 1):.2f} s/step)",
                  flush=True)
        if args.ckpt_every and (i + 1) % args.ckpt_every == 0:
            digest = ckpt.digest(tree)
            ts = time.time()
            ckpt.save(args.ckpt_dir, i + 1, tree,
                      extra={"data_step": i + 1})
            saves[i + 1] = {"digest": digest, "s": time.time() - ts}
            print(f"[train] saved step {i + 1} (digest {digest}) in "
                  f"{saves[i + 1]['s']:.1f} s", flush=True)
    if m is None:
        print(f"[train] nothing to do: step {start_step} of {args.steps}")
        return None
    print(f"[train] done: final loss {float(m['loss']):.4f}")
    warm = step_s[1:] or step_s
    s_per_step = sum(warm) / len(warm)
    print(json.dumps({
        "device": str(dev), "arch": cfg.name, "dtype": cfg.dtype,
        "param_dtype": str(params["embed"].dtype).removeprefix("torch."),
        "params": lm.param_count(params), "start_step": start_step,
        "steps": args.steps, "tokens_per_step": dc.global_batch * dc.seq_len,
        "losses": losses, "saves": saves, "first_step_s": step_s[0],
        "s_per_step": s_per_step,
        "tokens_per_s": dc.global_batch * dc.seq_len / s_per_step,
        "peak_memory_bytes": (torch.cuda.max_memory_allocated(dev)
                              if dev.type == "cuda" else None)}),
        flush=True)
    return float(m["loss"])


if __name__ == "__main__":
    main()
