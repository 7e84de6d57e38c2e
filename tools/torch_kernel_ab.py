#!/usr/bin/env python3
"""Time two versions of some of the port's kernels on one NVIDIA card, in
turns.

    git archive HEAD src/repro_torch | tar -x -C <dir>   # the older version
    python3 tools/torch_kernel_ab.py --before <dir>/src \
        --kernels lightning_redundancy paged_attention ragged_paged_attention
    python3 tools/torch_kernel_ab.py --before <dir>/src --kernels compaction
    python3 tools/torch_kernel_ab.py --before <dir>/src --idle-slots
    python3 tools/torch_kernel_ab.py --before <dir>/src --dtype bfloat16 \
        --kernels ragged_paged_attention paged_score

Runs four worker processes one after another -- before, after, after,
before -- each importing ``repro_torch`` from its own copy of a source
tree (``--before``, and this checkout's ``src`` for "after") in a
temporary directory, so each builds its own kernels there. Each worker
runs ``chip_smoke.time_at`` on the named kernels (any of
``chip_smoke.TIMED_AT``) at a serve's shape (K2, K3, B5: 2 requests of 64
entries, table width 4; B6: the same, 36 layers, compacted to 3 blocks;
K1, B4: 16 slots, 8 live at 55-64 entries, table width 32) and at the
long inputs (table width 128; seq_lens 2048 and 1999, B6 compacted to
``chip_smoke.LONG_BUDGET`` blocks, or ``chip_smoke.LONG_DECODE_LENS``):
the checks against the plain versions, then event, device and host ms of
each kernel and its library yardstick, with the bound. A kernel that the
older version refuses at launch (a compaction kernel that staged a whole
stripe in shared memory took no budget above 28 blocks) is recorded as
refused in a "before" turn; in an "after" turn it fails the run.
``--idle-slots`` also runs ``chip_smoke.check_idle_slots`` (K1 and B4
against their plain versions on slots that attend seq_len >= 1 over an
empty table, as the serve passes them) at g = 1 (h_kv 16) and g = 4
(h_kv 8), recording a disagreement instead of failing. ``--dtype
bfloat16`` runs all of it on bf16 queries, keys and values (the kernels'
bf16 variants, held to ``chip_smoke.kernel_tols``); a tree whose kernels
take no bf16 is recorded as refused in its turns. Prints one line per
kernel and turn and writes ``chiprun_out/kernel_ab.json``. Needs a card;
imports no JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

#: label -> (table width, seq_lens) of K2, K3, B5, B6 and of K1, B4, and
#: B6's budget in blocks (the serve's: the engine's n_max - 1)
INPUTS = {"serve": ((4, [64, 64]),
                    (32, [64, 63, 62, 60, 59, 58, 56, 55] + [0] * 8), 3),
          "long": ((chip_smoke.LONG_TABLE, chip_smoke.LONG_LENS),
                   (chip_smoke.LONG_TABLE, chip_smoke.LONG_DECODE_LENS),
                   chip_smoke.LONG_BUDGET)}


#: --idle-slots: label -> (h_q, h_kv) at Qwen3-8B's other widths
IDLE_LAYOUTS = {"g = 1, h_kv 16": (16, 16), "g = 4, h_kv 8": (32, 8)}


def worker(src, names, allow_refused, idle_slots=False, dtype="float32"):
    import torch
    dtype = getattr(torch, dtype)
    if not torch.cuda.is_available():
        raise SystemExit("torch_kernel_ab: no CUDA device")
    tmp = Path(tempfile.mkdtemp(prefix="kernel_ab_"))
    try:
        shutil.copytree(Path(src) / "repro_torch", tmp / "repro_torch",
                        ignore=shutil.ignore_patterns("_build",
                                                      "__pycache__"))
        sys.path.insert(0, str(tmp))     # ahead of chip_smoke's own src
        from repro_torch.configs import get_config
        from repro_torch.core.engine import EngineOptions
        from repro_torch.kernels import native
        native.build_all()
        dev = torch.device("cuda")
        out = {}
        if idle_slots:
            import dataclasses

            import numpy as np
            out["idle_slots"] = {}
            for label, (hq, hkv) in IDLE_LAYOUTS.items():
                cfg = dataclasses.replace(get_config("qwen3-8b"),
                                          num_heads=hq, num_kv_heads=hkv)
                try:
                    rec = {"max_abs_err": chip_smoke.check_idle_slots(
                        torch, dev, cfg, EngineOptions(),
                        np.random.default_rng(0), f"idle[{label}]",
                        dtype)}
                except AssertionError as e:
                    rec = {"differs": str(e)}
                out["idle_slots"][label] = rec
        for label, (comp, dec, budget) in INPUTS.items():
            if not names:
                break
            out[label] = {}
            for name in names:
                try:
                    out[label].update(chip_smoke.time_at(
                        torch, dev, get_config("qwen3-8b"), EngineOptions(),
                        [name], comp, dec, budget, dtype))
                except (RuntimeError, ValueError) as e:
                    # an older launch refused, or an older wrapper that
                    # takes no bf16
                    if not (allow_refused and ("at launch" in str(e) or
                                               "must be" in str(e))):
                        raise
                    out[label][name] = {"refused": str(e)}
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--before", required=True,
                    help="a src/ directory holding the older repro_torch")
    ap.add_argument("--kernels", nargs="*", default=[],
                    choices=chip_smoke.TIMED_AT, help="kernels to time")
    ap.add_argument("--idle-slots", action="store_true",
                    help="check K1 and B4 on idle slots in each turn")
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "bfloat16"),
                    help="the dtype of the kernels' K/V and query inputs")
    ap.add_argument("--worker", metavar="SRC", help=argparse.SUPPRESS)
    ap.add_argument("--allow-refused", action="store_true",
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        print(json.dumps(worker(args.worker, args.kernels,
                                args.allow_refused, args.idle_slots,
                                args.dtype)))
        return 0
    card = chip_smoke.card_line()
    turns = [("before", args.before), ("after", str(ROOT / "src")),
             ("after", str(ROOT / "src")), ("before", args.before)]
    results = []
    for version, src in turns:
        flags = ["--allow-refused"] if version == "before" else []
        if args.idle_slots:
            flags.append("--idle-slots")
        out = subprocess.run([sys.executable, __file__, "--before",
                              args.before, "--kernels", *args.kernels,
                              "--dtype", args.dtype, "--worker", src,
                              *flags],
                             capture_output=True, text=True,
                             timeout=900, env={**os.environ,
                                               "PYTHONPATH": ""})
        if out.returncode != 0:
            sys.stderr.write(out.stdout[-4000:] + out.stderr[-8000:])
            raise SystemExit(f"torch_kernel_ab: the {version} turn failed "
                             f"(exit code {out.returncode})")
        recs = json.loads(out.stdout.strip().splitlines()[-1])
        results.append({"version": version, "inputs": recs})
        for label, r in recs.pop("idle_slots", {}).items():
            print(f"{version:6s} idle slots at {label}: " + (
                f"K1 and B4 equal their plain versions, max_abs_err "
                f"{r['max_abs_err']:.3e}" if "max_abs_err" in r
                else r["differs"]), flush=True)
        for label, by_name in recs.items():
            for name, r in by_name.items():
                if "refused" in r:
                    print(f"{version:6s} {name:22s} {label:5s} refused at "
                          f"launch: {r['refused']}", flush=True)
                    continue
                ms = {k: chip_smoke.fmt_ms(r[k]) for k in (
                    "device_ms", "host_ms", "library_device_ms")}
                print(f"{version:6s} {name:22s} {label:5s} event "
                      f"{r['ms']:.4f} device {ms['device_ms']} host "
                      f"{ms['host_ms']} ms | bound {r['bound_ms']:.5f} "
                      f"({r['bound_by']}) | library event "
                      f"{r['library_ms']:.4f} device "
                      f"{ms['library_device_ms']} ms", flush=True)
    print(card)
    os.makedirs(ROOT / "chiprun_out", exist_ok=True)
    with open(ROOT / "chiprun_out" / "kernel_ab.json", "w") as f:
        json.dump({"card": card, "dtype": args.dtype, "turns": results}, f,
                  indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
