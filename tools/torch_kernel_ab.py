#!/usr/bin/env python3
"""Time two versions of the port's flash-redundancy (B5) and window-logits
(K2) kernels on one NVIDIA card, in turns.

    git archive HEAD src/repro_torch | tar -x -C <dir>   # the older version
    python3 tools/torch_kernel_ab.py --before <dir>/src

Runs four worker processes one after another -- before, after, after,
before -- each importing ``repro_torch`` from its own copy of a source
tree (``--before``, and this checkout's ``src`` for "after") in a
temporary directory, so each builds its own kernels there. Each worker
runs ``chip_smoke.time_flash_and_score`` at the serve's shape (2 requests
of 64 entries, table width 4) and at the long input (table width 128,
seq_lens 2048 and 1999): the checks against the plain versions, then
event, device and host ms of each kernel and its library yardstick, with
the bound. Prints one line per kernel and turn and writes
``chiprun_out/kernel_ab.json``. Needs a card; imports no JAX.
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

INPUTS = {"serve": (4, [64, 64]),
          "long": (chip_smoke.LONG_TABLE, chip_smoke.LONG_LENS)}


def worker(src):
    import torch
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
        return {label: chip_smoke.time_flash_and_score(
                    torch, dev, get_config("qwen3-8b"), EngineOptions(),
                    table, lens)
                for label, (table, lens) in INPUTS.items()}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--before", required=True,
                    help="a src/ directory holding the older repro_torch")
    ap.add_argument("--worker", metavar="SRC", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        print(json.dumps(worker(args.worker)))
        return 0
    card = chip_smoke.card_line()
    turns = [("before", args.before), ("after", str(ROOT / "src")),
             ("after", str(ROOT / "src")), ("before", args.before)]
    results = []
    for version, src in turns:
        out = subprocess.run([sys.executable, __file__, "--before",
                              args.before, "--worker", src],
                             capture_output=True, text=True, check=True,
                             timeout=900, env={**os.environ,
                                               "PYTHONPATH": ""})
        recs = json.loads(out.stdout.strip().splitlines()[-1])
        results.append({"version": version, "inputs": recs})
        for label, by_name in recs.items():
            for name, r in by_name.items():
                print(f"{version:6s} {name:16s} {label:5s} event "
                      f"{r['ms']:.4f} device {r['device_ms']:.4f} host "
                      f"{r['host_ms']:.4f} ms | bound {r['bound_ms']:.5f} "
                      f"({r['bound_by']}) | library event "
                      f"{r['library_ms']:.4f} device "
                      f"{r['library_device_ms']:.4f} ms", flush=True)
    print(card)
    os.makedirs(ROOT / "chiprun_out", exist_ok=True)
    with open(ROOT / "chiprun_out" / "kernel_ab.json", "w") as f:
        json.dump({"card": card, "turns": results}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
