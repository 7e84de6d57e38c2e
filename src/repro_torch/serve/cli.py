"""CLI entry point: ``python -m repro_torch.serve --model tiny-lm --port 8000``.

Brings up the engine (on the card; ``--device cpu`` for the CPU), hosts
the ASGI app on the stdlib HTTP bridge and
wires SIGTERM/SIGINT to graceful drain: intake closes (new requests get
503), running requests finish and flush their streams, then the process
exits.
"""
from __future__ import annotations

import argparse
import asyncio
import signal

from repro_torch.serve.app import create_app
from repro_torch.serve.config import ServeConfig
from repro_torch.serve.http import run_server


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.serve",
        description="OpenAI-compatible serving tier for the Zipage engine "
                    "(PyTorch/CUDA port)")
    p.add_argument("--model", default="tiny-lm")
    p.add_argument("--device", default=None,
                   help="device of the engine (default: cuda, which "
                        "raises without a card; cpu runs the kernels' "
                        "plain versions)")
    p.add_argument("--full-size", action="store_true",
                   help="use the full architecture (default: reduced)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--max-queued-requests", type=int, default=64)
    p.add_argument("--max-tokens-limit", type=int, default=512)
    p.add_argument("--no-fairness", action="store_true")
    p.add_argument("--policy", default="priority",
                   help="scheduler admission policy (priority enables "
                        "per-client fairness)")
    p.add_argument("--override", action="append", default=[],
                   metavar="KEY=VALUE",
                   help="flat engine-config override, repeatable "
                        "(e.g. --override n_total_blocks=128)")
    return p


def _parse_overrides(pairs) -> dict:
    out = {}
    for pair in pairs:
        key, _, value = pair.partition("=")
        if not _ or not key:
            raise SystemExit(f"--override expects KEY=VALUE, got {pair!r}")
        try:
            out[key] = int(value)
        except ValueError:
            try:
                out[key] = float(value)
            except ValueError:
                out[key] = {"true": True, "false": False,
                            "none": None}.get(value.lower(), value)
    return out


def config_from_args(args) -> ServeConfig:
    return ServeConfig(
        model=args.model, reduce=not args.full_size, host=args.host,
        port=args.port, max_queued_requests=args.max_queued_requests,
        max_tokens_limit=args.max_tokens_limit,
        fairness=not args.no_fairness, policy=args.policy,
        engine_overrides=_parse_overrides(args.override),
        device=args.device)


async def amain(config: ServeConfig) -> None:
    app = create_app(config)
    loop = asyncio.get_running_loop()
    server_task = asyncio.create_task(
        run_server(app, config.host, config.port))
    stop = asyncio.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        loop.add_signal_handler(sig, stop.set)
    print(f"repro_torch.serve: listening on http://{config.host}:"
          f"{config.port} (model={config.model}, device="
          f"{app.state.zipage.engine.device}, max_queued="
          f"{config.max_queued_requests})", flush=True)
    await stop.wait()
    print("repro_torch.serve: draining... (finishing running requests, "
          "rejecting new ones)", flush=True)
    await app.state.drain()               # graceful: flush, then stop
    server_task.cancel()
    try:
        await server_task
    except asyncio.CancelledError:
        pass
    print("repro_torch.serve: drained, bye", flush=True)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    asyncio.run(amain(config_from_args(args)))
    return 0
