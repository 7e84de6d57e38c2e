"""The port's HTTP serving tier (``repro_torch.serve``) on the CPU.

  * the fourteen contracts of tests/test_serve.py — protocol validation,
    SSE parity with the sync engine path, backpressure, fairness,
    disconnect-abort and graceful drain — against the port's app through
    the port's in-process ``ASGIClient``, each followed by the
    whole-engine sanitizer;
  * cross-package parity: the same request bodies (unary, SSE with
    ``include_usage``, chat, a ``stop`` that fires, seeded sampling) sent
    to the JAX package's app and to the port's, each on the same weights,
    give equal JSON and equal SSE event sequences; only ``id`` and
    ``created`` may differ;
  * one real socket: ``python -m repro_torch.serve --device cpu`` in a
    subprocess on a free port answers a unary and an SSE request, and on
    SIGTERM drains and exits 0.

Shapes as in tests/test_serve.py.
"""
import asyncio
import dataclasses
import http.client
import json
import os
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path

import jax
import numpy as np
import pytest

from repro.api import Zipage as JZipage
from repro.configs import get_config as jget_config
from repro.models import lm as jlm
from repro.serve import ServeConfig as JServeConfig
from repro.serve import create_app as jcreate_app
from repro.serve.testing import ASGIClient as JASGIClient
from repro_torch.api import SamplingParams, Zipage
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import invariants
from repro_torch.serve import ServeConfig, create_app
from repro_torch.serve.cli import build_parser, config_from_args
from repro_torch.serve.fairness import ClientFairness
from repro_torch.serve.protocol import (CompletionRequest, ProtocolError,
                                        parse_token_ids, render_text)
from repro_torch.serve.testing import ASGIClient

REPO = Path(__file__).resolve().parent.parent
JCFG = dataclasses.replace(jget_config("tiny-lm"), dtype="float32")
JPARAMS = jlm.init(JCFG, jax.random.key(0))
CFG = dataclasses.replace(get_config("tiny-lm"), dtype="float32")
PARAMS = params_from_numpy(CFG, jax.tree.map(np.asarray, JPARAMS))
N_BLOCKS = 64
SHAPES = dict(block_size=8, n_total_blocks=N_BLOCKS, max_batch=4,
              m_qslots=4, n_max=3, window=4, max_model_len=128,
              prefill_rows=2, prefill_len=64, policy="priority")

# the "priority" policy is what per-client fairness maps onto
Z = Zipage(CFG, PARAMS, device="cpu", **SHAPES)
P1 = [1, 2, 3, 4, 5]


def make_client(**cfg):
    """Fresh app (own AsyncEngineLoop) on the shared warm facade."""
    app = create_app(ServeConfig(device="cpu", **cfg), zipage=Z)
    return app, ASGIClient(app)


def run(coro):
    result = asyncio.run(coro)
    assert Z.num_free_blocks == N_BLOCKS
    # whole-engine sanitizer audit post-test; the qwin-ownership shadow
    # is a between-steps check (stale across sporadic audits) — reset it
    Z.engine._qwin_shadow.clear()
    invariants.check_engine(Z.engine)
    return result


# ----------------------------------------------------------------------
# protocol layer (no engine)

def test_token_codec_roundtrip():
    assert parse_token_ids("1 2 3", "prompt") == [1, 2, 3]
    assert parse_token_ids([4, 5], "prompt") == [4, 5]
    assert render_text([1, 2, 3]) == "1 2 3"
    with pytest.raises(ProtocolError, match="must not be empty"):
        parse_token_ids("", "prompt")
    with pytest.raises(ProtocolError, match="token ids"):
        parse_token_ids("one two", "prompt")
    with pytest.raises(ProtocolError, match="token ids"):
        parse_token_ids([1, "2"], "prompt")


def test_request_validation_did_you_mean():
    with pytest.raises(ProtocolError, match="did you mean 'prompt'"):
        CompletionRequest.from_body({"promt": "1 2"}, chat=False)
    with pytest.raises(ProtocolError, match="did you mean 'messages'"):
        CompletionRequest.from_body({"message": []}, chat=True)
    # SamplingParams-level errors surface as 400s too
    with pytest.raises(ProtocolError, match="n separate requests"):
        CompletionRequest.from_body({"prompt": "1", "n": 3}, chat=False)


def test_capacity_validation_before_admission():
    req = CompletionRequest.from_body(
        {"prompt": "1 2 3", "max_tokens": 1000}, chat=False)
    with pytest.raises(ProtocolError, match="max_model_len"):
        req.check_capacity(vocab_size=256, max_model_len=128,
                           max_tokens_limit=None)
    with pytest.raises(ProtocolError, match="server's limit"):
        req.check_capacity(vocab_size=256, max_model_len=4096,
                           max_tokens_limit=512)
    req = CompletionRequest.from_body({"prompt": "999999 1"}, chat=False)
    with pytest.raises(ProtocolError, match="vocabulary"):
        req.check_capacity(vocab_size=256, max_model_len=128,
                           max_tokens_limit=None)


def test_fairness_ledger():
    f = ClientFairness()
    assert f.admit("a") == 0 and f.admit("a") == -1 and f.admit("a") == -2
    assert f.admit("b") == 0                 # other clients unaffected
    f.release("a")
    assert f.admit("a") == -2
    for _ in range(3):
        f.release("a")
    f.release("b")
    assert f.snapshot() == {}


def test_cli_arg_parsing():
    args = build_parser().parse_args(
        ["--model", "tiny-lm", "--port", "9000", "--no-fairness",
         "--max-queued-requests", "7",
         "--override", "n_total_blocks=128", "--override", "n_max=none"])
    cfg = config_from_args(args)
    assert cfg.port == 9000 and not cfg.fairness
    assert cfg.device is None                # the card, unless asked
    assert config_from_args(build_parser().parse_args(
        ["--device", "cpu"])).device == "cpu"
    assert cfg.max_queued_requests == 7
    assert cfg.engine_overrides == {"n_total_blocks": 128, "n_max": None}


# ----------------------------------------------------------------------
# end-to-end over the in-process ASGI app

def test_unary_completion_matches_generate():
    hot = SamplingParams(max_new_tokens=10, seed=7, temperature=0.8)
    ref, = Z.generate([P1], hot)
    _, client = make_client()

    async def main():
        r = await client.request("POST", "/v1/completions", json={
            "prompt": render_text(P1), "max_tokens": 10, "seed": 7,
            "temperature": 0.8})
        await client.app.state.drain()
        return r

    r = run(main())
    assert r.status == 200
    choice = r.json()["choices"][0]
    assert choice["token_ids"] == ref.token_ids
    assert choice["text"] == render_text(ref.token_ids)
    assert choice["finish_reason"] == "length"
    assert r.json()["usage"] == {"prompt_tokens": len(P1),
                                 "completion_tokens": 10,
                                 "total_tokens": len(P1) + 10}


def test_sse_stream_token_identical_to_generate():
    """Acceptance pin: the SSE-streamed completion is token-for-token
    identical to an in-process generate() of the same seeded request."""
    hot = SamplingParams(max_new_tokens=14, seed=21, temperature=1.0)
    ref, = Z.generate([P1], hot)
    _, client = make_client()

    async def main():
        async with client.stream("POST", "/v1/completions", json={
                "prompt": render_text(P1), "max_tokens": 14, "seed": 21,
                "temperature": 1.0, "stream": True,
                "stream_options": {"include_usage": True}}) as h:
            await h.started()
            assert h.status == 200
            assert h.headers["content-type"].startswith(
                "text/event-stream")
            events = [e async for e in h.events()]
        await client.app.state.drain()
        return events

    events = run(main())
    assert events[-1] == "[DONE]"
    usage = events[-2]["usage"]
    data = [e for e in events[:-2] if e["choices"]]
    toks = [t for e in data for t in e["choices"][0]["token_ids"]]
    assert toks == ref.token_ids             # the tentpole guarantee
    reasons = [e["choices"][0]["finish_reason"] for e in data]
    assert reasons[-1] == "length"
    assert all(r is None for r in reasons[:-1])
    assert usage == {"prompt_tokens": len(P1), "completion_tokens": 14,
                     "total_tokens": len(P1) + 14}


def test_chat_stream_matches_completions():
    ref, = Z.generate([P1], SamplingParams(max_new_tokens=8))
    _, client = make_client()

    async def main():
        async with client.stream("POST", "/v1/chat/completions", json={
                "messages": [{"role": "system", "content": "1 2"},
                             {"role": "user", "content": "3 4 5"}],
                "max_tokens": 8, "stream": True}) as h:
            events = [e async for e in h.events()]
        await client.app.state.drain()
        return events

    events = run(main())
    data = [e for e in events if e != "[DONE]" and e["choices"]]
    assert data[0]["choices"][0]["delta"]["role"] == "assistant"
    toks = [t for e in data
            for t in e["choices"][0]["delta"].get("token_ids", [])]
    assert toks == ref.token_ids             # same concatenated prompt
    assert data[0]["object"] == "chat.completion.chunk"


def test_disconnect_mid_stream_aborts_and_reclaims():
    """Client goes away mid-stream -> abort(), slots and blocks return
    to the pool; the whole-engine sanitizer audits the result."""
    _, client = make_client()

    async def main():
        async with client.stream("POST", "/v1/completions", json={
                "prompt": render_text(P1), "max_tokens": 100,
                "stream": True}) as h:
            ev = await h.events().__anext__()   # at least one token out
            assert ev["choices"][0]["token_ids"]
            h.disconnect()
        # context exit waited for the handler: abort has been applied
        assert not Z.has_unfinished()
        await client.app.state.drain()

    run(main())
    aborted = [r for r in Z.engine.finished.values()
               if r.finish_reason == "abort"]
    assert aborted


def test_disconnect_before_response_aborts_unary():
    _, client = make_client()

    async def main():
        async with client.stream("POST", "/v1/completions", json={
                "prompt": render_text(P1), "max_tokens": 100}) as h:
            # handle used for its disconnect control; unary response
            # won't arrive before we hang up
            await asyncio.sleep(0.05)
            h.disconnect()
        assert not Z.has_unfinished()
        await client.app.state.drain()

    run(main())


def test_backpressure_429_with_retry_after():
    parked = Z.add_request(P1, SamplingParams(max_new_tokens=30))
    _, client = make_client(max_queued_requests=1)

    async def main():
        r = await client.request("POST", "/v1/completions", json={
            "prompt": "1 2", "max_tokens": 4})
        return r

    r = asyncio.run(main())
    assert r.status == 429
    assert int(r.headers["retry-after"]) >= 1
    assert r.json()["error"]["code"] == "engine_saturated"
    Z.abort(parked)
    assert Z.num_free_blocks == N_BLOCKS


def test_graceful_drain_finishes_running_rejects_new():
    _, client = make_client()

    async def main():
        async with client.stream("POST", "/v1/completions", json={
                "prompt": render_text(P1), "max_tokens": 12,
                "stream": True}) as h:
            await h.events().__anext__()        # request is running
            drainer = asyncio.create_task(client.app.state.drain())
            await asyncio.sleep(0)              # drain closes intake
            r = await client.request("POST", "/v1/completions", json={
                "prompt": "1 2", "max_tokens": 4})
            assert r.status == 503
            assert r.json()["error"]["code"] == "draining"
            # ... but the running stream finishes and flushes
            rest = [e async for e in h.events()]
            await drainer
        health = await client.request("GET", "/health")
        assert health.status == 503             # still draining: no intake
        return rest

    rest = run(main())
    assert rest[-1] == "[DONE]"
    data = [e for e in rest[:-1] if e != "[DONE]" and e["choices"]]
    assert data[-1]["choices"][0]["finish_reason"] == "length"


def test_fairness_tags_priorities_per_client():
    _, client = make_client()

    async def main():
        streams = []
        for i, key in enumerate(["alice", "alice", "bob"]):
            h = client.stream("POST", "/v1/completions", json={
                "prompt": render_text(P1), "max_tokens": 30,
                "stream": True},
                headers={"authorization": f"Bearer {key}"})
            await h.__aenter__()
            await h.events().__anext__()
            streams.append(h)
        # alice's second request sorts behind bob's first
        prios = {r.rid: r.priority
                 for r in Z.engine.running + list(Z.engine.waiting)}
        for h in streams:
            h.disconnect()
            await h.__aexit__(None, None, None)
        await client.app.state.drain()
        return sorted(prios.values(), reverse=True)

    assert run(main()) == [0, 0, -1]


def test_misc_endpoints_and_errors():
    _, client = make_client()

    async def main():
        health = await client.request("GET", "/health")
        models = await client.request("GET", "/v1/models")
        missing = await client.request("GET", "/v1/nope")
        wrong = await client.request("GET", "/v1/completions")
        bad_json = await client.request("POST", "/v1/completions",
                                        body=b"{nope")
        bad_field = await client.request("POST", "/v1/completions", json={
            "prompt": "1 2", "max_token": 4})
        too_long = await client.request("POST", "/v1/completions", json={
            "prompt": "1 2", "max_tokens": 127})
        await client.app.state.drain()
        return health, models, missing, wrong, bad_json, bad_field, \
            too_long

    health, models, missing, wrong, bad_json, bad_field, too_long = \
        run(main())
    assert health.status == 200 and health.json()["backlog"] == 0
    assert models.json()["data"][0]["id"] == "tiny-lm"
    assert missing.status == 404
    assert wrong.status == 405
    assert bad_json.status == 400
    assert bad_field.status == 400
    assert "did you mean 'max_tokens'" in \
        bad_field.json()["error"]["message"]
    assert too_long.status == 400
    assert "max_model_len" in too_long.json()["error"]["message"]


# ----------------------------------------------------------------------
# the port's app against the JAX package's, on the same weights

LONG = [1, 2, 3, 4, 5] * 6


@pytest.fixture(scope="module")
def jz():
    return JZipage(JCFG, JPARAMS, kernel_backend="jnp", **SHAPES)


def _stop_pair():
    """Two consecutive tokens from the middle of LONG's greedy output:
    a stop sequence that fires there."""
    out, = Z.generate([LONG], SamplingParams(max_new_tokens=24))
    return out.token_ids[10:12]


def _bodies():
    return {
        "unary": ("/v1/completions", {
            "prompt": render_text(LONG), "max_tokens": 40}),
        "sse_usage": ("/v1/completions", {
            "prompt": render_text(P1), "max_tokens": 30, "seed": 21,
            "temperature": 1.0, "stream": True,
            "stream_options": {"include_usage": True}}),
        "chat": ("/v1/chat/completions", {
            "messages": [{"role": "system", "content": "1 2"},
                         {"role": "user", "content": "3 4 5"}],
            "max_tokens": 20, "stream": True}),
        "stop": ("/v1/completions", {
            "prompt": render_text(LONG), "max_tokens": 24,
            "stop": _stop_pair()}),
        "seeded": ("/v1/completions", {
            "prompt": list(range(10, 80)), "max_tokens": 40,
            "temperature": 0.6, "top_p": 0.95, "top_k": 20, "seed": 7}),
    }


async def _send(client, path, body):
    if body.get("stream"):
        async with client.stream("POST", path, json=body) as h:
            events = [e async for e in h.events()]
        return h.status, events
    r = await client.request("POST", path, json=body)
    return r.status, r.json()


def _strip(payload):
    if isinstance(payload, list):
        return [_strip(p) for p in payload]
    if isinstance(payload, dict):
        return {k: v for k, v in payload.items()
                if k not in ("id", "created")}
    return payload


@pytest.mark.parametrize("kind", ["unary", "sse_usage", "chat", "stop",
                                  "seeded"])
def test_responses_equal_the_jax_app(jz, kind):
    path, body = _bodies()[kind]

    async def serve(app, client):
        got = await _send(client, path, body)
        await app.state.drain()
        return got

    japp = jcreate_app(JServeConfig(), zipage=jz)
    want = asyncio.run(serve(japp, JASGIClient(japp)))
    app, client = make_client()
    got = run(serve(app, client))
    assert got[0] == want[0] == 200
    assert _strip(got[1]) == _strip(want[1])
    if kind == "stop":
        assert got[1]["choices"][0]["finish_reason"] == "stop"
    if kind in ("unary", "seeded"):       # compression fired in both
        last = Z.output(max(Z.engine.finished))
        assert last.metrics.compression.n_compressions > 0
    if kind == "sse_usage":
        assert got[1][-1] == "[DONE]" and got[1][-2]["usage"] == {
            "prompt_tokens": len(P1), "completion_tokens": 30,
            "total_tokens": len(P1) + 30}


# ----------------------------------------------------------------------
# the CLI over a real socket


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _post(port, body, timeout=60):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    conn.request("POST", "/v1/completions", json.dumps(body),
                 {"content-type": "application/json"})
    r = conn.getresponse()
    data = r.read()
    conn.close()
    return r.status, data


def test_cli_serves_over_a_socket_and_drains_on_sigterm():
    port = _free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO / "src")] + [p for p in [env.get("PYTHONPATH")] if p])
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.serve", "--device", "cpu",
         "--model", "tiny-lm", "--port", str(port)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
        cwd=REPO, text=True)
    try:
        deadline = time.monotonic() + 90
        while True:
            try:
                conn = http.client.HTTPConnection("127.0.0.1", port,
                                                  timeout=5)
                conn.request("GET", "/health")
                health = conn.getresponse()
                assert health.status == 200
                assert json.loads(health.read())["draining"] is False
                conn.close()
                break
            except OSError:
                assert proc.poll() is None, proc.stdout.read()
                assert time.monotonic() < deadline, "server never came up"
                time.sleep(0.2)
        status, data = _post(port, {"prompt": "1 2 3", "max_tokens": 8})
        assert status == 200
        unary = json.loads(data)["choices"][0]["token_ids"]
        status, data = _post(port, {"prompt": [1, 2, 3], "max_tokens": 8,
                                    "stream": True})
        assert status == 200
        frames = [f[6:] for f in data.decode().split("\n\n")
                  if f.startswith("data: ")]
        assert frames[-1] == "[DONE]"
        events = [json.loads(f) for f in frames[:-1]]
        assert [t for e in events for t in e["choices"][0]["token_ids"]] \
            == unary and len(unary) == 8
        assert events[-1]["choices"][0]["finish_reason"] == "length"
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, out
    assert "device=cpu" in out
    assert "draining..." in out and "drained, bye" in out
    assert out.index("draining...") < out.index("drained, bye")
