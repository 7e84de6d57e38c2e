"""OpenAI wire protocol: request parsing/validation and response shaping.

The repo has no tokenizer — requests carry token ids directly, either as
JSON integer lists or as whitespace-separated integer strings ("1 2 3"),
and response ``text`` renders ids back as the same string form
(docs/SERVING.md "Token codec"). Everything else follows the OpenAI
completions/chat schema closely enough that off-the-shelf clients work
once their tokenizer step is bypassed.

Validation is strict and actionable: unknown body fields get a
did-you-mean 400 (mirroring ``SamplingParams``' own kwarg checking),
and engine-capacity violations (prompt too long, cap exceeded) are
rejected here — before admission — so a malformed request can never
trip an assertion inside the background engine loop.
"""
from __future__ import annotations

import difflib
import json
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.api import SamplingParams, UsageInfo


class ProtocolError(Exception):
    """Maps to an OpenAI-style 400 error body."""

    def __init__(self, message: str, param: Optional[str] = None,
                 status: int = 400):
        super().__init__(message)
        self.message = message
        self.param = param
        self.status = status


def error_body(message: str, *, err_type: str = "invalid_request_error",
               param: Optional[str] = None, code: Optional[str] = None
               ) -> dict:
    return {"error": {"message": message, "type": err_type,
                      "param": param, "code": code}}


# ----------------------------------------------------------------------
# token codec

def parse_token_ids(value, field: str) -> List[int]:
    """Accept a token-id list or a whitespace-separated int string."""
    if isinstance(value, str):
        try:
            ids = [int(t) for t in value.split()]
        except ValueError:
            raise ProtocolError(
                f"'{field}' must be token ids: a list of ints or a "
                f"whitespace-separated int string (got {value!r})",
                param=field) from None
    elif isinstance(value, (list, tuple)) \
            and all(isinstance(t, int) and not isinstance(t, bool)
                    for t in value):
        ids = list(value)
    else:
        raise ProtocolError(
            f"'{field}' must be a list of token ids or a whitespace-"
            "separated int string", param=field)
    if not ids:
        raise ProtocolError(f"'{field}' must not be empty", param=field)
    return ids


def render_text(ids: Sequence[int]) -> str:
    return " ".join(str(i) for i in ids)


# ----------------------------------------------------------------------
# request models

_COMMON_FIELDS = (
    "model", "max_tokens", "temperature", "top_p", "top_k", "seed",
    "stop", "stream", "stream_options", "n", "logprobs", "user",
)
COMPLETION_FIELDS = _COMMON_FIELDS + ("prompt",)
CHAT_FIELDS = _COMMON_FIELDS + ("messages",)


def _check_fields(body: dict, known: Tuple[str, ...], endpoint: str):
    unknown = [k for k in body if k not in known]
    if not unknown:
        return
    hints = []
    for k in unknown:
        close = difflib.get_close_matches(k, known, n=1)
        hints.append(f"{k!r}" + (f" (did you mean {close[0]!r}?)"
                                 if close else ""))
    raise ProtocolError(
        f"unknown field(s) for {endpoint}: {', '.join(hints)}; known "
        f"fields: {', '.join(known)}", param=unknown[0])


def _parse_stop(value) -> Tuple[Tuple[int, ...], ...]:
    if value is None:
        return ()
    if isinstance(value, str) or (isinstance(value, (list, tuple))
                                  and value
                                  and isinstance(value[0], int)):
        value = [value]
    return tuple(tuple(parse_token_ids(s, "stop")) for s in value)


class CompletionRequest:
    """A validated /v1/completions (or chat) request, engine-ready."""

    def __init__(self, prompt: List[int], params: SamplingParams,
                 *, model: str, stream: bool, include_usage: bool,
                 echo_chat: bool, client_hint: Optional[str]):
        self.prompt = prompt
        self.params = params
        self.model = model
        self.stream = stream
        self.include_usage = include_usage
        self.chat = echo_chat           # shape the response as chat.*
        self.client_hint = client_hint  # body "user" field, if any

    @classmethod
    def from_body(cls, body, *, chat: bool) -> "CompletionRequest":
        if not isinstance(body, dict):
            raise ProtocolError("request body must be a JSON object")
        endpoint = ("/v1/chat/completions" if chat else "/v1/completions")
        _check_fields(body, CHAT_FIELDS if chat else COMPLETION_FIELDS,
                      endpoint)
        if chat:
            prompt = _prompt_from_messages(body.get("messages"))
        else:
            if "prompt" not in body:
                raise ProtocolError("'prompt' is required", param="prompt")
            prompt = parse_token_ids(body["prompt"], "prompt")

        kwargs = {}
        for k in ("max_tokens", "temperature", "top_p", "top_k",
                  "seed", "n"):
            if body.get(k) is not None:
                kwargs[k] = body[k]
        if body.get("stop") is not None:
            kwargs["stop"] = _parse_stop(body["stop"])
        if body.get("logprobs"):
            kwargs["logprobs"] = True
        try:
            params = SamplingParams(**kwargs)
        except (TypeError, ValueError) as e:
            raise ProtocolError(str(e)) from None

        stream = bool(body.get("stream", False))
        opts = body.get("stream_options") or {}
        if not isinstance(opts, dict):
            raise ProtocolError("'stream_options' must be an object",
                                param="stream_options")
        include_usage = bool(opts.get("include_usage", False))
        user = body.get("user")
        if user is not None and not isinstance(user, str):
            raise ProtocolError("'user' must be a string", param="user")
        return cls(prompt, params, model=str(body.get("model", "")),
                   stream=stream, include_usage=include_usage,
                   echo_chat=chat, client_hint=user)

    def check_capacity(self, *, vocab_size: int, max_model_len: int,
                       max_tokens_limit: Optional[int]):
        """Engine-capacity validation, done before admission so a bad
        request 400s instead of tripping engine assertions."""
        bad = [t for t in self.prompt if not 0 <= t < vocab_size]
        if bad:
            raise ProtocolError(
                f"prompt token id {bad[0]} outside the model vocabulary "
                f"[0, {vocab_size})", param="prompt")
        if max_tokens_limit is not None \
                and self.params.max_new_tokens > max_tokens_limit:
            raise ProtocolError(
                f"max_tokens={self.params.max_new_tokens} exceeds this "
                f"server's limit of {max_tokens_limit}",
                param="max_tokens")
        total = len(self.prompt) + self.params.max_new_tokens
        if total > max_model_len:
            raise ProtocolError(
                f"prompt ({len(self.prompt)} tokens) + max_tokens "
                f"({self.params.max_new_tokens}) = {total} exceeds "
                f"max_model_len={max_model_len}", param="max_tokens")


def _prompt_from_messages(messages) -> List[int]:
    if not isinstance(messages, list) or not messages:
        raise ProtocolError("'messages' must be a non-empty array",
                            param="messages")
    prompt: List[int] = []
    for i, m in enumerate(messages):
        if not isinstance(m, dict) or "role" not in m \
                or "content" not in m:
            raise ProtocolError(
                f"messages[{i}] must be an object with 'role' and "
                "'content'", param="messages")
        if m["role"] not in ("system", "user", "assistant"):
            raise ProtocolError(
                f"messages[{i}].role must be system|user|assistant",
                param="messages")
        # no tokenizer: message contents are token ids and the chat
        # template is plain concatenation in message order
        prompt.extend(parse_token_ids(m["content"],
                                      f"messages[{i}].content"))
    return prompt


# ----------------------------------------------------------------------
# response shaping

def usage_dict(usage: Optional[UsageInfo]) -> Optional[dict]:
    if usage is None:
        return None
    return {"prompt_tokens": usage.prompt_tokens,
            "completion_tokens": usage.completion_tokens,
            "total_tokens": usage.total_tokens}


def completion_response(req: CompletionRequest, out, created: int) -> dict:
    """Final (non-streaming) response for either endpoint."""
    if req.chat:
        choice = {"index": 0,
                  "message": {"role": "assistant",
                              "content": render_text(out.token_ids),
                              "token_ids": list(out.token_ids)},
                  "finish_reason": out.finish_reason}
        obj = "chat.completion"
    else:
        choice = {"index": 0, "text": render_text(out.token_ids),
                  "token_ids": list(out.token_ids),
                  "finish_reason": out.finish_reason}
        obj = "text_completion"
    return {"id": f"cmpl-{out.request_id}", "object": obj,
            "created": created, "model": req.model,
            "choices": [choice], "usage": usage_dict(out.usage)}


def chunk_payload(req: CompletionRequest, rid: int, token_ids,
                  finish_reason: Optional[str], created: int,
                  *, first: bool) -> dict:
    """One SSE data payload for a streamed delta."""
    if req.chat:
        delta: Dict[str, object] = {}
        if first:
            delta["role"] = "assistant"
        if token_ids:
            delta["content"] = render_text(token_ids)
            delta["token_ids"] = list(token_ids)
        choice = {"index": 0, "delta": delta,
                  "finish_reason": finish_reason}
        obj = "chat.completion.chunk"
    else:
        choice = {"index": 0, "text": render_text(token_ids),
                  "token_ids": list(token_ids),
                  "finish_reason": finish_reason}
        obj = "text_completion"
    return {"id": f"cmpl-{rid}", "object": obj, "created": created,
            "model": req.model, "choices": [choice]}


def usage_chunk_payload(req: CompletionRequest, rid: int,
                        usage: Optional[UsageInfo], created: int) -> dict:
    """OpenAI stream_options.include_usage: a final chunk with empty
    choices carrying the usage record."""
    return {"id": f"cmpl-{rid}",
            "object": ("chat.completion.chunk" if req.chat
                       else "text_completion"),
            "created": created, "model": req.model, "choices": [],
            "usage": usage_dict(usage)}


def dumps(payload: dict) -> bytes:
    return json.dumps(payload, separators=(",", ":")).encode()
