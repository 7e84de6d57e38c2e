"""Training step builder (the port's ``repro.training.train_loop``): loss,
gradient accumulation in fp32 and AdamW, on one device.

The reference's ``pod_axis`` (an EF-int8 compressed reduction across a
manual mesh axis, ``repro.training.compress_grads``) belongs to
distribution and is not ported: asking for it raises.
"""
from __future__ import annotations

import torch

from repro_torch.models import lm
from repro_torch.training import optimizer as opt


def microbatch(batch, accum_steps):
    """Split every leaf of ``batch`` along its leading dim into
    ``accum_steps`` micro-batches: (B, ...) -> (accum_steps, B / accum,
    ...)."""
    def split(x):
        B = x.shape[0]
        return x.reshape(accum_steps, B // accum_steps, *x.shape[1:])
    return {k: split(v) for k, v in batch.items()}


def build_loss_fn(cfg, *, vocab_chunk=256):
    def loss_fn(params, batch):
        return lm.lm_loss(cfg, params, batch, vocab_chunk=vocab_chunk)
    return loss_fn


def _as_tensors(batch, device):
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def build_train_step(cfg, adamw: opt.AdamWConfig, *, accum_steps=1,
                     vocab_chunk=256, pod_axis=None):
    """Returns train_step(params, opt_state, err_state, batch) ->
    (params, opt_state, err_state, metrics), ``params`` and ``opt_state``
    updated in place. ``batch`` holds ``tokens`` and ``labels`` (B, S),
    as numpy arrays or tensors; they go to the params' device. The
    metrics are ``loss`` and ``grad_norm`` (0-d fp32 tensors on that
    device) and ``lr`` (a float)."""
    if pod_axis is not None:
        raise NotImplementedError(
            f"pod_axis={pod_axis!r} (EF-int8 compressed gradient reduction "
            "across a mesh axis) is not ported to repro_torch yet: it "
            "belongs to distribution")
    loss_fn = build_loss_fn(cfg, vocab_chunk=vocab_chunk)

    def value_and_grad(params, batch):
        """The loss and its gradient by every leaf, at the leaves' dtype.
        The leaves are differentiated through detached aliases, so the
        caller's tensors keep ``requires_grad`` as they were."""
        leaves = opt.tree_leaves(params)
        xs = [p.detach().requires_grad_(True) for p in leaves]
        with torch.enable_grad():
            loss = loss_fn(opt.tree_unflatten(params, xs), batch)
            grads = torch.autograd.grad(loss, xs, allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g
                 for x, g in zip(xs, grads)]
        return loss.detach(), grads

    def grads_of(params, batch):
        if accum_steps == 1:
            return value_and_grad(params, batch)
        micro = microbatch(batch, accum_steps)
        loss_sum = None
        g_sum = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                 for p in opt.tree_leaves(params)]
        for i in range(accum_steps):
            loss, g = value_and_grad(params,
                                     {k: v[i] for k, v in micro.items()})
            loss_sum = loss if loss_sum is None else loss_sum + loss
            for a, b in zip(g_sum, g):
                a.add_(b.float())
            del g
        inv = 1.0 / accum_steps
        for g in g_sum:
            g.mul_(inv)
        return loss_sum * inv, g_sum

    def train_step(params, opt_state, err_state, batch):
        device = opt.tree_leaves(params)[0].device
        loss, grads = grads_of(params, _as_tensors(batch, device))
        grads = opt.tree_unflatten(params, grads)
        params, opt_state, gnorm = opt.adamw_update(adamw, params, grads,
                                                    opt_state)
        metrics = {"loss": loss, "grad_norm": gnorm,
                   "lr": opt.lr_at(adamw, opt_state["step"])}
        return params, opt_state, err_state, metrics

    return train_step
