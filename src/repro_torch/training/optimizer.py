"""AdamW + LR schedule (the port's ``repro.training.optimizer``).

Plain functions on trees of tensors (dicts and lists, as the model's
params). The optimizer state mirrors the params: ``m`` and ``v`` are fp32
whatever the param dtype, and the update math runs in fp32 and casts the
result back to each param's dtype. Clipping by global norm, bias
correction and decoupled weight decay on every leaf (norms included), as
the reference.

``adamw_update`` updates ``params`` and ``opt_state`` in place and returns
them, as the reference's launcher donates its buffers: a caller that
needs the old tree clones it first.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def tree_leaves(tree):
    """The tensors of a tree of dicts and lists, in a fixed order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    items = tree.values() if isinstance(tree, dict) else tree
    return [leaf for t in items for leaf in tree_leaves(t)]


def tree_unflatten(like, leaves):
    """A tree shaped like ``like`` holding ``leaves`` (``tree_leaves``
    order)."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, torch.Tensor):
            return next(it)
        if isinstance(t, dict):
            return {k: build(v) for k, v in t.items()}
        return [build(v) for v in t]
    return build(like)


def lr_at(cfg: AdamWConfig, step) -> float:
    """Linear warm-up, then cosine decay to ``min_lr_frac`` of the peak,
    computed in float32 as the reference does."""
    f32 = np.float32
    step = f32(int(step))
    warm = f32(cfg.lr) * step / f32(max(cfg.warmup_steps, 1))
    prog = np.clip((step - f32(cfg.warmup_steps))
                   / f32(max(cfg.total_steps - cfg.warmup_steps, 1)),
                   f32(0), f32(1))
    cos = f32(cfg.min_lr_frac) + f32((1 - cfg.min_lr_frac) * 0.5) * (
        f32(1) + np.cos(f32(math.pi) * prog))
    return float(warm if step < cfg.warmup_steps else f32(cfg.lr) * cos)


def init_opt_state(params):
    zeros = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for p in tree_leaves(params)]
    return {"m": tree_unflatten(params, zeros),
            "v": tree_unflatten(params, [torch.zeros_like(z)
                                         for z in zeros]),
            "step": torch.zeros((), dtype=torch.int32,
                                device=zeros[0].device)}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in fp32 (a 0-d tensor on
    the leaves' device)."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in tree_leaves(tree)))


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params, grads, opt_state):
    """One AdamW step. Returns ``(params, opt_state, gnorm)``, the first
    two updated in place. Grads may be bf16 or fp32; the math is fp32."""
    opt_state["step"].add_(1)
    step = int(opt_state["step"])
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    lr = lr_at(cfg, step)
    t = np.float32(step)
    bc1 = float(np.float32(1) - np.float32(cfg.b1) ** t)
    bc2 = float(np.float32(1) - np.float32(cfg.b2) ** t)
    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(opt_state["m"]),
                          tree_leaves(opt_state["v"])):
        # the reference's expressions, in place: two temporaries a leaf
        g = g.float() * scale
        m.mul_(cfg.b1).add_(g, alpha=1 - cfg.b1)
        v.mul_(cfg.b2).addcmul_(g, g, value=1 - cfg.b2)
        u = torch.div(v, bc2).sqrt_().add_(cfg.eps)
        u = torch.div(m, bc1, out=g).div_(u)
        pf = p.float()                 # p itself when p is fp32
        u.add_(pf, alpha=cfg.weight_decay)
        p.copy_(pf.sub_(u, alpha=lr))
    return params, opt_state, gnorm
