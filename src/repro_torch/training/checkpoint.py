"""Fault-tolerant checkpoints (the port's ``repro.training.checkpoint``).

* atomic two-phase save: write to ``<dir>.tmp``, then ``os.replace``: a
  crash mid-save never corrupts the previous checkpoint;
* one ``.npy`` file per leaf plus a JSON manifest with the tree's paths,
  dtypes and shapes. numpy has no bfloat16, so a bf16 leaf is stored as
  its 16-bit pattern (int16), with ``bfloat16`` in the manifest; float16
  leaves are stored as numpy's own float16;
* step-tagged directories with retention, ``latest_step`` resolution.

The reference's manifest also names each leaf's sharding spec, for
restoring onto another mesh; that belongs to distribution and is left
out. ``restore`` loads into the tensors of a tree of the same structure,
in place, so a restart holds one copy of the model on its device.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil

import numpy as np
import torch

#: dtypes a leaf may have, by the name the manifest gives them
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16, "int32": torch.int32}
#: the integer type whose bits stand in for a dtype numpy lacks
_BITS = {torch.bfloat16: torch.int16}


def _flatten_with_paths(tree, prefix=""):
    if isinstance(tree, torch.Tensor):
        return {prefix: tree}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        out.update(_flatten_with_paths(v, f"{prefix}/{k}" if prefix
                                       else str(k)))
    return out


def _dtype_name(t: torch.Tensor) -> str:
    name = str(t.dtype).removeprefix("torch.")
    if name not in DTYPES:
        raise ValueError(f"cannot checkpoint a {t.dtype} leaf")
    return name


def save(ckpt_dir: str, step: int, tree, *, extra=None, keep=3):
    """Atomically save a tree of tensors; one leaf at a time goes through
    host memory."""
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "extra": extra or {}, "leaves": {}}
    for key, leaf in _flatten_with_paths(tree).items():
        t = leaf.detach()
        bits = _BITS.get(t.dtype)
        arr = (t.view(bits) if bits is not None else t).cpu().numpy()
        fname = key.replace("/", "__") + ".npy"
        np.save(os.path.join(tmp, fname), arr)
        manifest["leaves"][key] = {"file": fname, "dtype": _dtype_name(t),
                                   "shape": list(t.shape)}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)                      # atomic publish
    _gc(ckpt_dir, keep)
    return final


def _gc(ckpt_dir, keep):
    steps = sorted(d for d in os.listdir(ckpt_dir)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, d))


def latest_step(ckpt_dir: str):
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


@torch.no_grad()
def restore(ckpt_dir: str, step: int, like_tree):
    """Load the checkpoint of ``step`` into the tensors of ``like_tree``
    (same paths, dtypes and shapes), in place. Returns ``(like_tree,
    extra)``."""
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    for key, leaf in _flatten_with_paths(like_tree).items():
        info = manifest["leaves"][key]
        if info["dtype"] != _dtype_name(leaf) \
                or info["shape"] != list(leaf.shape):
            raise ValueError(
                f"checkpoint leaf {key} is {info['dtype']} {info['shape']}, "
                f"the tree's is {leaf.dtype} {list(leaf.shape)}")
        src = torch.from_numpy(np.load(os.path.join(d, info["file"])))
        if leaf.dtype in _BITS:
            src = src.view(leaf.dtype)
        leaf.copy_(src)
    return like_tree, manifest["extra"]


@torch.no_grad()
def digest(tree) -> str:
    """A fingerprint of the exact bits of every leaf, computed on the
    leaves' device: equal trees give equal digests on any device, so a
    restart can show that it restored what was saved."""
    h = hashlib.sha256()
    for key, leaf in _flatten_with_paths(tree).items():
        t = leaf.detach().reshape(-1)
        bits = {2: torch.int16, 4: torch.int32}[t.element_size()]
        sums = []
        for s in range(0, t.numel(), 1 << 24):
            x = t[s:s + (1 << 24)].view(bits).long()
            w = torch.arange(s, s + x.numel(), device=x.device) % 65521 + 1
            sums.append(torch.stack([x.sum(), (x * w).sum()]))
        total = (torch.stack(sums).sum(0) if sums
                 else torch.zeros(2, dtype=torch.int64))
        h.update(f"{key}:{leaf.dtype}:{tuple(leaf.shape)}:"
                 f"{total.tolist()};".encode())
    return h.hexdigest()[:16]
