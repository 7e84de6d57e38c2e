"""Build and load the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper
(``-gencode arch=compute_90a,code=sm_90a``) into its own shared library
with a plain C interface, and loaded with ``ctypes``. Building happens at
first use, from the sources in the checkout, into ``_build/`` beside the
package (listed in ``.gitignore``); a library is named after the hash of
its sources and flags, so an edited kernel is rebuilt and an unchanged one
is reused. Nothing here runs at import time: modules that import this one
also run on machines without ``nvcc`` or a card.

Each kernel has an entry point for each storage type of its K/V (and
query) tensors: ``<name>_launch`` for float32, ``<name>_launch_bf16`` for
bfloat16 and ``<name>_launch_f16`` for float16, with the same arguments;
``launcher`` picks one by a tensor's dtype. Scores and the other fp32
tensors are fp32 at any of them.

The launch counters live here too: each kernel wrapper adds one to its
kernel's count right after a successful launch, and a replay of a captured
CUDA graph adds the launches captured in it (``core/decode_graphs.py``).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

PKG = Path(__file__).resolve().parents[1]
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: kernel name -> source file under csrc/ (each also includes common.cuh)
SOURCES = {
    "ragged_paged_attention": "ragged_paged_attention.cu",
    "paged_score": "paged_score.cu",
    "lightning_redundancy": "redundancy.cu",
    "paged_attention": "paged_attention.cu",
    "flash_redundancy": "flash_redundancy.cu",
    "compaction": "compaction.cu",
}

#: launches per kernel since the last ``reset_launch_counts()``
launch_counts: Dict[str, int] = {name: 0 for name in SOURCES}

_libs: Dict[str, ctypes.CDLL] = {}
_build_logs: Dict[str, str] = {}

#: the storage types the kernels read: the suffix of each one's entry point
DTYPE_SUFFIX = {"torch.float32": "", "torch.bfloat16": "_bf16",
                "torch.float16": "_f16"}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
#: C functions and their argument types; each returns an int (a CUDA error
#: code for a launch), unless listed in _RESTYPES
_ARGTYPES = {
    "ragged_paged_attention_launch":
        [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P],
    "paged_score_launch":
        [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _P],
    "lightning_redundancy_launch":
        [_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P],
    "paged_attention_launch":
        [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P],
    "flash_redundancy_launch":
        [_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P],
    "flash_redundancy_workspace": [_I, _I, _I, _I, _I, _I],
    "ragged_paged_attention_workspace": [_I, _I, _I, _I, _I, _I],
    "paged_attention_workspace": [_I, _I, _I, _I, _I, _I],
    "compaction_launch":
        [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
}
_ARGTYPES.update({fn + suffix: argtypes for fn, argtypes in _ARGTYPES.items()
                  if fn.endswith("_launch")
                  for suffix in DTYPE_SUFFIX.values() if suffix})
_RESTYPES = {name: ctypes.c_longlong for name in (
    "flash_redundancy_workspace", "ragged_paged_attention_workspace",
    "paged_attention_workspace")}


def launcher(lib: ctypes.CDLL, fn: str, dtype):
    """The entry point ``fn`` of ``lib`` for tensors of ``dtype``
    (``<fn>`` at float32, ``<fn>_bf16`` at bfloat16, ``<fn>_f16`` at
    float16). A library without that entry raises (AttributeError): no
    other entry or plain version stands in for it."""
    return getattr(lib, fn + DTYPE_SUFFIX[str(dtype)])


def count_launch(name: str) -> None:
    launch_counts[name] += 1


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def add_launches(counts: Dict[str, int]) -> None:
    """Count the launches of a graph replay: ``counts`` per kernel."""
    for name, n in counts.items():
        launch_counts[name] += n


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked on PATH and in $CUDA_HOME/bin): "
                       "the CUDA kernels are built from source at first use")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for f in (SOURCES[name], "common.cuh"):
        h.update((CSRC / f).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all() -> Dict[str, str]:
    """Compile every kernel library that is not built yet, with one
    ``nvcc`` process per source, all started together. Returns each
    kernel's compiler report (``-Xptxas -v``: registers, shared memory,
    spills); raises with the compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for name, src in SOURCES.items():
        out = _lib_path(name)
        log = out.with_suffix(".log")
        if out.exists() and log.exists():
            _build_logs[name] = log.read_text()
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, log)
    failed = []
    for name, (proc, tmp, out, log) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}:\n{text}")
            continue
        os.replace(tmp, out)
        log.write_text(text)
        _build_logs[name] = text
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return dict(_build_logs)


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        path = _lib_path(name)
        if not path.exists():
            build_all()
        lib = ctypes.CDLL(str(path))
        for fn, argtypes in _ARGTYPES.items():
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = _RESTYPES.get(fn, ctypes.c_int)
        lib.zp_error_string.argtypes = [ctypes.c_int]
        lib.zp_error_string.restype = ctypes.c_char_p
        _libs[name] = lib
    return lib


def check(name: str, lib: ctypes.CDLL, code: int) -> None:
    """Raise if a launch returned a CUDA error; else count the launch."""
    if code != 0:
        msg = lib.zp_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA error {code} at launch: {msg}")
    count_launch(name)
