"""Architecture configs the port serves: the paper's Qwen3-8B and the tiny
CPU test model. Each module registers one ``ArchConfig`` on import."""
import importlib

from repro_torch.configs.base import (  # noqa: F401
    ArchConfig, all_arch_names, get_config, register,
)

_MODULES = ["qwen3_8b", "tiny"]

_loaded = False


def load_all():
    global _loaded
    if _loaded:
        return
    for m in _MODULES:
        importlib.import_module(f"repro_torch.configs.{m}")
    _loaded = True
