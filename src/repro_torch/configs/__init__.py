"""Architecture configs the port serves: every config the JAX package
registers. The dense GQA family (the paper's Qwen3-8B, Llama-3-8B,
Qwen2.5-3B, OLMo-1B and Nemotron-4-15B), the MoE configs
DeepSeek-V2-Lite-16B (MLA) and DBRX-132B (GQA), the tiny CPU test model,
the recurrent configs RecurrentGemma-2B (RG-LRU with local-window
attention) and RWKV6-3B (attention-free), the encoder-decoder
Whisper-tiny (cross attention over a stub audio frontend) and
InternVL2-26B (an InternLM2-20B backbone that takes a stub vision
frontend's patch embeddings as a prefix). Each module registers one
``ArchConfig`` on import."""
import importlib

from repro_torch.configs.base import (  # noqa: F401
    ArchConfig, all_arch_names, get_config, register,
)

_MODULES = ["qwen3_8b", "llama3_8b", "qwen2_5_3b", "olmo_1b",
            "nemotron_4_15b", "deepseek_v2_lite_16b", "dbrx_132b",
            "recurrentgemma_2b", "rwkv6_3b", "whisper_tiny",
            "internvl2_26b", "tiny"]

_loaded = False


def load_all():
    global _loaded
    if _loaded:
        return
    for m in _MODULES:
        importlib.import_module(f"repro_torch.configs.{m}")
    _loaded = True
