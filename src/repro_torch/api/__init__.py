"""Public serving API of the PyTorch/CUDA port.

    from repro_torch.api import Zipage, SamplingParams

    z = Zipage.from_config("qwen3-8b")                  # on the card
    z = Zipage.from_config("tiny-lm", device="cpu")     # plain versions
    outs = z.generate([[1, 2, 3]], SamplingParams(max_new_tokens=32))
    out = await z.generate_async([1, 2, 3])             # in a coroutine

Same names and knobs as ``repro.api`` for what the port supports.
"""
from repro_torch.api.config import (KERNEL_BACKENDS, CacheConfig,  # noqa: F401
                                    ModelRunnerConfig, SchedulerConfig,
                                    build_engine_options)
from repro_torch.api.outputs import (CompletionChunk,  # noqa: F401
                                     CompressionMetrics, FinishReason,
                                     RequestMetrics, RequestOutput,
                                     UsageInfo)
from repro_torch.api.params import SamplingParams  # noqa: F401
from repro_torch.api.engine import Zipage  # noqa: F401
from repro_torch.api.aio import (AsyncEngineLoop,  # noqa: F401
                                 EngineDraining, EngineSaturated)

__all__ = [
    "Zipage", "AsyncEngineLoop", "EngineSaturated", "EngineDraining",
    "SamplingParams", "RequestOutput", "CompletionChunk",
    "RequestMetrics", "CompressionMetrics", "FinishReason", "UsageInfo",
    "CacheConfig", "SchedulerConfig", "ModelRunnerConfig",
    "build_engine_options", "KERNEL_BACKENDS",
]
