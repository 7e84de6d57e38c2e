"""Rules of the port itself: it imports neither JAX nor the JAX package,
and its entry points run on the card unless the caller asks for the CPU.
"""
import ast
from pathlib import Path

import pytest
import torch

from repro_torch.api import SamplingParams, Zipage
from repro_torch.configs import get_config
from repro_torch.core.compression import CompressOptions
from repro_torch.core.engine import EngineOptions, ZipageEngine
from repro_torch.device import resolve_device
from repro_torch.models import lm

REPO = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + \
    [REPO / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
#: the serving tier is standard library only: the card's machine has none
#: of these
HTTP_PACKAGES = ("aiohttp", "httpx", "uvicorn", "starlette", "fastapi",
                 "flask", "requests", "urllib3", "websockets")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this module runs, restored after: the
    suite runs six workers on a few cores, where torch's default of one
    spinning thread a core makes these small ops many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield node.lineno, a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""
        elif isinstance(node, ast.Call) and node.args and isinstance(
                node.args[0], ast.Constant) and isinstance(
                    node.args[0].value, str) and (
                getattr(node.func, "attr", None) == "import_module"
                or getattr(node.func, "id", None) == "__import__"):
            yield node.lineno, node.args[0].value


def test_port_imports_no_jax_and_nothing_of_repro():
    assert len(PORT_FILES) > 20
    bad = [f"{p.relative_to(REPO)}:{line}: {mod}"
           for p in PORT_FILES for line, mod in _imported_modules(p)
           if mod.split(".")[0] in FORBIDDEN + HTTP_PACKAGES]
    assert bad == []


def test_scan_catches_a_forbidden_import(tmp_path):
    f = tmp_path / "x.py"
    f.write_text("import os\nfrom repro.core import paged\n"
                 "importlib.import_module('jax.numpy')\n")
    assert [m for _l, m in _imported_modules(f)] == \
        ["os", "repro.core", "jax.numpy"]


def _no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_need_a_card_by_default(monkeypatch):
    _no_card(monkeypatch)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Zipage.from_config("tiny-lm")
    cfg = get_config("tiny-lm")
    params = lm.init(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ZipageEngine(cfg, params, EngineOptions())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Zipage(cfg, params)


def test_cpu_when_asked(monkeypatch):
    _no_card(monkeypatch)
    assert resolve_device("cpu").type == "cpu"
    z = Zipage.from_config("tiny-lm", device="cpu", block_size=8,
                           n_total_blocks=16, max_batch=2, max_model_len=64,
                           prefill_rows=1, prefill_len=32)
    assert z.engine.device.type == "cpu"
    assert z.engine.state["pools"]["k"].device.type == "cpu"


def _serving_entry_points(device):
    """The serving tier's entry points, each built with ``device`` (None
    leaves the choice to the entry point)."""
    from repro_torch.launch import serve as launch
    from repro_torch.serve import ServeConfig, ServerState, create_app
    from repro_torch.serve import cli

    small = dict(block_size=8, n_total_blocks=16, max_batch=2,
                 max_model_len=64, prefill_rows=1, prefill_len=32)
    dev = [] if device is None else ["--device", device]
    return {
        "state": lambda: ServerState(ServeConfig(
            device=device, engine_overrides=small)).zipage,
        "app": lambda: create_app(ServeConfig(
            device=device, engine_overrides=small)).state.zipage,
        "cli": lambda: cli.create_app(cli.config_from_args(
            cli.build_parser().parse_args(dev))).state.zipage,
        "launcher": lambda: launch.run_engine(
            "tiny-lm", [([1, 2, 3], 4)], device=device, **small)["engine"],
    }


@pytest.mark.parametrize("entry", ["state", "app", "cli", "launcher"])
def test_serving_entry_points_need_a_card_by_default(monkeypatch, entry):
    _no_card(monkeypatch)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _serving_entry_points(None)[entry]()


def test_serve_cli_main_needs_a_card_by_default(monkeypatch):
    from repro_torch.serve import cli
    _no_card(monkeypatch)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["--model", "tiny-lm", "--port", "0"])


@pytest.mark.parametrize("entry", ["state", "app", "cli", "launcher"])
def test_serving_entry_points_on_the_cpu_when_asked(monkeypatch, entry):
    _no_card(monkeypatch)
    z = _serving_entry_points("cpu")[entry]()
    assert z.engine.device.type == "cpu"
    assert z.engine.state["pools"]["k"].device.type == "cpu"


TRAIN_SMALL = ["--arch", "tiny-lm", "--steps", "2", "--seq-len", "16",
               "--global-batch", "2", "--vocab-chunk", "16"]
EVAL_SMALL = ["--smoke", "--requests", "3", "--train-steps", "2"]


def _training_and_eval_entry_points(device, tmp_path):
    """The training launcher and the eval's entry points, each run with
    ``device`` (None leaves the choice to the entry point)."""
    from repro_torch.eval import __main__ as eval_cli
    from repro_torch.eval import runner
    from repro_torch.launch import train

    dev = [] if device is None else ["--device", device]
    out = str(tmp_path / "eval.json")
    return {
        "train": lambda: train.main(TRAIN_SMALL + dev),
        "eval": lambda: eval_cli.main(EVAL_SMALL + ["--out", out] + dev),
        "trained_params": lambda: runner.trained_params(2, 0, device),
        "run_eval": lambda: runner.run_eval(n_requests=3, train_steps=2,
                                            device=device),
    }


@pytest.mark.parametrize("entry", ["train", "eval", "trained_params",
                                   "run_eval"])
def test_training_and_eval_entry_points_need_a_card_by_default(
        monkeypatch, tmp_path, entry):
    _no_card(monkeypatch)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _training_and_eval_entry_points(None, tmp_path)[entry]()


@pytest.mark.parametrize("entry", ["train", "eval"])
def test_training_and_eval_entry_points_on_the_cpu_when_asked(
        monkeypatch, tmp_path, capsys, entry):
    import json
    _no_card(monkeypatch)
    result = _training_and_eval_entry_points("cpu", tmp_path)[entry]()
    out = capsys.readouterr().out
    if entry == "train":
        summary = json.loads(out.strip().splitlines()[-1])
        assert summary["device"] == "cpu" and len(summary["losses"]) == 2
        assert result == summary["losses"]["2"]
    else:
        assert result == 0 and "| full_kv |" in out
        report = json.loads((tmp_path / "eval.json").read_text())
        assert report["schema"] == "zipage-eval/v1"
        assert [r["n"] for r in report["results"]] == [3] * 5


@pytest.mark.parametrize("knob", [
    dict(dtype="float64"),
])
def test_unported_knobs_raise(knob):
    with pytest.raises(NotImplementedError, match="not ported"):
        Zipage.from_config("tiny-lm", device="cpu", **knob)


def test_dtype_knob_is_accepted():
    """bfloat16 serves on the CPU: the K/V pools, the observation windows
    and the model's matrices at bf16, the global scores F and the norms'
    scales in fp32 (tests/test_torch_bf16.py holds it against the JAX
    package)."""
    z = Zipage.from_config("tiny-lm", device="cpu", block_size=8,
                           n_total_blocks=16, max_batch=2, max_model_len=64,
                           prefill_rows=1, prefill_len=32, dtype="bfloat16")
    outs = z.generate([[1, 2, 3], [4, 5]], SamplingParams(max_new_tokens=12))
    assert [len(o.token_ids) for o in outs] == [12, 12]
    st, params = z.engine.state, z.engine.params
    assert st["pools"]["k"].dtype == st["pools"]["v"].dtype == torch.bfloat16
    assert st["qwin"].dtype == torch.bfloat16
    assert st["pools"]["f"].dtype == torch.float32
    assert params["embed"].dtype == torch.bfloat16
    assert params["layers"][0]["attn"]["wq"].dtype == torch.bfloat16
    assert params["final_norm"]["scale"].dtype == torch.float32
    assert z.num_free_blocks == 16


def test_float16_knob_is_accepted():
    """float16 serves on the CPU: the K/V pools, the observation windows
    and the model's matrices at fp16, the global scores F and the norms'
    scales in fp32 (tests/test_torch_fp16.py holds it against the JAX
    package)."""
    z = Zipage.from_config("tiny-lm", device="cpu", block_size=8,
                           n_total_blocks=16, max_batch=2, max_model_len=64,
                           prefill_rows=1, prefill_len=32, dtype="float16")
    outs = z.generate([[1, 2, 3], [4, 5]], SamplingParams(max_new_tokens=12))
    assert [len(o.token_ids) for o in outs] == [12, 12]
    st, params = z.engine.state, z.engine.params
    assert st["pools"]["k"].dtype == st["pools"]["v"].dtype == torch.float16
    assert st["qwin"].dtype == torch.float16
    assert st["pools"]["f"].dtype == torch.float32
    assert params["embed"].dtype == torch.float16
    assert params["layers"][0]["attn"]["wq"].dtype == torch.float16
    assert params["final_norm"]["scale"].dtype == torch.float32
    assert params["layers"][0]["ln1"]["scale"].dtype == torch.float32
    assert z.num_free_blocks == 16


@pytest.mark.parametrize("knob", [
    dict(preemption_mode="swap", swap_space_blocks=8),
    dict(preemption_mode="auto", swap_space_blocks=8),
    dict(cache_compressed_prefixes=True),
])
def test_memory_knobs_are_accepted(knob):
    """The host swap tier and compressed-prefix caching serve on the CPU
    (tests/test_torch_swap.py and tests/test_torch_prefix_cache.py hold
    them against the JAX engine)."""
    z = Zipage.from_config("tiny-lm", device="cpu", block_size=8,
                           n_total_blocks=16, max_batch=2, max_model_len=64,
                           prefill_rows=1, prefill_len=32, **knob)
    for k, v in knob.items():
        assert getattr(z.engine.opts, k) == v
    assert (z.engine.swap_pool is not None) == ("swap_space_blocks" in knob)
    assert z.engine.scheduler.p.cache_compressed_prefixes == \
        knob.get("cache_compressed_prefixes", False)
    outs = z.generate([[1, 2, 3], [4, 5]], SamplingParams(max_new_tokens=12))
    assert [len(o.token_ids) for o in outs] == [12, 12]
    assert z.num_free_blocks == 16


@pytest.mark.parametrize("knob", [
    dict(decode_steps=4),
    dict(decode_steps=8),
    dict(fuse_sampling=False),
])
def test_decode_knobs_are_accepted(knob):
    """Multi-step fused decode and the unfused path serve on the CPU."""
    z = Zipage.from_config("tiny-lm", device="cpu", block_size=8,
                           n_total_blocks=16, max_batch=2, max_model_len=64,
                           prefill_rows=1, prefill_len=32, **knob)
    for k, v in knob.items():
        assert getattr(z.engine.opts, k) == v
    outs = z.generate([[1, 2, 3], [4, 5]], SamplingParams(max_new_tokens=12))
    assert [len(o.token_ids) for o in outs] == [12, 12]
    horizon = max(m["decode_horizon"] for m in z.metrics)
    assert (horizon > 1) == (knob.get("decode_steps", 1) > 1)


@pytest.mark.parametrize("knob", [
    dict(fuse_sampling=False, decode_steps=4),
    dict(decode_steps=0),
])
def test_decode_knobs_refused_as_in_jax(knob):
    """``decode_steps > 1`` needs fused sampling and ``decode_steps`` is at
    least 1 (tests/test_fused_decode.py)."""
    with pytest.raises(ValueError, match="decode_steps"):
        Zipage.from_config("tiny-lm", device="cpu", **knob)


def test_unknown_decode_kernel_raises():
    """``decode_kernel`` is ragged or dense, as in the JAX package; the
    engine refuses anything else too."""
    with pytest.raises(ValueError, match="decode_kernel"):
        Zipage.from_config("tiny-lm", device="cpu", decode_kernel="bogus")
    cfg = get_config("tiny-lm")
    params = lm.init(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="decode_kernel"):
        ZipageEngine(cfg, params, EngineOptions(decode_kernel="bogus"),
                     device="cpu")


@pytest.mark.parametrize("knob", [
    dict(decode_kernel="dense"),
    dict(compress=CompressOptions(window=4, redundancy="flash")),
])
def test_dense_decode_and_flash_are_accepted(knob):
    z = Zipage.from_config("tiny-lm", device="cpu", block_size=8,
                           n_total_blocks=16, max_batch=2, max_model_len=64,
                           prefill_rows=1, prefill_len=32, **knob)
    assert z.engine.spec.decode_kernel == z.engine.opts.decode_kernel


def test_unported_architectures_raise():
    """What the port still refuses: local-window MLA, which no config
    uses (MLA and MoE layers, local-window attention, the recurrent
    mixers, encoder-decoder models and the frontends' embeddings are
    ported: the tests below)."""
    import dataclasses
    tiny = get_config("tiny-lm")
    cases = {"local_window MLA": dict(attn_type="mla", local_window=32,
                                      kv_lora_rank=32, qk_rope_head_dim=8,
                                      v_head_dim=16)}
    for match, kw in cases.items():
        cfg = dataclasses.replace(tiny, **kw)
        with pytest.raises(NotImplementedError, match=match):
            lm.init(cfg, torch.Generator(), "cpu")
        with pytest.raises(NotImplementedError, match=match):
            lm.check_supported(cfg)


@pytest.mark.parametrize("kw", [
    dict(local_window=32),
    dict(block_pattern=("rglru", "rglru", "attn")),
    dict(block_pattern=("rwkv",), attn_type="none", num_kv_heads=0),
], ids=["local_window", "rglru", "rwkv"])
def test_recurrent_and_local_window_knobs_are_accepted(kw):
    """Local-window attention and the recurrent mixers (RG-LRU, RWKV),
    formerly refused, pass ``lm.check_supported`` and run the forward."""
    import dataclasses
    cfg = dataclasses.replace(get_config("tiny-lm"), dtype="float32", **kw)
    lm.check_supported(cfg)
    params = lm.init(cfg, torch.Generator().manual_seed(0), "cpu")
    out = lm.forward(cfg, params, torch.tensor([[1, 2, 3, 4, 5]]))
    assert out.shape == (1, 5, cfg.vocab_size)
    assert bool(torch.isfinite(out).all())


@pytest.mark.parametrize("name", ["recurrentgemma-2b", "rwkv6-3b"])
def test_recurrent_configs_are_accepted(name):
    """RecurrentGemma-2B and RWKV6-3B pass ``lm.check_supported`` and
    serve through the facade on the CPU at their reduced widths, with
    compression and prefix caching off, as the JAX engine runs them."""
    lm.check_supported(get_config(name))
    z = Zipage.from_config(name, device="cpu", reduce=True, block_size=8,
                           n_total_blocks=32, max_batch=2, max_model_len=64,
                           prefill_rows=1, prefill_len=32)
    outs = z.generate([[1, 2, 3, 4, 5], [9, 8, 7]],
                      SamplingParams(max_new_tokens=8))
    assert [len(o.token_ids) for o in outs] == [8, 8]
    assert z.num_free_blocks == 32
    assert not z.engine.compression_enabled and not z.engine.prefix_ok


@pytest.mark.parametrize("name", ["whisper-tiny", "internvl2-26b"])
def test_frontend_configs_are_accepted(name):
    """Whisper-tiny (encoder-decoder) and InternVL2-26B (a vision
    frontend's prefix embeddings), formerly refused, pass
    ``lm.check_supported`` and serve through the facade on the CPU at
    their reduced widths, with compression on, as the JAX engine runs
    them; Whisper without prefix caching."""
    cfg = get_config(name)
    lm.check_supported(cfg)
    assert cfg.is_enc_dec or cfg.num_prefix_embeds
    z = Zipage.from_config(name, device="cpu", reduce=True, block_size=8,
                           n_total_blocks=32, max_batch=2, max_model_len=64,
                           prefill_rows=1, prefill_len=32)
    outs = z.generate([[1, 2, 3, 4, 5], [9, 8, 7]],
                      SamplingParams(max_new_tokens=8))
    assert [len(o.token_ids) for o in outs] == [8, 8]
    assert z.num_free_blocks == 32
    assert z.engine.compression_enabled
    assert z.engine.prefix_ok == (not cfg.is_enc_dec)
    assert ("cross_kv" in z.engine.state) == cfg.is_enc_dec


@pytest.mark.parametrize("name", ["deepseek-v2-lite-16b", "dbrx-132b"])
def test_moe_and_mla_configs_are_accepted(name):
    """DeepSeek-V2-Lite-16B (MLA, MoE with shared experts, a dense first
    layer) and DBRX-132B (GQA, MoE) pass ``lm.check_supported`` and serve
    through the facade on the CPU at their reduced widths."""
    cfg = get_config(name)
    lm.check_supported(cfg)
    assert cfg.num_experts > 0
    z = Zipage.from_config(name, device="cpu", reduce=True, block_size=8,
                           n_total_blocks=32, max_batch=2, max_model_len=64,
                           prefill_rows=1, prefill_len=32)
    outs = z.generate([[1, 2, 3, 4, 5], [9, 8, 7]],
                      SamplingParams(max_new_tokens=8))
    assert [len(o.token_ids) for o in outs] == [8, 8]
    assert z.num_free_blocks == 32
    kinds = {f for _, f in lm.layer_specs(z.cfg)}
    assert kinds == ({"dense", "moe"} if name.startswith("deepseek")
                     else {"moe"})
