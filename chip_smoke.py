#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each fatal on failure (exit code != 0, no result line):

  1. environment: the card (nvidia-smi), torch, CUDA and nvcc versions;
  2. build: all six CUDA kernels under src/repro_torch/csrc/ with nvcc for
     sm_90a, one process per source, all started together, with the
     ptxas report;
  3. kernels vs plain versions on the card, at the serves' shapes
     (Qwen3-8B widths, g = 4, engine defaults) and again at the head
     layouts of OLMo-1B (g = 1, h_kv 16), Nemotron-4-15B (g = 6, h_kv 8)
     and Qwen2.5-3B (g = 8, h_kv 2), d = 128, over length mixes with
     seq_len == 0 rows, sub-block rows, full-table rows and a NaN-poisoned
     page 0 that no live row maps; the dense decode kernel against the
     ragged one on live rows, bit for bit (any difference fails the run,
     as the JAX package asserts ragged == dense), two launches of the
     dense decode, lightning and flash redundancy kernels giving the same
     bits, the redundancy zero-outs firing, and an in-place compaction
     whose ranks overlap their sources beside a prefix-shared pair, bit for
     bit at the engine's budget (k = 48) and at k = 1024; and the decode
     kernels on idle slots (seq_len >= 1 over an empty table, as the
     serve passes them), where a -1 entry below seq_len reads page 0;
     then all of it again at bf16 inputs, against the kernels' bf16
     variants (fp32 outputs within BF16_TOL, bf16 outputs within one ulp,
     B6 and dense vs ragged bit for bit);
  4. card vs CPU at Qwen3-8B widths and 2 layers: one paged prefill and a
     few decode steps (logits), the threefry sampling noise (bit for bit),
     a fused chunk of 4 decode steps replayed from its CUDA graph against
     the same chunk run eagerly, greedy and seeded, at offsets 0 and 4,
     with an eos mid-chunk and idle slots (tokens, logprobs and state bit
     for bit), greedy and seeded streams through the dense-decode / flash
     path (also at ``decode_steps=8`` on the card and unfused on the CPU,
     all four equal), greedy streams at n_max = 33 (k = 512) with
     compression firing, and the memory tier: a block round trip through
     the pinned host swap pool (all layers and pool leaves, and the
     observation-window row, bit for bit), a swap-mode serve at
     tests/test_swap.py's tight shapes (card == CPU, pools drained), a
     snapshot with a swapped request restored into a fresh captured card
     engine, and compressed-prefix adoption (card == CPU: streams,
     pos_gap, segment hits); then
     at 2 layers of each other dense config, its own widths and head
     layout (vocabulary capped at CPU_VOCAB, logged): logits, and greedy
     and seeded streams with compression firing (Qwen2.5-3B's also through
     the dense-decode / flash path); and at bf16, 2 layers of Qwen3-8B
     widths with bf16 weights: logits within a relative L2 of
     BF16_REL_L2, the noise bit for bit, graph replay == eager bit for
     bit, and the card's streams at ``decode_steps=8`` equal its K = 1
     streams, tokens and logprobs (the CPU's measured against them);
  5. the main serve at full width: ``Zipage.from_config("qwen3-8b")`` at
     the engine defaults (36 layers, fp32, random weights from a seed,
     ``decode_steps=1``, every decode step a CUDA graph replay) serves
     greedy requests; compression must fire, every compression goes
     through the compaction kernel, no plain version runs, and the decode
     kernels' launches are counted through the replays;
  5b. the paper's Alg. 3 / Alg. 4 serve at full width on the same weight
     tensors: ``decode_kernel="dense"`` and flash redundancy, four greedy
     and four seeded requests (Qwen3's thinking-mode sampling);
  6. timing of each kernel at the serves' own inputs (K1 and B4 at the
     serve's state at its fullest step, held against their plain versions
     there first; the compression kernels at recorded calls): kernel, plain
     version, a library call that computes the same function (or its
     product), and the bound from bytes and flops; for the kernel and the
     library call, CUDA-event time, device time (torch.profiler, the
     calls' CUDA kernels) and host time (event minus device). K2, K3 and
     B5 also at a long input (table width 128, seq_lens 2048 and 1999),
     B6 at the same table compacted to 64 blocks (k = 1024, 36 layers),
     K1 and B4 at a long decode input (16 slots at table width 128, 8 of
     them live at 64-2048 entries), each held against its plain version
     there first (K3, B4, B5, B6 two launches bit for bit, B6 against
     plain bit for bit, B4 against K1 bit for bit on live rows);
  7. a profiled window of decode steps of the main serve: device-busy
     share of wall time and kernel time by group;
  7b. paired serves of Qwen3-8B at full width and PAIRED_LAYERS of its
     36 layers (the same weight tensors), at ``decode_steps`` 1, 8, 8
     and 1 in turn: 4 greedy and 4 seeded
     requests with logprobs, whose streams and logprobs must be equal in
     all four; tok/s, step median, steps, graph replays, launches and the
     device-idle share of a profiled window of each;
  8. with Qwen3-8B's weights released, each other dense config, smallest
     to largest (OLMo-1B, Qwen2.5-3B, Llama-3-8B, Nemotron-4-15B), at full
     width and depth through ``Zipage.from_config`` under
     ZIPAGE_SANITIZE=1: a recorded warm-up at whose inputs K1 and K2 are
     held against their plain versions, then 8 greedy requests of 128
     tokens (compression fires, every compression goes through the
     compaction kernel, no plain version runs, the sanitizer audits every
     step and reports nothing); tok/s, step median, launches, peak memory
     and the memory planner's figures. Qwen2.5-3B also serves through
     dense decode and flash redundancy (2 greedy, 2 seeded), so that B4
     and B5 run in a serve at g = 8.
  9. (run between 7b and 8, on the Qwen3-8B weights) memory pressure and
     shared prefixes at full width and MEMORY_LAYERS of the 36 layers,
     every engine under ZIPAGE_SANITIZE=1:
     16 requests (8 greedy, 8 seeded, logprobs) on an ample pool, then
     recompute, swap and auto on a tight pool that starts at 36 blocks
     and shrinks until each run preempts at least 8 times; swap's streams
     and logprobs must equal the ample run's bit for bit, auto's for
     every request it never recomputed, recompute's are measured; swap
     copies timed by CUDA events. Then a 128-token prompt and 8
     extensions of it: cold (no prefix cache), raw prefix hits (equal to
     cold bit for bit) and compressed-segment adoption after the raw
     chain is evicted under the watermark (pos_gap 80, 8 segment hits),
     with B6 held bit for bit at an adopter's copy-on-write launch.
  10. (run after 6, before 7, on the Qwen3-8B weights cast to bf16, norms
     fp32) bfloat16 at full width: the main serve at the engine defaults
     under ZIPAGE_SANITIZE=1 on the phase 5 prompts (where each stream
     leaves its fp32 twin is logged), paired serves at ``decode_steps``
     1 and 8 (equal streams and logprobs), dense decode with flash
     redundancy (4 greedy, 4 seeded), a profiled window (device idle,
     matmul's share of busy time), the six kernels' bf16 variants timed
     as in phase 6 at the serves' inputs and the long inputs (bounds at
     bf16 bytes, products at the bf16 tensor-core peak), and the memory
     planner's M and N_total at bf16 against fp32.
  11. (run after 7b, before 9, on the main serve's engine and its phase 5
     prompts and outputs) the async surface and the OpenAI-compatible
     server: generate() again (timed), the 8 requests through
     ``generate_async`` at once (bit for bit), 4 streams through
     ``stream()`` with logprobs while a request whose eos ids widen the
     pad from 1 to 4 makes the step on the loop's worker thread capture
     the decode graphs anew (streams and the widened request bit for
     bit); then the port's app on its stdlib HTTP server at a loopback
     port: 8 SSE streams at once equal to phase 5's, with a profiled
     window of 8 steps taken on the worker thread between steps, a unary
     request equal to its SSE twin, a client that hangs up after 3 events
     (aborted, blocks reclaimed), a drain with 2 requests in flight (they
     finish, a new one gets 503, the pool is full, the sanitizer clean);
     tok/s beside generate()'s, time to first token and inter-chunk
     latency as the client measures them, the gap between steps, launch
     counts (no plain version runs); then ``python -m repro_torch.serve
     --model tiny-lm`` on the card in a subprocess (a unary and an SSE
     request, SIGTERM: "draining..." then "drained, bye", exit 0) and
     ``python -m repro_torch.launch.serve --arch qwen3-8b --workload
     mix`` with compression and under ``--full-kv``.
  12. (run last, after 8) training and the seeded eval: (a) 5 steps of
     ``build_train_step`` at ``accum_steps=2`` from one init at
     Qwen2.5-3B's widths, 2 layers, vocabulary capped at CPU_VOCAB,
     fp32, on the card and on the CPU (loss and gradient norm each step
     within 1e-3 relative, final params within 1e-3); (b) ``python -m
     repro_torch.launch.train --arch qwen2.5-3b`` at full width and depth
     in its registered bf16 (fp32 master params cast at each use, as the
     JAX package; batch 8 x 512 at ``--accum 2``, 20 steps, a checkpoint
     every 10), killed while it saves step 20 (the machine lets a run
     write 45 GiB to its disk, one 37 GB checkpoint), then restarted from
     the step-10 checkpoint: the restored params and optimizer state
     equal the saved ones (digests), step 11's loss equals the first
     run's bit for bit, steps 12-20 within 1e-2; s/step, tokens/s, peak
     memory and the share of the bf16 peak that 6 N tokens/s makes;
     (c) tiny-lm trained 300 steps on the card through
     ``repro_torch.eval``, its five rows served on the card under
     PlainGuard (K1, K2, K3 and B6 counted), ``python -m repro_torch.eval
     --smoke`` in a cold process (the same bytes), and the card's weights
     served on the CPU: each row equal to the card's unless a stream
     parts at a near-tie the CPU serve recorded (``TieRecorder``). The
     evals and the CPU halves run beside 12b's first run
     (phase_train_eval).
  13. (run last, after 12) MoE and MLA (``phase_moe_mla``): (a) card vs
     CPU at full width, fp32, random weights from the seed (vocabulary
     capped at CPU_VOCAB): DeepSeek-V2-Lite-16B's first three layers (the
     dense one and two MoE, MLA) and DBRX-132B's first two, one paged
     prefill and 16 decode steps, the logits within CARD_CPU_TOL; every
     MoE call's routing is recorded on both (``TieRecorder``), and a
     token routed to other experts on the two devices is excused only at
     a router margin under TIE_TOL, and counted; (b) the changed kernels
     at DeepSeek-V2-Lite's widths against their plain versions in fp32
     and bf16: K2 over the 576-wide latent entries (h_kv 1, g 16, the MLA
     scale 1/sqrt(192), windows 4 and 16: the d-tiled path) and its route
     to ``scoring.mla_attention_scores``, K3 and B5 on the 512-wide
     latents (B5 on 32-key tiles in fp32), B6 with no V at d 576 bit for
     bit; (c) ``Zipage.from_config("deepseek-v2-lite-16b")`` at full width
     and depth in bf16 under ZIPAGE_SANITIZE=1: phase 5's prompts, 8
     greedy x NEW_TOKENS (K2, K3 and B6 launch; MLA decodes in plain
     PyTorch as the JAX package does), 2 with flash redundancy (B5); the
     memory planner's M and N_total beside Qwen3-8B's; the kernels timed
     at the serve's recorded calls (rows ``<kernel>_mla_bf16``); then at a
     drop-free capacity ``decode_steps`` 1 and 8 give equal streams and
     logprobs bit for bit; (d) DBRX-132B at full width and DBRX_LAYERS of
     its 40 layers (one card's memory), bf16, 8 greedy x NEW_TOKENS under
     the sanitizer (K1, K2, K3 and B6 counted into the bf16 rows).
  14. (run last, after 13) the recurrent configs (``phase_recurrent``):
     (a) K1 and B4 at RecurrentGemma-2B's layout (g = 10, h_kv = 1,
     d = 256, b = 16, a 128-block ring: the G = 16 instantiations) in
     fp32 and bf16 against their plain versions on full rings (seq_len
     2048), partly filled ones, seq_len 0 rows and idle slots, dense ==
     ragged bit for bit on live rows; (b) card vs CPU at full width, fp32,
     vocabulary capped at CPU_VOCAB: RecurrentGemma's first 5 layers
     (rglru, rglru, attn, rglru, rglru) and RWKV6's first 2, prompts of
     150 and 100 tokens fed in prefill calls of 64 (the recurrent state
     and the ring carried across calls), then 16 greedy decode steps: the
     logits within CARD_CPU_TOL, the tokens equal; (c)
     ``Zipage.from_config("recurrentgemma-2b")`` at full width and depth
     in bf16 under ZIPAGE_SANITIZE=1, 10 requests (phase 5's 8 prompts
     and two of 2000 and 2300 tokens, whose 2048-token rings wrap in
     decode and across 18 prefill calls), NEW_TOKENS each, at
     ``decode_steps`` 1 and 8 (streams and logprobs bit for bit), 2 of
     them through dense decode (B4; streams equal to ragged's), K1 and B4
     timed at the serve's fullest decode input (rows ``<kernel>_g10_bf16``);
     (d) ``Zipage.from_config("rwkv6-3b")`` at full width and depth in
     bf16 under the sanitizer, phase 5's prompts at ``decode_steps`` 1 and
     8 (bit for bit; RWKV6 runs no kernel); (e) ``python -m
     repro_torch.launch.serve --arch`` for both on the card (reduced
     widths, as the launcher serves a non-tiny arch).
  15. (run last, after 14) the frontend configs (``phase_frontends``):
     (a) the six kernels at Whisper-tiny's layout (g = 1, h_kv = 6,
     d = 64) against their plain versions in fp32 and bf16, as phase 3
     runs them (dense == ragged bit for bit, idle slots, B6 at k = 48 and
     1024); (b) card vs CPU, fp32, random weights from the seed:
     Whisper-tiny at full width and depth, a paged prefill over random
     frames and 6 greedy decode steps (logits within CARD_CPU_TOL, tokens
     equal), greedy streams through the facade with compression firing
     (a stream that parts is excused only at a near-tie the CPU serve
     recorded, ``TieRecorder``), and a graph-replayed decode chunk across
     a prefill that rewrites the slots' cross KV in place (replay == eager
     bit for bit); InternVL2-26B at full width and 2 layers (vocabulary
     capped at CPU_VOCAB), a prefill after 256 random patch embeddings
     and decode steps, also held against the card's own
     ``lm.forward(prefix_embeds=)``; (c) ``Zipage.from_config
     ("whisper-tiny")`` at full width and depth in bf16 under
     ZIPAGE_SANITIZE=1 with compression on: phase 5's prompts, 8 greedy
     requests of NEW_TOKENS tokens at ``decode_steps`` 1 and 8 (streams
     and logprobs bit for bit), 2 through dense decode and flash
     redundancy, and ``preemption_mode="swap"`` warning and preempting by
     recompute; K1, K2, K3 and B6 timed at the serve's inputs (rows
     ``<kernel>_whisper_bf16``); (d) ``Zipage.from_config
     ("internvl2-26b")`` at full width and depth (48 layers) in bf16, the
     same requests, sanitizer and K = 1 == K = 8 check, its peak memory
     under the card's, K1 timed (row ``ragged_paged_attention_internvl2_
     bf16``); (e) ``python -m repro_torch.launch.serve --arch`` for both
     on the card (reduced widths), run beside 15b.
  16. (run after 10, before 7, on the Qwen3-8B weights cast to fp16,
     norms fp32) float16 (``phase_fp16``): (a) the six kernels' ``_f16``
     entries against their plain versions at the shapes of phases 3, 13b,
     14a and 15a (g = 1, 4, 6, 8, 10; d = 64, 128, 256; MLA's 512- and
     576-wide entries): fp32 outputs within FP16_TOL, fp16 outputs within
     one fp16 ulp, B6 and dense vs ragged bit for bit; (b) card vs CPU at
     2 layers of Qwen3-8B widths in fp16: logits within a relative L2 of
     FP16_REL_L2 (vocabulary capped at CPU_VOCAB; the CPU's fp16 products
     formed in fp32 and rounded once, ``cpu_fp16_gemm``), a
     graph-replayed chunk == eager bit for bit, the card's K = 8 streams
     == its K = 1 streams; (c) Qwen3-8B at full width and
     36 layers in fp16: the engine defaults under ZIPAGE_SANITIZE=1, dense
     decode with flash redundancy, and ``decode_steps=8`` (streams and
     logprobs equal to the K = 1 serve's), each launch resolving a
     ``_f16`` entry and all six kernels launching; the largest |hidden
     state| against fp16's 65504 (nothing clamped); the six kernels timed
     at the serves' inputs and the long inputs (rows ``<kernel>_f16``).

The last two lines of standard output are the card's name and power
limit, and ``{"ok": true, "device": {...}}``; the line before them is the
``{"kernels": [...]}`` record. Exits non-zero without a card.
"""
from __future__ import annotations

import asyncio
import dataclasses
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

SEED = 0
TOL = 1e-4            # atol = rtol for fp32 kernel-vs-plain comparisons:
#                       the kernels sum in another order than PyTorch
#: atol = rtol for the kernels against their plain versions at bf16
#: inputs: fp32 outputs (K2, K3, B5) to 1e-5, bf16 outputs (K1, B4) to one
#: bf16 ulp (both round an fp32 result once)
BF16_TOL, BF16_OUT_TOL = 1e-5, 2.0 ** -7
CARD_CPU_TOL = 1e-3   # atol = rtol for card-vs-CPU logits of a 4096-wide
#                       model: each matmul sums 4096-12288 products in a
#                       different order on each device
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA data sheet
FP32_FLOPS_PER_S = 67e12    # H100 SXM fp32 outside the tensor cores
#: H100 SXM dense bf16 (and fp16) on the tensor cores: the least time for
#: products of 16-bit inputs (the port's bf16 and fp16 kernels form them
#: in fp32 on CUDA cores)
BF16_FLOPS_PER_S = 989e12
#: relative L2 of bf16 logits, card against CPU (and the port against the
#: JAX package on the CPU): cuBLAS and the CPU sum bf16 products in other
#: orders, and bf16 rounds every stored result
BF16_REL_L2 = 2e-2
#: the same at fp16 inputs: fp32 outputs to 1e-5, fp16 outputs to one
#: fp16 ulp (11 significant bits)
FP16_TOL, FP16_OUT_TOL = 1e-5, 2.0 ** -10
#: relative L2 of fp16 logits, card against CPU: twice the 1.5e-3 that the
#: JAX package's own fp16 forward lies from its fp32 one at Qwen3-8B's
#: reduced widths (tests/test_torch_fp16.py holds the port to it there)
FP16_REL_L2 = 3e-3
#: the largest finite fp16 value: a hidden state past it overflows
FP16_MAX = 65504.0
N_REQUESTS = 8
NEW_TOKENS = 128
#: the long inputs of phase 6: table width and seq_lens of K2, K3 and B5,
#: and seq_lens of K1 and B4 (8 live slots, 8 empty ones)
LONG_TABLE, LONG_LENS = 128, [2048, 1999]
#: B6's long input: the same table and lengths compacted to 64 blocks
#: (k = 1024 at block 16, n_max = 65)
LONG_BUDGET = 64
#: phase 4's block cap: a budget of 32 blocks (k = 512 at block 16), above
#: the 28 that a kernel staging a whole stripe in shared memory could take
BIG_N_MAX = 33
LONG_DECODE_LENS = [2048, 1999, 1536, 1024, 777, 512, 300, 64] + [0] * 8

#: Qwen3's published thinking-mode sampling (the model card's advice)
THINKING = dict(temperature=0.6, top_p=0.95, top_k=20)

#: the other dense configs, smallest to largest (fp32 weights 4.7, 12.3,
#: 32.1 and 62.5 GB), served at full width in phase 8
DENSE_CONFIGS = ("olmo-1b", "qwen2.5-3b", "llama3-8b", "nemotron-4-15b")
#: their head layouts that Qwen3-8B's g = 4 does not cover, held in
#: phase 3: g = 1 (h_kv 16), 6 (h_kv 8) and 8 (h_kv 2)
LAYOUT_CONFIGS = ("olmo-1b", "nemotron-4-15b", "qwen2.5-3b")
#: phase 4's vocabulary cap for the other configs' 2-layer models, for the
#: CPU side's memory (Nemotron-4-15B's 256000 x 6144 fp32 embedding and
#: unembedding alone take 12.6 GB); the run logs each cut
CPU_VOCAB = 65536
#: phase 8's recorded warm-up before each serve: new tokens per request
WARMUP_TOKENS = 16
#: phase 9's pressure serves: requests, query slots (one a decode slot, so
#: that when a request compresses does not depend on how many run beside
#: it), the tight pool's first size (36 blocks: 40, about 2.5 blocks a
#: request, preempted 6 times in every run, 36 at least 8), its step and
#: floor, the host swap pool, and the preemptions each tight run must reach
PRESSURE_REQUESTS, PRESSURE_QSLOTS = 16, 16
TIGHT_POOL, TIGHT_STEP, MIN_POOL = 36, 4, 20
SWAP_BLOCKS = 64
MIN_PREEMPTIONS = 8
#: phase 9's depth: the first 12 of Qwen3-8B's 36 layers, at full width
#: (preemptions and prefix hits count blocks, which depth does not
#: change), so that the script keeps well inside its time limit
MEMORY_LAYERS = 12
#: the host link's nominal rate a direction (PCIe Gen5 x16)
HOST_LINK_BYTES_PER_S = 64e9
#: phase 9's shared-prefix serves: the prompt, its extensions, and the
#: watermark (4 of 256 blocks) under which the raw chain is evicted while
#: the prompt's compressed segment (3 blocks, newer) stays
PREFIX_TOKENS, EXTENSION_TOKENS, N_EXTENSIONS = 128, 8, 8
SEGMENT_WATERMARK = 4 / 256

#: where each ported TPU kernel lived (function definition line)
REPLACES = {
    "ragged_paged_attention": "src/repro/kernels/ragged_paged_attention.py:129",
    "paged_score": "src/repro/kernels/paged_score.py:43",
    "lightning_redundancy": "src/repro/kernels/redundancy.py:61",
    "paged_attention": "src/repro/kernels/paged_attention.py:71",
    "flash_redundancy": "src/repro/kernels/redundancy.py:125",
    "compaction": "src/repro/kernels/compaction.py:26",
}
#: the kernels of each serve path
MAIN_PATH = ("ragged_paged_attention", "paged_score", "lightning_redundancy",
             "compaction")
ALG34_PATH = ("paged_attention", "paged_score", "flash_redundancy",
              "compaction")


def log(phase, msg):
    print(f"{phase}: {msg}", flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0].strip()


# ----------------------------------------------------------------------
# phase 1-2


def phase_env(torch, native):
    card = card_line()
    nvcc = subprocess.run([native.nvcc_path(), "--version"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[-1]
    log("env", f"card={card} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | nvcc {nvcc}")
    return card


def phase_build(native):
    t = time.monotonic()
    reports = native.build_all()
    log("build", f"{len(reports)} kernel libraries ready in "
        f"{time.monotonic() - t:.1f} s (sm_90a)")
    for name, text in sorted(reports.items()):
        fn = ""
        for line in text.splitlines():
            if "Function properties for" in line:
                fn = _ptxas_function(line)
            elif "Used" in line or "spill" in line:
                log("build", f"{name}: {fn}: {line.strip()}")
    return reports


def _ptxas_function(line):
    """The kernel's name and template arguments in a ptxas report line:
    '..._cu_<hash><len><name>ILi4ELi1EE...' -> 'name<4,1>'."""
    import re
    m = re.search(r"_cu_[0-9a-f]{8}(\d+)(\w+)", line)
    if m is None:
        return line.split()[-1]
    n, rest = int(m.group(1)), m.group(2)
    t = re.match(r"ILi(\d+)E(?:Li(\d+)E)?", rest[n:])
    args = f"<{','.join(x for x in t.groups() if x)}>" if t else ""
    return rest[:n] + args


# ----------------------------------------------------------------------
# phase 3: kernels against their plain versions


def make_pool(torch, rng, n_pages, b, hkv, d, dev, *, similar=False,
              dtype=None):
    """Random pool on the card (fp32, or ``dtype``); page 0 is NaN.
    ``similar`` makes the keys of a page near-duplicates, so cosines cross
    the redundancy threshold."""
    import numpy as np
    k = rng.normal(size=(n_pages, b, hkv, d)).astype(np.float32)
    if similar:
        base = rng.normal(size=(n_pages, 1, hkv, d)).astype(np.float32)
        k = 0.35 * k + base
    v = rng.normal(size=(n_pages, b, hkv, d)).astype(np.float32)
    k[0] = np.nan
    v[0] = np.nan
    dtype = dtype or torch.float32
    return (torch.from_numpy(k).to(dev, dtype),
            torch.from_numpy(v).to(dev, dtype))


def make_tables(torch, rng, seq_lens, b, mb, n_pages, dev, pool_k=None,
                pool_v=None):
    """-1 padded tables drawing live pages from 1..n_pages-1 (never page
    0); the stale tail past each row's seq_len in its last page is NaN."""
    import numpy as np
    free = list(rng.permutation(np.arange(1, n_pages)))
    bt = np.full((len(seq_lens), mb), -1, np.int32)
    for i, s in enumerate(seq_lens):
        for j in range(-(-s // b)):
            bt[i, j] = free.pop()
        if s % b and pool_k is not None:
            blk = int(bt[i, s // b])
            pool_k[blk, s % b:] = float("nan")
            pool_v[blk, s % b:] = float("nan")
    return (torch.from_numpy(bt).to(dev),
            torch.tensor(seq_lens, dtype=torch.int32, device=dev))


def max_err(torch, got, want, name, tol=TOL):
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: kernel output is not finite")
    if got.dtype != want.dtype:
        raise AssertionError(f"{name}: {got.dtype} out, the plain version "
                             f"gives {want.dtype}")
    want = want.float()
    err = (got.float() - want).abs()
    bad = err > tol + tol * want.abs()
    if bool(bad.any()):
        raise AssertionError(f"{name}: {int(bad.sum())} entries off by up to "
                             f"{float(err.max()):.3e} (tol {tol})")
    return float(err.max())


def kernel_tols(torch, dtype):
    """(tolerance of fp32 outputs, of outputs in the input dtype) for the
    kernels against their plain versions at inputs of ``dtype``."""
    if dtype == torch.bfloat16:
        return BF16_TOL, BF16_OUT_TOL
    if dtype == torch.float16:
        return FP16_TOL, FP16_OUT_TOL
    return TOL, TOL


def dtype_tag(torch, dtype):
    """A phase label's suffix for inputs of ``dtype``: "", " bf16" or
    " fp16"."""
    return {torch.bfloat16: " bf16", torch.float16: " fp16"}.get(dtype, "")


def half_rel_l2(dtype):
    """The relative L2 bound of a 16-bit serve dtype's logits, card
    against CPU."""
    return {"bfloat16": BF16_REL_L2, "float16": FP16_REL_L2}[dtype]


def phase_kernels(torch, dev, cfg, opts, phase="kernels", dtype=None):
    """The kernels against their plain versions at inputs of ``dtype``
    (fp32 unless given)."""
    import numpy as np
    from repro_torch.kernels import paged_score as ps
    from repro_torch.kernels import ragged_paged_attention as rpa
    from repro_torch.kernels import redundancy as red

    dtype = dtype or torch.float32
    tol, out_tol = kernel_tols(torch, dtype)
    b, mb = opts.block_size, -(-opts.max_model_len // opts.block_size)
    n_pages, B = opts.n_total_blocks, opts.max_batch
    hq, hkv, d, w = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, \
        opts.window
    T = mb * b
    rng = np.random.default_rng(SEED)
    errs = {rpa.NAME: 0.0, ps.NAME: 0.0, red.NAME: 0.0}
    decode_mixes = {
        "mixed": [0, 1, 7, 15, 16, 17, 33, 64, 100, 127, 200, 255, T, T - 1,
                  0, 48],
        "full": [T] * 7 + [0] * (B - 7),
        "inactive": [0] * B,
    }
    for label, lens in decode_mixes.items():
        k, v = make_pool(torch, rng, n_pages, b, hkv, d, dev, dtype=dtype)
        bt, sl = make_tables(torch, rng, lens, b, mb, n_pages, dev, k, v)
        q = torch.randn(B, hq, d, device=dev,
                        generator=torch.Generator(dev).manual_seed(SEED)) \
            .to(dtype)
        got = rpa.ragged_paged_attention_cuda(q, k, v, bt, sl)
        want = rpa.ragged_paged_attention_plain(q, k, v, bt, sl)
        torch.cuda.synchronize()
        if not bool((got[sl == 0] == 0).all()):
            raise AssertionError("ragged: seq_len == 0 rows are not zeros")
        e = max_err(torch, got, want, f"ragged[{label}]", out_tol)
        errs[rpa.NAME] = max(errs[rpa.NAME], e)
        log(phase, f"{rpa.NAME}[{label}]: max_abs_err={e:.3e} "
            f"(atol=rtol={out_tol}) ok")
    comp_mixes = {
        "compress": [64, 176, 4, T, 16, 80, 0, 48],
        "similar": [64, 64, 128, 200, 31, T, 5, 0],
    }
    n_thresh_hits = 0
    for label, lens in comp_mixes.items():
        k, v = make_pool(torch, rng, n_pages, b, hkv, d, dev,
                         similar=label == "similar", dtype=dtype)
        bt, sl = make_tables(torch, rng, lens, b, mb, n_pages, dev, k, v)
        q_win = torch.randn(len(lens), w, hq, d, device=dev,
                            generator=torch.Generator(dev).manual_seed(SEED)) \
            .to(dtype)
        got = ps.paged_score_logits_cuda(q_win, k, bt, sl)
        want = ps.paged_score_logits_plain(q_win, k, bt, sl)
        e = max_err(torch, got, want, f"paged_score[{label}]", tol)
        errs[ps.NAME] = max(errs[ps.NAME], e)
        log(phase, f"{ps.NAME}[{label}]: max_abs_err={e:.3e} "
            f"(atol=rtol={tol}) ok")
        got = red.lightning_redundancy_cuda(k, bt, sl,
                                            p_thresh=opts.compress.p_thresh)
        want = red.lightning_redundancy_plain(k, bt, sl,
                                              p_thresh=opts.compress.p_thresh)
        e = max_err(torch, got, want, f"redundancy[{label}]", tol)
        errs[red.NAME] = max(errs[red.NAME], e)
        if not bool(torch.equal(got, red.lightning_redundancy_cuda(
                k, bt, sl, p_thresh=opts.compress.p_thresh))):
            raise AssertionError("redundancy: two runs differ")
        no_thresh = red.lightning_redundancy_plain(k, bt, sl, p_thresh=2.0)
        n_thresh_hits += int((no_thresh != want).sum())
        log(phase, f"{red.NAME}[{label}]: max_abs_err={e:.3e} "
            f"(atol=rtol={tol}), the same in two runs, ok")
    if n_thresh_hits == 0:
        raise AssertionError("redundancy: the p_thresh zero-out never fired")
    log(phase, f"{red.NAME}: the p_thresh zero-out changed "
        f"{n_thresh_hits} row sums (exercised)")
    torch.cuda.synchronize()
    errs.update(phase_kernels_alg34(torch, dev, cfg, opts, rng, decode_mixes,
                                    comp_mixes, phase, dtype))
    errs[rpa.NAME] = max(errs[rpa.NAME], check_idle_slots(
        torch, dev, cfg, opts, rng, phase, dtype))
    return errs


def phase_kernels_alg34(torch, dev, cfg, opts, rng, decode_mixes,
                        comp_mixes, phase, dtype):
    """B4 dense decode, B5 flash redundancy and B6 compaction against their
    plain versions on the card, at inputs of ``dtype``."""
    from repro_torch.kernels import compaction as cmp
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ragged_paged_attention as rpa
    from repro_torch.kernels import redundancy as red

    b, mb = opts.block_size, -(-opts.max_model_len // opts.block_size)
    n_pages, B = opts.n_total_blocks, opts.max_batch
    hq, hkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    tol, out_tol = kernel_tols(torch, dtype)
    errs = {pa.NAME: 0.0, red.FLASH_NAME: 0.0, cmp.NAME: 0.0}
    for label, lens in decode_mixes.items():
        k, v = make_pool(torch, rng, n_pages, b, hkv, d, dev, dtype=dtype)
        bt, sl = make_tables(torch, rng, lens, b, mb, n_pages, dev, k, v)
        q = torch.randn(B, hq, d, device=dev,
                        generator=torch.Generator(dev).manual_seed(SEED)) \
            .to(dtype)
        got = pa.paged_attention_cuda(q, k, v, bt, sl)
        want = pa.paged_attention_plain(q, k, v, bt, sl)
        ragged = rpa.ragged_paged_attention_cuda(q, k, v, bt, sl)
        torch.cuda.synchronize()
        e = max_err(torch, got, want, f"dense[{label}]", out_tol)
        errs[pa.NAME] = max(errs[pa.NAME], e)
        if not bool((got[sl == 0] == 0).all()):
            raise AssertionError("dense: seq_len == 0 rows are not zeros")
        if not bool(torch.equal(got, pa.paged_attention_cuda(q, k, v, bt,
                                                             sl))):
            raise AssertionError("dense: two runs differ")
        live = sl > 0
        # the JAX package asserts ragged == dense bit for bit on live rows
        if not bool(torch.equal(got[live], ragged[live])):
            raise AssertionError(
                f"dense vs ragged[{label}]: live rows differ by up to "
                f"{float((got[live] - ragged[live]).float().abs().max()):.3e}")
        log(phase, f"{pa.NAME}[{label}]: max_abs_err={e:.3e} "
            f"(atol=rtol={out_tol}), the same in two runs, ok")
    log(phase, "dense vs ragged on live rows: bit-identical ok")

    n_hits = 0
    for label, lens in comp_mixes.items():
        k, _ = make_pool(torch, rng, n_pages, b, hkv, d, dev,
                         similar=label == "similar", dtype=dtype)
        bt, sl = make_tables(torch, rng, lens, b, mb, n_pages, dev, k, k)
        p = opts.compress.p_thresh
        got = red.flash_redundancy_cuda(k, bt, sl, p_thresh=p)
        want = red.flash_redundancy_plain(k, bt, sl, p_thresh=p)
        e = max_err(torch, got, want, f"flash[{label}]", tol)
        errs[red.FLASH_NAME] = max(errs[red.FLASH_NAME], e)
        if not bool(torch.equal(got, red.flash_redundancy_cuda(
                k, bt, sl, p_thresh=p))):
            raise AssertionError("flash: two runs differ")
        no_thresh = red.flash_redundancy_plain(k, bt, sl, p_thresh=2.0)
        n_hits += int((no_thresh != want).sum())
        log(phase, f"{red.FLASH_NAME}[{label}]: max_abs_err={e:.3e} "
            f"(atol=rtol={tol}), the same in two runs, ok")
    if n_hits == 0:
        raise AssertionError("flash: the p_thresh zero-out never fired")
    log(phase, f"{red.FLASH_NAME}: the p_thresh zero-out changed "
        f"{n_hits} row sums (exercised)")

    errs[cmp.NAME] = check_compaction(torch, dev, cfg, opts, rng, phase,
                                      dtype)
    torch.cuda.synchronize()
    return errs


def check_idle_slots(torch, dev, cfg, opts, rng, phase, dtype=None):
    """K1 and B4 against their plain versions on what the serve passes for
    a slot that decodes nothing: it attends seq_len + 1 entries over an
    empty (all -1) table, and a -1 entry below seq_len is page 0, as the
    TPU kernels clamp it. Here a never-used slot (seq_len 1), finished
    ones with stale seq_lens, and a live row with a -1 entry in the middle
    of its table; page 0 holds finite data, as in a serve. The two kernels
    must also agree bit for bit on every row. Returns K1's max error."""
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ragged_paged_attention as rpa

    b, mb = opts.block_size, -(-opts.max_model_len // opts.block_size)
    n_pages, B = opts.n_total_blocks, opts.max_batch
    dtype = dtype or torch.float32
    out_tol = kernel_tols(torch, dtype)[1]
    lens = [1, 1, 57, 130, 16, 1] + [int(x) for x in rng.integers(
        1, 8 * b, B - 7)] + [0]
    k, v = make_pool(torch, rng, n_pages, b, cfg.num_kv_heads, cfg.head_dim,
                     dev, dtype=dtype)
    k[0] = torch.randn_like(k[0])
    v[0] = torch.randn_like(v[0])
    bt, sl = make_tables(torch, rng, lens, b, mb, n_pages, dev, k, v)
    bt[:4] = -1                         # idle: no page mapped below seq_len
    bt[4, 0] = -1                       # a -1 entry below seq_len
    q = torch.randn(B, cfg.num_heads, cfg.head_dim, device=dev,
                    generator=torch.Generator(dev).manual_seed(SEED)).to(dtype)
    ragged = rpa.ragged_paged_attention_cuda(q, k, v, bt, sl)
    dense = pa.paged_attention_cuda(q, k, v, bt, sl)
    e = max_err(torch, ragged, rpa.ragged_paged_attention_plain(
        q, k, v, bt, sl), f"{rpa.NAME}[idle slots]", out_tol)
    e_dense = max_err(torch, dense, pa.paged_attention_plain(q, k, v, bt, sl),
                      f"{pa.NAME}[idle slots]", out_tol)
    if not bool(torch.equal(dense, ragged)):
        diff = (dense - ragged).float().abs().max()
        raise AssertionError(f"idle slots: dense and ragged differ by "
                             f"{float(diff):.3e}")
    log(phase, f"idle slots (seq_len {lens[:6]} over empty tables or a -1 "
        f"entry below seq_len, page 0 read): {rpa.NAME} max_abs_err="
        f"{e:.3e}, {pa.NAME} {e_dense:.3e} (atol=rtol={out_tol}), "
        "bit-identical to each other ok")
    return e


def compaction_case(torch, dev, cfg, opts, rng, lens, kinds, width, budget,
                    L, dtype=None):
    """A compression batch as the scheduler plans it, at Qwen3-8B heads and
    ``L`` layers: request i holds ``lens[i]`` entries on a ``width``-wide
    table and is compacted to ``budget`` blocks as ``kinds[i]`` says:
    "in_place" (destination = its first ``budget`` blocks, so ranks overlap
    their sources), "cow" (copy-on-write over a two-block prefix that every
    "cow" request shares: two fresh blocks, then its own blocks 2 ..
    budget - 1) or "pad" (a padding row writing the sink page). Random
    pools, survivors and scores from ``rng``; the sink page last. Returns
    the arguments of ``compact_cuda``; K and V at ``dtype`` (fp32 unless
    given), F fp32."""
    import numpy as np
    b, h, d = opts.block_size, cfg.num_kv_heads, cfg.head_dim
    n, kk = len(lens), budget * b
    nbs = [-(-s // b) for s in lens]
    N = 1 + sum(nbs) + 2 * kinds.count("cow")
    free = [int(x) for x in rng.permutation(np.arange(1, N))]
    prefix = [free.pop(), free.pop()] if "cow" in kinds else []
    src = np.full((n, width), -1, np.int32)
    dest = np.full((n, budget), N, np.int64)        # the sink by default
    for i, kind in enumerate(kinds):
        if kind == "pad":
            continue
        own = prefix if kind == "cow" else []
        src[i, :nbs[i]] = own + [free.pop() for _ in range(nbs[i] - len(own))]
        dest[i] = src[i, :budget] if kind == "in_place" else \
            [free.pop(), free.pop()] + list(src[i, 2:budget])
    dest_flat = np.repeat(dest, b, axis=1) * b + np.tile(np.arange(b), budget)
    # survivors per (layer, request, head): kk ascending positions below
    # the request's length
    T = max(max(lens), kk)
    keys = rng.random((L, n, h, T)) + (np.arange(T) >= np.maximum(
        lens, kk)[None, :, None, None])
    src_cache = np.sort(np.argsort(keys, axis=-1)[..., :kk], axis=-1)
    gen = torch.Generator(dev).manual_seed(int(rng.integers(2**31)))
    pools = [torch.randn(L, N + 1, b, h, d, device=dev, generator=gen)
             .to(dtype or torch.float32) for _ in range(2)]
    pools.append(torch.rand(L, N + 1, b, h, device=dev, generator=gen))
    new_f = torch.rand(L, n, width * b, h, device=dev, generator=gen)
    return (*pools, new_f, torch.from_numpy(src).to(dev),
            torch.from_numpy(src_cache).to(dev),
            torch.from_numpy(dest_flat).to(dev))


def check_compaction(torch, dev, cfg, opts, rng, phase, dtype=None):
    """B6 in place at the engine's budget (k = 48) and at LONG_BUDGET
    blocks (k = 1024): six requests in place, a prefix-shared pair
    copy-on-write and two padding rows, 4 layers, K and V at ``dtype``."""
    kinds = ["in_place"] * 6 + ["cow"] * 2 + ["pad"] * 2
    for width, budget in ((8, opts.n_max - 1), (LONG_TABLE, LONG_BUDGET)):
        lens = [int(x) * opts.block_size
                for x in rng.integers(budget + 1, width + 1, 8)] + [0, 0]
        args = compaction_case(torch, dev, cfg, opts, rng, lens, kinds,
                               width, budget, L=4, dtype=dtype)
        kk = budget * opts.block_size
        check_compaction_at(torch, args, f"compaction[k={kk}]")
        log(phase, f"compaction: {len(lens)} rows x 4 layers at k={kk} "
            "(in place with overlapping ranks, a prefix-shared pair "
            "copy-on-write, padding rows) equal to the sequential plain "
            "version bit for bit, and the same in two launches, "
            "max_abs_err=0.000e+00 ok")
        del args
        torch.cuda.empty_cache()
    return 0.0


def check_compaction_at(torch, args, label):
    """B6 on ``args`` against its sequential plain version, and a second
    launch against the first, bit for bit on every page but the sink."""
    from repro_torch.kernels import compaction as cmp

    def clone(pools):               # V may be None (MLA: no V pool)
        return [None if x is None else x.clone() for x in pools]

    want = clone(args[:3])
    cmp.compact_plain(*want, *args[3:])
    runs = []
    for _ in range(2):
        got = clone(args[:3])
        cmp.compact_cuda(*got, *args[3:])
        runs.append(got)
    torch.cuda.synchronize()
    for got, ref, what in ((runs[0], want, "the sequential plain version"),
                           (runs[1], runs[0], "the first launch")):
        for n, a, r in zip("kvf", got, ref):
            if a is None:
                continue
            a, r = a[:, :-1], r[:, :-1]     # the sink page: garbage on both
            if not bool(torch.isfinite(a).all()):
                raise AssertionError(f"{label}: {n} pool not finite")
            if not bool(torch.equal(_bits(torch, a), _bits(torch, r))):
                raise AssertionError(
                    f"{label}: {n} pool differs from {what} by "
                    f"{float((a.float() - r.float()).abs().max()):.3e}")


# ----------------------------------------------------------------------
# phase 4: card vs CPU at reduced depth


def phase_card_vs_cpu(torch, dev, cfg):
    from repro_torch.core import serve_model
    from repro_torch.models import lm

    # what the card's fp32 matmul does at these widths: full fp32 leaves
    # ~1e-6 against float64, TF32 ~1e-3
    gen = torch.Generator("cpu").manual_seed(SEED)
    a = torch.randn(128, cfg.d_model, generator=gen) / cfg.d_model ** 0.5
    w = torch.randn(cfg.d_model, cfg.d_model, generator=gen)
    probe = float(((a.to(dev) @ w.to(dev)).cpu().double()
                   - a.double() @ w.double()).abs().max())
    log("card-vs-cpu", f"fp32 matmul probe 128x{cfg.d_model}x{cfg.d_model} "
        f"on the card vs float64: max_abs_err={probe:.2e} (allow_tf32="
        f"{torch.backends.cuda.matmul.allow_tf32})")

    small = dataclasses.replace(cfg, num_layers=2)
    gen = torch.Generator("cpu").manual_seed(SEED)
    p_cpu = lm.init(small, gen, "cpu")
    p_dev = _tree_to(p_cpu, dev)
    worst = check_logits(torch, dev, small, p_cpu, p_dev, "card-vs-cpu",
                         f"{cfg.name} widths")
    check_noise(torch, dev, small.vocab_size)
    for greedy in (True, False):
        check_graph_vs_eager(torch, dev, small, p_dev, greedy)
    check_streams(torch, dev, small, p_cpu, p_dev, modes=True)
    check_budget_streams(torch, dev, small, p_cpu, p_dev)
    t = time.monotonic()
    check_block_round_trip(torch, dev, small, p_dev)
    check_swap_streams(torch, dev, small, p_cpu, p_dev)
    check_swap_snapshot(torch, dev, small, p_dev)
    check_adoption(torch, dev, small, p_cpu, p_dev)
    log("card-vs-cpu", f"the swap and prefix checks took "
        f"{time.monotonic() - t:.1f} s")
    del p_dev
    torch.cuda.empty_cache()
    return worst


def cpu_fp16_gemm(torch, dtype):
    """A context for the CPU side of a card-vs-CPU check at ``dtype``. At
    float16 it forms every product of CPU fp16 tensors (``@``, matmul, mm,
    bmm, linear) as the fp32 product of the same fp16 values, rounded once
    to fp16: the fp32 accumulation and single rounding of PyTorch's CPU
    fp16 GEMM (the same logits bit for bit where that GEMM is fast,
    tests/test_torch_fp16.py), at its fp32 speed: the CPU beside the card
    may have no fast fp16 GEMM, and there phase 16b did not finish within
    the script's time limit. Any other dtype: no change."""
    import contextlib
    if dtype != "float16":
        return contextlib.nullcontext()
    from torch.overrides import TorchFunctionMode
    gemms = {torch.matmul, torch.Tensor.matmul, torch.Tensor.__matmul__,
             torch.mm, torch.bmm, torch.nn.functional.linear}

    def fp16_cpu(a):
        return isinstance(a, torch.Tensor) and a.dtype == torch.float16 \
            and a.device.type == "cpu"

    class Fp16GemmInFp32(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if func in gemms and args and all(
                    fp16_cpu(a) for a in args
                    if isinstance(a, torch.Tensor)):
                return func(*(a.float() if isinstance(a, torch.Tensor)
                              else a for a in args), **kwargs).half()
            return func(*args, **kwargs)

    return Fp16GemmInFp32()


def check_logits(torch, dev, small, p_cpu, p_dev, phase, what):
    """One paged prefill and six decode steps of ``small`` on the CPU and
    on the card, at ``small.dtype``: the logits within CARD_CPU_TOL in
    fp32, within a relative L2 of BF16_REL_L2 in bf16 and of FP16_REL_L2
    in fp16. Returns the max error (the largest relative L2 at the 16-bit
    dtypes)."""
    from repro_torch.core import serve_model

    spec = serve_model.ServeSpec(n_slots=4, block_size=16, max_blocks=8,
                                 n_total_blocks=32, m_qslots=4, window=4,
                                 prefill_rows=2, prefill_len=64,
                                 dtype=small.dtype)
    def run(device, params):
        st = serve_model.make_state(small, spec, device)
        i32 = dict(dtype=torch.int32, device=device)
        st["block_tables"][0, :4] = torch.tensor([3, 5, 7, 9], **i32)
        st["block_tables"][1, :5] = torch.tensor([11, 2, 4, 6, 8], **i32)
        st["seq_lens"][:2] = torch.tensor([45, 60], **i32)
        st["qslot"][:2] = torch.tensor([0, 1], **i32)
        prefill = serve_model.build_prefill_step(small, spec)
        decode = serve_model.build_decode_step(small, spec)
        toks = torch.arange(2 * 64, device=device).reshape(2, 64) * 97 \
            % small.vocab_size
        lengths = torch.tensor([45, 60], dtype=torch.int32, device=device)
        zero = torch.zeros(2, dtype=torch.int32, device=device)
        outs = [prefill(params, st, toks, torch.tensor(
            [0, 1], dtype=torch.int32, device=device), lengths, zero)]
        st["positions"][:2] = lengths
        active = torch.tensor([True, True, False, False], device=device)
        tok = torch.tensor([5, 6, 0, 0], device=device)
        for i in range(6):
            outs.append(decode(params, st, tok, active)[:2])
            tok = (tok + 1000 * (i + 1)) % small.vocab_size
        return [o.cpu() for o in outs]

    with cpu_fp16_gemm(torch, small.dtype):
        results = {"cpu": run("cpu", p_cpu)}
    results["card"] = run(dev, p_dev)
    errs = []
    half = small.dtype in ("bfloat16", "float16")
    for a, b in zip(results["cpu"], results["card"]):
        if a.dtype != torch.float32 or b.dtype != torch.float32:
            raise AssertionError(f"{phase}: logits are not fp32")
        err = (a - b).abs()
        if half:
            rel = float((a - b).double().norm() / a.double().norm())
            if not rel <= half_rel_l2(small.dtype):
                raise AssertionError(f"{phase}: card vs cpu {small.dtype} "
                                     f"logits at a relative L2 of {rel:.3e}")
            errs.append(rel)
            continue
        if bool((err > CARD_CPU_TOL + CARD_CPU_TOL * a.abs()).any()):
            raise AssertionError(f"{phase}: card vs cpu logits off by "
                                 f"{float(err.max()):.3e}")
        errs.append(float(err.max()))
    worst = max(errs)
    bar = (f"relative L2 {worst:.3e} (at most {half_rel_l2(small.dtype)})"
           if half else f"max_abs_err={worst:.3e} (atol=rtol={CARD_CPU_TOL})")
    log(phase, f"{what}, 2 layers, {small.dtype}: prefill + 6 decode steps,"
        f" {bar} ok; per output {', '.join(f'{e:.1e}' for e in errs)}")
    return worst


def phase_card_vs_cpu_configs(torch, dev):
    """Card against CPU at 2 layers of each other dense config, at its own
    widths and head layout: the logits, and greedy and seeded streams
    through the main path with compression firing (Qwen2.5-3B's, g = 8,
    through the Alg. 3 / Alg. 4 path too)."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm

    for name in DENSE_CONFIGS:
        phase = f"card-vs-cpu[{name}]"
        cfg = dataclasses.replace(get_config(name), dtype="float32")
        small = dataclasses.replace(cfg, num_layers=2, vocab_size=min(
            cfg.vocab_size, CPU_VOCAB))
        if small.vocab_size != cfg.vocab_size:
            log(phase, f"vocabulary cut from {cfg.vocab_size} to "
                f"{small.vocab_size} for the CPU side's memory")
        p_cpu = lm.init(small, torch.Generator("cpu").manual_seed(SEED),
                        "cpu")
        p_dev = _tree_to(p_cpu, dev)
        g = cfg.num_heads // cfg.num_kv_heads
        check_logits(torch, dev, small, p_cpu, p_dev, phase,
                     f"{name} widths (d_model {cfg.d_model}, "
                     f"{cfg.num_heads}/{cfg.num_kv_heads} heads, g = {g}, "
                     f"{cfg.norm_type})")
        check_streams(torch, dev, small, p_cpu, p_dev, phase, alg34=False)
        if name == "qwen2.5-3b":
            check_streams(torch, dev, small, p_cpu, p_dev, phase)
        del p_cpu, p_dev
        torch.cuda.empty_cache()


def phase_card_vs_cpu_bf16(torch, dev, cfg):
    """Phase 4 at bf16: 2 layers of ``cfg``'s widths with weights drawn at
    bf16 (norms fp32). Card against CPU: the logits within a relative L2
    of BF16_REL_L2 (cuBLAS and the CPU sum bf16 products in other orders),
    the threefry noise bit for bit; on the card a graph-replayed chunk ==
    the eager chunk bit for bit, greedy and seeded; and streams: the
    card's K = 8 (graph replays) == its K = 1, tokens and logprobs bit for
    bit, with compression firing, while the card's streams against the
    CPU's are measured (where each first parts is logged), not gated.
    Returns the largest relative L2 of the logits."""
    from repro_torch.models import lm

    small = dataclasses.replace(cfg, num_layers=2, dtype="bfloat16")
    p_cpu = lm.init(small, torch.Generator("cpu").manual_seed(SEED), "cpu")
    if p_cpu["layers"][0]["attn"]["wq"].dtype != torch.bfloat16 or \
            p_cpu["final_norm"]["scale"].dtype != torch.float32:
        raise AssertionError("bf16: lm.init did not draw bf16 matrices "
                             "beside fp32 norms")
    p_dev = _tree_to(p_cpu, dev)
    worst = check_logits(torch, dev, small, p_cpu, p_dev, "card-vs-cpu bf16",
                         f"{cfg.name} widths")
    check_noise(torch, dev, small.vocab_size)
    for greedy in (True, False):
        check_graph_vs_eager(torch, dev, small, p_dev, greedy)
    check_streams_bf16(torch, dev, small, p_cpu, p_dev)
    del p_dev
    torch.cuda.empty_cache()
    return worst


def check_streams_bf16(torch, dev, small, p_cpu, p_dev,
                       phase="card-vs-cpu bf16"):
    """Two greedy and two seeded streams with logprobs at ``small.dtype``
    (bf16, or fp16 in phase 16), compression firing: the card at
    ``decode_steps`` 1 and 8 equal bit for bit, tokens and logprobs; the
    CPU's (its fp16 products through ``cpu_fp16_gemm``) measured against
    the card's."""
    import numpy as np
    from repro_torch.api import SamplingParams, Zipage

    rng = np.random.default_rng(SEED + 2)
    prompts = [[int(x) for x in rng.integers(0, small.vocab_size, int(n))]
               for n in (70, 96, 81, 110)]
    sps = [SamplingParams(max_new_tokens=24, logprobs=True)] * 2 + [
        SamplingParams(max_new_tokens=24, seed=s, logprobs=True, **THINKING)
        for s in (SEED + 1, 2**31 + 3)]
    outs = {}
    for name, device, params, mode in (
            ("card K=1", dev, p_dev, {}),
            ("card K=8", dev, p_dev, dict(decode_steps=8)),
            ("cpu", "cpu", p_cpu, {})):
        z = Zipage(small, params, device=device, max_batch=4,
                   dtype=small.dtype, **mode)
        if z.engine.state["pools"]["k"].dtype != getattr(torch, small.dtype):
            raise AssertionError(f"{phase}: {name}: the pools are not "
                                 f"{small.dtype}")
        with cpu_fp16_gemm(torch, small.dtype if device == "cpu" else None):
            outs[name] = [(o.token_ids, o.logprobs)
                          for o in z.generate(prompts, sps)]
        if not sum(m["n_compressing"] for m in z.metrics):
            raise AssertionError(f"{phase}: {name}: no compression")
        if mode and max(m["decode_horizon"] for m in z.metrics) < 2:
            raise AssertionError(f"{phase}: {name}: no horizon above 1")
    for i, (a, b) in enumerate(zip(outs["card K=1"], outs["card K=8"])):
        if a != b:
            raise AssertionError(f"{phase}: stream {i}: K = 8 differs from "
                                 f"K = 1 at {_first_difference(a, b)}")
    firsts = [_first_difference(a, b)[0]
              for a, b in zip(outs["card K=1"], outs["cpu"])]
    log(phase, f"2 greedy and 2 seeded streams of 24 tokens: card K=8 == "
        f"card K=1, tokens and logprobs bit for bit ok; card vs cpu "
        f"(measured, not gated): first differing position {firsts}")


def check_noise(torch, dev, vocab):
    """The threefry sampling noise is the same bits on the card and the
    CPU (integer arithmetic only)."""
    from repro_torch.core.sampling import sampling_noise
    seeds = torch.tensor([0, 1, 7, 2**31 - 1, 2**31, 2**31 + 12345,
                          2**32 - 1, 123456789], dtype=torch.int64)
    counters = torch.tensor([0, 5, 127, 1, 0, 2**31 - 1, 4096, 64],
                            dtype=torch.int32)
    on_cpu = sampling_noise(seeds, counters, vocab)
    on_card = sampling_noise(seeds.to(dev), counters.to(dev), vocab).cpu()
    if not torch.equal(on_cpu.view(torch.int32), on_card.view(torch.int32)):
        n = int((on_cpu != on_card).sum())
        raise AssertionError(f"threefry noise: {n} of {on_cpu.numel()} "
                             "values differ between card and CPU")
    log("card-vs-cpu", f"threefry noise {tuple(on_cpu.shape)} for 8 "
        "(seed, counter) pairs, seeds up to 2**32-1: bit-identical on the "
        "card and the CPU ok")


def _graph_state(torch, dev, cfg, spec, seed):
    """A decode state at ``cfg``'s widths: random pools and windows, five
    live slots of 33-70 entries, one idle slot with a stale seq_len over
    an empty table, two never used (seq_len 0)."""
    from repro_torch.core import serve_model
    g = torch.Generator(device=dev).manual_seed(seed)
    st = serve_model.make_state(cfg, spec, dev)
    for name in ("k", "v"):
        st["pools"][name].normal_(generator=g)
    st["pools"]["f"].uniform_(generator=g)
    st["qwin"].normal_(generator=g)
    b = spec.block_size
    lens = [40, 57, 70, 33, 64, 21, 0]
    page = 1
    for i, n in enumerate(lens[:5]):
        n = -(-(n + 8) // b)
        st["block_tables"][i, :n] = torch.arange(page, page + n)
        page += n
    st["seq_lens"][:7] = torch.tensor(lens, dtype=torch.int32)
    st["positions"][:7] = torch.tensor(lens, dtype=torch.int32) + 3
    st["qslot"][:4] = torch.arange(4, dtype=torch.int32)
    st["tokens_next"].random_(0, cfg.vocab_size, generator=g)
    st["active_mask"][:5] = True
    st["sample_counters"][:5] = torch.tensor([0, 5, 9, 1, 2],
                                              dtype=torch.int32)
    return st


def check_graph_vs_eager(torch, dev, small, p_dev, greedy):
    """The fused decode chunk (n_steps = 4) of ``small`` run eagerly on one
    clone of a state and by replays of its captured CUDA graph on another,
    at chunk offsets 0 and 4 (idx0 on the card): tokens, logprobs and the
    state after both chunks must be the same bits. Row 0 meets its eos in
    the first chunk; three slots are idle. The sink page and the sink
    query slot are left out: the dropped writes of idle rows land there in
    no fixed order."""
    from repro_torch.core import serve_model
    from repro_torch.core.decode_graphs import DecodeGraphs
    from repro_torch.kernels import ops

    spec = serve_model.ServeSpec(n_slots=8, block_size=16, max_blocks=8,
                                 n_total_blocks=40, m_qslots=4, window=4,
                                 dtype=small.dtype)
    st0 = _graph_state(torch, dev, small, spec, SEED + 9)
    i32 = dict(dtype=torch.int32, device=dev)
    inp = [torch.zeros((), **i32),
           torch.tensor([8, 8, 3, 6, 8, 8, 8, 8], **i32),
           torch.tensor([7, 2**31 + 5, 11, 0, 3, 1, 2, 4], device=dev),
           torch.zeros(8, device=dev), torch.zeros(8, **i32),
           torch.ones(8, device=dev),
           torch.full((8, 2), -1, dtype=torch.int64, device=dev)]
    if not greedy:
        inp[3][1:4] = THINKING["temperature"]
        inp[4][1:4] = THINKING["top_k"]
        inp[5][1:4] = THINKING["top_p"]
    fused = serve_model.build_fused_decode_step(small, spec, 4,
                                                greedy=greedy)
    probe = fused(p_dev, _tree_clone(st0), *inp)[0][:, 0].tolist()
    inp[6][0, 1] = probe[1]
    n0 = probe.index(probe[1]) + 1          # row 0's tokens up to its eos
    eager, replayed = _tree_clone(st0), _tree_clone(st0)
    graphs = DecodeGraphs(lambda k, g: fused(p_dev, replayed, *inp), inp[1])
    before = ops.launch_counts["ragged_paged_attention"]
    graphs.capture(4, greedy, 2)
    if ops.launch_counts["ragged_paged_attention"] != before:
        raise AssertionError("graphs: the capture counted launches")
    outs = {"eager": [], "graph": []}
    for off in (0, 4):
        inp[0].fill_(off)
        outs["eager"].append([t.clone() for t in fused(p_dev, eager, *inp)])
        outs["graph"].append([t.clone() for t in graphs.replay(4, greedy,
                                                               2)])
    torch.cuda.synchronize()
    counted = ops.launch_counts["ragged_paged_attention"] - before
    pairs = [(f"{what} {i}", a, b)
             for i, (x, y) in enumerate(zip(outs["eager"], outs["graph"]))
             for what, a, b in (("tokens", x[0], y[0]),
                                ("logprobs", x[1], y[1]))]
    for name in ("seq_lens", "positions", "sample_counters", "active_mask",
                 "tokens_next"):
        pairs.append((name, eager[name], replayed[name]))
    for name in ("k", "v", "f"):
        pairs.append((f"pools[{name}]", eager["pools"][name][:, :-1],
                      replayed["pools"][name][:, :-1]))
    pairs.append(("qwin", eager["qwin"][:, :-1], replayed["qwin"][:, :-1]))
    for name, a, b in pairs:
        a, b = _bits(torch, a), _bits(torch, b)
        if not bool(torch.equal(a, b)):
            raise AssertionError(f"graphs: {name} differs between eager and "
                                 f"replay ({int((a != b).sum())} entries)")
    steps = (eager["seq_lens"] - st0["seq_lens"]).tolist()
    if steps != [n0, 8, 3, 6, 8, 0, 0, 0] or bool(eager["active_mask"][0]):
        raise AssertionError(f"graphs: rows decoded {steps} tokens, expected "
                             f"[{n0}, 8, 3, 6, 8, 0, 0, 0] with row 0 halted")
    expect = 2 * 4 * small.num_layers * 2   # 2 replays + 2 eager chunks
    if counted != expect:
        raise AssertionError(f"graphs: {counted} K1 launches counted, "
                             f"expected {expect}")
    log("graphs", f"{'greedy' if greedy else 'seeded'} chunk of 4 at 2 "
        f"layers of {small.name} widths, {small.dtype}, offsets 0 and 4: "
        f"replay == eager "
        f"bit for bit (tokens, logprobs, pools, qwin, seq_lens, positions, "
        f"counters, mask); rows decoded {steps}, row 0 halted at its eos; "
        f"captured launches {graphs.launches()}")


def _tree_clone(t):
    if isinstance(t, dict):
        return {k: _tree_clone(v) for k, v in t.items()}
    if isinstance(t, list):
        return [_tree_clone(v) for v in t]
    return t.clone()


def check_streams(torch, dev, small, p_cpu, p_dev, phase="card-vs-cpu",
                  alg34=True, modes=False):
    """Greedy and seeded streams, card against CPU, with compression
    firing: two of each through the Alg. 3 / Alg. 4 path (dense decode,
    flash redundancy, compaction), or (``alg34=False``) two greedy and one
    seeded through the main path (ragged decode, lightning redundancy).
    ``modes`` adds the card at ``decode_steps=8`` (graph replays of
    chunks of up to 4) and the CPU's unfused path, whose streams must be
    the same."""
    import numpy as np
    from repro_torch.api import SamplingParams, Zipage
    from repro_torch.core.compression import CompressOptions

    rng = np.random.default_rng(SEED + 2)
    prompts = [[int(x) for x in rng.integers(0, small.vocab_size, int(n))]
               for n in (70, 96, 81, 110)]
    sps = [SamplingParams(max_new_tokens=24),
           SamplingParams(max_new_tokens=24),
           SamplingParams(max_new_tokens=24, seed=SEED + 1, **THINKING),
           SamplingParams(max_new_tokens=24, seed=2**31 + 3, **THINKING)]
    knobs = dict(decode_kernel="dense", max_batch=4,
                 compress=CompressOptions(window=4, redundancy="flash"))
    if not alg34:
        prompts, sps, knobs = prompts[:3], sps[:3], dict(max_batch=4)
    outs, n_comp = {}, {}
    runs = [("cpu", "cpu", p_cpu, {}), ("card", dev, p_dev, {})]
    if modes:
        runs += [("card K=8", dev, p_dev, dict(decode_steps=8)),
                 ("cpu unfused", "cpu", p_cpu, dict(fuse_sampling=False))]
    for name, device, params, mode in runs:
        z = Zipage(small, params, device=device, **knobs, **mode)
        outs[name] = z.generate(prompts, sps)
        n_comp[name] = [o.metrics.compression.n_compressions
                        for o in outs[name]]
        if sum(n_comp[name]) == 0:
            raise AssertionError(f"{phase}: streams on {name}: no "
                                 "compression")
        if mode.get("decode_steps", 1) > 1 and max(
                m["decode_horizon"] for m in z.metrics) < 2:
            raise AssertionError(f"{phase}: {name}: no horizon above 1")
        if name not in ("cpu", "card") and [
                o.token_ids for o in outs[name]] != [
                o.token_ids for o in outs["cpu"]]:
            raise AssertionError(f"{phase}: {name} streams differ from the "
                                 "CPU's fused K = 1 streams")
    for i, (a, b) in enumerate(zip(outs["cpu"], outs["card"])):
        kind = "greedy" if sps[i].is_greedy else "seeded"
        log(phase, f"{kind} stream {i}: card {b.token_ids[:12]}...")
        if a.token_ids != b.token_ids:
            j = next(j for j, (x, y) in enumerate(zip(a.token_ids,
                                                      b.token_ids)) if x != y)
            raise AssertionError(f"{phase}: {kind} stream {i} differs at "
                                 f"token {j}: cpu {a.token_ids} card "
                                 f"{b.token_ids}")
    n_seeded = sum(1 for sp in sps if not sp.is_greedy)
    path = ("dense decode + flash redundancy" if alg34 else
            "ragged decode + lightning redundancy")
    log(phase, f"{path}, {len(sps) - n_seeded} greedy and {n_seeded} seeded "
        f"streams of 24 tokens: {' == '.join(outs)} ok; compressions per "
        f"request {n_comp['card']}")


def check_budget_streams(torch, dev, small, p_cpu, p_dev):
    """Greedy streams at ``n_max = BIG_N_MAX`` (a budget of 32 blocks,
    k = 512), card against CPU: the prompts pass the cap, so compression
    fires and each compaction moves 512 rows a (layer, request, head)."""
    import numpy as np
    from repro_torch.api import SamplingParams, Zipage

    rng = np.random.default_rng(SEED + 6)
    prompts = [[int(x) for x in rng.integers(0, small.vocab_size, n)]
               for n in (560, 601)]
    sp = SamplingParams(max_new_tokens=24)
    knobs = dict(n_max=BIG_N_MAX, max_model_len=1024, max_batch=2)
    outs, n_comp = {}, {}
    for name, device, params in (("cpu", "cpu", p_cpu), ("card", dev, p_dev)):
        z = Zipage(small, params, device=device, **knobs)
        outs[name] = z.generate(prompts, sp)
        n_comp[name] = [o.metrics.compression.n_compressions
                        for o in outs[name]]
        if min(n_comp[name]) == 0:
            raise AssertionError(f"n_max={BIG_N_MAX} on {name}: a request "
                                 f"never compressed ({n_comp[name]})")
    for i, (a, b) in enumerate(zip(outs["cpu"], outs["card"])):
        if a.token_ids != b.token_ids:
            raise AssertionError(f"n_max={BIG_N_MAX} greedy stream {i} "
                                 f"differs: cpu {a.token_ids} card "
                                 f"{b.token_ids}")
    k = (BIG_N_MAX - 1) * z.engine.opts.block_size
    log("card-vs-cpu", f"n_max={BIG_N_MAX} (k={k}), "
        f"prompts of {[len(p) for p in prompts]} tokens, 2 greedy streams "
        f"of 24 tokens: card == CPU ok; compressions per request "
        f"{n_comp['card']} (CPU {n_comp['cpu']})")


#: the tight shapes of tests/test_swap.py: 10 blocks of 8 for four requests
#: that want about four blocks each, so preemption fires
SWAP_SHAPES = dict(block_size=8, n_total_blocks=10, max_batch=4, m_qslots=4,
                   n_max=3, window=4, max_model_len=256, prefill_rows=2,
                   prefill_len=64)


def _bits(torch, t):
    """A float tensor's bits, as integers of its width (numpy has no
    bf16, and -0 / NaN compare as bits at any width)."""
    if t.dtype == torch.float32:
        return t.view(torch.int32)
    if t.dtype in (torch.bfloat16, torch.float16):
        return t.view(torch.int16)
    return t


def check_block_round_trip(torch, dev, small, p_dev):
    """A request's blocks of all three pool leaves and all layers gathered
    on the card, parked in the engine's pinned host swap pool over two runs
    of host blocks, and scattered into other device blocks; its
    observation-window row parked and restored into another query slot.
    Both must equal their sources bit for bit."""
    from repro_torch.api import Zipage
    from repro_torch.core.request import Request

    z = Zipage(small, p_dev, **SWAP_SHAPES, preemption_mode="swap",
               swap_space_blocks=24)
    eng = z.engine
    pinned = [k for k, t in eng.swap_pool.items() if not t.is_pinned()]
    if pinned:
        raise AssertionError(f"memory: host swap pool {pinned} not pinned")
    gen = torch.Generator(dev).manual_seed(SEED + 10)
    for name, leaf in eng.state["pools"].items():
        leaf.normal_(generator=gen) if name != "f" else leaf.uniform_(
            generator=gen)
    eng.state["qwin"].normal_(generator=gen)
    r = Request(rid=0, prompt=[1, 2], max_new_tokens=4)
    r.blocks, r.slot, r.qslot, r.output = [4, 2, 3, 7], 1, 2, [5, 9]
    r.n_prefilled = r.prefill_target = 2
    src = {k: v[:, r.blocks].clone() for k, v in eng.state["pools"].items()}
    win = eng.state["qwin"][:, r.qslot].clone()
    host_blocks, dest = [5, 6, 0, 1], [8, 0, 9, 1]
    eng._swap_out_blocks(r, list(r.blocks), host_blocks)
    r.slot, r.qslot = 3, 0
    restored = eng._swap_in_blocks(r, host_blocks, dest)
    torch.cuda.synchronize()
    pairs = [(f"host pool[{k}]", eng.swap_pool[k][host_blocks].transpose(
        0, 1), src[k].cpu()) for k in src]
    pairs += [(f"pools[{k}]", eng.state["pools"][k][:, dest], src[k])
              for k in src]
    pairs.append(("qwin", eng.state["qwin"][:, 0], win))
    for name, a, b in pairs:
        if not bool(torch.equal(_bits(torch, a), _bits(torch, b))):
            raise AssertionError(f"memory: block round trip: {name} differs "
                                 "from its source")
    if not restored or eng.tokens_next[3] != 9:
        raise AssertionError("memory: swap-in did not restore the window or "
                             "re-arm the next token")
    nbytes = eng._kv_block_bytes() * len(dest)
    log("card-vs-cpu", f"block round trip at 2 layers of {small.name} widths: "
        f"{len(dest)} blocks x 3 pool leaves ({nbytes / 1e6:.2f} MB) card -> "
        "pinned host pool (two runs of host blocks) -> other card blocks, "
        "and the observation-window row into another query slot: bit for "
        "bit ok")
    del z, eng


def _tight_prompts(vocab, seed, lens):
    import numpy as np
    rng = np.random.default_rng(seed)
    return [[int(x) for x in rng.integers(0, vocab, n)] for n in lens]


def _drained(z, label):
    """The pools and the swap tier after a finished serve, as
    tests/test_swap.py holds them."""
    eng, bm = z.engine, z.bm
    bm.check_invariants()
    if bm.num_free != eng.opts.n_total_blocks \
            or len(bm.swap_free) != eng.opts.swap_space_blocks \
            or bm.swapped or eng.scheduler.swapped or eng._swap_qwin:
        raise AssertionError(
            f"{label}: pools not drained: {bm.num_free} of "
            f"{eng.opts.n_total_blocks} free, {len(bm.swap_free)} of "
            f"{eng.opts.swap_space_blocks} host blocks free, swapped "
            f"{bm.swapped}, parked windows {sorted(eng._swap_qwin)}")


def check_swap_streams(torch, dev, small, p_cpu, p_dev, phase="card-vs-cpu"):
    """A swap-mode serve at tests/test_swap.py's tight shapes (four
    requests, greedy and seeded, all with logprobs), on the card and on
    the CPU: equal tokens, logprobs within CARD_CPU_TOL, preemption on
    both, swap-outs == swap-ins, and the pools drained clean."""
    import numpy as np
    from repro_torch.api import SamplingParams, Zipage

    prompts = _tight_prompts(small.vocab_size, SEED + 12, (5, 3, 7, 2))
    sps = [SamplingParams(max_new_tokens=28, logprobs=True),
           SamplingParams(max_new_tokens=28, seed=7, logprobs=True,
                          **THINKING),
           SamplingParams(max_new_tokens=28, logprobs=True),
           SamplingParams(max_new_tokens=28, seed=11, logprobs=True,
                          **THINKING)]
    outs, counts = {}, {}
    for name, device, params in (("cpu", "cpu", p_cpu), ("card", dev, p_dev)):
        z = Zipage(small, params, device=device, **SWAP_SHAPES,
                   preemption_mode="swap", swap_space_blocks=24)
        outs[name] = z.generate(prompts, sps)
        counts[name] = [sum(m[k] for m in z.metrics) for k in (
            "n_preempted", "n_swapped_out", "n_swapped_in")]
        if counts[name][1] == 0 or counts[name][1] != counts[name][2]:
            raise AssertionError(f"{phase}: swap serve on {name}: preempted, "
                                 f"swapped out, in {counts[name]}")
        _drained(z, f"{phase}: swap serve on {name}")
    for i, (a, b) in enumerate(zip(outs["cpu"], outs["card"])):
        if a.token_ids != b.token_ids:
            raise AssertionError(f"{phase}: swap serve stream {i} differs: "
                                 f"cpu {a.token_ids} card {b.token_ids}")
        np.testing.assert_allclose(b.logprobs, a.logprobs, rtol=CARD_CPU_TOL,
                                   atol=CARD_CPU_TOL)
    log(phase, f"swap serve at tests/test_swap.py's shapes (10 blocks of 8, "
        f"2 greedy + 2 seeded requests of 28 tokens with logprobs): card == "
        f"CPU (logprobs within {CARD_CPU_TOL}); preempted, swapped out, "
        f"swapped in: card {counts['card']}, CPU {counts['cpu']}; pools "
        "drained clean ok")
    return counts["card"]


def check_swap_snapshot(torch, dev, small, p_dev, phase="card-vs-cpu"):
    """A snapshot taken on the card while a request's KV is parked on the
    host restores into a fresh card engine whose decode graphs were
    captured before the restore, into its own buffers and host pool, and
    continues with the uninterrupted run's streams."""
    from repro_torch.core.engine import EngineOptions, ZipageEngine
    from repro_torch.core.compression import CompressOptions
    from repro_torch.core.sampling import SamplingParams

    prompts = _tight_prompts(small.vocab_size, SEED + 13, [5] * 5)
    opts = EngineOptions(**SWAP_SHAPES, compress=CompressOptions(window=4),
                         preemption_mode="swap", swap_space_blocks=24,
                         prefix_caching=False)

    def boot():
        eng = ZipageEngine(small, p_dev, opts)
        return eng, [eng.add_request(p, SamplingParams(max_new_tokens=30))
                     for p in prompts]

    eng, rids = boot()
    snap = None
    for _ in range(400):
        eng.step()
        if eng.scheduler.swapped:
            snap = eng.snapshot()
            break
    if snap is None:
        raise AssertionError(f"{phase}: never caught a swapped request")
    done_a = eng.run(max_steps=2000)
    fresh, _ = boot()
    if not fresh._graphs.graphs:
        raise AssertionError(f"{phase}: the fresh engine captured no graph")
    ptrs = {k: v.data_ptr() for k, v in fresh.swap_pool.items()}
    ptrs.update({k: v.data_ptr() for k, v in fresh.state["pools"].items()})
    fresh.restore(snap)
    done_b = fresh.run(max_steps=2000)
    after = {k: v.data_ptr() for k, v in fresh.swap_pool.items()}
    after.update({k: v.data_ptr() for k, v in fresh.state["pools"].items()})
    if after != ptrs:
        raise AssertionError(f"{phase}: restore rebound a pool")
    a = [done_a[r].output for r in rids]
    b = [done_b[r].output for r in rids]
    if a != b:
        raise AssertionError(f"{phase}: restored streams differ: {a} vs {b}")
    log(phase, f"snapshot with {len(snap['requests']['swapped'])} request(s) "
        "in the swapped queue, restored into a fresh captured card engine "
        f"(buffers and host pool kept): streams == the uninterrupted run's, "
        f"{fresh._graphs.replays} graph replays after the restore ok")


def check_adoption(torch, dev, small, p_cpu, p_dev, phase="card-vs-cpu"):
    """Compressed-prefix adoption, card against CPU: a 32-token prompt
    (four blocks of 8) compresses prompt-pure and registers a segment of
    two blocks; a watermark of 3 unreferenced cached blocks evicts its raw
    chain leaf first; three extensions of the prompt adopt the segment.
    Streams, pos_gap and the segment hits must be equal."""
    from repro_torch.api import SamplingParams, Zipage

    prefix, = _tight_prompts(small.vocab_size, SEED + 14, [32])
    ext = [prefix + p for p in _tight_prompts(small.vocab_size, SEED + 15,
                                              [2, 2, 2])]
    got = {}
    for name, device, params in (("cpu", "cpu", p_cpu), ("card", dev, p_dev)):
        z = Zipage(small, params, device=device, **dict(
            SWAP_SHAPES, n_total_blocks=64), cache_compressed_prefixes=True,
            prefix_cache_watermark=0.05)
        first = z.generate([prefix], SamplingParams(max_new_tokens=8))
        segments = len(z.bm.segments)
        outs = z.generate(ext, SamplingParams(max_new_tokens=24))
        reqs = [z.engine.finished[o.request_id] for o in outs]
        got[name] = dict(
            first=first[0].token_ids, streams=[o.token_ids for o in outs],
            pos_gap=[r.pos_gap for r in reqs], segments=segments,
            segment_hits=z.metrics[-1]["prefix_segment_hits"])
    if got["card"] != got["cpu"]:
        raise AssertionError(f"{phase}: adoption differs: card {got['card']} "
                             f"cpu {got['cpu']}")
    g = got["card"]
    if g["segments"] != 1 or g["segment_hits"] < len(ext) \
            or g["pos_gap"] != [32 - 16] * len(ext):
        raise AssertionError(f"{phase}: expected one segment adopted by each "
                             f"extension at pos_gap 16, got {g}")
    log(phase, f"compressed-prefix adoption (32-token prompt, segment of 2 "
        f"blocks, watermark eviction of the raw chain): {len(ext)} adopters "
        f"at pos_gap {g['pos_gap']}, {g['segment_hits']} segment hits, "
        "streams card == CPU ok")


def _tree_to(t, dev):
    if isinstance(t, dict):
        return {k: _tree_to(v, dev) for k, v in t.items()}
    if isinstance(t, list):
        return [_tree_to(v, dev) for v in t]
    return t.to(dev)


# ----------------------------------------------------------------------
# phase 5: full-width serve


class Recorder:
    """Keeps references to the inputs of the compression kernels' calls
    during a serve (no copies, no syncs), so phase 6 times them on exactly
    the serve's inputs. The decode kernels run inside captured CUDA graphs,
    whose arguments live in the graphs' memory pool and hold whatever a
    later replay left there; their input comes from ``DecodeInputs``."""

    NAMES = ("score_logits", "lightning_redundancy", "flash_redundancy",
             "compact")

    def __init__(self, ops):
        self.ops = ops
        self.orig = {n: getattr(ops, n) for n in self.NAMES}
        self.calls = {n: [] for n in self.orig}

    def __enter__(self):
        for name, fn in self.orig.items():
            setattr(self.ops, name, self._wrap(name, fn))
        return self

    def _wrap(self, name, fn):
        calls = self.calls[name]

        def wrapped(*args, **kw):
            calls.append((args, kw))
            if len(calls) > 400:
                del calls[:200]
            return fn(*args, **kw)
        return wrapped

    def __exit__(self, *exc):
        for name, fn in self.orig.items():
            setattr(self.ops, name, fn)


class DecodeInputs:
    """A step hook that keeps the decode kernels' input of the serve with
    the most live entries: after a step, the engine's block tables,
    ``seq_lens + 1`` (the lengths its next decode step passes, idle slots
    as they come) and layer 0's K and V pools, cloned on the card, and
    later a query drawn from the seed. Live entries are counted on the
    host mirrors, which equal the device state after a step (the
    sanitizer holds them to it), so the hook reads nothing back."""

    def __init__(self, eng):
        self.eng = eng
        self.best, self.best_live = None, -1
        eng.step_hooks.append(self)

    def __call__(self, entry):
        import numpy as np
        e = self.eng
        mapped = (e.host_bt >= 0).sum(1) * e.opts.block_size
        live = int(np.minimum(e.host_seq + 1, mapped).sum())
        if live <= self.best_live:
            return
        st = e.state
        if "k" not in st["pools"]:      # MLA decodes in plain PyTorch
            return
        self.best = (st["pools"]["k"][0].clone(), st["pools"]["v"][0].clone(),
                     st["block_tables"].clone(), st["seq_lens"] + 1)
        self.best_live = live

    def close(self):
        self.eng.step_hooks.remove(self)

    def args(self, torch):
        """(q, k_pages, v_pages, block_tables, seq_lens) for K1 and B4;
        None where the serve ran no decode kernel (MLA)."""
        if self.best is None:
            return None
        kp, vp, bt, sl = self.best
        cfg = self.eng.cfg
        gen = torch.Generator(device=kp.device).manual_seed(SEED + 8)
        q = torch.randn(bt.shape[0], cfg.num_heads, cfg.head_dim,
                        generator=gen, device=kp.device).to(kp.dtype)
        return q, kp, vp, bt, sl


class PlainGuard:
    """While on, any kernel's plain PyTorch version raises: on the card the
    serve must launch the kernels and never run their plain versions."""

    def __init__(self):
        from repro_torch.kernels import (compaction, paged_attention,
                                         paged_score, ragged_paged_attention,
                                         redundancy)
        self.targets = [(m, n) for m in (compaction, paged_attention,
                                         paged_score, ragged_paged_attention,
                                         redundancy)
                        for n in dir(m) if n.endswith("_plain")]
        self.saved = []

    def __enter__(self):
        for m, n in self.targets:
            self.saved.append((m, n, getattr(m, n)))
            setattr(m, n, self._refuse(n))
        return self

    @staticmethod
    def _refuse(name):
        def refuse(*args, **kw):
            raise AssertionError(f"{name} ran on the serve path")
        return refuse

    def __exit__(self, *exc):
        for m, n, fn in self.saved:
            setattr(m, n, fn)


def make_prompts(cfg, n_requests=N_REQUESTS):
    import numpy as np
    rng = np.random.default_rng(SEED)
    lens = [int(x) for x in rng.integers(40, 181, n_requests)]
    return [[int(x) for x in rng.integers(0, cfg.vocab_size, n)]
            for n in lens]


def run_serve(torch, card, z, label, prompts, sps, path):
    """Serve ``prompts`` through ``z`` with the launch counts set to 0 just
    before and read just after; check the result by the repo's own means
    and that every kernel of ``path`` launched and no plain version ran."""
    import numpy as np
    from repro_torch.kernels import ops

    eng = z.engine
    cfg = z.cfg
    hook = DecodeInputs(eng)
    replays0 = eng._graphs.replays
    m0 = len(eng.metrics)
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t = time.monotonic()
    with Recorder(ops) as rec, PlainGuard():
        outs = z.generate(prompts, sps)
        torch.cuda.synchronize()
    wall = time.monotonic() - t
    launches = dict(ops.launch_counts)
    hook.close()
    rec.decode_args = hook.args(torch)
    replays = eng._graphs.replays - replays0
    metrics = eng.metrics[m0:]
    horizons = [m["decode_horizon"] for m in metrics]
    n_tok = sum(len(o.token_ids) for o in outs)
    steps = [m["t_total"] for m in metrics]
    n_comp = sum(o.metrics.compression.n_compressions for o in outs)
    n_batches = sum(1 for m in metrics if m["n_compressing"] > 0)
    t_dev = sum(m["t_device"] for m in metrics)
    visited = sum(m["pages_visited"] for m in metrics)
    dense = sum(m["pages_dense"] for m in metrics)
    for i, o in enumerate(outs):
        kind = "greedy" if sps[i].is_greedy else "seeded"
        log(label, f"request {i} ({kind}): prompt {len(prompts[i])} tokens, "
            f"{len(o.token_ids)} new, {o.metrics.compression.n_compressions} "
            f"compressions, first tokens {o.token_ids[:8]}")
    log(label, f"{len(prompts)} requests, {n_tok} tokens in {wall:.2f} s = "
        f"{n_tok / wall:.1f} tok/s over {len(steps)} steps (step median "
        f"{1e3 * statistics.median(steps):.1f} ms, max "
        f"{1e3 * max(steps):.1f} ms, host wait on device "
        f"{t_dev / sum(steps):.3f} of step time) on {card}")
    log(label, f"{n_comp} compressions in {n_batches} launches; kernel "
        f"launches {launches}; decode pages visited {visited} (ragged) vs "
        f"{dense} (dense, decode_kernel={eng.opts.decode_kernel!r})")
    log(label, f"decode_steps={eng.opts.decode_steps}: {replays} graph "
        f"replays, horizon max {max(horizons)} mean "
        f"{statistics.mean(horizons):.2f}; graphs captured "
        f"{sorted(eng._graphs.graphs)}")
    # the repo's own checks of a finished serve
    assert all(len(o.token_ids) == NEW_TOKENS for o in outs), "short output"
    assert all(o.finish_reason == "length" for o in outs)
    assert all(0 <= t < cfg.vocab_size for o in outs for t in o.token_ids)
    assert all(np.isfinite(o.logprobs).all() for o in outs
               if o.logprobs is not None)
    assert n_comp > 0, "compression never fired"
    assert z.num_free_blocks == eng.opts.n_total_blocks, "blocks leaked"
    z.bm.check_invariants()
    for name in path:
        assert launches[name] > 0, f"kernel {name} never launched ({label})"
    for name, n in launches.items():
        assert name in path or n == 0, f"{name} launched off its path"
    assert launches["compaction"] == n_batches, \
        "a compression did not go through the compaction kernel"
    assert replays > 0, f"no decode graph replayed ({label})"
    summary = {"tokens": n_tok, "wall_s": wall, "tok_per_s": n_tok / wall,
               "steps": len(steps), "step_median_ms": 1e3 * statistics.median(
                   steps), "compressions": n_comp,
               "compression_launches": n_batches, "launches": launches,
               "pages_visited": visited, "pages_dense": dense,
               "decode_kernel": eng.opts.decode_kernel,
               "redundancy": eng.opts.compress.redundancy,
               "decode_steps": eng.opts.decode_steps, "graph_replays": replays,
               "horizon_max": max(horizons),
               "horizon_mean": statistics.mean(horizons)}
    return rec, launches, summary, outs


def phase_serve(torch, card):
    from repro_torch.api import SamplingParams, Zipage
    from repro_torch.models import lm

    t = time.monotonic()
    z = Zipage.from_config("qwen3-8b", param_seed=SEED)
    torch.cuda.synchronize()
    eng = z.engine
    cfg = z.cfg
    n_params = lm.param_count(eng.params)
    log("serve", f"{cfg.name}: {cfg.num_layers} layers, d_model "
        f"{cfg.d_model}, {n_params / 1e9:.2f} B params fp32 on the card, "
        f"ready in {time.monotonic() - t:.1f} s; defaults block_size="
        f"{eng.opts.block_size} n_max={eng.opts.n_max} window="
        f"{eng.opts.window} n_total_blocks={eng.opts.n_total_blocks} "
        f"max_batch={eng.opts.max_batch}")
    prompts = make_prompts(cfg)
    sps = [SamplingParams(max_new_tokens=NEW_TOKENS)] * N_REQUESTS
    rec, launches, summary, outs = run_serve(torch, card, z, "serve",
                                             prompts, sps, MAIN_PATH)
    return z, rec, launches, summary, outs


def phase_serve_alg34(torch, card, z_main):
    """The paper's Alg. 3 / Alg. 4 path at full width, on the main serve's
    weight tensors (no second copy): dense decode, flash redundancy."""
    from repro_torch.api import SamplingParams, Zipage
    from repro_torch.core.compression import CompressOptions

    z = Zipage(z_main.cfg, z_main.engine.params, decode_kernel="dense",
               compress=CompressOptions(window=4, redundancy="flash"))
    assert z.engine.params is z_main.engine.params
    prompts = make_prompts(z.cfg)
    half = N_REQUESTS // 2
    sps = [SamplingParams(max_new_tokens=NEW_TOKENS)] * half + [
        SamplingParams(max_new_tokens=NEW_TOKENS, seed=SEED + i, **THINKING)
        for i in range(N_REQUESTS - half)]
    rec, launches, summary, _ = run_serve(torch, card, z, "serve-alg34",
                                          prompts, sps, ALG34_PATH)
    return z, rec, launches, summary


# ----------------------------------------------------------------------
# phase 6: timing


def time_ms(torch, fn, n=50):
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def device_ms(torch, fn, n=20, windows=5):
    """Per call, the self device time of each CUDA kernel that ``n`` calls
    of ``fn`` ran, under torch.profiler: {kernel name: ms}, each kernel's
    mean time per recorded launch times its launches per call.

    The profiler (torch 2.11 on the H100) drops launches from a window: of
    20 calls it has recorded a kernel's launches 19, 14, 9 or 1 times, and
    now and then none at all. A dropped launch leaves the mean per launch
    as it was but not the sum, so the sum over ``n`` calls is never used
    (on an NVIDIA H100 80GB HBM3 at 700 W it once put fp16 compaction at
    0.11 ms, under its 0.18 ms byte bound). A window whose every kernel counts within a tenth of a whole
    number of launches per call ends the profiling; else another window
    is profiled, up to ``windows`` in all, and the means pooled over them
    are scaled by the launches per call of each kernel's fullest count
    (at least one). If no window records a kernel, the device time is not
    measured (None)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    total, counts, fullest = {}, {}, {}
    for _ in range(windows):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        window = {}
        for ev in prof.key_averages():
            us = getattr(ev, "self_device_time_total", None)
            if us is None:
                us = getattr(ev, "self_cuda_time_total", 0.0)
            if us and str(ev.device_type).endswith("CUDA"):
                name = _kernel_name(ev.key)
                total[name] = total.get(name, 0.0) + us / 1e3
                counts[name] = counts.get(name, 0) + ev.count
                window[name] = window.get(name, 0) + ev.count
        for name, c in window.items():
            fullest[name] = max(fullest.get(name, 0), c)
        if window and set(window) == set(total) and all(
                round(c / n) >= 1 and abs(c / n - round(c / n))
                <= 0.1 * round(c / n) for c in window.values()):
            break
        log("timing", "the profiler recorded launches " + (
            f"{window} of {n} calls" if window else "of no kernel")
            + "; profiling again")
    if not total:
        log("timing", f"the profiler recorded no device time in {windows} "
            "windows: the device time is not measured")
        return None
    return {name: total[name] / counts[name] * max(1, round(fullest[name] / n))
            for name in total}


def _kernel_name(key):
    """A profiler key without return type, namespace, template arguments
    and parameters: 'paged_attention_chunk_kernel'."""
    import re
    key = re.sub(r"\(anonymous namespace\)::", "", key)
    key = re.sub(r"^void ", "", key)
    return re.split(r"[<(]", key, maxsplit=1)[0].strip()


def times(torch, kernel, library):
    """Event, device and host (event minus device) ms per call of the
    kernel's wrapper and of its library yardstick; ``device_kernels``
    splits the kernel's device time by CUDA kernel. Device and host times
    are None where the profiler recorded nothing (``device_ms``)."""
    ms, by_kernel = time_ms(torch, kernel), device_ms(torch, kernel)
    lib, lib_by = time_ms(torch, library), device_ms(torch, library)
    dev = None if by_kernel is None else sum(by_kernel.values())
    lib_dev = None if lib_by is None else sum(lib_by.values())
    return {"ms": ms, "device_ms": dev,
            "host_ms": None if dev is None else ms - dev,
            "library_ms": lib, "library_device_ms": lib_dev,
            "library_host_ms": None if lib_dev is None else lib - lib_dev,
            "device_kernels": by_kernel or {}}


def fmt_ms(x):
    """A time in ms for the log, or "not measured" for None."""
    return "not measured" if x is None else f"{x:.4f}"


def bound(nbytes, flops, half=False):
    """The least time: bytes over HBM bandwidth or operations over the
    peak of their type (fp32 CUDA cores, or the tensor cores' bf16 and
    fp16 peak for products of 16-bit inputs), whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / (BF16_FLOPS_PER_S if half else FP32_FLOPS_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _live_lens(bt, sl, b):
    """Cache entries a call really reads, per row: seq_len capped by the
    pages its table maps (a finished slot keeps a stale seq_len over an
    empty table)."""
    mapped = (bt >= 0).sum(1) * b
    return sl.clamp(min=0).minimum(mapped.to(sl.dtype)).tolist()


def _live_entries(bt, sl, b):
    return sum(_live_lens(bt, sl, b))


def score_work(lens, hkv, g, w, d, T, table_el, es=4):
    """Bytes and flops of K2 over requests of ``lens`` live keys: queries
    and live keys (``es`` bytes an element), table and seq_lens read once,
    the (n, hkv, g, w, T) fp32 logits written once; 2 d flops per (query
    row, live key)."""
    n, n_live = len(lens), sum(lens)
    nbytes = es * (n * w * hkv * g * d + n_live * hkv * d) + 4 * (
        table_el + n + n * hkv * g * w * T)
    return nbytes, 2 * n_live * hkv * g * w * d


def redundancy_work(lens, span, h, d, T, table_el, es=4):
    """Bytes and flops of K3 (``span`` = the page size: pairs within a
    page) or B5 (``span`` >= T: all pairs) over requests of ``lens`` live
    keys: live keys (``es`` bytes an element), table and seq_lens read
    once, the (n, T, h) fp32 row sums written once. The cosine matrix is
    symmetric, so a block of m live keys needs m (m - 1) / 2 distinct
    products of 2 d flops; each key's norm and scaling adds 3 d."""
    n, n_live = len(lens), sum(lens)
    pairs2 = sum((L // span) * span * (span - 1) + (L % span) * (L % span - 1)
                 for L in lens)                   # twice the distinct pairs
    nbytes = es * n_live * h * d + 4 * (table_el + n + n * T * h)
    return nbytes, pairs2 * h * d + 3 * n_live * h * d


def _pick(calls, key):
    """The recorded call whose live work is largest."""
    best, best_v = None, -1
    for args, kw in calls:
        v = key(args)
        if v > best_v:
            best, best_v = (args, kw), v
    return best


def phase_timing(torch, rec, rec34, launches, launches34, errs,
                 dtype=None):
    """Times every kernel at an input of its serve: K1-K3 from the main
    serve, B4-B6 from the Alg. 3 / Alg. 4 serve, whose launch count is the
    row's ``launches``; ``launches_per_serve`` has both. The compression
    kernels' inputs are recorded calls; the decode kernels' are the
    serve's state at the step with the most live entries
    (``DecodeInputs``), where K1 and B4 are first held against their plain
    versions, B4 against K1 bit for bit on live rows. ``dtype``: the
    serves' K/V dtype (fp32 unless given), which names the rows."""
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ragged_paged_attention as rpa

    dtype = dtype or torch.float32
    out_tol = kernel_tols(torch, dtype)[1]
    per_serve = {n: {"main": launches[n], "alg34": launches34[n]}
                 for n in launches}
    errs = dict(errs)
    for mod, args in ((rpa, rec.decode_args), (pa, rec34.decode_args)):
        assert args[0].dtype == args[1].dtype == dtype
        got = getattr(mod, mod.NAME + "_cuda")(*args)
        e = max_err(torch, got, getattr(mod, mod.NAME + "_plain")(*args),
                    f"{mod.NAME}[serve state]", out_tol)
        live = args[4] > 0
        other = (rpa if mod is pa else pa)
        if not bool(torch.equal(got[live], getattr(
                other, other.NAME + "_cuda")(*args)[live])):
            raise AssertionError(f"{mod.NAME}[serve state]: dense and "
                                 "ragged decode differ on live rows")
        b = args[1].shape[1]
        idle = int(((args[3] >= 0).sum(1) * b < args[4]).sum())
        log("timing", f"{mod.NAME} at the serve's state: max_abs_err={e:.3e}"
            f" (atol=rtol={out_tol}), {idle} idle rows of {args[0].shape[0]}"
            f", seq_lens {args[4].tolist()}")
        errs[mod.NAME] = max(errs[mod.NAME], e)

    def pick(r, op, key):
        return _pick(r.calls[op], key)

    def comp_live(a):
        return _live_entries(a[1], a[2], a[0].shape[1])

    def score_live(a):
        return _live_entries(a[2], a[3], a[1].shape[1])

    specs = [
        ("main", decode_spec(torch, "ragged_paged_attention",
                             rec.decode_args)),
        ("main", score_spec(torch, pick(rec, "score_logits", score_live)[0])),
        ("main", redundancy_spec(torch, "lightning_redundancy",
                                 *pick(rec, "lightning_redundancy",
                                       comp_live))),
        ("alg34", decode_spec(torch, "paged_attention", rec34.decode_args)),
        ("alg34", redundancy_spec(torch, "flash_redundancy",
                                  *pick(rec34, "flash_redundancy",
                                        comp_live))),
        ("alg34", compaction_spec(torch, pick(rec34, "compact",
                                              _live_rows)[0])),
    ]
    return [_row(torch, spec, per_serve, serve, errs) for serve, spec in specs]


def row_name(torch, name, dtype):
    """A kernel row's name: the kernel's, with ``_bf16`` for its bf16
    variant and ``_f16`` for its fp16 one (its entry points' suffixes)."""
    return name + {torch.bfloat16: "_bf16", torch.float16: "_f16"}.get(
        dtype, "")


def decode_spec(torch, name, args):
    """K1 (ragged) or B4 (dense) on ``args``. The bound counts the live
    entries either way: the function's output depends on them alone,
    whatever the kernel reads. The library yardstick is SDPA over the
    gathered table."""
    from repro_torch.core.paged import gather_entries
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ragged_paged_attention as rpa

    F = torch.nn.functional
    mod = rpa if name == rpa.NAME else pa
    cuda_fn = getattr(mod, mod.NAME + "_cuda")
    plain_fn = getattr(mod, mod.NAME + "_plain")
    q, kp, vp, bt, sl = args
    B, hq, d = q.shape
    hkv = kp.shape[2]
    n_live = _live_entries(bt, sl, kp.shape[1])
    es = kp.element_size()        # q in, out and K, V: the pools' dtype
    nbytes = es * (2 * q.numel() + 2 * n_live * hkv * d) + 4 * (
        bt.numel() + sl.numel())
    kg = gather_entries(kp, bt).repeat_interleave(hq // hkv, dim=2)
    vg = gather_entries(vp, bt).repeat_interleave(hq // hkv, dim=2)
    kg, vg = kg.transpose(1, 2).contiguous(), vg.transpose(1, 2).contiguous()
    T = kg.shape[2]
    mask = (torch.arange(T, device=q.device)[None] < sl[:, None])[:, None,
                                                                  None]
    q4 = q[:, :, None]
    return dict(name=mod.NAME, source=f"src/repro_torch/csrc/{mod.NAME}.cu",
                dtype=kp.dtype, kernel=lambda: cuda_fn(q, kp, vp, bt, sl),
                plain=lambda: plain_fn(q, kp, vp, bt, sl),
                library=lambda: F.scaled_dot_product_attention(
                    q4, kg, vg, attn_mask=mask),
                nbytes=nbytes, flops=4 * n_live * hq * d,
                shapes={"batch": B, "seq_lens": sl.tolist(),
                        "table_width": bt.shape[1]})


def score_spec(torch, args, kw=None):
    """K2 on ``args`` (and ``kw``: MLA's ``scale``); the library
    yardstick is the matmul of the pre-gathered queries and keys, without
    the mask."""
    from repro_torch.kernels import paged_score as ps

    q_win, kp, bt, sl = args
    scale = (kw or {}).get("scale")
    n, w, hq, d = q_win.shape
    hkv = kp.shape[2]
    g = hq // hkv
    nbytes, flops = score_work(_live_lens(bt, sl, kp.shape[1]), hkv, g, w, d,
                               bt.shape[1] * kp.shape[1], bt.numel(),
                               kp.element_size())
    qg = q_win.reshape(n, w, hkv, g, d).permute(0, 2, 3, 1, 4) \
        .reshape(n, hkv, g * w, d).contiguous()
    kt = _masked_keys(torch, kp, bt, sl).permute(0, 2, 3, 1).contiguous()
    return dict(name=ps.NAME, source="src/repro_torch/csrc/paged_score.cu",
                dtype=kp.dtype,
                kernel=lambda: ps.paged_score_logits_cuda(q_win, kp, bt, sl,
                                                          scale=scale),
                plain=lambda: ps.paged_score_logits_plain(q_win, kp, bt, sl,
                                                          scale=scale),
                library=lambda: torch.matmul(qg, kt), nbytes=nbytes,
                flops=flops, shapes={"n": n, "seq_lens": sl.tolist(),
                                     "table_width": bt.shape[1]})


def _masked_keys(torch, kp, bt, sl):
    """The gathered keys (n, T, h, d) in the pool's dtype, zero at
    positions >= seq_len."""
    from repro_torch.core.paged import gather_entries
    e = gather_entries(kp, bt)
    T = e.shape[1]
    valid = torch.arange(T, device=e.device)[None] < sl[:, None]
    return torch.where(valid[..., None, None], e,
                       torch.zeros((), dtype=e.dtype, device=e.device))


def redundancy_spec(torch, name, args, kw):
    """K3 (lightning) or B5 (flash) on ``args``. The library yardstick is
    the matmul of the pre-gathered, normalised keys: all pairs (flash) or
    the pairs of each page (lightning), without the mask and zero-out."""
    from repro_torch.kernels import redundancy as red

    flash = name == red.FLASH_NAME
    cuda_fn = red.flash_redundancy_cuda if flash else \
        red.lightning_redundancy_cuda
    plain_fn = red.flash_redundancy_plain if flash else \
        red.lightning_redundancy_plain
    kp, bt, sl = args
    p = kw.get("p_thresh", 0.8)
    N, b, h, d = kp.shape
    n, mb = bt.shape
    nbytes, flops = redundancy_work(_live_lens(bt, sl, b), mb * b if flash
                                    else b, h, d, mb * b, bt.numel(),
                                    kp.element_size())
    e = _masked_keys(torch, kp, bt, sl)                     # (n, T, h, d)
    eh = (e / torch.linalg.vector_norm(e, dim=-1, keepdim=True)
          .clamp(min=1e-12)).permute(0, 2, 1, 3).contiguous()  # (n,h,T,d)
    if not flash:
        eh = eh.reshape(n, h, mb, b, d)
    source = "flash_redundancy.cu" if flash else "redundancy.cu"
    return dict(name=name, source="src/repro_torch/csrc/" + source,
                dtype=kp.dtype,
                kernel=lambda: cuda_fn(kp, bt, sl, p_thresh=p),
                plain=lambda: plain_fn(kp, bt, sl, p_thresh=p),
                library=lambda: torch.matmul(eh, eh.transpose(-1, -2)),
                nbytes=nbytes, flops=flops,
                shapes={"n": n, "seq_lens": sl.tolist(), "table_width": mb})


def _live_rows(a):
    """Rows of a compaction call that write outside the sink page (a
    padding row writes only there)."""
    dest, sink = a[6], a[0].shape[1] - 1
    return int(((dest // a[0].shape[2]) != sink).any(1).sum())


def compaction_spec(torch, args):
    """B6 on ``args``. The library yardstick is one advanced-indexing
    gather and one ``index_copy_`` per pool. The timed calls move the
    pools again in place (after the serve is over, for the serve's
    input)."""
    from repro_torch.kernels import compaction as cmp

    kp, vp, fp, new_f, src_bt, src_cache, dest_flat = args
    L, N1, b, h, d = kp.shape
    n, kk = dest_flat.shape
    n_rows = _live_rows(args)
    moved = L * n_rows * h * kk
    es = kp.element_size()        # K and V; F, new_f and indices are 4 B
    n_kv = 1 if vp is None else 2   # MLA's latent pool has no V
    nbytes = es * n_kv * 2 * moved * d + 4 * 2 * moved \
        + 4 * n_rows * (src_bt.shape[1] + kk) + 4 * L * n_rows * h * kk
    # flat row indices over (L * slots * h) rows of d (K, V) or 1 (F)
    S = N1 * b
    dev = kp.device
    sc = src_cache.long()
    blk = torch.gather(src_bt.long().clamp(min=0)[None, :, None, :]
                       .expand(L, n, h, -1), 3, sc // b)
    slot = blk * b + sc % b                                  # (L, n, h, k)
    lay = torch.arange(L, device=dev)[:, None, None, None]
    hd = torch.arange(h, device=dev)[None, None, :, None]
    src_idx = ((lay * S + slot) * h + hd).reshape(-1)
    dst_idx = ((lay * S + dest_flat.long()[None, :, None, :]) * h + hd) \
        .reshape(-1)
    nf_idx = (((lay * n + torch.arange(n, device=dev)[None, :, None, None])
               * (new_f.shape[2]) + sc) * h + hd).reshape(-1)
    kvf = [t.view(-1, d) for t in (kp, vp) if t is not None]
    ff, nff = fp.view(-1), new_f.reshape(-1)

    def library():
        for t in kvf:
            t.index_copy_(0, dst_idx, t[src_idx])
        ff.index_copy_(0, dst_idx, nff[nf_idx])

    return dict(name=cmp.NAME, source="src/repro_torch/csrc/compaction.cu",
                dtype=kp.dtype, kernel=lambda: cmp.compact_cuda(*args),
                plain=lambda: cmp.compact_plain(*args), library=library,
                nbytes=nbytes, flops=0,
                shapes={"layers": L, "n": n, "live_rows": n_rows, "k": kk,
                        "table_width": src_bt.shape[1]})


def _row(torch, spec, per_serve, serve, errs, label=None):
    """The kernels-line row of ``spec``, timed; named ``label`` if given,
    else by kernel and dtype (``row_name``)."""
    name = spec["name"]
    dtype = spec["dtype"]
    label = label or row_name(torch, name, dtype)
    t = times(torch, spec["kernel"], spec["library"])
    plain_ms = time_ms(torch, spec["plain"], n=10)
    bound_ms, bound_by = bound(spec["nbytes"], spec["flops"],
                               dtype in (torch.bfloat16, torch.float16))
    log("timing", f"{label}: {t['ms']:.4f} ms = device "
        f"{fmt_ms(t['device_ms'])} + host {fmt_ms(t['host_ms'])} (plain "
        f"{plain_ms:.4f} ms, bound {bound_ms:.5f} ms by {bound_by}, "
        f"library {t['library_ms']:.4f} ms "
        f"= device {fmt_ms(t['library_device_ms'])} + host "
        f"{fmt_ms(t['library_host_ms'])}) at {spec['shapes']}; launches "
        f"per serve {per_serve[name]}; device by kernel {_split(t)}")
    return {"name": label, "kernel": name,
            "dtype": str(dtype).replace("torch.", ""), "route": "cuda",
            "source": spec["source"],
            "replaces": REPLACES[name], "launches": per_serve[name][serve],
            "max_abs_err": errs[name], "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, **t,
            "launches_per_serve": per_serve[name]}


def _split(t):
    return ", ".join(f"{k} {v:.4f}" for k, v in t["device_kernels"].items())


def long_input(torch, dev, cfg, opts, table=LONG_TABLE, lens=LONG_LENS,
               dtype=None):
    """An input of K2, K3 and B5 at Qwen3-8B heads: ``table`` pages of the
    engine's block size, seq_lens ``lens``, random keys from the seed with
    a NaN page 0 and NaN stale tails; each row's newest page is a
    near-duplicate of its oldest, so the flash zero-out fires. Queries and
    keys at ``dtype`` (fp32 unless given)."""
    import numpy as np
    b, hkv, d = opts.block_size, cfg.num_kv_heads, cfg.head_dim
    rng = np.random.default_rng(SEED + 3)
    n_pages = 1 + sum(-(-s // b) for s in lens)
    k = rng.normal(size=(n_pages, b, hkv, d)).astype(np.float32)
    bt = np.full((len(lens), table), -1, np.int32)
    free = list(rng.permutation(np.arange(1, n_pages)))
    for i, s in enumerate(lens):
        for j in range(-(-s // b)):
            bt[i, j] = free.pop()
        k[bt[i, (s - 1) // b]] = k[bt[i, 0]] + 0.05 * rng.normal(
            size=(b, hkv, d))
        if s % b:
            k[bt[i, s // b], s % b:] = np.nan
    k[0] = np.nan
    q_win = rng.normal(size=(len(lens), opts.window, cfg.num_heads,
                             d)).astype(np.float32)
    dtype = dtype or torch.float32
    return (torch.from_numpy(q_win).to(dev, dtype),
            torch.from_numpy(k).to(dev, dtype),
            torch.from_numpy(bt).to(dev),
            torch.tensor(lens, dtype=torch.int32, device=dev))


def decode_input(torch, dev, cfg, opts, table=LONG_TABLE,
                 lens=LONG_DECODE_LENS, dtype=None):
    """A decode input of K1 and B4 at Qwen3-8B heads: one query token per
    slot of ``lens``, ``table`` pages of the engine's block size, random
    q, K and V (at ``dtype``, fp32 unless given) from the seed with a NaN
    page 0 and NaN stale tails."""
    import numpy as np
    b, hkv, d = opts.block_size, cfg.num_kv_heads, cfg.head_dim
    rng = np.random.default_rng(SEED + 4)
    n_pages = 1 + sum(-(-s // b) for s in lens)
    k = rng.normal(size=(n_pages, b, hkv, d)).astype(np.float32)
    v = rng.normal(size=(n_pages, b, hkv, d)).astype(np.float32)
    bt = np.full((len(lens), table), -1, np.int32)
    free = list(rng.permutation(np.arange(1, n_pages)))
    for i, s in enumerate(lens):
        for j in range(-(-s // b)):
            bt[i, j] = free.pop()
        if s % b:
            k[bt[i, s // b], s % b:] = v[bt[i, s // b], s % b:] = np.nan
    k[0] = v[0] = np.nan
    q = rng.normal(size=(len(lens), cfg.num_heads, d)).astype(np.float32)
    dtype = dtype or torch.float32
    return tuple(torch.from_numpy(a).to(dev, dtype) for a in (q, k, v)) + (
        torch.from_numpy(bt).to(dev),
        torch.tensor(lens, dtype=torch.int32, device=dev))


#: kernels with an input for ``time_at``: K2, K3, B5 at ``long_input``,
#: K1 and B4 at ``decode_input``, B6 at ``compaction_case``
TIMED_AT = ("paged_score", "lightning_redundancy", "flash_redundancy",
            "ragged_paged_attention", "paged_attention", "compaction")


def time_at(torch, dev, cfg, opts, names, comp=(LONG_TABLE, LONG_LENS),
            dec=(LONG_TABLE, LONG_DECODE_LENS), budget=LONG_BUDGET,
            dtype=None):
    """The kernels ``names`` (of TIMED_AT) at ``long_input(*comp)``,
    ``decode_input(*dec)`` and, for B6, ``comp`` compacted to ``budget``
    blocks (one request in place, the others copy-on-write): each held
    against its plain version (at ``kernel_tols``; B6 bit for bit; K3, B4,
    B5 and B6 also two launches bit for bit, K3's and B5's zero-outs
    firing, B4 against K1 bit for bit on live rows), then timed like the
    serve's rows. K/V and queries at ``dtype`` (fp32 unless given).
    Returns {kernel name: record}."""
    import numpy as np
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ragged_paged_attention as rpa
    from repro_torch.kernels import redundancy as red

    dtype = dtype or torch.float32
    tol, out_tol = kernel_tols(torch, dtype)
    specs, errs, extra = {}, {}, {}
    if {"paged_score", red.NAME, red.FLASH_NAME} & set(names):
        q_win, k, bt, sl = long_input(torch, dev, cfg, opts, *comp, dtype)
        p = opts.compress.p_thresh
        if "paged_score" in names:
            specs["paged_score"] = score_spec(torch, (q_win, k, bt, sl))
        for name in (red.NAME, red.FLASH_NAME):
            if name in names:
                specs[name] = redundancy_spec(torch, name, (k, bt, sl),
                                              {"p_thresh": p})
                off = (red.lightning_redundancy_plain if name == red.NAME
                       else red.flash_redundancy_plain)(k, bt, sl,
                                                        p_thresh=2.0)
                extra[name] = {"zero_outs": int(
                    (off != specs[name]["plain"]()).sum())}
                del off
        # the long input's near-duplicate pages fire the flash zero-out;
        # its pages hold random keys, so the lightning one may not fire
        if red.FLASH_NAME in names and \
                extra[red.FLASH_NAME]["zero_outs"] == 0:
            raise AssertionError(f"flash{comp}: the p_thresh zero-out "
                                 "never fired")
    if {rpa.NAME, pa.NAME} & set(names):
        args = decode_input(torch, dev, cfg, opts, *dec, dtype)
        sl = args[4]
        live = sl > 0
        dense = pa.paged_attention_cuda(*args)
        ragged = rpa.ragged_paged_attention_cuda(*args)
        if not bool(torch.equal(dense[live], ragged[live])):
            diff = (dense - ragged)[live].float().abs().max()
            raise AssertionError(f"dense vs ragged{dec}: live rows differ by "
                                 f"{float(diff)}"
                                 " (bit for bit is required)")
        for name in (rpa.NAME, pa.NAME):
            if name in names:
                specs[name] = decode_spec(torch, name, args)
        del dense, ragged
    if "compaction" in names:
        table, lens = comp
        kinds = ["in_place"] + ["cow"] * (len(lens) - 1)
        args = compaction_case(torch, dev, cfg, opts,
                               np.random.default_rng(SEED + 5), lens, kinds,
                               table, budget, L=cfg.num_layers, dtype=dtype)
        check_compaction_at(torch, args,
                            f"compaction[k={budget * opts.block_size}]")
        errs["compaction"] = 0.0
        specs["compaction"] = compaction_spec(torch, args)
        torch.cuda.empty_cache()
    out = {}
    for name in names:
        spec = specs[name]
        if name != "compaction":    # B6 was held bit for bit above
            got = spec["kernel"]()
            errs[name] = max_err(torch, got, spec["plain"](),
                                 f"{name}[{spec['shapes']['table_width']}]",
                                 out_tol if got.dtype == dtype else tol)
            if name in (red.NAME, red.FLASH_NAME, pa.NAME) and not bool(
                    torch.equal(got, spec["kernel"]())):
                raise AssertionError(f"{name}: two launches differ")
            del got
        t = times(torch, spec["kernel"], spec["library"])
        b_ms, b_by = bound(spec["nbytes"], spec["flops"],
                           dtype in (torch.bfloat16, torch.float16))
        out[name] = {**t, "bound_ms": b_ms, "bound_by": b_by,
                     "max_abs_err": errs[name], **extra.get(name, {}),
                     **spec["shapes"]}
        log("timing", f"{row_name(torch, name, dtype)}"
            f"[{spec['shapes']['table_width']}]: "
            f"max_abs_err={errs[name]:.3e}; {t['ms']:.4f} "
            f"ms = device {fmt_ms(t['device_ms'])} + host "
            f"{fmt_ms(t['host_ms'])} (bound {b_ms:.5f} ms by {b_by}, library "
            f"{t['library_ms']:.4f} ms = device "
            f"{fmt_ms(t['library_device_ms'])}) at {spec['shapes']}; "
            f"device by kernel {_split(t)}")
        del specs[name]
        torch.cuda.empty_cache()
    return out


def phase_long(torch, dev, cfg, opts, rows, dtype=None):
    """Every kernel at its long input (K/V at ``dtype``, fp32 unless
    given); the records go into their rows as ``long_input``."""
    by_name = {r["kernel"]: r for r in rows}
    for name, rec in time_at(torch, dev, cfg, opts, TIMED_AT,
                             dtype=dtype).items():
        by_name[name]["long_input"] = rec


# ----------------------------------------------------------------------
# phase 7: profiled decode window


def phase_profile(torch, z, card, label="profile", new_tokens=40):
    """A profiled window of 8 steps of ``z`` over 4 fresh requests of
    ``new_tokens`` tokens, after 3 steps of admission and prefill: the
    device-busy share of wall time and kernel time by group."""
    import numpy as np
    from repro_torch.api import SamplingParams
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(SEED + 1)
    for n in rng.integers(60, 121, 4):
        z.add_request([int(x) for x in rng.integers(0, z.cfg.vocab_size,
                                                    int(n))],
                      SamplingParams(max_new_tokens=new_tokens))
    for _ in range(3):              # admission + prefill, out of the window
        z.step()
    torch.cuda.synchronize()
    n_steps = 8
    tokens0 = sum(m["tokens"] for m in z.metrics)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.monotonic()
        for _ in range(n_steps):
            z.step()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.monotonic() - t)
    n_tok = sum(m["tokens"] for m in z.metrics) - tokens0
    busy, groups, calls = device_busy(prof)
    while z.has_unfinished():
        z.step()
    if busy <= 0:
        log(label, "the profiler recorded no device time (not measured)")
        return None
    log(label, f"{card}: {n_steps} steps, {n_tok} tokens in {wall_ms:.1f} ms "
        f"wall, device busy {busy:.1f} ms ({busy / wall_ms:.3f} of wall, "
        f"idle {1 - busy / wall_ms:.3f})")
    for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        log(label, f"  {g:<24s} {ms:8.2f} ms ({ms / busy:.3f} of busy)")
    for g, (ms, n) in sorted(calls.items()):
        log(label, f"  {g}: {n} CUDA kernels, {ms / n:.4f} ms of device "
            "time each")  # a K1 or B4 call runs two: chunks, then merge
    return {"steps": n_steps, "tokens": n_tok, "wall_ms": wall_ms,
            "busy_ms": busy, "idle": 1 - busy / wall_ms,
            "groups_ms": groups, "kernel_calls": calls}


def device_busy(prof):
    """A finished profile's device time in ms: in all, by kernel group, and
    (ms, count) for each of the port's kernels."""
    groups = {}
    calls = {}                # device time and count of the port's kernels
    busy = 0.0
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0.0)
        if not dev_us or not str(ev.device_type).endswith("CUDA"):
            continue          # host-side ops; their kernels are listed too
        g = _group(ev.key)
        groups[g] = groups.get(g, 0.0) + dev_us / 1e3
        busy += dev_us / 1e3
        if g[0] in "KB" and g[1].isdigit():
            ms, n = calls.get(g, (0.0, 0))
            calls[g] = (ms + dev_us / 1e3, n + ev.count)
    return busy, groups, calls


#: decode_steps of the paired serves, in order
PAIRED_STEPS = (1, 8, 8, 1)
#: 7b's depth: the first 12 of Qwen3-8B's 36 layers, at full width, so
#: that the script keeps well inside its time limit with phase 13 (the
#: whole script took 1086.8 s of 1200 on an H100 80GB HBM3 at 700 W
#: with 7b and 9 at 36 layers, ~968 s with them at 18 and 12)
PAIRED_LAYERS = 12


def shallow(z, n_layers):
    """(config, params) of the first ``n_layers`` layers of ``z``'s model,
    at full width, sharing its weight tensors (no copy)."""
    cfg = dataclasses.replace(z.cfg, num_layers=n_layers)
    return cfg, dict(z.engine.params, layers=z.engine.params["layers"][
        :n_layers])


def phase_paired(torch, card, z_main):
    """Qwen3-8B at full width and its first PAIRED_LAYERS layers (the main
    serve's weight tensors), served at ``decode_steps`` 1, 8, 8 and 1 in
    turn (each a fresh engine whose
    fused chunks replay CUDA graphs): 4 greedy and 4 seeded requests of
    NEW_TOKENS tokens with logprobs. Token streams and logprobs must be
    equal across the four serves (the tests/test_fused_decode.py
    contract), and K = 8 must reach a horizon above 1. Each serve also
    reads the device-idle share of a profiled window (``phase_profile``).
    No limit is set on the times."""
    from repro_torch.api import SamplingParams, Zipage

    cfg, params = shallow(z_main, PAIRED_LAYERS)
    prompts = make_prompts(cfg)
    half = N_REQUESTS // 2
    sps = [SamplingParams(max_new_tokens=NEW_TOKENS, logprobs=True)] * half \
        + [SamplingParams(max_new_tokens=NEW_TOKENS, seed=SEED + i,
                          logprobs=True, **THINKING)
           for i in range(N_REQUESTS - half)]
    ref, out = None, []
    for turn, k in enumerate(PAIRED_STEPS):
        label = f"paired[{turn}: K={k}]"
        t = time.monotonic()
        z = Zipage(cfg, params, decode_steps=k)
        torch.cuda.synchronize()
        ready = time.monotonic() - t
        summary, outs = run_serve(torch, card, z, label, prompts, sps,
                                  MAIN_PATH)[2:]
        streams = [(o.token_ids, o.logprobs) for o in outs]
        if ref is None:
            ref = streams
        for i, (a, b) in enumerate(zip(ref, streams)):
            if a != b:
                j = next((j for j, (x, y) in enumerate(zip(zip(*a),
                                                           zip(*b)))
                          if x != y), None)
                raise AssertionError(f"{label}: request {i} differs from the "
                                     f"first serve's (tokens equal: "
                                     f"{a[0] == b[0]}; first difference at "
                                     f"{j})")
        if k > 1 and summary["horizon_max"] < 2:
            raise AssertionError(f"{label}: the horizon never passed 1")
        prof = phase_profile(torch, z, card, label, new_tokens=80)
        summary.update(turn=turn, ready_s=ready, profile=prof)
        idle = "not measured" if prof is None else f"{prof['idle']:.3f}"
        log(label, f"{summary['tok_per_s']:.1f} tok/s, step median "
            f"{summary['step_median_ms']:.1f} ms over {summary['steps']} "
            f"steps, {summary['graph_replays']} graph replays, launches "
            f"{summary['launches']}, device idle {idle} of a profiled "
            f"window, engine ready in {ready:.1f} s; streams and logprobs "
            f"== the first serve's ({card})")
        out.append(summary)
        del z
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _group(key):
    k = key.lower()
    if "ragged_paged_attention" in k:
        return "K1 ragged decode"
    if "paged_score" in k:
        return "K2 window logits"
    if "lightning_redundancy" in k:
        return "K3 redundancy"
    if "paged_attention" in k:
        return "B4 dense decode"
    if "flash_redundancy" in k:
        return "B5 flash redundancy"
    if "compaction" in k:
        return "B6 compaction"
    if "gemm" in k or "gemv" in k or "xmma" in k or "nvjet" in k \
            or "cutlass" in k:
        return "matmul"
    if "reduce" in k or "softmax" in k or "sort" in k or "scan" in k:
        return "reductions/sort"
    if "index" in k or "gather" in k or "scatter" in k:
        return "gather/scatter"
    if "copy" in k or "memcpy" in k or "memset" in k:
        return "copies"
    if "elementwise" in k:
        return "elementwise"
    return "other"


# ----------------------------------------------------------------------
# phase 11: the async surface and the HTTP tier at full width


#: phase 11's eos ids of its recapture request: three ids its greedy twin
#: never emits widen the eos pad from 1 to 4
RECAPTURE_EOS = 3
#: phase 11's SSE events a client reads before it hangs up
HANGUP_AFTER = 3
#: phase 11's drain: requests in flight when intake closes, and their
#: new tokens
DRAIN_REQUESTS, DRAIN_TOKENS = 2, 64


def free_port():
    """A free loopback port: bind port 0 and read the one given."""
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def port_cmd(module, *args):
    """The command line that runs one of the port's modules with this
    interpreter; the entry points serve on the card by default."""
    return [sys.executable, "-m", module, *args]


def _port_env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + [p for p in [env.get("PYTHONPATH")] if p])
    return env


def _same_output(label, got, want):
    """``got`` (tokens, finish reason, usage) equals ``want``'s."""
    if got.token_ids != want.token_ids:
        j = next((j for j, (a, b) in enumerate(zip(got.token_ids,
                                                   want.token_ids))
                  if a != b), min(len(got.token_ids), len(want.token_ids)))
        raise AssertionError(f"{label}: tokens differ from generate()'s at "
                             f"position {j}")
    assert got.finish_reason == want.finish_reason, label
    assert dataclasses.astuple(got.usage) == dataclasses.astuple(
        want.usage), label


async def async_burst(z, prompts, sps, refs):
    """Gate 1: every request through ``generate_async`` at once. All ops
    are queued before the loop's first step, so admission order is
    ``generate()``'s; tokens, finish reasons and usage equal ``refs``."""
    hook = StepGaps(z.engine)
    outs = await asyncio.gather(*[z.generate_async(p, s)
                                  for p, s in zip(prompts, sps)])
    split = hook.close()
    for i, (o, r) in enumerate(zip(outs, refs)):
        _same_output(f"async burst request {i}", o, r)
    split["tokens"] = sum(len(o.token_ids) for o in outs)
    return split


async def stream_with_recapture(z, prompts, refs, n_streams, new_tokens):
    """Gates 2 and 3: ``n_streams`` requests stream through ``stream()``
    with logprobs; once each has its first chunk, request ``n_streams``
    goes through ``generate_async`` with eos ids its greedy twin never
    emits, which widens the eos pad from 1 to 4 inside a step on the
    loop's worker thread and captures every decode graph anew there.
    Chunk indices are contiguous, each stream's chunks concatenate to its
    final output, whose tokens equal ``refs``, and the last chunk carries
    the finish reason and usage. Returns the threads that captured."""
    import threading

    from repro_torch.api import SamplingParams

    eng = z.engine
    assert eng._eos_width == 1, f"eos pad already {eng._eos_width} wide"
    graphs = eng._graphs
    captured = []
    capture = graphs.capture

    def recorded(k, greedy, width):
        captured.append((threading.current_thread().name, k, greedy, width))
        return capture(k, greedy, width)

    graphs.capture = recorded
    firsts = [asyncio.Event() for _ in range(n_streams)]

    async def collect(i):
        toks, lps, last = [], [], None
        async for chunk in z.stream(prompts[i], SamplingParams(
                max_new_tokens=new_tokens, logprobs=True)):
            assert chunk.index == len(toks), \
                f"stream {i}: chunk index {chunk.index} after {len(toks)}"
            toks.extend(chunk.token_ids)
            lps.extend(chunk.logprobs)
            last = chunk
            firsts[i].set()
        return toks, lps, last

    try:
        tasks = [asyncio.create_task(collect(i)) for i in range(n_streams)]
        for f in firsts:
            await f.wait()
        twin = refs[n_streams]
        eos = tuple(t for t in range(z.cfg.vocab_size)
                    if t not in twin.token_ids)[:RECAPTURE_EOS]
        widened = await z.generate_async(prompts[n_streams], SamplingParams(
            max_new_tokens=new_tokens, eos_ids=eos))
        streams = await asyncio.gather(*tasks)
    finally:
        graphs.capture = capture
    for i, (toks, lps, last) in enumerate(streams):
        final = z.output(last.request_id)
        assert toks == final.token_ids == refs[i].token_ids, \
            f"stream {i} differs from generate()'s"
        assert lps == final.logprobs and len(lps) == new_tokens
        assert all(math.isfinite(x) for x in lps)
        assert last.finish_reason == "length"
        assert dataclasses.astuple(last.usage) == dataclasses.astuple(
            refs[i].usage)
    _same_output("recapture request", widened, twin)
    assert eng._eos_width == 4
    keys = sorted(graphs.graphs)
    assert keys and all(w == 4 for _k, _g, w in keys), keys
    assert captured and all(name.startswith("zipage-step")
                            for name, *_ in captured), captured
    return captured, keys


async def _http(port, body=None, *, path="/v1/completions",
                hangup_after=None):
    """POST ``body`` to ``path`` (GET without one) over a socket. Returns
    the status, the decoded SSE payloads (or the JSON body) and, for a
    stream, the arrival time of each event, and the time the request
    started; ``hangup_after`` events closes the socket there."""
    t0 = time.monotonic()
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    try:
        return await _exchange(reader, writer, path, body, hangup_after, t0)
    finally:
        writer.close()


async def _exchange(reader, writer, path, body, hangup_after, t0):
    data = b"" if body is None else json.dumps(body).encode()
    method = b"GET " if body is None else b"POST "
    writer.write(method + path.encode() + b" HTTP/1.1\r\nhost: 127.0.0.1"
                 b"\r\ncontent-type: application/json\r\ncontent-length: "
                 + str(len(data)).encode() + b"\r\nconnection: close\r\n"
                 b"\r\n" + data)
    await writer.drain()
    head = (await reader.readuntil(b"\r\n\r\n")).decode("latin-1")
    status = int(head.split(" ", 2)[1])
    headers = {k.strip().lower(): v.strip() for k, _, v in
               (line.partition(":") for line in head.split("\r\n")[1:])
               if k}
    if "content-length" in headers:
        payload = json.loads(await reader.readexactly(
            int(headers["content-length"])))
        return status, payload, [], t0
    events, times, buf = [], [], b""
    while True:                          # chunked transfer
        size = int((await reader.readuntil(b"\r\n")).strip(), 16)
        if size == 0:
            break
        buf += await reader.readexactly(size)
        await reader.readexactly(2)
        while b"\n\n" in buf:
            frame, buf = buf.split(b"\n\n", 1)
            assert frame.startswith(b"data: "), frame
            events.append("[DONE]" if frame == b"data: [DONE]"
                          else json.loads(frame[6:]))
            times.append(time.monotonic())
        if hangup_after is not None and len(events) >= hangup_after:
            break
    return status, events, times, t0


def _sse_tokens(events):
    return [t for e in events if e != "[DONE]" and e["choices"]
            for t in e["choices"][0]["token_ids"]]


class StepGaps:
    """A step hook that splits a serve's wall time: the steps themselves
    (each one's ``t_total``), the host time between one step's end and the
    next one's start (the loop's gap between steps), the time before the
    first step starts and the time after the last one ends. Called on the
    worker thread under the async loop, on the caller's under
    ``generate()``."""

    def __init__(self, eng):
        self.eng = eng
        self.ends, self.totals = [], []
        self.t0 = time.monotonic()
        eng.step_hooks.append(self)

    def __call__(self, entry):
        self.ends.append(time.monotonic())
        self.totals.append(entry["t_total"])

    def close(self):
        t1 = time.monotonic()
        self.eng.step_hooks.remove(self)
        gaps = [e1 - t1_ - e0 for e0, e1, t1_ in zip(
            self.ends, self.ends[1:], self.totals[1:])]
        return {"wall_s": t1 - self.t0, "steps": len(self.totals),
                "step_s": sum(self.totals),
                "step_median_ms": 1e3 * statistics.median(self.totals),
                "first5_s": sum(self.totals[:5]),
                "step_max_ms": 1e3 * max(self.totals),
                "gap_s": sum(gaps), "gap": _quantiles(gaps),
                "head_s": self.ends[0] - self.totals[0] - self.t0,
                "tail_s": t1 - self.ends[-1]}


def _wall_split(label, b):
    """One line of a serve's wall time, split as ``StepGaps`` splits it."""
    return (f"{label}: {b['wall_s']:.2f} s = {b['steps']} steps "
            f"{b['step_s']:.2f} s (median {b['step_median_ms']:.1f} ms, max "
            f"{b['step_max_ms']:.1f}, the first 5 {b['first5_s']:.3f} s) + "
            f"gaps {b['gap_s']:.3f} s (median {b['gap']['median_ms']:.3f} "
            f"ms, p99 {b['gap']['p99_ms']:.3f}) + before the first step "
            f"{b['head_s']:.3f} s + after the last {b['tail_s']:.3f} s")


def _quantiles(xs):
    xs = sorted(xs)
    return {"median_ms": 1e3 * statistics.median(xs),
            "p99_ms": 1e3 * xs[min(len(xs) - 1, int(0.99 * len(xs)))],
            "n": len(xs)}


async def http_serve(torch, z, prompts, refs, new_tokens, prof_steps=8):
    """Gates 4 and 5 over a real socket: the port's app on its stdlib HTTP
    server at a free loopback port. Every prompt streams at once (SSE with
    usage); each stream ends in [DONE], its tokens equal ``refs`` and its
    usage is right; tok/s, time to first token, inter-chunk latency and
    the split of the wall time are read there. Then every prompt streams
    again, and once no prompt is left to prefill ``prof_steps`` decode
    steps are profiled on the loop's worker thread, between steps; then
    every client hangs up, and every request is aborted. Then a unary
    completion equals its SSE twin; a client that hangs up after
    HANGUP_AFTER events has its request aborted and its blocks reclaimed;
    and a drain with DRAIN_REQUESTS requests in flight finishes them,
    answers a new one 503 and leaves the pool full and the sanitizer
    clean."""
    from repro_torch.core import invariants
    from repro_torch.serve import ServeConfig, create_app
    from repro_torch.serve.http import run_server

    eng = z.engine
    n_blocks = eng.opts.n_total_blocks
    app = create_app(ServeConfig(model=z.cfg.name,
                                 max_tokens_limit=new_tokens,
                                 device=str(eng.device)), zipage=z)
    port = free_port()
    ready = asyncio.Event()
    server = asyncio.create_task(run_server(app, "127.0.0.1", port, ready))
    await ready.wait()
    aio = app.state.loop
    out = {"port": port}

    def body(i, n=new_tokens, stream=True):
        return {"model": z.cfg.name, "prompt": prompts[i], "max_tokens": n,
                "stream": stream, "stream_options": {"include_usage": True}}

    async def reclaimed(label):
        for _ in range(3000):
            if not z.has_unfinished():
                break
            await asyncio.sleep(0.01)
        assert not z.has_unfinished(), f"{label}: requests still run"
        assert z.num_free_blocks == n_blocks, f"{label}: blocks leaked"

    try:
        # gate 4: every prompt at once
        hook = StepGaps(eng)
        results = await asyncio.gather(*[_http(port, body(i))
                                         for i in range(len(prompts))])
        split = hook.close()
        ttft, gaps = [], []
        for i, (status, events, times, t0) in enumerate(results):
            assert status == 200, f"HTTP stream {i}: status {status}"
            assert events[-1] == "[DONE]", f"HTTP stream {i} has no [DONE]"
            assert _sse_tokens(events) == refs[i].token_ids, \
                f"HTTP stream {i} differs from generate()'s"
            assert events[-2]["usage"] == {
                "prompt_tokens": len(prompts[i]),
                "completion_tokens": new_tokens,
                "total_tokens": len(prompts[i]) + new_tokens}
            data = [(e, tt) for e, tt in zip(events, times)
                    if e != "[DONE]" and e["choices"]]
            assert data[-1][0]["choices"][0]["finish_reason"] == "length"
            arrived = [tt for e, tt in data if e["choices"][0]["token_ids"]]
            ttft.append(arrived[0] - t0)
            gaps += [b - a for a, b in zip(arrived, arrived[1:])]
        n_tok = sum(len(_sse_tokens(r[1])) for r in results)
        out.update(tokens=n_tok, tok_per_s=n_tok / split["wall_s"],
                   ttft=_quantiles(ttft), inter_chunk=_quantiles(gaps),
                   split=split)

        # every prompt again, a profiled window of decode steps, hang-ups;
        # the profiler's first start in a process registers it with CUPTI
        # on that thread, and Kineto wants its later starts there too
        # ("External init callback must run in same thread as
        # registerClient"): start it once here first
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            pass
        clients = [asyncio.create_task(_http(port, body(i)))
                   for i in range(len(prompts))]
        await decoding_only(eng, len(prompts))
        win = await profile_window(torch, aio, eng, prof_steps)
        for c in clients:
            c.cancel()
        await asyncio.gather(*clients, return_exceptions=True)
        out["profile"] = win.result()
        await reclaimed("hang-up of every client")
        last = [eng.finished[r] for r in sorted(eng.finished)[-len(prompts):]]
        # where steps are short (a few layers), the event loop lags the
        # engine, and a request may finish before its client hangs up
        assert all(r.finish_reason == "abort" or (
            r.finish_reason == "length" and len(r.output) == new_tokens)
            for r in last), [(r.finish_reason, len(r.output)) for r in last]
        out["hangups_aborted"] = sum(r.finish_reason == "abort"
                                     for r in last)

        # a unary completion equals its SSE twin
        status, unary, _, t0 = await _http(port, body(0, stream=False))
        assert status == 200
        choice = unary["choices"][0]
        assert choice["token_ids"] == _sse_tokens(results[0][1])
        assert choice["finish_reason"] == "length"
        assert unary["usage"] == results[0][1][-2]["usage"]
        out["unary_s"] = time.monotonic() - t0

        # a client hangs up mid-stream: abort, blocks back to the pool
        status, events, _, _ = await _http(port, body(1),
                                           hangup_after=HANGUP_AFTER)
        assert status == 200 and len(events) >= HANGUP_AFTER
        rid = int(events[0]["id"].split("-")[1])
        await reclaimed("hang-up")
        r = eng.finished[rid]
        assert r.finish_reason == "abort", r.finish_reason
        assert len(r.output) < new_tokens
        out["hangup_tokens"] = len(r.output)

        # gate 5: drain with requests in flight
        inflight = [asyncio.create_task(_http(port, body(i, DRAIN_TOKENS)))
                    for i in range(DRAIN_REQUESTS)]
        for _ in range(3000):
            if len(eng.running) == DRAIN_REQUESTS:
                break
            await asyncio.sleep(0.005)
        assert len(eng.running) == DRAIN_REQUESTS, "no requests in flight"
        drainer = asyncio.create_task(app.state.drain())
        await asyncio.sleep(0)
        status, refused, _, _ = await _http(port, body(2, stream=False))
        assert status == 503 and refused["error"]["code"] == "draining"
        for i, (status, events, _, _) in enumerate(
                await asyncio.gather(*inflight)):
            assert status == 200 and events[-1] == "[DONE]"
            assert _sse_tokens(events) == refs[i].token_ids[:DRAIN_TOKENS], \
                f"drained stream {i} differs from generate()'s"
        await drainer
    finally:
        server.cancel()
        try:
            await server
        except asyncio.CancelledError:
            pass
    assert not aio.started
    assert z.num_free_blocks == n_blocks, "blocks leaked after the drain"
    eng._qwin_shadow.clear()          # a between-steps check: reset
    invariants.check_engine(eng)
    return out


def _decodes_all(eng, m0, n):
    """Whether a step since metrics entry ``m0`` ran ``n`` requests and
    prefilled none: from there on the steps decode (and compress)."""
    return any(m["n_running"] == n and m["n_prefill_tokens"] == 0
               for m in eng.metrics[m0:])


async def decoding_only(eng, n):
    """Wait until a step of the running loop decodes all ``n`` requests
    without prefill."""
    m0 = len(eng.metrics)
    for _ in range(60000):
        if _decodes_all(eng, m0, n):
            return
        await asyncio.sleep(0.002)
    raise AssertionError(f"no step decoded {n} requests without prefill")


class Window:
    """A profiled window of steps: ``start`` and ``stop`` run on the thread
    that steps the engine, between two steps, so the profiler sees the
    steps' host work as well as their kernels. ``result`` is the
    device-busy share of wall time (``phase_profile``'s reading), or None
    without device time."""

    def __init__(self, torch, eng):
        from torch.profiler import ProfilerActivity, profile
        self.torch, self.eng = torch, eng
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])

    def start(self):
        self.torch.cuda.synchronize()
        self.prof.__enter__()
        self.t, self.step = time.monotonic(), self.eng.step_count

    def stop(self):
        self.torch.cuda.synchronize()
        self.wall_ms = 1e3 * (time.monotonic() - self.t)
        self.steps = self.eng.step_count - self.step
        self.prof.__exit__(None, None, None)

    def result(self):
        busy, groups, _calls = device_busy(self.prof)
        if busy <= 0:
            return None
        return {"steps": self.steps, "wall_ms": self.wall_ms,
                "busy_ms": busy, "idle": 1 - busy / self.wall_ms,
                "groups_ms": groups}


async def profile_window(torch, aio, eng, n_steps):
    """Profile ``n_steps`` steps of a running async loop, the window
    opened and closed on the loop's worker thread. Returns the closed
    ``Window``: reading it takes seconds, while the loop steps on."""
    loop = asyncio.get_running_loop()
    win = Window(torch, eng)
    await loop.run_in_executor(aio._executor, win.start)
    while eng.step_count < win.step + n_steps and eng.running:
        await asyncio.sleep(0.002)
    await loop.run_in_executor(aio._executor, win.stop)
    return win


def threaded_generate(z, prompts, sps, refs):
    """generate() on one worker thread while this thread only waits: the
    async loop's threading without its event loop, to tell a cost of the
    thread from one of the loop. Outputs equal ``refs``."""
    import concurrent.futures

    hook = StepGaps(z.engine)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        outs = pool.submit(z.generate, prompts, sps).result()
    split = hook.close()
    for i, (o, r) in enumerate(zip(outs, refs)):
        _same_output(f"threaded generate() request {i}", o, r)
    split["tokens"] = sum(len(o.token_ids) for o in outs)
    return split


def generate_window(torch, z, prompts, sps, n_steps=8):
    """The synchronous facade's counterpart of the HTTP tier's profiled
    window: the same requests submitted at once and stepped on this thread
    until a step decodes them all without prefill, then ``n_steps`` steps
    profiled; then every request is aborted."""
    eng = z.engine
    rids = [z.add_request(p, s) for p, s in zip(prompts, sps)]
    m0 = len(eng.metrics)
    for _ in range(200):
        z.step()
        if _decodes_all(eng, m0, len(prompts)):
            break
    assert _decodes_all(eng, m0, len(prompts))
    win = Window(torch, eng)
    win.start()
    for _ in range(n_steps):
        z.step()
    win.stop()
    for rid in rids:
        z.abort(rid)
    assert z.num_free_blocks == eng.opts.n_total_blocks
    return win.result()


def cli_serve(label, device="cuda"):
    """Gate 6: ``python -m repro_torch.serve --model tiny-lm`` on the card
    (reduced, as its default) at a free port answers a unary and an SSE
    request, equal in tokens, and on SIGTERM prints "draining..." then
    "drained, bye" and exits 0; meanwhile the launcher serves the paper's
    mix at Qwen3-8B's reduced widths with compression and, under
    ``--full-kv``, without."""
    import signal

    env = _port_env()
    launchers = {kv: subprocess.Popen(
        port_cmd("repro_torch.launch.serve", "--arch", "qwen3-8b",
                 "--workload", "mix", "--n-requests", "8",
                 *(["--full-kv"] if kv else [])),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=ROOT) for kv in (False, True)}
    port = free_port()
    t = time.monotonic()
    proc = subprocess.Popen(
        port_cmd("repro_torch.serve", "--model", "tiny-lm", "--port",
                 str(port)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=ROOT)
    out = {}
    try:
        while True:
            try:
                status, health, _, _ = asyncio.run(_http(port,
                                                         path="/health"))
                break
            except OSError:
                if proc.poll() is not None:
                    raise AssertionError(f"{label}: the server exited: "
                                         f"{proc.stdout.read()}")
                if time.monotonic() - t > 180:
                    raise AssertionError(f"{label}: no server after 180 s")
                time.sleep(0.2)
        assert status == 200 and not health["draining"]
        out["ready_s"] = time.monotonic() - t
        status, data, _, _ = asyncio.run(_http(port, {
            "prompt": "1 2 3 4 5", "max_tokens": 16}))
        assert status == 200, data
        unary = data["choices"][0]["token_ids"]
        status, events, _, _ = asyncio.run(_http(port, {
            "prompt": [1, 2, 3, 4, 5], "max_tokens": 16, "stream": True}))
        assert status == 200 and events[-1] == "[DONE]"
        streamed = _sse_tokens(events)
        assert streamed == unary and len(unary) == 16, (streamed, unary)
        proc.send_signal(signal.SIGTERM)
        text, _ = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    for line in text.splitlines():
        log(label, f"server: {line}")
    assert proc.returncode == 0, f"{label}: server exit {proc.returncode}"
    assert f"device={device}" in text, f"the CLI did not serve on {device}"
    assert "draining..." in text and "drained, bye" in text
    assert text.index("draining...") < text.index("drained, bye")
    out["server_tokens"] = unary
    for kv, p in launchers.items():
        stdout, stderr = p.communicate(timeout=300)
        assert p.returncode == 0, f"{label}: launcher failed:\n{stderr}"
        res = json.loads(stdout[stdout.index("{"):])
        tag = "full_kv" if kv else "compressed"
        log(label, f"launcher --arch qwen3-8b --workload mix "
            f"--n-requests 8{' --full-kv' if kv else ''}: {res}")
        assert res["device"].startswith(device)
        assert (res["compressions"] == 0) if kv else \
            (res["compressions"] > 0), res
        out[f"launcher_{tag}"] = res
    return out


def phase_http(torch, card, z, main_outs, prof7):
    """Phase 11: the async surface and the OpenAI-compatible server on the
    main serve's engine (Qwen3-8B at full width, engine defaults), its
    phase 5 prompts and outputs as the reference. Launch counts are set to
    0 before and read after, with every plain version refused
    (``PlainGuard``): generate() again (timed; then a profiled window of
    the same requests), then gates 1-5 in one event loop, then the CLI and
    the launcher in subprocesses."""
    from repro_torch.api import SamplingParams
    from repro_torch.kernels import ops

    eng = z.engine
    prompts = make_prompts(z.cfg)
    sps = [SamplingParams(max_new_tokens=NEW_TOKENS)] * N_REQUESTS
    ops.reset_launch_counts()
    with PlainGuard():
        torch.cuda.synchronize()
        hook = StepGaps(eng)
        again = z.generate(prompts, sps)
        gen = hook.close()
        for i, (o, r) in enumerate(zip(again, main_outs)):
            _same_output(f"http: generate() request {i}", o, r)
        gen["tokens"] = sum(len(o.token_ids) for o in again)
        threaded = threaded_generate(z, prompts, sps, main_outs)
        gen_prof = generate_window(torch, z, prompts, sps)

        async def gates():
            burst = await async_burst(z, prompts, sps, main_outs)
            captured, keys = await stream_with_recapture(
                z, prompts, main_outs, N_REQUESTS // 2, NEW_TOKENS)
            await z._aio.drain()
            served = await http_serve(torch, z, prompts, main_outs,
                                      NEW_TOKENS)
            return burst, captured, keys, served

        burst, captured, keys, served = asyncio.run(gates())
        launches = dict(ops.launch_counts)
    rate = {k: b["tokens"] / b["wall_s"] for k, b in
            (("generate", gen), ("threaded", threaded), ("burst", burst))}
    log("http", f"generate(): {rate['generate']:.1f} tok/s; async burst of "
        f"{N_REQUESTS}: {rate['burst']:.1f} tok/s, streams == phase 5's bit "
        "for bit")
    log("http", _wall_split("generate()", gen))
    log("http", _wall_split(f"generate() on a worker thread, "
                       f"{rate['threaded']:.1f} tok/s", threaded))
    log("http", _wall_split("async burst", burst))
    log("http", f"recapture on the worker thread: {len(captured)} captures "
        f"({sorted({c[0] for c in captured})}), graphs now {keys}; "
        "streams, logprobs and the widened request == phase 5's")
    ttft, gaps, split = served["ttft"], served["inter_chunk"], \
        served["split"]
    log("http", f"HTTP on 127.0.0.1:{served['port']}: {N_REQUESTS} SSE "
        f"streams == phase 5's, {served['tokens']} tokens = "
        f"{served['tok_per_s']:.1f} tok/s (generate() "
        f"{rate['generate']:.1f}); TTFT median {ttft['median_ms']:.1f} ms "
        f"p99 {ttft['p99_ms']:.1f} ms; inter-chunk median "
        f"{gaps['median_ms']:.2f} ms p99 {gaps['p99_ms']:.2f} ms over "
        f"{gaps['n']} gaps; on {card}")
    log("http", _wall_split("HTTP", split))
    idle = {k: "not measured" if p is None else f"{p['idle']:.3f}"
            for k, p in (("http", served["profile"]), ("generate", gen_prof),
                         ("phase 7", prof7))}
    log("http", f"device idle {idle['http']} of a profiled window of decode "
        f"steps while the server streams; generate() on the same engine "
        f"and requests {idle['generate']}; phase 7's window "
        f"{idle['phase 7']}")
    for label, p in (("http", served["profile"]), ("generate", gen_prof)):
        if p is not None:
            log("http", f"  {label}: {p['steps']} steps in "
                f"{p['wall_ms']:.1f} ms, busy {p['busy_ms']:.1f} ms: "
                + ", ".join(f"{g} {ms:.1f}" for g, ms in sorted(
                    p["groups_ms"].items(), key=lambda kv: -kv[1])))
    log("http", f"unary == its SSE twin ({served['unary_s']:.2f} s); every "
        f"client hung up after the profiled window: "
        f"{served['hangups_aborted']} of {N_REQUESTS} aborted, the rest "
        f"finished, blocks reclaimed; a client hung up after {HANGUP_AFTER} events: aborted "
        f"at {served['hangup_tokens']} tokens, blocks reclaimed; drain with "
        f"{DRAIN_REQUESTS} in flight: finished, new request 503, pool full, "
        "sanitizer clean")
    log("http", f"kernel launches in the phase {launches}")
    for name in MAIN_PATH:
        assert launches[name] > 0, f"kernel {name} never launched (http)"
    for name, n in launches.items():
        assert name in MAIN_PATH or n == 0, f"{name} launched off its path"
    cli = cli_serve("http-cli")
    log("http", f"CLI on the card: ready in {cli['ready_s']:.1f} s, unary "
        "== SSE, drained on SIGTERM, exit 0; launcher compressions "
        f"{cli['launcher_compressed']['compressions']} (--full-kv "
        f"{cli['launcher_full_kv']['compressions']})")
    return {"generate": gen, "generate_tok_per_s": rate["generate"],
            "generate_profile": gen_prof, "threaded_generate": threaded,
            "threaded_tok_per_s": rate["threaded"], "async_burst": burst,
            "async_burst_tok_per_s": rate["burst"],
            "recaptures": len(captured), "graph_keys": [list(k) for k in keys],
            "launches": launches, **served, "cli": cli}


# ----------------------------------------------------------------------
# phase 10: bfloat16 at full width


def phase_bf16(torch, dev, card, z_main, fp32_outs, errs):
    """Phase 10: Qwen3-8B at full width in bf16, on the main serve's fp32
    weights cast once to bf16 (norms fp32), in this order: (a) the main
    serve at the engine defaults under ZIPAGE_SANITIZE=1, the phase 5
    prompts, with where each stream leaves its fp32 twin (measured); (c)
    dense decode with flash redundancy, so that B4 and B5 run in a bf16
    serve; (e) the six kernels' bf16 variants timed at those serves'
    inputs and at the long inputs (before any profiled window of a serve:
    after one, torch.profiler has been seen to record only some kernels,
    or none); (b) paired serves at ``decode_steps`` 1 and 8 whose streams
    and logprobs must be equal; (d) a profiled window of the K = 1 engine
    (no audits): device idle share and matmul's share of busy time; (f)
    the memory planner at bf16 against fp32. Returns (the bf16 kernel
    rows, the phase's record). ``errs``: phase 3's bf16 max errors by
    kernel."""
    from repro_torch.api import SamplingParams, Zipage
    from repro_torch.core import memory_planner
    from repro_torch.core.compression import CompressOptions
    from repro_torch.models import lm

    bf16 = torch.bfloat16
    took, t = {}, time.monotonic()

    def lap(what):
        nonlocal t
        took[what] = time.monotonic() - t
        t = time.monotonic()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    cfg = dataclasses.replace(z_main.cfg, dtype="bfloat16")
    params = lm.cast_params(z_main.engine.params, bf16)
    n_params = lm.param_count(params)
    w_bf16 = sum(t_.numel() * t_.element_size()
                 for t_ in _leaves(params))
    w_fp32 = sum(t_.numel() * t_.element_size()
                 for t_ in _leaves(z_main.engine.params))
    if params["layers"][0]["attn"]["wq"].dtype != bf16 or \
            params["final_norm"]["scale"].dtype != torch.float32:
        raise AssertionError("bf16: the cast did not give bf16 matrices "
                             "beside fp32 norms")
    z = _sanitized(lambda: Zipage(cfg, params, dtype="bfloat16"))
    eng = z.engine
    assert eng.sanitize, "the engine did not read ZIPAGE_SANITIZE"
    pools = eng.state["pools"]
    if (pools["k"].dtype, pools["v"].dtype, eng.state["qwin"].dtype,
            pools["f"].dtype) != (bf16, bf16, bf16, torch.float32):
        raise AssertionError("bf16: the state is not bf16 K/V/qwin with "
                             "fp32 F")
    log("bf16", f"{cfg.name}: {n_params / 1e9:.2f} B params, weights "
        f"{w_bf16 / 1e9:.2f} GB in bf16 against {w_fp32 / 1e9:.2f} GB in "
        f"fp32; a KV block {eng._kv_block_bytes()} B against "
        f"{z_main.engine._kv_block_bytes()} B in fp32")
    lap("build")
    prompts = make_prompts(cfg)
    greedy = [SamplingParams(max_new_tokens=NEW_TOKENS)] * N_REQUESTS
    with Audits() as audits:
        rec, launches, summary, outs = sanitized_serve(
            torch, card, z, "bf16 serve", prompts, greedy, MAIN_PATH, audits)
    peak = torch.cuda.max_memory_allocated()
    firsts = [next((j for j, (x, y) in enumerate(zip(a.token_ids,
                                                     b.token_ids)) if x != y),
                   len(a.token_ids)) for a, b in zip(fp32_outs, outs)]
    log("bf16 serve", f"{summary['tok_per_s']:.1f} tok/s, step median "
        f"{summary['step_median_ms']:.1f} ms over {summary['steps']} steps, "
        f"{summary['compressions']} compressions, {summary['audits']} "
        f"audits with 0 violations, peak {(peak - base) / 1e9:.2f} GB "
        f"allocated above the phase's start ({peak / 1e9:.2f} GB in all, "
        f"the fp32 weights included) on {card}; each stream leaves its "
        f"fp32 twin at position {firsts} (measured, not gated)")
    summary.update(first_difference_from_fp32=firsts, peak_bytes=peak,
                   peak_bytes_above_start=peak - base)
    lap("serve")

    half = N_REQUESTS // 2
    sps = [SamplingParams(max_new_tokens=NEW_TOKENS, logprobs=True)] * half \
        + [SamplingParams(max_new_tokens=NEW_TOKENS, seed=SEED + i,
                          logprobs=True, **THINKING)
           for i in range(N_REQUESTS - half)]
    z34 = Zipage(cfg, params, dtype="bfloat16", decode_kernel="dense",
                 compress=CompressOptions(window=4, redundancy="flash"))
    rec34, launches34, summary34, _ = run_serve(
        torch, card, z34, "bf16 serve-alg34", prompts, sps, ALG34_PATH)
    del z34
    lap("serve-alg34")

    rows = phase_timing(torch, rec, rec34, launches, launches34, errs,
                        dtype=bf16)
    del rec, rec34
    torch.cuda.empty_cache()
    phase_long(torch, dev, cfg, eng.opts, rows, dtype=bf16)
    torch.cuda.empty_cache()
    lap("timing")

    ref, paired = None, []
    prof = None
    for k in (1, 8):
        label = f"bf16 paired[K={k}]"
        zk = Zipage(cfg, params, dtype="bfloat16", decode_steps=k)
        s_k, outs_k = run_serve(torch, card, zk, label, prompts, sps,
                                MAIN_PATH)[2:]
        if k == 1:         # the profiled window: an engine without audits
            prof = phase_profile(torch, zk, card, "bf16 profile")
        streams = [(o.token_ids, o.logprobs) for o in outs_k]
        ref = ref or streams
        for i, (a, b) in enumerate(zip(ref, streams)):
            if a != b:
                raise AssertionError(f"{label}: request {i} differs from "
                                     f"K = 1 at {_first_difference(a, b)}")
        if k > 1 and s_k["horizon_max"] < 2:
            raise AssertionError(f"{label}: the horizon never passed 1")
        log(label, f"{s_k['tok_per_s']:.1f} tok/s, step median "
            f"{s_k['step_median_ms']:.1f} ms, {s_k['graph_replays']} graph "
            "replays; streams and logprobs == K = 1's")
        paired.append(s_k)
        del zk
        gc.collect()
        torch.cuda.empty_cache()
    lap("paired")

    if prof is not None:
        share = prof["groups_ms"].get("matmul", 0.0) / prof["busy_ms"]
        prof["matmul_share_of_busy"] = share
        log("bf16 profile", f"matmul {share:.3f} of device-busy time, "
            f"device idle {prof['idle']:.3f} of wall")

    opts = eng.opts
    free, total = torch.cuda.mem_get_info()
    plans = {dt: memory_planner.plan_memory(
        cfg, free, opts.n_max, block_size=opts.block_size,
        window=opts.window, dtype_bytes=memory_planner.dtype_bytes_of(dt))
        for dt in ("float32", "bfloat16")}
    real = memory_planner.pool_bytes_per_kv_block(cfg, opts.block_size,
                                                  dtype_bytes=2)
    if real != eng._kv_block_bytes():
        raise AssertionError(f"bf16: the pools' block bytes "
                             f"{eng._kv_block_bytes()} are not {real}")
    if plans["float32"].m_kv_block != z_main.engine._kv_block_bytes():
        raise AssertionError("bf16: the fp32 plan's block bytes are not the "
                             "fp32 pools'")
    for dt, plan in plans.items():
        log("bf16 planner", f"{dt}: for {free / 1e9:.2f} GB free of "
            f"{total / 1e9:.2f} GB: M = {plan.M} requests, N_total = "
            f"{plan.N_total} blocks of {plan.m_kv_block} B (the JAX "
            f"package's accounting), {plan.m_q_req} B of window a request")
    log("bf16 planner", f"a bf16 block really takes {real} B in the pools: "
        f"{real - plans['bfloat16'].m_kv_block} B above the accounting "
        f"(F is fp32 where it counts 2 B); M {plans['bfloat16'].M} against "
        f"{plans['float32'].M} in fp32")
    lap("planner")
    record = {"serve": summary, "paired": paired, "serve_alg34": summary34,
              "profile": prof, "weights_bytes": {"bfloat16": w_bf16,
                                                 "float32": w_fp32},
              "plans": {dt: dataclasses.asdict(p) for dt, p in plans.items()},
              "pool_block_bytes": real, "took": took}
    del z, eng, params
    gc.collect()
    torch.cuda.empty_cache()
    log("bf16", "passed: " + ", ".join(f"{k} {v:.1f} s"
                                       for k, v in took.items()))
    return rows, record


# ----------------------------------------------------------------------
# phase 16: float16


class EntrySpy:
    """While on, records the entry point each kernel launch resolves
    (``native.launcher``, by symbol name), so a serve shows which storage
    type's entries it launched."""

    def __init__(self):
        from repro_torch.kernels import native
        self.native = native
        self.entries = {}

    def __enter__(self):
        orig = self.orig = self.native.launcher

        def spying(lib, fn, dtype):
            entry = orig(lib, fn, dtype)
            self.entries[entry.__name__] = \
                self.entries.get(entry.__name__, 0) + 1
            return entry

        self.native.launcher = spying
        return self

    def __exit__(self, *exc):
        self.native.launcher = self.orig


class HiddenRange:
    """While on, records the largest |x| of every input to a norm of
    ``lm`` (the residual stream entering each layer's ln1 and ln2 and the
    final norm) and the largest |logit|, per forward."""

    def __init__(self, torch):
        from repro_torch.models import lm
        self.torch, self.lm = torch, lm
        self.stream, self.logits = [], []

    def __enter__(self):
        norm = self.orig = self.lm.apply_norm

        def recording(cfg, p, x, *a, **kw):
            self.stream.append(x.detach().abs().amax().float())
            return norm(cfg, p, x, *a, **kw)

        self.lm.apply_norm = recording
        return self

    def __exit__(self, *exc):
        self.lm.apply_norm = self.orig

    def forward(self, cfg, params, tokens):
        logits = self.lm.forward(cfg, params, tokens)
        self.logits.append(logits.abs().amax().float())
        return logits

    def peaks(self):
        return (float(self.torch.stack(self.stream).max()),
                float(self.torch.stack(self.logits).max()))


def phase_fp16_kernels(torch, dev, cfg, opts):
    """16a: the six kernels' fp16 entries against their plain versions on
    the card at the shapes of phases 3 (Qwen3-8B's g = 4 and the layouts
    g = 1, 6, 8 at d = 128), 13b (MLA's 576-wide entries through K2's
    d-tiled kernel, its 512-wide latents through K3 and B5, B6 with no V
    at d = 576), 14a (g = 10, d = 256: the G = 16 decode row) and 15a
    (g = 1, d = 64): fp32 outputs within FP16_TOL, fp16 outputs within one
    fp16 ulp, B6 and dense vs ragged bit for bit. Returns the largest
    error of each kernel."""
    from repro_torch.configs import get_config

    fp16 = torch.float16
    worst = {}

    def merge(errs):
        for k, v in errs.items():
            worst[k] = max(worst.get(k, 0.0), v)

    for name in ("qwen3-8b",) + LAYOUT_CONFIGS + (WHISPER,):
        lcfg = cfg if name == "qwen3-8b" else dataclasses.replace(
            get_config(name), dtype="float32")
        merge(phase_kernels(
            torch, dev, lcfg, opts, phase=f"fp16 kernels[{name}: g = "
            f"{lcfg.num_heads // lcfg.num_kv_heads}, h_kv = "
            f"{lcfg.num_kv_heads}, d = {lcfg.head_dim}]", dtype=fp16))
        torch.cuda.empty_cache()
    merge(check_mla_kernels(torch, dev, get_config(MLA_CONFIG), fp16))
    merge(check_rec_kernels(torch, dev, get_config(RG_CONFIG), fp16))
    torch.cuda.empty_cache()
    return worst


def phase_fp16_card_vs_cpu(torch, dev, cfg):
    """16b: 2 layers of ``cfg``'s widths with weights drawn at fp16 (norms
    fp32), the vocabulary capped at CPU_VOCAB, on the card and on the
    CPU (its fp16 products through ``cpu_fp16_gemm``): the logits of a
    paged prefill and six decode steps within a relative L2 of
    FP16_REL_L2; on the card a graph-replayed chunk == the eager chunk bit
    for bit, and the card's K = 8 streams == its K = 1 streams, tokens
    and logprobs, the CPU's measured against them. Returns the largest
    relative L2."""
    from repro_torch.models import lm

    small = dataclasses.replace(cfg, num_layers=2, dtype="float16",
                                vocab_size=min(cfg.vocab_size, CPU_VOCAB))
    log("fp16 card-vs-cpu", f"vocabulary capped at {small.vocab_size} of "
        f"{cfg.vocab_size} for the CPU side")
    p_cpu = lm.init(small, torch.Generator("cpu").manual_seed(SEED), "cpu")
    if p_cpu["layers"][0]["attn"]["wq"].dtype != torch.float16 or \
            p_cpu["final_norm"]["scale"].dtype != torch.float32:
        raise AssertionError("fp16: lm.init did not draw fp16 matrices "
                             "beside fp32 norms")
    p_dev = _tree_to(p_cpu, dev)
    worst = check_logits(torch, dev, small, p_cpu, p_dev, "fp16 card-vs-cpu",
                         f"{cfg.name} widths")
    check_graph_vs_eager(torch, dev, small, p_dev, True)
    check_streams_bf16(torch, dev, small, p_cpu, p_dev,
                       phase="fp16 card-vs-cpu")
    del p_dev, p_cpu
    gc.collect()
    torch.cuda.empty_cache()
    return worst


def phase_fp16(torch, dev, card, z_main, fp32_outs):
    """Phase 16: float16. (a) ``phase_fp16_kernels``; (b)
    ``phase_fp16_card_vs_cpu``; (c) Qwen3-8B at full width and all 36
    layers in fp16, on the main serve's fp32 weights cast once (norms fp32;
    phase 10's bf16 copy is freed by then): the main serve at the engine
    defaults under ZIPAGE_SANITIZE=1 (4 greedy and 4 seeded requests with
    logprobs; where each greedy stream leaves its fp32 twin is logged),
    dense decode with flash redundancy (B4 and B5 in an fp16 serve), then
    ``decode_steps=8`` on the same requests, whose streams and logprobs
    must equal the K = 1 serve's; every launch of the three serves
    resolves a ``_f16`` entry and all six kernels launch; the six kernels
    timed at the serves' inputs and the long inputs (rows ``<kernel>_f16``);
    the largest |hidden state| and |logit| of an eager forward over every
    served sequence, against fp16's largest finite value. Returns (the
    fp16 kernel rows, the phase's record)."""
    from repro_torch.api import SamplingParams, Zipage
    from repro_torch.core.compression import CompressOptions
    from repro_torch.core.engine import EngineOptions
    from repro_torch.models import lm

    fp16 = torch.float16
    took, t = {}, time.monotonic()

    def lap(what):
        nonlocal t
        took[what] = time.monotonic() - t
        t = time.monotonic()

    cfg32 = dataclasses.replace(z_main.cfg, dtype="float32")
    errs = phase_fp16_kernels(torch, dev, cfg32, EngineOptions())
    lap("16a")
    card_cpu = phase_fp16_card_vs_cpu(torch, dev, cfg32)
    lap("16b")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cfg = dataclasses.replace(z_main.cfg, dtype="float16")
    params = lm.cast_params(z_main.engine.params, fp16)
    if params["layers"][0]["attn"]["wq"].dtype != fp16 or \
            params["final_norm"]["scale"].dtype != torch.float32 or \
            params["layers"][0]["ln1"]["scale"].dtype != torch.float32:
        raise AssertionError("fp16: the cast did not give fp16 matrices "
                             "beside fp32 norms")
    prompts = make_prompts(cfg)
    half = N_REQUESTS // 2
    sps = [SamplingParams(max_new_tokens=NEW_TOKENS, logprobs=True)] * half \
        + [SamplingParams(max_new_tokens=NEW_TOKENS, seed=SEED + i,
                          logprobs=True, **THINKING)
           for i in range(N_REQUESTS - half)]
    with EntrySpy() as spy:
        z = _sanitized(lambda: Zipage(cfg, params, dtype="float16"))
        eng = z.engine
        assert eng.sanitize, "the engine did not read ZIPAGE_SANITIZE"
        pools = eng.state["pools"]
        if (pools["k"].dtype, pools["v"].dtype, eng.state["qwin"].dtype,
                pools["f"].dtype) != (fp16, fp16, fp16, torch.float32):
            raise AssertionError("fp16: the state is not fp16 K/V/qwin with "
                                 "fp32 F")
        with Audits() as audits:
            rec, launches, summary, outs = sanitized_serve(
                torch, card, z, "fp16 serve", prompts, sps, MAIN_PATH,
                audits)
        lap("16c serve")
        z34 = Zipage(cfg, params, dtype="float16", decode_kernel="dense",
                     compress=CompressOptions(window=4, redundancy="flash"))
        rec34, launches34, summary34, _ = run_serve(
            torch, card, z34, "fp16 serve-alg34", prompts, sps, ALG34_PATH)
        del z34
        lap("16c serve-alg34")
        z8 = Zipage(cfg, params, dtype="float16", decode_steps=8)
        summary8, outs8 = run_serve(torch, card, z8, "fp16 serve[K=8]",
                                    prompts, sps, MAIN_PATH)[2:]
        del z8
        lap("16c K=8")
    peak = torch.cuda.max_memory_allocated()
    ref = [(o.token_ids, o.logprobs) for o in outs]
    for i, (a, b) in enumerate(zip(ref, [(o.token_ids, o.logprobs)
                                         for o in outs8])):
        if a != b:
            raise AssertionError(f"fp16 serve[K=8]: request {i} differs "
                                 f"from K = 1 at {_first_difference(a, b)}")
    if summary8["horizon_max"] < 2:
        raise AssertionError("fp16 serve[K=8]: the horizon never passed 1")
    entries = dict(spy.entries)
    f16 = {n + "_launch_f16" for n in REPLACES}
    if set(entries) != f16:
        raise AssertionError(f"fp16: the serves resolved the entries "
                             f"{sorted(entries)}, not the six _f16 ones")
    for name in REPLACES:
        if launches[name] + launches34[name] <= 0:
            raise AssertionError(f"fp16: {name}_launch_f16 never launched")
    firsts = [next((j for j, (x, y) in enumerate(zip(a.token_ids,
                                                     b.token_ids)) if x != y),
                   len(a.token_ids))
              for a, b in zip(fp32_outs[:half], outs[:half])]
    log("fp16 serve", f"{cfg.name} at full width, {cfg.num_layers} layers: "
        f"{summary['tok_per_s']:.1f} tok/s (K = 1, sanitized), "
        f"{summary8['tok_per_s']:.1f} tok/s (K = 8), streams and logprobs "
        f"of K = 8 == K = 1 ok; entries resolved {entries}; launches "
        f"main {launches}, alg34 {launches34}; peak {peak / 1e9:.2f} GB "
        f"allocated on {card}; each greedy stream leaves its fp32 twin at "
        f"position {firsts} (measured, not gated)")
    summary.update(first_difference_from_fp32=firsts, peak_bytes=peak)

    with HiddenRange(torch) as hr:
        with torch.no_grad():
            for p_, o in zip(prompts, outs):
                seq = torch.tensor([p_ + o.token_ids], device=dev)
                if not bool(torch.isfinite(hr.forward(cfg, params,
                                                      seq)).all()):
                    raise AssertionError("fp16: a forward over a served "
                                         "sequence gave a non-finite logit")
    h_max, logit_max = hr.peaks()
    log("fp16 range", f"largest |hidden state| {h_max:.1f} and |logit| "
        f"{logit_max:.2f} over the {len(prompts)} served sequences (eager "
        f"forward, {cfg.num_layers} layers), against fp16's largest finite "
        f"{FP16_MAX:.0f}: headroom {FP16_MAX / h_max:.1f}x; nothing is "
        "clamped or rescaled")
    lap("16c range")

    rows = phase_timing(torch, rec, rec34, launches, launches34, errs,
                        dtype=fp16)
    del rec, rec34
    torch.cuda.empty_cache()
    phase_long(torch, dev, cfg, eng.opts, rows, dtype=fp16)
    lap("16c timing")
    record = {"kernel_errs": errs, "card_vs_cpu_rel_l2": card_cpu,
              "serve": summary, "serve_alg34": summary34, "serve_k8": summary8,
              "entries": entries, "hidden_max": h_max,
              "logit_max": logit_max, "took": took}
    del z, eng, params
    gc.collect()
    torch.cuda.empty_cache()
    log("fp16", "passed: " + ", ".join(f"{k} {v:.1f} s"
                                       for k, v in took.items()))
    return rows, record


def _leaves(t):
    if isinstance(t, dict):
        return [x for v in t.values() for x in _leaves(v)]
    if isinstance(t, list):
        return [x for v in t for x in _leaves(v)]
    return [t]


# ----------------------------------------------------------------------
# phase 9: memory pressure and shared prefixes at full width


def _timed(torch, fn, out):
    """A swap executor that appends (blocks, ms) for each call: CUDA events
    around the callback, after a synchronize, so the span holds the
    call's own gather, copies and scatter."""
    def timed(r, src, dst):
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        res = fn(r, src, dst)
        end.record()
        end.synchronize()
        out.append((len(src), start.elapsed_time(end)))
        return res
    return timed


def _swap_rate(times, block_bytes):
    """Mean ms a copy and effective GB/s over ``times``."""
    if not times:
        return None, None
    ms = sum(t for _, t in times)
    gb = sum(n for n, _ in times) * block_bytes / 1e9
    return ms / len(times), gb / (ms / 1e3)


def pressure_serve(torch, card, cfg, params, label, prompts, sps, audits,
                   **knobs):
    """One pressure serve of phase 9 in a fresh engine built under
    ZIPAGE_SANITIZE=1 on ``params``: ``run_serve`` with the audits
    counted, the swap copies timed, and the pools drained clean after.
    Returns its summary and its (tokens, logprobs) streams."""
    from repro_torch.api import Zipage
    z = _sanitized(lambda: Zipage(cfg, params, m_qslots=PRESSURE_QSLOTS,
                                  **knobs))
    eng = z.engine
    times = {"out": [], "in": []}
    if eng.swap_pool is not None:
        sched = eng.scheduler
        sched.swap_executor = _timed(torch, sched.swap_executor, times["out"])
        sched.swap_in_executor = _timed(torch, sched.swap_in_executor,
                                        times["in"])
    summary, outs = sanitized_serve(
        torch, card, z, label, prompts, sps, MAIN_PATH, audits)[2:]
    _drained(z, label)
    m = eng.metrics
    block = eng._kv_block_bytes()
    reqs = [eng.finished[o.request_id] for o in outs]
    out_ms, out_rate = _swap_rate(times["out"], block)
    in_ms, in_rate = _swap_rate(times["in"], block)
    summary.update(
        pool=eng.opts.n_total_blocks, mode=eng.opts.preemption_mode,
        swap_space_blocks=eng.opts.swap_space_blocks,
        preemptions=sum(x["n_preempted"] for x in m),
        swapped_out=sum(x["n_swapped_out"] for x in m),
        swapped_in=sum(x["n_swapped_in"] for x in m),
        swap_gb=m[-1]["swap_bytes"] / 1e9,
        prefill_tokens=sum(x["n_prefill_tokens"] for x in m),
        recomputed=[i for i, r in enumerate(reqs)
                    if r.preempt_count > r.n_swaps],
        swap_out_ms=out_ms, swap_in_ms=in_ms, swap_out_gb_per_s=out_rate,
        swap_in_gb_per_s=in_rate, block_bytes=block)
    if summary["swapped_out"] != summary["swapped_in"]:
        raise AssertionError(f"{label}: {summary['swapped_out']} swap-outs, "
                             f"{summary['swapped_in']} swap-ins")
    rate = "" if out_ms is None else (
        f"; {out_ms:.3f} ms a swap-out ({out_rate:.1f} GB/s), {in_ms:.3f} ms "
        f"a swap-in ({in_rate:.1f} GB/s) against the host link's nominal "
        f"{HOST_LINK_BYTES_PER_S / 1e9:.0f} GB/s a direction")
    log(label, f"pool {summary['pool']}: {summary['preemptions']} "
        f"preemptions, {summary['swapped_out']} swap-outs, "
        f"{summary['swapped_in']} swap-ins, {summary['swap_gb']:.3f} GB "
        f"moved, {summary['prefill_tokens']} prefill tokens, recomputed "
        f"requests {summary['recomputed']}{rate}; pools drained clean")
    streams = [(o.token_ids, o.logprobs) for o in outs]
    del z, eng, reqs
    gc.collect()
    torch.cuda.empty_cache()
    return summary, streams


def _first_difference(a, b):
    """(position, tokens differ there) of the first difference of two
    (tokens, logprobs) streams."""
    for j, (x, y) in enumerate(zip(zip(*a), zip(*b))):
        if x != y:
            return j, x[0] != y[0]
    return min(len(a[0]), len(b[0])), True


def phase_memory(torch, card, z_main, rows):
    """Phase 9: pressure serves and shared-prefix serves of Qwen3-8B at
    full width and its first MEMORY_LAYERS layers (the main serve's
    weight tensors), each in a fresh engine under
    ZIPAGE_SANITIZE=1; their launches go into the kernel rows'
    ``launches_per_serve``."""
    t = time.monotonic()
    with Audits() as audits:
        out = {"pressure": phase_pressure(torch, card, z_main, audits)}
        out["pressure_s"] = time.monotonic() - t
        out["prefix"] = phase_prefix(torch, card, z_main, audits)
    out["phase_s"] = time.monotonic() - t
    by_name = {r["kernel"]: r for r in rows}
    for group in ("pressure", "prefix"):
        for label, summary in out[group]["serves"].items():
            for kname, n in summary["launches"].items():
                by_name[kname]["launches_per_serve"][label] = n
    log("memory", f"passed in {out['phase_s']:.1f} s (pressure "
        f"{out['pressure_s']:.1f} s)")
    return out


def phase_pressure(torch, card, z_main, audits):
    """PRESSURE_REQUESTS requests of ``make_prompts``' kind, half greedy
    and half at Qwen3's thinking-mode sampling, NEW_TOKENS each with
    logprobs, at the engine defaults but the pool and PRESSURE_QSLOTS
    query slots: first an ample pool (256 blocks, no preemption), then
    recompute, swap and auto on a tight pool that starts at TIGHT_POOL
    blocks and shrinks by TIGHT_STEP until each of the three preempts at
    least MIN_PREEMPTIONS times (swap and auto with SWAP_BLOCKS host
    blocks). Swap's streams must equal the ample run's bit for bit, and
    auto's too for every request it never recomputed; recompute's are
    measured against it."""
    from repro_torch.api import SamplingParams

    cfg, params = shallow(z_main, MEMORY_LAYERS)
    prompts = make_prompts(cfg, PRESSURE_REQUESTS)
    half = PRESSURE_REQUESTS // 2
    sps = [SamplingParams(max_new_tokens=NEW_TOKENS, logprobs=True)] * half \
        + [SamplingParams(max_new_tokens=NEW_TOKENS, seed=SEED + i,
                          logprobs=True, **THINKING) for i in range(half)]
    serves = {}

    def serve(label, **knobs):
        summary, streams = pressure_serve(torch, card, cfg, params, label,
                                          prompts, sps, audits, **knobs)
        serves[label] = summary
        return summary, streams

    ample_s, ample = serve("memory[ample]")
    if ample_s["preemptions"]:
        raise AssertionError("memory[ample]: the ample pool preempted")
    pool, tried = TIGHT_POOL, []
    while True:
        runs = {}
        for mode in ("recompute", "swap", "auto"):
            knobs = dict(n_total_blocks=pool, preemption_mode=mode)
            if mode != "recompute":
                knobs["swap_space_blocks"] = SWAP_BLOCKS
            runs[mode] = serve(f"memory[{mode}, pool {pool}]", **knobs)
            if runs[mode][0]["preemptions"] < MIN_PREEMPTIONS:
                break
        tried.append((pool, {m: r[0]["preemptions"] for m, r in runs.items()}))
        if len(runs) == 3 and runs["auto"][0]["preemptions"] \
                >= MIN_PREEMPTIONS:
            break
        pool -= TIGHT_STEP
        if pool < MIN_POOL:
            raise AssertionError(f"memory: no pool from {TIGHT_POOL} down to "
                                 f"{MIN_POOL} preempts {MIN_PREEMPTIONS} "
                                 f"times in each run: {tried}")
        log("memory", f"preemptions {tried[-1][1]} at pool {tried[-1][0]}: "
            f"shrinking the pool to {pool}")
    swap_s, swap = runs["swap"]
    if swap_s["swapped_out"] == 0:
        raise AssertionError("memory: the swap run never swapped")
    for i, (a, b) in enumerate(zip(ample, swap)):
        if a != b:
            raise AssertionError(f"memory: swap stream {i} differs from the "
                                 f"ample run's at {_first_difference(a, b)}")
    auto_s, auto = runs["auto"]
    kept = [i for i in range(len(prompts)) if i not in auto_s["recomputed"]]
    for i in kept:
        if auto[i] != ample[i]:
            raise AssertionError(f"memory: auto stream {i} (never "
                                 "recomputed) differs from the ample run's at "
                                 f"{_first_difference(ample[i], auto[i])}")
    rec_s, rec = runs["recompute"]
    diffs = []
    for i, (a, b) in enumerate(zip(ample, rec)):
        if a == b:
            continue
        j = next((j for j, (x, y) in enumerate(zip(a[0], b[0])) if x != y),
                 None)
        # at a flip, the ample run's logprob of its token minus the
        # recompute run's of its own: with near-equal distributions, the
        # top-2 logit margin there
        margin = None if j is None else a[1][j] - b[1][j]
        same = len(a[0]) if j is None else j
        diffs.append(dict(
            request=i, greedy=sps[i].is_greedy,
            first_logprob_difference=_first_difference(a, b)[0],
            first_token_difference=j, margin=margin,
            max_logprob_delta=max(abs(x - y) for x, y in zip(
                a[1][:same], b[1][:same])),
            recomputed=i in rec_s["recomputed"]))
    log("memory", f"pool {pool} ({tried}): swap == ample bit for bit "
        f"(tokens and logprobs of {len(prompts)} requests); auto == ample on "
        f"the {len(kept)} requests it never recomputed; recompute differs "
        f"from ample on {len(diffs)} requests: {diffs} (measured, not "
        "gated)")
    for d in diffs:
        if d["greedy"] and d["margin"] is not None and abs(d["margin"]) > 1e-3:
            log("memory", f"recompute request {d['request']}: greedy flip at "
                f"{d['first_token_difference']} with an estimated top-2 "
                f"margin {d['margin']:.3e} above 1e-3: a fault for ROADMAP "
                "§C")
    return {"pool": pool, "tried": tried, "serves": serves,
            "recompute_diffs": diffs,
            "recompute_extra_prefill_tokens": rec_s["prefill_tokens"]
            - ample_s["prefill_tokens"],
            "auto_kept": kept}


class CowCheck:
    """Holds B6 against its plain version bit for bit, on the serve's own
    input, at the first compaction launch that moves an adopter's shared
    segment payload into fresh blocks (copy-on-write): the pools are
    cloned before that launch and the plain version run on the clones."""

    def __init__(self, torch, eng):
        from repro_torch.kernels import compaction as cmp
        from repro_torch.kernels import ops
        self.torch, self.eng, self.ops = torch, eng, ops
        self.plain = cmp.compact_plain      # held before PlainGuard swaps it
        self.armed, self.checked = False, None

    def __enter__(self):
        self.launch, self.compact = self.eng._launch_compression, \
            self.ops.compact

        def launch(outs):
            self.armed = any(
                c.request.pos_gap > 0 and any(
                    blk != c.request.blocks[i] for i, blk in enumerate(c.dest))
                for c in outs.compress)
            return self.launch(outs)

        def compact(*args):
            if not self.armed or self.checked is not None:
                return self.compact(*args)
            want = [x.clone() for x in args[:3]]
            out = self.compact(*args)
            self.plain(*want, *args[3:])
            for name, a, r in zip("kvf", args[:3], want):
                if not bool(self.torch.equal(a[:, :-1], r[:, :-1])):
                    raise AssertionError(f"memory: B6 at an adopter's "
                                         f"copy-on-write launch: {name} pool "
                                         "differs from the plain version")
            self.checked = dict(rows=int(args[4].shape[0]),
                                width=int(args[4].shape[1]),
                                k=int(args[6].shape[1]))
            return out

        self.eng._launch_compression = launch
        self.ops.compact = compact
        return self

    def __exit__(self, *exc):
        self.eng._launch_compression = self.launch
        self.ops.compact = self.compact


def phase_prefix(torch, card, z_main, audits):
    """Shared-prefix serves: a PREFIX_TOKENS prompt served first
    (WARMUP_TOKENS new tokens), then N_EXTENSIONS requests that extend it
    by EXTENSION_TOKENS distinct tokens (half greedy, half seeded, with
    logprobs, NEW_TOKENS each), in three fresh engines: no prefix cache
    (cold), the default raw cache (hits must equal cold bit for bit), and
    ``cache_compressed_prefixes`` under a watermark of SEGMENT_WATERMARK
    (the raw chain is evicted, the extensions adopt the prompt's
    compressed segment; B6 held bit for bit at an adopter's copy-on-write
    launch)."""
    import numpy as np
    from repro_torch.api import SamplingParams, Zipage
    from repro_torch.core.engine import EngineOptions

    cfg, params = shallow(z_main, MEMORY_LAYERS)
    rng = np.random.default_rng(SEED + 16)
    prefix = [int(x) for x in rng.integers(0, cfg.vocab_size, PREFIX_TOKENS)]
    ext = [prefix + [int(x) for x in rng.integers(0, cfg.vocab_size,
                                                  EXTENSION_TOKENS)]
           for _ in range(N_EXTENSIONS)]
    half = N_EXTENSIONS // 2
    sps = [SamplingParams(max_new_tokens=NEW_TOKENS, logprobs=True)] * half \
        + [SamplingParams(max_new_tokens=NEW_TOKENS, seed=SEED + i,
                          logprobs=True, **THINKING) for i in range(half)]
    engines = {"cold": dict(prefix_caching=False), "raw-hit": {},
               "segment": dict(cache_compressed_prefixes=True,
                               prefix_cache_watermark=SEGMENT_WATERMARK)}
    serves, streams, cow = {}, {}, None
    for name, knobs in engines.items():
        label = f"memory[prefix {name}]"
        z = _sanitized(lambda: Zipage(cfg, params, **knobs))
        eng = z.engine
        z.generate([prefix], SamplingParams(max_new_tokens=WARMUP_TOKENS))
        chain = eng.bm._block_chain(prefix)
        raw = sum(h in eng.bm.hash_to_block for h in chain)
        segments = len(eng.bm.segments)
        held = []
        n_blocks = eng.opts.n_total_blocks
        eng.step_hooks.append(lambda m: held.append(
            (m["n_running"], round(m["block_util"] * n_blocks))))
        with CowCheck(torch, eng) as check:
            summary, outs = sanitized_serve(
                torch, card, z, label, ext, sps, MAIN_PATH, audits)[2:]
        reqs = [eng.finished[o.request_id] for o in outs]
        peak = max(n for n, _ in held)
        used = next(u for n, u in held if n == peak)
        m = eng.metrics[-1]
        summary.update(
            raw_chain_blocks_cached=raw, segments=segments,
            n_cached=[r.n_cached for r in reqs],
            pos_gap=[r.pos_gap for r in reqs],
            prefill_tokens=sum(x["n_prefill_tokens"]
                               for x in eng.metrics[-summary["steps"]:]),
            blocks_per_request=used / peak, peak_running=peak,
            prefix_hits=m["prefix_hits"],
            prefix_segment_hits=m["prefix_segment_hits"],
            cached_tokens_per_block=m["cached_tokens_per_block"])
        serves[label] = summary
        streams[name] = [(o.token_ids, o.logprobs) for o in outs]
        if name == "segment":
            cow = check.checked
        log(label, f"raw chain blocks cached after the first request {raw} "
            f"of {len(chain)}, segments {segments}; n_cached "
            f"{summary['n_cached']}, pos_gap {summary['pos_gap']}, "
            f"{summary['prefill_tokens']} prefill tokens, "
            f"{used / peak:.2f} blocks a request at {peak} running, "
            f"prefix hits {m['prefix_hits']}, segment hits "
            f"{m['prefix_segment_hits']}, cached tokens a block "
            f"{m['cached_tokens_per_block']:.2f}")
        del z, eng, reqs
        gc.collect()
        torch.cuda.empty_cache()
    cold, hit, seg = (serves[f"memory[prefix {n}]"] for n in engines)
    if streams["raw-hit"] != streams["cold"]:
        i = next(i for i, (a, b) in enumerate(zip(streams["cold"],
                                                  streams["raw-hit"]))
                 if a != b)
        raise AssertionError(
            f"memory: raw prefix hit stream {i} differs from the cold run's "
            "at "
            f"{_first_difference(streams['cold'][i], streams['raw-hit'][i])}")
    if hit["n_cached"] != [PREFIX_TOKENS] * N_EXTENSIONS:
        raise AssertionError(f"memory: raw hits cached {hit['n_cached']}")
    b = EngineOptions().block_size
    gap = PREFIX_TOKENS - (EngineOptions().n_max - 1) * b
    if seg["segments"] != 1 \
            or seg["raw_chain_blocks_cached"] >= PREFIX_TOKENS // b \
            or seg["pos_gap"] != [gap] * N_EXTENSIONS \
            or seg["prefix_segment_hits"] < N_EXTENSIONS \
            or seg["cached_tokens_per_block"] <= b:
        raise AssertionError(f"memory: segment adoption: {seg}")
    if cow is None:
        raise AssertionError("memory: no copy-on-write compaction launch of "
                             "an adopter was held against plain")
    saved = [cold["prefill_tokens"] - x["prefill_tokens"] for x in (hit, seg)]
    log("memory", f"raw hits == cold bit for bit; adopters at pos_gap {gap}; "
        f"B6 at an adopter's copy-on-write launch ({cow}) == plain bit for "
        f"bit; prefill tokens saved: raw {saved[0]}, segment {saved[1]}; "
        "tok/s "
        f"cold {cold['tok_per_s']:.1f}, raw hit {hit['tok_per_s']:.1f}, "
        f"segment {seg['tok_per_s']:.1f}")
    return {"serves": serves, "cow_launch": cow, "pos_gap": gap}


# ----------------------------------------------------------------------
# phase 8: the other dense configs at full width, under the sanitizer


def phase_dense(torch, card, rows):
    """Serve each of DENSE_CONFIGS, smallest to largest, at full width and
    depth (``dense_serve``); their launch counts go into the kernel rows'
    ``launches_per_serve``. Returns {config: summary}."""
    by_name = {r["kernel"]: r for r in rows}
    out = {}
    for name in DENSE_CONFIGS:
        t = time.monotonic()
        out[name] = dense_serve(torch, card, name)
        out[name]["phase_s"] = time.monotonic() - t
        for serve, summary in out[name]["serves"].items():
            for kname, n in summary["launches"].items():
                by_name[kname]["launches_per_serve"][serve] = n
        log(f"dense[{name}]", f"passed in {out[name]['phase_s']:.1f} s ("
            + ", ".join(f"{k} {v:.1f} s" for k, v in out[name][
                "took"].items()) + ")")
        gc.collect()
        torch.cuda.empty_cache()
    return out


class Audits:
    """While on, counts the sanitizer's audits (``invariants.check_engine``
    wrapped; a violation still raises in the step)."""

    def __init__(self):
        from repro_torch.core import invariants
        self.invariants = invariants
        self.steps = []

    def __enter__(self):
        check = self.check = self.invariants.check_engine

        def counted(engine):
            self.steps.append(engine.step_count)
            check(engine)

        self.invariants.check_engine = counted
        return self

    def __exit__(self, *exc):
        self.invariants.check_engine = self.check


def sanitized_serve(torch, card, z, label, prompts, sps, path, audits):
    """``run_serve`` under ``audits``: one audit after every step of the
    serve, and none reports a violation."""
    audits.steps.clear()
    s0 = z.engine.step_count
    out = run_serve(torch, card, z, label, prompts, sps, path)
    if audits.steps != list(range(s0 + 1, z.engine.step_count + 1)):
        raise AssertionError(f"{label}: {len(audits.steps)} audits over "
                             f"{z.engine.step_count - s0} steps")
    log(label, f"sanitizer: {len(audits.steps)} audits, one after each "
        "step, 0 violations")
    out[2]["audits"] = len(audits.steps)
    return out


def _sanitized(fn):
    """``fn()`` with ZIPAGE_SANITIZE=1, which an engine reads when it is
    built; the variable is restored afterwards."""
    old = os.environ.get("ZIPAGE_SANITIZE")
    os.environ["ZIPAGE_SANITIZE"] = "1"
    try:
        return fn()
    finally:
        if old is None:
            del os.environ["ZIPAGE_SANITIZE"]
        else:
            os.environ["ZIPAGE_SANITIZE"] = old


def dense_serve(torch, card, name):
    """``Zipage.from_config(name)`` at full width and the engine defaults,
    fp32, random weights from the seed, built under ZIPAGE_SANITIZE=1 so
    that the engine audits its whole state after every step. First a
    recorded warm-up serve on the same weights, at whose inputs K1 and K2
    are held against their plain versions; then the serve of N_REQUESTS
    greedy requests of NEW_TOKENS tokens (``run_serve``: compression fires,
    every compression goes through the compaction kernel, no plain version
    runs), with its tok/s, step median, launches, peak memory and the
    memory planner's figures. Qwen2.5-3B also serves through dense decode
    and flash redundancy (two greedy, two seeded requests), so that B4 and
    B5 run in a serve at g = 8."""
    from repro_torch.api import SamplingParams, Zipage
    from repro_torch.core import memory_planner
    from repro_torch.core.compression import CompressOptions
    from repro_torch.models import lm

    phase = f"dense[{name}]"
    took, t = {}, time.monotonic()

    def lap(what):
        nonlocal t
        took[what] = time.monotonic() - t
        t = time.monotonic()

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    z = _sanitized(lambda: Zipage.from_config(name, param_seed=SEED))
    torch.cuda.synchronize()
    eng, cfg = z.engine, z.cfg
    assert eng.sanitize, "the engine did not read ZIPAGE_SANITIZE"
    g = cfg.num_heads // cfg.num_kv_heads
    log(phase, f"{cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.num_heads}/{cfg.num_kv_heads} heads of {cfg.head_dim} (g = "
        f"{g}), d_ff {cfg.d_ff} {cfg.ffn_act}, {cfg.norm_type}, vocab "
        f"{cfg.vocab_size}, qkv_bias={cfg.qkv_bias}, tie_embeddings="
        f"{cfg.tie_embeddings}; {lm.param_count(eng.params) / 1e9:.2f} B "
        "params fp32 on the card")
    opts = eng.opts
    free, total = torch.cuda.mem_get_info()
    weights = lm.param_count(eng.params) * 4
    plan = memory_planner.plan_memory(cfg, free, opts.n_max,
                                      block_size=opts.block_size,
                                      window=opts.window)
    if plan.m_kv_block != eng._kv_block_bytes():
        raise AssertionError(f"{phase}: the planner's block bytes "
                             f"{plan.m_kv_block} are not the pools' "
                             f"{eng._kv_block_bytes()}")
    log(phase, f"memory plan (Eq. 1): {weights / 1e9:.2f} GB of weights, "
        f"{free / 1e9:.2f} of {total / 1e9:.2f} GB free: M = {plan.M} "
        f"requests, N_total = {plan.N_total} blocks of {plan.m_kv_block} B "
        f"and {plan.m_q_req} B of window a request (the engine defaults use "
        f"{opts.n_total_blocks} blocks and {opts.m_qslots} slots)")
    lap("build")

    def serve(zz, label, prompts, sps, path):
        return sanitized_serve(torch, card, zz, label, prompts, sps, path,
                               audits)[2]

    with Audits() as audits:
        errs = dense_warmup(torch, z, phase)
        lap("warm-up")
        prompts = make_prompts(cfg)
        serves = {name: serve(z, f"{phase} sanitized", prompts, [
            SamplingParams(max_new_tokens=NEW_TOKENS)] * N_REQUESTS,
            MAIN_PATH)}
        lap("serve")
        if name == "qwen2.5-3b":
            z34 = _sanitized(lambda: Zipage(
                cfg, eng.params, decode_kernel="dense",
                compress=CompressOptions(window=4, redundancy="flash")))
            sps = [SamplingParams(max_new_tokens=NEW_TOKENS)] * 2 + [
                SamplingParams(max_new_tokens=NEW_TOKENS, seed=SEED + i,
                               **THINKING) for i in range(2)]
            serves[f"{name}-alg34"] = serve(z34, f"{phase} alg34 sanitized",
                                            prompts[:4], sps, ALG34_PATH)
            del z34
            lap("serve-alg34")
    peak = torch.cuda.max_memory_allocated()
    log(phase, f"peak memory allocated {peak / 1e9:.2f} GB on {card}")
    out = {"layers": cfg.num_layers, "d_model": cfg.d_model,
           "heads": [cfg.num_heads, cfg.num_kv_heads], "g": g,
           "params": lm.param_count(eng.params), "peak_bytes": peak,
           "free_bytes_after_weights": free, "plan": dataclasses.asdict(plan),
           "recorded_errs": errs, "serves": serves, "took": took}
    del z, eng
    return out


def dense_warmup(torch, z, phase):
    """A warm-up serve of two requests through a second engine on ``z``'s
    weights, recorded; compression fires. K1 and K2 are then held against
    their plain versions at the input whose live work is largest: for K2
    a recorded call, for K1 the warm-up's state at its fullest step
    (``DecodeInputs``; its decode runs inside CUDA graphs), which holds
    the serve's idle slots (seq_len 1, or a stale one, over an empty
    table). Returns their errors."""
    import numpy as np
    from repro_torch.api import SamplingParams, Zipage
    from repro_torch.kernels import ops
    from repro_torch.kernels import paged_score as ps
    from repro_torch.kernels import ragged_paged_attention as rpa

    cfg = z.cfg
    zw = _sanitized(lambda: Zipage(cfg, z.engine.params))
    rng = np.random.default_rng(SEED + 7)
    prompts = [[int(x) for x in rng.integers(0, cfg.vocab_size, n)]
               for n in (100, 123)]
    hook = DecodeInputs(zw.engine)
    with Recorder(ops) as rec, PlainGuard():
        outs = zw.generate(prompts, SamplingParams(
            max_new_tokens=WARMUP_TOKENS))
        torch.cuda.synchronize()
    hook.close()
    n_comp = [o.metrics.compression.n_compressions for o in outs]
    if min(n_comp) == 0:
        raise AssertionError(f"{phase}: the warm-up did not compress "
                             f"({n_comp})")
    b = zw.engine.opts.block_size
    q, kp, vp, bt, sl = hook.args(torch)
    idle = int(((sl > 0) & ((bt >= 0).sum(1) * b < sl)).sum())
    e1 = max_err(torch, rpa.ragged_paged_attention_cuda(q, kp, vp, bt, sl),
                 rpa.ragged_paged_attention_plain(q, kp, vp, bt, sl),
                 f"{phase} {rpa.NAME}[serve state]")
    q_win, kp2, bt2, sl2 = _pick(rec.calls["score_logits"],
                                 lambda a: _live_entries(a[2], a[3], b))[0]
    e2 = max_err(torch, ps.paged_score_logits_cuda(q_win, kp2, bt2, sl2),
                 ps.paged_score_logits_plain(q_win, kp2, bt2, sl2),
                 f"{phase} {ps.NAME}[recorded]")
    log(phase, f"warm-up: 2 requests of {WARMUP_TOKENS} tokens, "
        f"compressions {n_comp}; at its state {rpa.NAME} "
        f"max_abs_err={e1:.3e} (batch {tuple(q.shape)}, seq_lens "
        f"{sl.tolist()}, {idle} idle rows over empty tables), at a "
        f"recorded call {ps.NAME} max_abs_err={e2:.3e} (seq_lens "
        f"{sl2.tolist()}) (atol=rtol={TOL}) "
        "ok")
    del rec, zw
    return {rpa.NAME: e1, ps.NAME: e2}


# ----------------------------------------------------------------------


# ----------------------------------------------------------------------
# phase 12: training and the seeded eval

TRAIN_ARCH = "qwen2.5-3b"
#: 12a: card vs CPU at 2 layers (vocabulary capped at CPU_VOCAB)
TRAIN_SMALL = dict(steps=5, seq_len=32, global_batch=4, accum=2)
TRAIN_TOL = 1e-3      # rtol for loss and gnorm, atol = rtol for params
#: 12b: the launcher at full width and depth, at its registered bf16
TRAIN_FULL = dict(steps=20, seq_len=512, global_batch=8, accum=2,
                  ckpt_every=10, lr=3e-4)
RESTART_TOL = 1e-2    # relative, the restarted run's steps after the first
BF16_PEAK_FLOPS = 989e12   # H100 SXM dense bf16, NVIDIA data sheet
#: the eval's launches that must be counted (phase 12c)
EVAL_PATH = ("ragged_paged_attention", "paged_score", "lightning_redundancy",
             "compaction")
#: the eval's smoke size (``python -m repro_torch.eval --smoke``)
EVAL_STEPS, EVAL_REQUESTS = 300, 18
#: seconds a training launcher or an eval CLI may run before it is killed
SUBPROCESS_DEADLINE = 600
#: a top-2 logit gap or a survivor margin below this is a near-tie
TIE_TOL = 1e-4
#: torch's CPU threads while 12's CPU halves run beside its subprocesses
CPU_THREADS = 3


class Background:
    """``fn(*args)`` on a thread of its own; ``result()`` joins it and
    returns its value or raises its error. Torch's operators release the
    GIL, so CPU work runs while the main thread waits on the card."""

    def __init__(self, fn, *args):
        import threading
        self.out, self.err = None, None

        def run():
            try:
                self.out = fn(*args)
            except BaseException as e:      # re-raised by result()
                self.err = e
        self.thread = threading.Thread(target=run, daemon=True)
        self.thread.start()

    def result(self):
        self.thread.join()
        if self.err is not None:
            raise self.err
        return self.out


class Launched:
    """One of the port's entry points in a subprocess, its standard error
    merged into its output, which a thread reads line by line (a full pipe
    never stalls the process). ``lines()`` yields them until the process
    closes its output; past ``deadline`` seconds the process is killed and
    the phase fails. ``kill_on`` (a regular expression) has the reading
    thread kill the process, as a crash would, at the first line that
    matches it, whatever the main thread is doing."""

    def __init__(self, module, args, label, deadline=SUBPROCESS_DEADLINE,
                 kill_on=None):
        import queue
        import re
        import threading
        self.label, self.queue = label, queue.Queue()
        self.kill_on = None if kill_on is None else re.compile(kill_on)
        self.killed = False
        self.t0 = time.monotonic()
        self.deadline = self.t0 + deadline
        self.proc = subprocess.Popen(port_cmd(module, *args),
                                     stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True,
                                     env=_port_env(), cwd=ROOT)
        self.reader = threading.Thread(target=self._read, daemon=True)
        self.reader.start()

    def _read(self):
        for line in self.proc.stdout:
            if self.kill_on is not None and not self.killed \
                    and self.kill_on.match(line):
                self.proc.kill()
                self.killed = True
            self.queue.put(line.rstrip("\n"))
        self.queue.put(None)

    def lines(self):
        import queue
        while True:
            left = self.deadline - time.monotonic()
            if left <= 0:
                self.kill()
                raise AssertionError(f"{self.label}: still running after "
                                     f"{SUBPROCESS_DEADLINE} s")
            try:
                line = self.queue.get(timeout=min(left, 5.0))
            except queue.Empty:
                continue
            if line is None:
                return
            yield line

    def kill(self):
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait()
        self.reader.join(timeout=10)
        self.proc.stdout.close()

    def finish(self, lines):
        """Wait for the exit; fail unless it is 0."""
        rc = self.proc.wait(timeout=max(1.0, self.deadline
                                        - time.monotonic()))
        self.kill()
        if rc != 0:
            raise AssertionError(f"{self.label}: exit {rc}: "
                                 + "\n".join(lines[-40:]))
        return time.monotonic() - self.t0


def _last_json(lines, label):
    for i in range(len(lines) - 1, -1, -1):
        if lines[i].startswith("{"):
            return json.loads(lines.pop(i))
    raise AssertionError(f"{label}: no JSON summary: {lines[-20:]}")


def _train_small_cfg():
    from repro_torch.configs import get_config
    full = get_config(TRAIN_ARCH)
    return dataclasses.replace(full, num_layers=2, dtype="float32",
                               vocab_size=min(full.vocab_size, CPU_VOCAB))


def train_small(torch, device):
    """12a's run on one device: TRAIN_SMALL steps of ``build_train_step``
    at ``accum_steps=2`` from the init drawn on the CPU. Returns each
    step's (loss, gradient norm) and the final params on the CPU."""
    from repro_torch.models import lm
    from repro_torch.training import optimizer as opt
    from repro_torch.training.data import DataConfig, batch_at
    from repro_torch.training.train_loop import build_train_step

    cfg, s = _train_small_cfg(), TRAIN_SMALL
    adamw = opt.AdamWConfig(lr=3e-4, warmup_steps=2, total_steps=s["steps"])
    dc = DataConfig(seq_len=s["seq_len"], global_batch=s["global_batch"],
                    vocab_size=cfg.vocab_size, seed=SEED)
    step = build_train_step(cfg, adamw, accum_steps=s["accum"],
                            vocab_chunk=128)
    p = _tree_to(lm.init(cfg, torch.Generator("cpu").manual_seed(SEED),
                         "cpu"), device)
    st = opt.init_opt_state(p)
    out = []
    for i in range(s["steps"]):
        p, st, _, m = step(p, st, None, batch_at(dc, i))
        assert m["loss"].device.type == torch.device(device).type, \
            f"train[card-vs-cpu]: step {i + 1} left {device}"
        out.append((float(m["loss"]), float(m["grad_norm"])))
    return out, _tree_to(p, "cpu")


def check_train_vs_cpu(torch, card, cpu, seconds):
    """12a's gates: loss and gradient norm each step within TRAIN_TOL
    relative, the final params within TRAIN_TOL."""
    from repro_torch.training.checkpoint import _flatten_with_paths

    cfg, s = _train_small_cfg(), TRAIN_SMALL
    (card_steps, p_card), (cpu_steps, p_cpu) = card, cpu
    worst = {"loss": 0.0, "gnorm": 0.0}
    for i, (a, c) in enumerate(zip(card_steps, cpu_steps)):
        for j, name in enumerate(("loss", "gnorm")):
            assert math.isfinite(a[j]) and math.isfinite(c[j]), (i, a, c)
            rel = abs(a[j] - c[j]) / abs(c[j])
            worst[name] = max(worst[name], rel)
            assert rel <= TRAIN_TOL, \
                f"train[card-vs-cpu]: step {i + 1} {name}: {a[j]} vs {c[j]}"
    cpu_leaves = _flatten_with_paths(p_cpu)
    errs = {}
    for key, a in _flatten_with_paths(p_card).items():
        c = cpu_leaves[key]
        assert torch.allclose(a, c, rtol=TRAIN_TOL, atol=TRAIN_TOL), key
        errs[key] = float((a - c).abs().max())
    leaf = max(errs, key=errs.get)
    losses = [(a[0], c[0]) for a, c in zip(card_steps, cpu_steps)]
    log("train[card-vs-cpu]", f"{cfg.name} widths at 2 layers, vocabulary "
        f"{cfg.vocab_size}, fp32, {s['steps']} steps of batch "
        f"{s['global_batch']} x {s['seq_len']} at accum_steps="
        f"{s['accum']}: losses (card, CPU) {losses}; worst relative loss "
        f"{worst['loss']:.3e}, gnorm {worst['gnorm']:.3e} (tolerance "
        f"{TRAIN_TOL}); final params within atol = rtol = {TRAIN_TOL}, "
        f"largest difference {errs[leaf]:.3e} at {leaf}; card "
        f"{seconds['card']:.1f} s, CPU {seconds['cpu']:.1f} s (beside "
        f"12b's first run)")
    return {"worst_rel_loss": worst["loss"], "worst_rel_gnorm": worst["gnorm"],
            "losses": losses, "worst_param_abs": errs[leaf],
            "worst_param_leaf": leaf}


def _train_args(device):
    f = TRAIN_FULL
    return ["--arch", TRAIN_ARCH, "--steps", str(f["steps"]), "--seq-len",
            str(f["seq_len"]), "--global-batch", str(f["global_batch"]),
            "--accum", str(f["accum"]), "--lr", str(f["lr"]),
            "--log-every", "1", "--seed", str(SEED), "--device", device]


def train_run(args, label, stop_after=None):
    """The training launcher in a subprocess; with ``stop_after`` it is
    killed, as by a crash, as soon as it logs that step."""
    return Launched("repro_torch.launch.train", args, label,
                    kill_on=None if stop_after is None
                    else rf"\[train\] step {stop_after} loss ")


def collect_train(run):
    """The lines of a training launcher ``run`` and the exact losses it
    logged; its JSON summary (its last JSON line) unless it was killed
    (``train_run(stop_after=)``)."""
    import re

    lines, losses = [], {}
    for line in run.lines():
        lines.append(line)
        m = re.match(r"\[train\] step (\d+) loss (\S+) ", line)
        if m:
            losses[m.group(1)] = float(m.group(2))
    if run.killed:
        run.kill()
        summary = {"wall_s": time.monotonic() - run.t0}
    else:
        wall = run.finish(lines)
        summary = _last_json(lines, run.label)
        summary["wall_s"] = wall
    for line in lines:
        log(run.label, line)
    summary.update(logged=losses, lines=lines)
    return summary


def check_train_full(torch, card, first, second, device="cuda"):
    """12b's gates on the two launcher runs: the first, killed while it
    saved its last step (which never publishes: a save is atomic), and
    the second, restarted from the first checkpoint to the end. The
    restored params and optimizer state equal the saved ones bit for bit
    (their digests), the restarted run's first loss equals the first
    run's bit for bit (same weights, same batch), and its later steps are
    within RESTART_TOL of the first run's (a backward that accumulates in
    another order may round another way). The timings are the restarted
    run's, which ran alone on the card."""
    from repro_torch.configs import get_config

    f = TRAIN_FULL
    cfg = get_config(TRAIN_ARCH)
    mid, last = f["ckpt_every"], f["steps"]
    k = str(mid + 1)
    n = second["params"]
    first_losses = first["logged"]
    assert sorted(first_losses, key=int) == [
        str(i) for i in range(1, last + 1)]
    assert second["device"].startswith(device), second["device"]
    assert second["dtype"] == "bfloat16" and second["arch"] == TRAIN_ARCH
    assert second["param_dtype"] == "float32", second["param_dtype"]
    assert second["logged"] == second["losses"]
    assert all(math.isfinite(v) for v in first_losses.values())
    assert all(math.isfinite(v) for v in second["losses"].values())
    assert second["start_step"] == mid and not second["saves"]
    saved = [ln for ln in first["lines"] if f"saved step {mid} " in ln]
    restored = [ln for ln in second["lines"]
                if f"restored step {mid} " in ln]
    assert len(saved) == 1 and len(restored) == 1, (saved, restored)
    want = saved[0].split("(digest ")[1].split(")")[0]
    assert f"(digest {want})" in restored[0], \
        f"restored {restored} against the saved digest {want}"
    assert second["losses"][k] == first_losses[k], \
        f"step {k}: {second['losses'][k]!r} != {first_losses[k]!r}"
    diffs = {s: abs(second["losses"][s] - v) / abs(v)
             for s, v in first_losses.items() if int(s) > mid}
    worst = max(diffs, key=diffs.get)
    assert diffs[worst] <= RESTART_TOL, (worst, diffs[worst])
    tokens = second["tokens_per_s"]
    share = 6 * n * tokens / BF16_PEAK_FLOPS
    reckoned = _train_state_bytes(n, f["accum"])
    peak = second["peak_memory_bytes"] or 0
    save_s = float(saved[0].split(" in ")[-1].split(" s")[0])
    log("train[full]", f"{cfg.name}: {cfg.num_layers} layers, d_model "
        f"{cfg.d_model}, vocabulary {cfg.vocab_size}, {n / 1e9:.3f} B "
        f"params as fp32 masters cast to bf16 at each use, fp32 gradients, "
        f"m and v; batch {f['global_batch']} x {f['seq_len']} at accum "
        f"{f['accum']}; loss {first_losses['1']:.4f} -> "
        f"{first_losses[str(last)]:.4f} in {last} steps; restarted run: "
        f"{second['s_per_step']:.3f} s/step, {tokens:.0f} tokens/s after "
        f"its first step ({second['first_step_s']:.2f} s); 6 N tokens/s = "
        f"{6 * n * tokens / 1e12:.1f} TFLOP/s = {share:.4f} of the bf16 "
        f"tensor-core peak; peak device memory {peak / 1e9:.2f} GB against "
        f"{reckoned / 1e9:.2f} GB of params, gradients, the accumulator "
        f"and m, v; on {card}")
    n8 = _param_count(get_config("qwen3-8b"))
    log("train[restart]", f"checkpoint of step {mid} saved in {save_s:.1f} "
        f"s; the first run killed while it saved step {last} (not "
        f"published); restored with digest {want} equal to the saved one; "
        f"step {k} loss {second['losses'][k]!r} equal bit for bit; "
        f"largest relative difference over steps {k}-{last} "
        f"{diffs[worst]:.3e} at step {worst} (tolerance {RESTART_TOL}); "
        f"runs {first['wall_s']:.1f} s (beside 12c and 12a's CPU half) and "
        f"{second['wall_s']:.1f} s (alone); Qwen3-8B would "
        f"need {_train_state_bytes(n8, f['accum']) / 1e9:.1f} GB for the "
        f"same state, beyond one 80 GB card")
    for run in (first, second):
        del run["lines"]
    return {"first": first, "restart": second, "bf16_peak_share": share,
            "reckoned_bytes": reckoned, "save_s": save_s,
            "worst_restart_rel": diffs[worst],
            "worst_restart_step": int(worst)}


def _param_count(cfg):
    d, f, hq, hkv, dh = (cfg.d_model, cfg.d_ff, cfg.num_heads,
                         cfg.num_kv_heads, cfg.head_dim)
    layer = d * (hq + 2 * hkv) * dh + hq * dh * d + 3 * d * f
    return cfg.num_layers * layer + cfg.vocab_size * d * (
        1 if cfg.tie_embeddings else 2)


def _train_state_bytes(n, accum):
    """Bytes of ``n`` fp32 master params, their fp32 gradients, m and v,
    and the fp32 sum the micro-batches' gradients go into."""
    return n * (4 + 4 + 4 + 4 + (4 if accum > 1 else 0))


# -- near-ties: why two serves' greedy streams may part (12c)

def _gap(torch, logits):
    """Top-1 minus top-2 logit of each row."""
    top = torch.topk(logits.float(), 2, dim=-1)[0]
    return top[..., 0] - top[..., 1]


def _margins(torch, final, seq_lens, k):
    """Per row of a compression, the least margin over heads between the
    k-th and (k+1)-th keep score (inf where nothing is cut)."""
    v = torch.sort(final.float(), dim=1, descending=True)[0]
    out = []
    for i in range(final.shape[0]):
        if int(seq_lens[i]) <= k:
            out.append(math.inf)
            continue
        m = v[i, k - 1] - v[i, k]
        m = torch.where(torch.isfinite(m), m, torch.full_like(m, math.inf))
        out.append(float(m.min()))
    return out


def _router_margins(torch, cfg, p, x, valid):
    """Per token of a MoE call: the router's k-th minus (k+1)-th
    probability (inf where ``valid`` parks the token) and its top-k expert
    ids as a sorted set, on the CPU: (B, S) and (B, S, k). A token whose
    margin is under the rounding of two devices may route to another
    expert on each."""
    k = cfg.num_experts_per_tok
    probs = torch.softmax((x.reshape(-1, x.shape[-1]) @ p["router"]).float(),
                          -1)
    top, ids = torch.topk(probs, k + 1, dim=-1)
    m = (top[:, k - 1] - top[:, k]).reshape(x.shape[:2])
    if valid is not None:
        m = torch.where(valid.reshape(m.shape), m,
                        torch.full_like(m, math.inf))
    return m.cpu(), ids[:, :k].sort(-1)[0].reshape(*x.shape[:2], k).cpu()


class TieRecorder:
    """While on, every engine that serves records its near-ties:
    ``gaps[e][(rid, pos)]``, the top-2 logit gap of the token at output
    position ``pos`` of request ``rid`` in the ``e``-th engine seen,
    ``margins[e][rid][pos]``, the least margin over layers and heads of
    the request's compression launched at output length ``pos``, and
    ``routers[e][rid][pos]``, the least router margin (k-th minus (k+1)-th
    expert probability) over the MoE layers and tokens of the prefill
    that ended at output length ``pos`` or of the decode iteration that
    made token ``pos``. ``router_calls`` keeps every MoE call's per-token
    margins and expert ids (``_router_margins``), for a card-vs-CPU check
    that calls the steps itself. It reads each decode iteration's logits
    and router as it runs, so it works on engines that decode eagerly
    (the CPU); on the card the fused chunks are graph replays, which it
    cannot see, and a card engine must not capture its graphs while it is
    on (it reads the router back to the host). Unfused decode's router
    margins are not recorded."""

    def __init__(self):
        self.gaps, self.margins, self.routers = [], [], []
        self.router_calls = []
        self._iters, self._chunks = [], {}
        self._router, self._router_iters, self._router_chunks = [], [], {}
        self._prefill_rows = []
        self._compressing = None
        self._saved = []

    def _index(self, eng):
        """The engine's place in the order seen, kept on the engine: an
        ``id`` is reused once an engine is freed."""
        seen = eng.__dict__.setdefault("_tie_recorders", {})
        if id(self) not in seen:
            seen[id(self)] = len(self.gaps)
            self.gaps.append({})
            self.margins.append({})
            self.routers.append({})
        return seen[id(self)]

    def _patch(self, owner, name, make):
        orig = getattr(owner, name)
        self._saved.append((owner, name, orig))
        setattr(owner, name, make(orig))

    def _row_router(self, torch, n_rows):
        """The least router margin of each row over this step's MoE
        calls (inf without MoE)."""
        if not self._router:
            return torch.full((n_rows,), math.inf)
        return torch.stack(self._router).amin(0)

    def _note_router(self, e, rid, pos, m):
        seen = self.routers[e].setdefault(rid, {})
        seen[pos] = min(m, seen.get(pos, math.inf))

    def __enter__(self):
        import torch

        from repro_torch.core import compression, serve_model
        from repro_torch.core.engine import ZipageEngine
        from repro_torch.models import layers
        rec = self

        def moe_forward(orig):
            def wrapped(cfg, p, x, **kw):
                m, ids = _router_margins(torch, cfg, p, x, kw.get("valid"))
                rec.router_calls.append((m, ids))
                rec._router.append(m.amin(1))
                return orig(cfg, p, x, **kw)
            return wrapped

        def decode_step(orig):
            def build(cfg, spec):
                step = orig(cfg, spec)

                def recorded(params, state, tokens, active):
                    rec._router = []
                    logits = step(params, state, tokens, active)
                    rec._iters.append(_gap(torch, logits))
                    rec._router_iters.append(
                        rec._row_router(torch, logits.shape[0]))
                    return logits
                return recorded
            return build

        def prefill_step(orig):
            def build(cfg, spec):
                step = orig(cfg, spec)

                def recorded(params, state, tokens, slot_ids, *a, **kw):
                    rec._router = []
                    out = step(params, state, tokens, slot_ids, *a, **kw)
                    rec._prefill_rows.append((slot_ids.cpu().tolist(),
                                              rec._row_router(
                                                  torch, tokens.shape[0])))
                    return out
                return recorded
            return build

        def run_prefill(orig):
            def wrapped(self, chunks):
                rec._prefill_rows = []
                n0 = {c.request.rid: len(c.request.output) for c in chunks}
                by_slot = {c.request.slot: c.request for c in chunks}
                out = orig(self, chunks)
                e = rec._index(self)
                for slots, margins in rec._prefill_rows:
                    for s, m in zip(slots, margins.tolist()):
                        r = by_slot.get(s) if s >= 0 else None
                        if r is not None:
                            rec._note_router(e, r.rid, n0[r.rid], m)
                return out
            return wrapped

        def run_chunk(orig):
            def wrapped(self, k, greedy):
                rec._iters, rec._router_iters = [], []
                out = orig(self, k, greedy)
                rec._chunks.setdefault(id(self), []).append(
                    torch.stack(rec._iters))
                rec._router_chunks.setdefault(id(self), []).append(
                    torch.stack(rec._router_iters))
                return out
            return wrapped

        def record_block(orig):
            def wrapped(self, active, off, k, tok, lp, caps, halted):
                gaps = rec._chunks[id(self)].pop(0)
                routers = rec._router_chunks[id(self)].pop(0)
                n0 = {r.rid: len(r.output) for r in active}
                out = orig(self, active, off, k, tok, lp, caps, halted)
                e = rec._index(self)
                table = rec.gaps[e]
                for r in active:
                    for j in range(len(r.output) - n0[r.rid]):
                        table[(r.rid, n0[r.rid] + j)] = float(gaps[j, r.slot])
                        rec._note_router(e, r.rid, n0[r.rid] + j,
                                         float(routers[j, r.slot]))
                return out
            return wrapped

        def sample_rows(orig):
            def wrapped(self, logits, reqs):
                gaps = _gap(torch, logits)
                table = rec.gaps[rec._index(self)]
                for i, r in enumerate(reqs):
                    if r is not None:
                        table[(r.rid, len(r.output))] = float(gaps[i])
                return orig(self, logits, reqs)
            return wrapped

        def launch_compression(orig):
            def wrapped(self, outs):
                rec._compressing = (rec._index(self), [
                    (c.request.rid, len(c.request.output))
                    for c in outs.compress])
                try:
                    return orig(self, outs)
                finally:
                    rec._compressing = None
            return wrapped

        def select_survivors(orig):
            def wrapped(cfg, opts, k_keep, pre_s, pre_r, fscore, seq_lens,
                        hist_lens, T):
                out = orig(cfg, opts, k_keep, pre_s, pre_r, fscore,
                           seq_lens, hist_lens, T)
                if rec._compressing is not None:
                    e, rows = rec._compressing
                    margins = _margins(torch, out[3], seq_lens, k_keep)
                    for (rid, pos), m in zip(rows, margins):
                        seen = rec.margins[e].setdefault(rid, {})
                        seen[pos] = min(m, seen.get(pos, math.inf))
                return out
            return wrapped

        self._patch(layers, "moe_forward", moe_forward)
        self._patch(serve_model, "build_decode_step", decode_step)
        self._patch(serve_model, "build_prefill_step", prefill_step)
        self._patch(ZipageEngine, "_run_prefill", run_prefill)
        self._patch(ZipageEngine, "_run_chunk", run_chunk)
        self._patch(ZipageEngine, "_record_decode_block", record_block)
        self._patch(ZipageEngine, "_sample_rows", sample_rows)
        self._patch(ZipageEngine, "_launch_compression", launch_compression)
        self._patch(compression, "_select_survivors", select_survivors)
        return self

    def __exit__(self, *exc):
        for owner, name, orig in reversed(self._saved):
            setattr(owner, name, orig)
        self._saved = []

    def explain(self, engine, rid, pos, tol=TIE_TOL):
        """The near-tie of request ``rid`` in the ``engine``-th engine that
        explains its stream parting at output position ``pos``, or
        None."""
        gap = self.gaps[engine].get((rid, pos))
        if gap is not None and gap < tol:
            return f"top-2 logit gap {gap:.3e} at token {pos}"
        for at, m in self.margins[engine].get(rid, {}).items():
            if at <= pos and m < tol:
                return (f"survivor margin {m:.3e} at the compression "
                        f"after {at} tokens")
        for at, m in self.routers[engine].get(rid, {}).items():
            if at <= pos and m < tol:
                what = "the prefill" if at == 0 else f"token {at}"
                return f"router margin {m:.3e} at {what}"
        return None


def first_difference(a, b):
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return i
    return None if len(a) == len(b) else min(len(a), len(b))


def compare_rows(rows_a, rows_b, recorder=None, tol=TIE_TOL):
    """Hold two ``runner.serve_rows`` results (with ``_preds``) equal, row
    by row, every field and every stream. ``recorder`` watched the serves
    of ``rows_b``. Returns ``(unexplained, explained)``: lists of ``(row
    name, what differs)``; a differing stream is explained when the
    recorder saw a near-tie below ``tol`` where it parts."""
    unexplained, explained = [], []
    for e, (a, b) in enumerate(zip(rows_a, rows_b)):
        fields = sorted(k for k in a if k != "_preds" and a[k] != b.get(k))
        parted = [(rid, first_difference(pa, pb)) for rid, (pa, pb)
                  in enumerate(zip(a["_preds"], b["_preds"])) if pa != pb]
        if not fields and not parted:
            continue
        if not parted:
            unexplained.append((a["name"], f"fields {fields}, equal streams"))
            continue
        for rid, pos in parted:
            why = None if recorder is None else \
                recorder.explain(e, rid, pos, tol)
            note = f"request {rid} parts at token {pos}" + (
                f" ({why})" if why else "") + f"; fields {fields}"
            (explained if why else unexplained).append((a["name"], note))
    if len(rows_a) != len(rows_b):
        unexplained.append(("*", f"{len(rows_a)} rows against "
                                 f"{len(rows_b)}"))
    return unexplained, explained


def eval_on_card(torch, rows, device="cuda"):
    """12c's card run: tiny-lm trained EVAL_STEPS steps on the card
    through ``repro_torch.eval``, its five rows served under PlainGuard
    (K1, K2, K3 and B6 counted). Returns the weights, the rows with their
    streams, the rendered report and the launches."""
    import copy

    from repro_torch.eval import runner, tasks
    from repro_torch.kernels import ops

    t = time.monotonic()
    params = runner.trained_params(EVAL_STEPS, SEED, device)
    torch.cuda.synchronize()
    t_train = time.monotonic() - t
    examples = tasks.eval_set(EVAL_REQUESTS, SEED)
    t = time.monotonic()
    ops.reset_launch_counts()
    with PlainGuard():
        card_rows = runner.serve_rows(params, examples, runner.BUDGETS_SMOKE,
                                      device)
        torch.cuda.synchronize()
    launches = dict(ops.launch_counts)
    t_serve = time.monotonic() - t
    for name in EVAL_PATH:
        assert launches[name] > 0, f"eval: {name} never launched"
    by_name = {r["kernel"]: r for r in rows}
    for name, n in launches.items():
        by_name[name]["launches_per_serve"]["eval"] = n
    report = runner.make_report(runner.score_rows(copy.deepcopy(card_rows)),
                                seed=SEED, n_requests=EVAL_REQUESTS,
                                train_steps=EVAL_STEPS, smoke=True)
    return {"params": params, "examples": examples, "rows": card_rows,
            "report": report, "text": runner.render_report(report),
            "launches": launches, "train_s": t_train, "serve_s": t_serve}


def eval_on_cpu(params, examples):
    """12c's CPU serve of the card's weights, its near-ties recorded."""
    from repro_torch.eval import runner

    t = time.monotonic()
    rec = TieRecorder()
    with rec:
        cpu_rows = runner.serve_rows(_tree_to(params, "cpu"), examples,
                                     runner.BUDGETS_SMOKE, "cpu")
    return cpu_rows, rec, time.monotonic() - t


def check_eval(card, cold_text, cold_s, cpu):
    """12c's gates: the cold CLI run's bytes equal the card run's, and
    each CPU row equals the card's unless a stream parts at a near-tie
    the CPU serve recorded."""
    from repro_torch.eval import runner

    text = card["text"]
    assert cold_text == text, (
        f"eval: the cold CLI run's {len(cold_text)} bytes differ from the "
        f"card run's {len(text)}")
    for line in runner.summary_table(card["report"]):
        log("eval", line)
    log("eval", f"tiny-lm trained {EVAL_STEPS} steps on the card in "
        f"{card['train_s']:.1f} s; 5 rows x {EVAL_REQUESTS} requests served "
        f"in {card['serve_s']:.1f} s under PlainGuard (both beside 12b's "
        f"first run and the cold CLI run); kernel launches {card['launches']}; `python -m "
        f"repro_torch.eval --smoke` in a cold process rendered the same "
        f"{len(text)} bytes in {cold_s:.1f} s")
    cpu_rows, rec, cpu_s = cpu
    unexplained, explained = compare_rows(card["rows"], cpu_rows, rec)
    for name, note in explained:
        log("eval", f"card vs CPU, row {name}: {note}")
    assert unexplained == [], f"eval: card vs CPU: {unexplained}"
    same = sum(1 for a, b in zip(card["rows"], cpu_rows) if a == b)
    log("eval", f"card vs CPU on the card's weights: {same} of "
        f"{len(cpu_rows)} rows equal in every field and stream, "
        f"{len(explained)} stream(s) parted at a recorded near-tie; the "
        f"CPU serve took {cpu_s:.1f} s (beside 12b's first run)")
    table = [{k: r[k] for k in ("name", "accuracy", "accuracy_vs_full",
                                "agreement_vs_full", "tokens_per_step",
                                "compressions")}
             for r in card["report"]["results"]]
    return {"report": card["report"], "table": table,
            "launches": card["launches"], "train_s": card["train_s"],
            "serve_s": card["serve_s"], "cold_cli_s": cold_s,
            "card_vs_cpu_equal_rows": same, "near_ties": explained}


def phase_train_eval(torch, dev, card, rows, device="cuda"):
    """Phase 12, arranged so that CPU work and light card work run beside
    heavy card work: 12a's card half; then 12b's first launcher run beside
    12c's card run, the cold eval CLI, 12a's CPU half and 12c's CPU serve
    (the evals' reports cannot read the wall clock); then 12b's restarted
    run alone, whose timings are reported. (``device`` is the card; "cpu"
    rehearses the phase's plumbing.)"""
    import shutil
    import tempfile

    t0 = time.monotonic()
    took = {}
    work = tempfile.mkdtemp(prefix="zipage-train-")
    started = []
    try:
        t = time.monotonic()
        small_card = train_small(torch, dev)
        torch.cuda.synchronize()
        took["12a card"] = time.monotonic() - t
        gc.collect()
        torch.cuda.empty_cache()

        t = time.monotonic()
        ckpt_dir = os.path.join(work, "ckpt")
        args = _train_args(device) + ["--ckpt-dir", ckpt_dir]
        mid = TRAIN_FULL["ckpt_every"]
        cold_out = os.path.join(work, "eval-smoke.json")
        threads = torch.get_num_threads()
        torch.set_num_threads(CPU_THREADS)
        try:
            first_run = train_run(args + ["--ckpt-every", str(mid)],
                                  "train[first]",
                                  stop_after=TRAIN_FULL["steps"])
            started.append(first_run)
            cold = Launched("repro_torch.eval",
                            ["--smoke", "--device", device, "--seed",
                             str(SEED), "--requests", str(EVAL_REQUESTS),
                             "--train-steps", str(EVAL_STEPS), "--out",
                             cold_out], "eval[cold]")
            started.append(cold)
            t_cpu = time.monotonic()
            small_cpu = Background(lambda: (train_small(torch, "cpu"),
                                            time.monotonic() - t_cpu))
            card_eval = eval_on_card(torch, rows, device)
            cpu_eval = Background(eval_on_cpu, card_eval["params"],
                                  card_eval["examples"])
            cold_lines = list(cold.lines())
            cold_s = cold.finish(cold_lines)
            with open(cold_out) as f:
                cold_text = f.read()
            first = collect_train(first_run)
            assert first_run.killed, "train[first]: never reached its end"
            small_cpu, cpu_s = small_cpu.result()
            cpu_eval = cpu_eval.result()
        finally:
            torch.set_num_threads(threads)
        took["12b first + 12c + CPU halves"] = time.monotonic() - t
        published = sorted(d for d in os.listdir(ckpt_dir)
                           if not d.endswith(".tmp"))
        assert published == [f"step_{mid:08d}"], published
        gc.collect()
        torch.cuda.empty_cache()

        t = time.monotonic()
        restart = train_run(args, "train[restart]")
        started.append(restart)
        second = collect_train(restart)
        took["12b restart"] = time.monotonic() - t
    finally:
        for run in started:
            run.kill()
        shutil.rmtree(work, ignore_errors=True)
    out = {"card_vs_cpu": check_train_vs_cpu(
        torch, small_card, small_cpu,
        {"card": took["12a card"], "cpu": cpu_s}),
        "full": check_train_full(torch, card, first, second, device),
        "eval": check_eval(card_eval, cold_text, cold_s, cpu_eval)}
    took["all"] = time.monotonic() - t0
    out["took"] = took
    log("train+eval", "passed (" + ", ".join(
        f"{k} {v:.1f} s" for k, v in took.items()) + ")")
    return out


# ----------------------------------------------------------------------
# phase 13: MoE and MLA (DeepSeek-V2-Lite-16B, DBRX-132B)

MLA_CONFIG, DBRX_CONFIG = "deepseek-v2-lite-16b", "dbrx-132b"
#: 13a: the layers of each on the card and the CPU (DeepSeek-V2-Lite's
#: first, dense, layer and two MoE layers; DBRX's first two, both MoE),
#: and the decode steps after the prefill
MOE_CPU_LAYERS = {MLA_CONFIG: 3, DBRX_CONFIG: 2}
MOE_DECODE_STEPS = 16
#: 13b: K2's windows at MLA's widths
MLA_WINDOWS = (4, 16)
#: 13d: DBRX-132B's depth on one card: 8 of its 40 layers hold 54.6 GB of
#: bf16 weights (one layer's 16 experts are 6.3 GB), the whole model 264 GB
DBRX_LAYERS = 8
#: a capacity factor at which no token-expert pair is dropped, as the JAX
#: package's own equivalence tests take (tests/test_serve_equivalence.py)
DROP_FREE_CAPACITY = 8.0
#: the kernels of the MLA serves: MLA decodes in plain PyTorch, as the
#: JAX package decodes it in jnp, so K1 and B4 do not run
MLA_PATH = ("paged_score", "lightning_redundancy", "compaction")
MLA_FLASH_PATH = ("paged_score", "flash_redundancy", "compaction")


def moe_router_flips(cpu_calls, card_calls, label):
    """Tokens whose top-k experts differ between two runs of the same MoE
    calls (``TieRecorder.router_calls``), with the CPU's margin of each:
    [(call, row, position, margin)]. Parked tokens (inf margin) are not
    compared."""
    if len(cpu_calls) != len(card_calls):
        raise AssertionError(f"{label}: {len(cpu_calls)} MoE calls on the "
                             f"CPU, {len(card_calls)} on the card")
    flips = []
    for c, ((m, ids), (_, ids_card)) in enumerate(zip(cpu_calls, card_calls)):
        differ = (ids != ids_card).any(-1) & m.isfinite()
        for row, pos in differ.nonzero().tolist():
            flips.append((c, row, pos, float(m[row, pos])))
    return flips


def check_moe_logits(torch, dev, name):
    """13a: ``name`` at full width and MOE_CPU_LAYERS layers, fp32, random
    weights from the seed (vocabulary capped at CPU_VOCAB): one paged
    prefill and MOE_DECODE_STEPS decode steps on the card and on the CPU,
    the logits within CARD_CPU_TOL. Every MoE call's routing is recorded
    on both (``TieRecorder``): a token routed to other experts on the two
    devices is excused only where the CPU's router margin is below
    TIE_TOL, and is counted; the logits of that step and after are then
    not compared. Returns (max error, flips)."""
    from repro_torch.configs import get_config
    from repro_torch.core import serve_model
    from repro_torch.models import lm

    phase = f"moe card-vs-cpu[{name}]"
    cfg = dataclasses.replace(get_config(name), dtype="float32")
    small = dataclasses.replace(cfg, num_layers=MOE_CPU_LAYERS[name],
                                vocab_size=min(cfg.vocab_size, CPU_VOCAB))
    t = time.monotonic()
    p_dev = lm.init(small, torch.Generator(dev).manual_seed(SEED), dev)
    p_cpu = _tree_to(p_dev, "cpu")
    log(phase, f"{small.num_layers} layers ({[f for _, f in lm.layer_specs(small)]}), "
        f"d_model {cfg.d_model}, {cfg.attn_type}, {cfg.num_experts} experts "
        f"top-{cfg.num_experts_per_tok}, vocabulary {small.vocab_size} (of "
        f"{cfg.vocab_size}), {lm.param_count(p_cpu) / 1e9:.2f} B params fp32"
        f" on each side, drawn on the card in {time.monotonic() - t:.1f} s")
    spec = serve_model.ServeSpec(n_slots=4, block_size=16, max_blocks=8,
                                 n_total_blocks=32, m_qslots=4, window=4,
                                 prefill_rows=2, prefill_len=64,
                                 dtype="float32")
    results, calls, bounds = {}, {}, {}
    for side, device, params in (("cpu", "cpu", p_cpu), ("card", dev, p_dev)):
        t = time.monotonic()
        with TieRecorder() as rec:
            st = serve_model.make_state(small, spec, device)
            i32 = dict(dtype=torch.int32, device=device)
            st["block_tables"][0, :4] = torch.tensor([3, 5, 7, 9], **i32)
            st["block_tables"][1, :5] = torch.tensor([11, 2, 4, 6, 8], **i32)
            st["seq_lens"][:2] = torch.tensor([45, 60], **i32)
            st["qslot"][:2] = torch.tensor([0, 1], **i32)
            prefill = serve_model.build_prefill_step(small, spec)
            decode = serve_model.build_decode_step(small, spec)
            toks = torch.arange(2 * 64, device=device).reshape(2, 64) * 97 \
                % small.vocab_size
            lengths = torch.tensor([45, 60], **i32)
            zero = torch.zeros(2, **i32)
            outs = [prefill(params, st, toks, torch.tensor([0, 1], **i32),
                            lengths, zero)]
            step_calls = [len(rec.router_calls)]
            st["positions"][:2] = lengths
            active = torch.tensor([True, True, False, False], device=device)
            tok = torch.tensor([5, 6, 0, 0], device=device)
            for i in range(MOE_DECODE_STEPS):
                outs.append(decode(params, st, tok, active)[:2])
                step_calls.append(len(rec.router_calls))
                tok = (tok + 1000 * (i + 1)) % small.vocab_size
        results[side] = [o.cpu() for o in outs]
        calls[side], bounds[side] = rec.router_calls, step_calls
        log(phase, f"{side}: prefill + {MOE_DECODE_STEPS} decode steps in "
            f"{time.monotonic() - t:.1f} s")
    flips = moe_router_flips(calls["cpu"], calls["card"], phase)
    first = len(results["cpu"])
    for c, row, pos, m in flips:
        step = next(i for i, n in enumerate(bounds["cpu"]) if c < n)
        first = min(first, step)
        log(phase, f"router flip at step {step} (MoE call {c}, row {row}, "
            f"position {pos}): the CPU's k-th vs (k+1)-th margin {m:.3e}")
        if not m < TIE_TOL:
            raise AssertionError(f"{phase}: a token routes to other experts "
                                 f"on the card at a router margin of {m:.3e}"
                                 f" (tolerance {TIE_TOL})")
    errs = []
    for a, b in zip(results["cpu"][:first], results["card"][:first]):
        err = (a - b).abs()
        if bool((err > CARD_CPU_TOL + CARD_CPU_TOL * a.abs()).any()):
            raise AssertionError(f"{phase}: card vs cpu logits off by "
                                 f"{float(err.max()):.3e}")
        errs.append(float(err.max()))
    margins = torch.cat([m[m.isfinite()] for m, _ in calls["cpu"]])
    log(phase, f"prefill + {MOE_DECODE_STEPS} decode steps: max_abs_err="
        f"{max(errs):.3e} over {len(errs)} of {len(results['cpu'])} outputs "
        f"(atol=rtol={CARD_CPU_TOL}) ok; {len(calls['cpu'])} MoE calls, "
        f"{margins.numel()} routed tokens, least router margin "
        f"{float(margins.min()):.3e}, {int((margins < TIE_TOL).sum())} under "
        f"{TIE_TOL}; {len(flips)} router flip(s) between the devices")
    del p_dev, p_cpu
    gc.collect()
    torch.cuda.empty_cache()
    return max(errs), len(flips)


def check_mla_kernels(torch, dev, cfg, dtype):
    """13b: the changed kernels at DeepSeek-V2-Lite's widths against their
    plain versions, at inputs of ``dtype``: K2 over the 576-wide latent
    entries as h_kv = 1, g = 16 at the MLA scale, windows MLA_WINDOWS (the
    d-tiled path), and the K2 route to the MLA scores (softmax, max over
    heads, mean over w) against ``scoring.mla_attention_scores``; K3 and B5
    on the 512-wide latents of the live pages (B5 on 32-key tiles in fp32)
    with the zero-out firing and two launches bit for bit; B6 with no V at
    d = 576, h = 1, bit for bit, at the engine's budget (k = 48) and at
    k = 1024. Page 0 is NaN and no live row maps it. Returns each kernel's
    max error."""
    import types

    import numpy as np
    from repro_torch.core import compression, scoring
    from repro_torch.core.paged import gather_entries
    from repro_torch.kernels import compaction as cmp
    from repro_torch.kernels import ops
    from repro_torch.kernels import paged_score as ps
    from repro_torch.kernels import redundancy as red

    phase = "mla kernels" + dtype_tag(torch, dtype)
    tol = kernel_tols(torch, dtype)[0]
    r = cfg.kv_lora_rank
    e = r + cfg.qk_rope_head_dim
    scale = 1.0 / math.sqrt(cfg.head_dim + cfg.qk_rope_head_dim)
    b, mb, n_pages = 16, 32, 256           # the engine defaults' shapes
    T = mb * b
    rng = np.random.default_rng(SEED + 13)
    errs = {ps.NAME: 0.0, red.NAME: 0.0, red.FLASH_NAME: 0.0, cmp.NAME: 0.0}
    mixes = {"compress": [64, 176, 4, T, 16, 80, 0, 48],
             "similar": [64, 64, 128, 200, 31, T, 5, 0]}
    hits = {red.NAME: 0, red.FLASH_NAME: 0}
    for label, lens in mixes.items():
        kv, _ = make_pool(torch, rng, n_pages, b, 1, e, dev,
                          similar=label == "similar", dtype=dtype)
        bt, sl = make_tables(torch, rng, lens, b, mb, n_pages, dev, kv, kv)
        valid = torch.arange(T, device=dev)[None] < sl[:, None]
        for w in MLA_WINDOWS:
            q = torch.randn(len(lens), w, cfg.num_heads, e, device=dev,
                            generator=torch.Generator(dev).manual_seed(
                                SEED + w)).to(dtype)
            got = ps.paged_score_logits_cuda(q, kv, bt, sl, scale=scale)
            want = ps.paged_score_logits_plain(q, kv, bt, sl, scale=scale)
            err = max_err(torch, got, want, f"{ps.NAME}[mla {label} w={w}]",
                          tol)
            route = ops.attention_scores_from_logits(got, sl, causal=True)
            ref = scoring.mla_attention_scores(
                q, gather_entries(kv[:, :, 0], bt), valid, sl, scale=scale)
            err_s = max_err(torch, route, ref,
                            f"{ps.NAME}[mla {label} w={w}] scores", tol)
            errs[ps.NAME] = max(errs[ps.NAME], err, err_s)
            log(phase, f"{ps.NAME}[{label}, w={w}, h_kv 1, g "
                f"{cfg.num_heads}, d {e}, scale 1/sqrt("
                f"{cfg.head_dim + cfg.qk_rope_head_dim})]: max_abs_err="
                f"{err:.3e}, its route to mla_attention_scores {err_s:.3e} "
                f"(atol=rtol={tol}) ok")
        pool, table = compression._latent_pages(kv[:, :, 0], bt, r)
        for name, cuda_fn, plain_fn in (
                (red.NAME, red.lightning_redundancy_cuda,
                 red.lightning_redundancy_plain),
                (red.FLASH_NAME, red.flash_redundancy_cuda,
                 red.flash_redundancy_plain)):
            got = cuda_fn(pool, table, sl, p_thresh=0.8)
            want = plain_fn(pool, table, sl, p_thresh=0.8)
            err = max_err(torch, got, want, f"{name}[mla {label}]", tol)
            if not bool(torch.equal(got, cuda_fn(pool, table, sl,
                                                 p_thresh=0.8))):
                raise AssertionError(f"{name}[mla]: two runs differ")
            hits[name] += int((plain_fn(pool, table, sl, p_thresh=2.0)
                               != want).sum())
            errs[name] = max(errs[name], err)
            log(phase, f"{name}[{label}, latent d {r}, h 1]: max_abs_err="
                f"{err:.3e} (atol=rtol={tol}), the same in two runs, ok")
    for name, n in hits.items():
        if n == 0:
            raise AssertionError(f"{name}[mla]: the zero-out never fired")
    log(phase, f"the p_thresh zero-out changed {hits} row sums (exercised)")
    latent = types.SimpleNamespace(num_kv_heads=1, head_dim=e)
    kinds = ["in_place"] * 6 + ["cow"] * 2 + ["pad"] * 2
    for width, budget in ((8, 3), (LONG_TABLE, LONG_BUDGET)):
        lens = [int(x) * b for x in rng.integers(budget + 1, width + 1, 8)] \
            + [0, 0]
        args = compaction_case(torch, dev, latent, types.SimpleNamespace(
            block_size=b), rng, lens, kinds, width, budget, L=4, dtype=dtype)
        args = (args[0], None) + args[2:]
        check_compaction_at(torch, args, f"compaction[mla, k={budget * b}]")
        log(phase, f"compaction with no V at d {e}, h 1: {len(lens)} rows x "
            f"4 layers at k={budget * b} equal to the plain version bit for "
            "bit, and the same in two launches ok")
        del args
    torch.cuda.empty_cache()
    return errs


def mla_rows(torch, rec, rec_flash, per_serve, errs):
    """The MLA rows of the kernels line: K2, K3 and B6 timed at the
    DeepSeek serve's recorded calls whose live work is largest (bf16), B5
    at the flash serve's; launches from those serves."""
    def pick(r, op, key):
        return _pick(r.calls[op], key)

    def comp_live(a):
        return _live_entries(a[1], a[2], a[0].shape[1])

    def score_live(a):
        return _live_entries(a[2], a[3], a[1].shape[1])

    specs = [
        ("mla", score_spec(torch, *pick(rec, "score_logits", score_live))),
        ("mla", redundancy_spec(torch, "lightning_redundancy",
                                *pick(rec, "lightning_redundancy",
                                      comp_live))),
        ("mla-flash", redundancy_spec(torch, "flash_redundancy",
                                      *pick(rec_flash, "flash_redundancy",
                                            comp_live))),
        ("mla", compaction_spec(torch, pick(rec, "compact",
                                            _live_rows)[0])),
    ]
    return [dict(_row(torch, spec, per_serve, serve, errs,
                      label=spec["name"] + "_mla_bf16"),
                 shapes=spec["shapes"]) for serve, spec in specs]


def mla_serve(torch, card, errs_bf16):
    """13c: DeepSeek-V2-Lite-16B at full width and depth in bf16, its
    registered dtype, through ``Zipage.from_config`` at the engine
    defaults under ZIPAGE_SANITIZE=1: phase 5's prompts, 8 greedy
    requests of NEW_TOKENS tokens (compression fires, every compression
    goes through B6, no plain version runs, K2, K3 and B6 launch, the
    sanitizer reports nothing); 2 greedy requests with flash redundancy
    (B5); tok/s, step median, peak memory and the memory planner's M and
    N_total beside Qwen3-8B's at the same free memory. Then the same
    weights at a drop-free capacity, at ``decode_steps`` 1 and 8: equal
    streams and logprobs, bit for bit. Returns (summary, MLA rows)."""
    import numpy as np
    from repro_torch.api import SamplingParams, Zipage
    from repro_torch.configs import get_config
    from repro_torch.core import memory_planner
    from repro_torch.core.compression import CompressOptions
    from repro_torch.models import lm

    phase = f"mla[{MLA_CONFIG}]"
    took, t = {}, time.monotonic()

    def lap(what):
        nonlocal t
        took[what] = time.monotonic() - t
        t = time.monotonic()

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    z = _sanitized(lambda: Zipage.from_config(MLA_CONFIG, param_seed=SEED,
                                              dtype="bfloat16"))
    torch.cuda.synchronize()
    eng, cfg = z.engine, z.cfg
    assert eng.sanitize, "the engine did not read ZIPAGE_SANITIZE"
    opts = eng.opts
    n_params = lm.param_count(eng.params)
    log(phase, f"{cfg.num_layers} layers ({cfg.first_dense_layers} dense), "
        f"d_model {cfg.d_model}, MLA (kv_lora_rank {cfg.kv_lora_rank}, rope "
        f"{cfg.qk_rope_head_dim}, {cfg.num_heads} heads), {cfg.num_experts} "
        f"experts top-{cfg.num_experts_per_tok} + {cfg.num_shared_experts} "
        f"shared (d_ff {cfg.moe_d_ff}), vocab {cfg.vocab_size}; "
        f"{n_params / 1e9:.2f} B params bf16 on the card, ready in "
        f"{took.get('build', time.monotonic() - t):.1f} s")
    free, total = torch.cuda.mem_get_info()
    plans = {}
    for name in (MLA_CONFIG, "qwen3-8b"):
        plans[name] = memory_planner.plan_memory(
            get_config(name), free, opts.n_max, block_size=opts.block_size,
            window=opts.window, dtype_bytes=2)
    real = memory_planner.pool_bytes_per_kv_block(cfg, opts.block_size,
                                                  dtype_bytes=2)
    if real != eng._kv_block_bytes():
        raise AssertionError(f"{phase}: the planner's pool bytes {real} are "
                             f"not the pools' {eng._kv_block_bytes()}")
    for name, plan in plans.items():
        log(phase, f"memory plan (Eq. 1) at bf16 with {free / 1e9:.2f} of "
            f"{total / 1e9:.2f} GB free, n_max {opts.n_max}: {name} M = "
            f"{plan.M} requests, N_total = {plan.N_total} blocks of "
            f"{plan.m_kv_block} B, {plan.m_q_req} B of window a request")
    lap("build")
    prompts = make_prompts(cfg)
    greedy = [SamplingParams(max_new_tokens=NEW_TOKENS)] * N_REQUESTS
    with Audits() as audits:
        rec, launches, summary, outs = sanitized_serve(
            torch, card, z, f"{phase} sanitized", prompts, greedy, MLA_PATH,
            audits)
        lap("serve")
        zf = _sanitized(lambda: Zipage(cfg, eng.params, dtype="bfloat16",
                                       compress=CompressOptions(
                                           window=opts.window,
                                           redundancy="flash")))
        rec_f, launches_f, summary_f, _ = sanitized_serve(
            torch, card, zf, f"{phase} flash sanitized", prompts[:2],
            greedy[:2], MLA_FLASH_PATH, audits)
        del zf
        lap("serve-flash")
    peak = torch.cuda.max_memory_allocated()
    log(phase, f"peak memory allocated {peak / 1e9:.2f} GB on {card}")
    per_serve = {n: {"mla": launches[n], "mla-flash": launches_f[n]}
                 for n in launches}
    errs = {n: errs_bf16.get(n, 0.0) for n in launches}
    rows = mla_rows(torch, rec, rec_f, per_serve, errs)
    del rec, rec_f
    lap("timing")

    free_cfg = dataclasses.replace(cfg, moe_capacity_factor=DROP_FREE_CAPACITY)
    sps = [SamplingParams(max_new_tokens=NEW_TOKENS, logprobs=True)] * 4 + [
        SamplingParams(max_new_tokens=NEW_TOKENS, seed=SEED + i,
                       logprobs=True, **THINKING) for i in range(4)]
    pair = {}
    for k in (1, 8):
        zk = Zipage(free_cfg, eng.params, dtype="bfloat16", decode_steps=k)
        tk = time.monotonic()
        got = zk.generate(prompts, sps)
        torch.cuda.synchronize()
        wall = time.monotonic() - tk
        pair[k] = ([o.token_ids for o in got],
                   [np.asarray(o.logprobs).tobytes() for o in got])
        n_tok = sum(len(o.token_ids) for o in got)
        n_comp = sum(o.metrics.compression.n_compressions for o in got)
        log(phase, f"capacity factor {DROP_FREE_CAPACITY} (drop-free), "
            f"decode_steps={k}: {n_tok} tokens in {wall:.2f} s = "
            f"{n_tok / wall:.1f} tok/s, {n_comp} compressions, "
            f"{zk.engine._graphs.replays} graph replays")
        assert n_comp > 0, "compression never fired"
        del zk
    if pair[1] != pair[8]:
        diff = [i for i in range(len(prompts))
                if pair[1][0][i] != pair[8][0][i]
                or pair[1][1][i] != pair[8][1][i]]
        raise AssertionError(f"{phase}: decode_steps 1 and 8 differ at a "
                             f"drop-free capacity (requests {diff})")
    log(phase, "decode_steps 1 and 8 at a drop-free capacity: 4 greedy and "
        "4 seeded streams and their logprobs equal bit for bit ok")
    lap("pair")
    out = {"layers": cfg.num_layers, "params": n_params, "peak_bytes": peak,
           "free_bytes_after_weights": free,
           "plans": {n: dataclasses.asdict(p) for n, p in plans.items()},
           "serves": {"mla": summary, "mla-flash": summary_f},
           "k1_equals_k8_drop_free": True, "took": took}
    del z, eng
    gc.collect()
    torch.cuda.empty_cache()
    return out, rows


def dbrx_serve(torch, dev, card, rows):
    """13d: DBRX-132B at full width and DBRX_LAYERS of its 40 layers, bf16,
    random weights from the seed, under ZIPAGE_SANITIZE=1: 8 greedy
    requests of NEW_TOKENS tokens on the main path (K1, K2, K3 and B6,
    whose launch counts go into the bf16 rows)."""
    from repro_torch.api import SamplingParams, Zipage
    from repro_torch.configs import get_config
    from repro_torch.models import lm

    phase = f"moe[{DBRX_CONFIG}]"
    t = time.monotonic()
    full = get_config(DBRX_CONFIG)
    cfg = dataclasses.replace(full, num_layers=DBRX_LAYERS, dtype="bfloat16")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = lm.init(cfg, torch.Generator(dev).manual_seed(SEED), dev)
    z = _sanitized(lambda: Zipage(cfg, params, dtype="bfloat16"))
    torch.cuda.synchronize()
    assert z.engine.sanitize
    g = cfg.num_heads // cfg.num_kv_heads
    log(phase, f"{cfg.num_layers} of {full.num_layers} layers (depth cut "
        f"for one card's memory), d_model {cfg.d_model}, {cfg.num_heads}/"
        f"{cfg.num_kv_heads} heads (g = {g}), {cfg.num_experts} experts "
        f"top-{cfg.num_experts_per_tok} (d_ff {cfg.moe_d_ff}), "
        f"{cfg.norm_type}, vocab {cfg.vocab_size}; "
        f"{lm.param_count(params) / 1e9:.2f} B params bf16 on the card, "
        f"ready in {time.monotonic() - t:.1f} s")
    with Audits() as audits:
        _, launches, summary, _ = sanitized_serve(
            torch, card, z, f"{phase} sanitized", make_prompts(cfg),
            [SamplingParams(max_new_tokens=NEW_TOKENS)] * N_REQUESTS,
            MAIN_PATH, audits)
    peak = torch.cuda.max_memory_allocated()
    log(phase, f"peak memory allocated {peak / 1e9:.2f} GB on {card}")
    by_name = {r["name"]: r for r in rows}
    for kname, n in launches.items():
        if n:
            by_name[kname + "_bf16"]["launches_per_serve"][DBRX_CONFIG] = n
    out = {"layers": cfg.num_layers, "of_layers": full.num_layers,
           "params": lm.param_count(params), "peak_bytes": peak,
           "serve": summary, "phase_s": time.monotonic() - t}
    del z, params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_moe_mla(torch, dev, card, rows_bf16):
    """Phase 13: 13a card vs CPU at a few layers of both configs, 13b the
    changed kernels at MLA's widths, 13c DeepSeek-V2-Lite-16B served at
    full width and depth, 13d DBRX-132B served at full width and reduced
    depth. Returns (summary, the MLA kernel rows)."""
    from repro_torch.configs import get_config

    took, t = {}, time.monotonic()

    def lap(what):
        nonlocal t
        took[what] = time.monotonic() - t
        t = time.monotonic()

    card_cpu = {}
    for name in (MLA_CONFIG, DBRX_CONFIG):
        err, flips = check_moe_logits(torch, dev, name)
        card_cpu[name] = {"max_abs_err": err, "router_flips": flips}
    lap("13a")
    mcfg = get_config(MLA_CONFIG)
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        errs[str(dtype)] = check_mla_kernels(torch, dev, mcfg, dtype)
    lap("13b")
    served, rows = mla_serve(torch, card, errs[str(torch.bfloat16)])
    lap("13c")
    dbrx = dbrx_serve(torch, dev, card, rows_bf16)
    lap("13d")
    log("moe+mla", "passed in " + ", ".join(f"{k} {v:.1f} s"
                                            for k, v in took.items()))
    return {"card_vs_cpu": card_cpu, "kernel_errs": errs, "mla": served,
            "dbrx": dbrx, "took": took}, rows


# ----------------------------------------------------------------------
# phase 14: the recurrent configs (RecurrentGemma-2B, RWKV6-3B)

RG_CONFIG, RWKV_CONFIG = "recurrentgemma-2b", "rwkv6-3b"
#: 14b: the layers of each on the card and the CPU (RecurrentGemma's
#: first unit (rglru, rglru, attn) and two rglru layers, as its tail; two
#: RWKV layers), the prefill bucket the prompts span, their lengths, and
#: the decode steps after them
REC_CPU_LAYERS = {RG_CONFIG: 5, RWKV_CONFIG: 2}
REC_PREFILL_LEN = 64
REC_CPU_LENS = (150, 100)
REC_DECODE_STEPS = 16
#: 14c: the two requests that cross RecurrentGemma's 2048-token window:
#: one whose prompt wraps the ring in decode, one whose prompt wraps it
#: across prefill calls; the engine's table and pool for 10 requests,
#: each holding its 128-block ring
RG_LONG_PROMPTS = (2000, 2300)
RG_SHAPES = dict(max_model_len=2560, n_total_blocks=1280, max_batch=10)
#: the decode kernels on the recurrent serves (RWKV6 runs none)
RG_PATH = ("ragged_paged_attention",)
RG_DENSE_PATH = ("paged_attention",)


def check_rec_kernels(torch, dev, cfg, dtype):
    """14a: K1 and B4 at RecurrentGemma's layout (g = 10, h_kv = 1,
    d = 256, b = 16, a 128-block ring) against their plain versions at
    inputs of ``dtype``, on full rings (seq_len 2048), partly filled ones
    and seq_len 0 rows (exact zeros), the dense kernel against the ragged
    one bit for bit on live rows; then on idle slots (``check_idle_slots``:
    seq_len >= 1 over an empty table reads page 0). Returns each kernel's
    max error."""
    import types

    import numpy as np
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ragged_paged_attention as rpa

    phase = "recurrent kernels" + dtype_tag(torch, dtype)
    out_tol = kernel_tols(torch, dtype)[1]
    b = 16
    ring = cfg.local_window // b
    hq, hkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    rng = np.random.default_rng(SEED + 14)
    errs = {rpa.NAME: 0.0, pa.NAME: 0.0}
    W = cfg.local_window
    mixes = {"full ring": [W] * 6 + [0, 0],
             "partial": [W, W - 1, W * 39 // 40, W * 3 // 8, W // 7,
                         min(17, W), 1, 0]}
    for label, lens in mixes.items():
        n_pages = 1 + sum(-(-s // b) for s in lens) + 8
        k, v = make_pool(torch, rng, n_pages, b, hkv, d, dev, dtype=dtype)
        bt, sl = make_tables(torch, rng, lens, b, ring, n_pages, dev, k, v)
        q = torch.randn(len(lens), hq, d, device=dev,
                        generator=torch.Generator(dev).manual_seed(SEED)) \
            .to(dtype)
        ragged = rpa.ragged_paged_attention_cuda(q, k, v, bt, sl)
        dense = pa.paged_attention_cuda(q, k, v, bt, sl)
        torch.cuda.synchronize()
        for name, got in ((rpa.NAME, ragged), (pa.NAME, dense)):
            if not bool((got[sl == 0] == 0).all()):
                raise AssertionError(f"{name}[{label}]: seq_len == 0 rows "
                                     "are not zeros")
            plain = (rpa.ragged_paged_attention_plain if name == rpa.NAME
                     else pa.paged_attention_plain)
            errs[name] = max(errs[name], max_err(
                torch, got, plain(q, k, v, bt, sl), f"{name}[{label}]",
                out_tol))
        live = sl > 0
        if not bool(torch.equal(dense[live], ragged[live])):
            raise AssertionError(f"dense vs ragged[{label}]: live rows "
                                 "differ (bit for bit is required)")
        log(phase, f"[{label}, seq_lens {lens}, g {hq // hkv}, h_kv {hkv}, "
            f"d {d}, b {b}, table {ring}]: {rpa.NAME} max_abs_err="
            f"{errs[rpa.NAME]:.3e}, {pa.NAME} {errs[pa.NAME]:.3e} (atol=rtol="
            f"{out_tol}), dense == ragged on live rows bit for bit ok")
    # idle slots at the serve's table width (RG_SHAPES)
    opts = types.SimpleNamespace(
        block_size=b, max_model_len=RG_SHAPES["max_model_len"],
        n_total_blocks=64, max_batch=RG_SHAPES["max_batch"])
    errs[rpa.NAME] = max(errs[rpa.NAME], check_idle_slots(
        torch, dev, cfg, opts, rng, phase, dtype))
    torch.cuda.empty_cache()
    return errs


def rec_steps(torch, cfg, params, device, seqs):
    """14b on one device: the prompts ``seqs`` prefilled in calls of
    REC_PREFILL_LEN tokens (each spans several), then REC_DECODE_STEPS
    greedy decode steps, each feeding the device's own argmax. Returns
    the logits of the prompts' last prefill call and of each decode step
    ((n, rows, V) on the CPU), the greedy tokens and the prefill calls."""
    from repro_torch.core import serve_model

    P, S = len(seqs), REC_PREFILL_LEN
    b = 16
    spec = serve_model.ServeSpec(
        n_slots=P, block_size=b, max_blocks=cfg.local_window // b or 8,
        n_total_blocks=P * (cfg.local_window // b or 8), m_qslots=P,
        window=4, prefill_rows=P, prefill_len=S, dtype="float32")
    st = serve_model.make_state(cfg, spec, device)
    i32 = dict(dtype=torch.int32, device=device)
    if "pools" in st:
        n = spec.max_blocks
        st["block_tables"].copy_(torch.arange(P * n, **i32).reshape(P, n))
    prefill = serve_model.build_prefill_step(cfg, spec)
    decode = serve_model.build_decode_step(cfg, spec)
    lens = [len(s) for s in seqs]
    done, calls, last = [0] * P, 0, [None] * P
    while done != lens:
        toks = torch.zeros((P, S), dtype=torch.int64)
        slots, n, start = [-1] * P, [0] * P, [0] * P
        for i, s in enumerate(seqs):
            c = min(S, lens[i] - done[i])
            if c:
                toks[i, :c] = torch.tensor(s[done[i]:done[i] + c])
                slots[i], n[i], start[i] = i, c, done[i]
        logits = prefill(params, st, toks.to(device),
                         torch.tensor(slots, **i32), torch.tensor(n, **i32),
                         torch.tensor(start, **i32))
        calls += 1
        for i in range(P):
            done[i] += n[i]
            if n[i] and done[i] == lens[i]:
                last[i] = logits[i].cpu()
    ring = serve_model.ring_tokens(cfg, spec)
    st["positions"].copy_(torch.tensor(lens, **i32))
    st["seq_lens"].copy_(torch.tensor([min(x, ring) if ring else x
                                       for x in lens], **i32))
    outs = [torch.stack(last)]
    active = torch.ones(P, dtype=torch.bool, device=device)
    tok = outs[0].argmax(-1)
    toks = [tok]
    for _ in range(REC_DECODE_STEPS):
        logits = decode(params, st, tok.to(device), active).cpu()
        outs.append(logits)
        tok = logits.argmax(-1)
        toks.append(tok)
    return torch.stack(outs), torch.stack(toks).T.tolist(), calls


def check_rec_logits(torch, dev, name):
    """14b: ``name`` at full width and REC_CPU_LAYERS layers, fp32, random
    weights from the seed (vocabulary capped at CPU_VOCAB), on the card
    and on the CPU: prompts that span several prefill calls (the state
    carried across them), then greedy decode; the logits within
    CARD_CPU_TOL and the greedy tokens equal. Returns the max error."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import lm

    phase = f"recurrent card-vs-cpu[{name}]"
    cfg = dataclasses.replace(get_config(name), dtype="float32")
    small = dataclasses.replace(cfg, num_layers=REC_CPU_LAYERS[name],
                                vocab_size=min(cfg.vocab_size, CPU_VOCAB))
    t = time.monotonic()
    p_dev = lm.init(small, torch.Generator(dev).manual_seed(SEED), dev)
    p_cpu = _tree_to(p_dev, "cpu")
    rng = np.random.default_rng(SEED + 15)
    seqs = [[int(x) for x in rng.integers(0, small.vocab_size, n)]
            for n in REC_CPU_LENS]
    log(phase, f"{small.num_layers} layers {list(small.layer_kinds())}, "
        f"d_model {cfg.d_model}, vocabulary {small.vocab_size} (of "
        f"{cfg.vocab_size}), {lm.param_count(p_cpu) / 1e9:.2f} B params "
        f"fp32 on each side, drawn in {time.monotonic() - t:.1f} s")
    res = {}
    for side, device, params in (("cpu", "cpu", p_cpu), ("card", dev, p_dev)):
        t = time.monotonic()
        res[side] = rec_steps(torch, small, params, device, seqs)
        log(phase, f"{side}: prompts of {list(REC_CPU_LENS)} tokens in "
            f"{res[side][2]} prefill calls of {REC_PREFILL_LEN}, then "
            f"{REC_DECODE_STEPS} decode steps, in {time.monotonic() - t:.1f}"
            " s")
    a, b = res["cpu"][0], res["card"][0]
    err = (a - b).abs()
    if bool((err > CARD_CPU_TOL + CARD_CPU_TOL * a.abs()).any()):
        raise AssertionError(f"{phase}: card vs cpu logits off by "
                             f"{float(err.max()):.3e}")
    if res["cpu"][1] != res["card"][1]:
        raise AssertionError(f"{phase}: greedy tokens differ: cpu "
                             f"{res['cpu'][1]}, card {res['card'][1]}")
    log(phase, f"last prefill + {REC_DECODE_STEPS} decode steps: "
        f"max_abs_err={float(err.max()):.3e} (atol=rtol={CARD_CPU_TOL}), "
        f"greedy tokens equal ({res['card'][1][0][:8]} ...) ok")
    del p_dev, p_cpu
    gc.collect()
    torch.cuda.empty_cache()
    return float(err.max())


class RingDecodeInputs(DecodeInputs):
    """``DecodeInputs`` for a local-window serve: the lengths its next
    decode step passes are min(position + 1, ring), not seq_len + 1."""

    def __call__(self, entry):
        import numpy as np
        e = self.eng
        ring = e._ring * e.opts.block_size
        live = int(np.minimum(e.host_pos + 1, ring)[
            (e.host_bt >= 0).any(1)].sum())
        if live <= self.best_live:
            return
        st = e.state
        self.best = (st["pools"]["k"][0].clone(), st["pools"]["v"][0].clone(),
                     st["block_tables"].clone(),
                     (st["positions"] + 1).clamp(max=ring))
        self.best_live = live


def rec_serve(torch, card, z, label, prompts, sps, path, audits,
              hook=None):
    """Serve ``prompts`` through ``z`` (built under ZIPAGE_SANITIZE=1) with
    the launch counts set to 0 just before and read just after: one audit
    after every step, no violation, every kernel of ``path`` launched and
    no other, no plain version run, no compression (it is off for these
    configs), the pool whole again. Returns (launches, summary, outputs)."""
    import numpy as np
    from repro_torch.kernels import ops

    eng, cfg = z.engine, z.cfg
    audits.steps.clear()
    s0, m0 = eng.step_count, len(eng.metrics)
    replays0 = eng._graphs.replays
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t = time.monotonic()
    with PlainGuard():
        outs = z.generate(prompts, sps)
        torch.cuda.synchronize()
    wall = time.monotonic() - t
    launches = dict(ops.launch_counts)
    if hook is not None:
        hook.close()
    metrics = eng.metrics[m0:]
    steps = [m["t_total"] for m in metrics]
    n_tok = sum(len(o.token_ids) for o in outs)
    replays = eng._graphs.replays - replays0
    if audits.steps != list(range(s0 + 1, eng.step_count + 1)):
        raise AssertionError(f"{label}: {len(audits.steps)} audits over "
                             f"{eng.step_count - s0} steps")
    assert all(len(o.token_ids) == sp.max_new_tokens
               for o, sp in zip(outs, sps)), f"{label}: short output"
    assert all(o.finish_reason == "length" for o in outs)
    assert all(0 <= t < cfg.vocab_size for o in outs for t in o.token_ids)
    assert all(np.isfinite(o.logprobs).all() for o in outs
               if o.logprobs is not None)
    assert all(o.metrics.compression.n_compressions == 0 for o in outs)
    assert z.num_free_blocks == eng.opts.n_total_blocks, "blocks leaked"
    z.bm.check_invariants()
    for name in path:
        assert launches[name] > 0, f"kernel {name} never launched ({label})"
    for name, n in launches.items():
        assert name in path or n == 0, f"{name} launched off its path"
    assert replays > 0, f"no decode graph replayed ({label})"
    log(label, f"{len(prompts)} requests (prompts {[len(p) for p in prompts]}"
        f" tokens), {n_tok} tokens in {wall:.2f} s = {n_tok / wall:.1f} "
        f"tok/s over {len(steps)} steps (step median "
        f"{1e3 * statistics.median(steps):.1f} ms), decode_steps="
        f"{eng.opts.decode_steps}, {replays} graph replays, launches "
        f"{launches}; sanitizer: {len(audits.steps)} audits, 0 violations, "
        f"on {card}")
    return launches, {"tokens": n_tok, "wall_s": wall,
                      "tok_per_s": n_tok / wall, "steps": len(steps),
                      "step_median_ms": 1e3 * statistics.median(steps),
                      "decode_steps": eng.opts.decode_steps,
                      "graph_replays": replays, "launches": launches,
                      "audits": len(audits.steps), "violations": 0}, outs


def _streams(outs):
    import numpy as np
    return ([o.token_ids for o in outs],
            [np.asarray(o.logprobs).tobytes() for o in outs])


def recurrent_serve(torch, dev, card, name, errs):
    """14c / 14d: ``name`` at full width and depth in bf16 through
    ``Zipage.from_config`` under ZIPAGE_SANITIZE=1: phase 5's prompts, 8
    greedy requests of NEW_TOKENS tokens at ``decode_steps`` 1 and 8 (the
    streams and logprobs equal bit for bit); RecurrentGemma also with the
    two requests that cross its window (RG_LONG_PROMPTS: the ring wraps in
    decode and across prefill calls) and 2 requests through the dense
    decode kernel (streams equal to the ragged ones), RWKV6 with prompts
    over ``prefill_len``. Returns (summary, the K1 / B4 rows)."""
    import numpy as np
    from repro_torch.api import SamplingParams, Zipage
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ragged_paged_attention as rpa
    from repro_torch.models import lm

    phase = f"recurrent[{name}]"
    rg = name == RG_CONFIG
    t = time.monotonic()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    shapes = RG_SHAPES if rg else {}
    z = _sanitized(lambda: Zipage.from_config(name, param_seed=SEED,
                                              dtype="bfloat16", **shapes))
    torch.cuda.synchronize()
    eng, cfg = z.engine, z.cfg
    assert eng.sanitize, "the engine did not read ZIPAGE_SANITIZE"
    assert not eng.compression_enabled and not eng.prefix_ok
    n_params = lm.param_count(eng.params)
    log(phase, f"{cfg.num_layers} layers ({cfg.num_attn_layers} attention, "
        f"window {cfg.local_window}), d_model {cfg.d_model}, "
        f"{cfg.num_heads}/{cfg.num_kv_heads} heads of {cfg.head_dim}, vocab "
        f"{cfg.vocab_size}; {n_params / 1e9:.2f} B params bf16 on the card, "
        f"ready in {time.monotonic() - t:.1f} s; prefill_len "
        f"{eng.opts.prefill_len}, block_size {eng.opts.block_size}, "
        f"n_total_blocks {eng.opts.n_total_blocks}, max_model_len "
        f"{eng.opts.max_model_len}")
    prompts = make_prompts(cfg)
    rng = np.random.default_rng(SEED + 16)
    if rg:
        prompts += [[int(x) for x in rng.integers(0, cfg.vocab_size, n)]
                    for n in RG_LONG_PROMPTS]
    assert max(len(p) for p in prompts) > eng.opts.prefill_len
    sps = [SamplingParams(max_new_tokens=NEW_TOKENS, logprobs=True)] * \
        len(prompts)
    hook = RingDecodeInputs(eng) if rg else None
    served, launches = {}, {}
    with Audits() as audits:
        launches[1], served[1], outs1 = rec_serve(
            torch, card, z, f"{phase} K=1", prompts, sps,
            RG_PATH if rg else (), audits, hook)
        z8 = _sanitized(lambda: Zipage(cfg, eng.params, dtype="bfloat16",
                                       decode_steps=8, **shapes))
        launches[8], served[8], outs8 = rec_serve(
            torch, card, z8, f"{phase} K=8", prompts, sps,
            RG_PATH if rg else (), audits)
        del z8
        if _streams(outs1) != _streams(outs8):
            diff = [i for i, (a, b) in enumerate(zip(outs1, outs8))
                    if _streams([a]) != _streams([b])]
            raise AssertionError(f"{phase}: decode_steps 1 and 8 differ "
                                 f"(requests {diff})")
        log(phase, f"decode_steps 1 and 8: {len(prompts)} streams and their "
            "logprobs equal bit for bit ok")
        if rg:
            zd = _sanitized(lambda: Zipage(cfg, eng.params, dtype="bfloat16",
                                           decode_kernel="dense", **shapes))
            pick = [0, len(prompts) - 1]
            launches["dense"], served["dense"], outs_d = rec_serve(
                torch, card, zd, f"{phase} dense", [prompts[i] for i in pick],
                [sps[i] for i in pick], RG_DENSE_PATH, audits)
            del zd
            if [o.token_ids for o in outs_d] != \
                    [outs1[i].token_ids for i in pick]:
                raise AssertionError(f"{phase}: dense decode's streams are "
                                     "not the ragged ones")
            log(phase, "dense decode (B4): 2 streams equal to ragged's ok")
            wraps = [len(p) + NEW_TOKENS > cfg.local_window for p in prompts]
            log(phase, f"{sum(wraps)} requests wrap the {cfg.local_window}"
                f"-token ring (prompts {[len(p) for p, w in zip(prompts, wraps) if w]}"
                f"; one across {-(-RG_LONG_PROMPTS[1] // eng.opts.prefill_len)}"
                " prefill calls)")
    peak = torch.cuda.max_memory_allocated()
    log(phase, f"peak memory allocated {peak / 1e9:.2f} GB on {card}")
    rows = []
    if rg:
        per_serve = {n: {f"{name} K={k}": launches[k][n] for k in (1, 8)}
                     for n in (rpa.NAME, pa.NAME)}
        for n in per_serve:
            per_serve[n][f"{name} dense"] = launches["dense"][n]
        args = hook.args(torch)
        for n, serve in ((rpa.NAME, f"{name} K=1"),
                         (pa.NAME, f"{name} dense")):
            spec = decode_spec(torch, n, args)
            got = spec["kernel"]()
            max_err(torch, got, spec["plain"](), f"{n}[rg serve input]",
                    BF16_OUT_TOL)
            rows.append(dict(_row(torch, spec, per_serve, serve, errs,
                                  label=f"{n}_g10_bf16"),
                             shapes=spec["shapes"]))
    out = {"layers": cfg.num_layers, "params": n_params, "peak_bytes": peak,
           "serves": {str(k): v for k, v in served.items()},
           "k1_equals_k8": True, "phase_s": time.monotonic() - t}
    del z, eng, hook
    gc.collect()
    torch.cuda.empty_cache()
    return out, rows


def launch_serves(label, names):
    """Start ``python -m repro_torch.launch.serve --arch <name>`` for each
    of ``names`` on the card, side by side (the launcher serves a non-tiny
    arch at its reduced widths, as the JAX package's does). Returns
    {name: process}; ``collect_launches`` waits for them."""
    env = _port_env()
    return {name: subprocess.Popen(
        port_cmd("repro_torch.launch.serve", "--arch", name, "--workload",
                 "mix", "--n-requests", "8"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=ROOT) for name in names}


def collect_launches(label, procs, compressing=False):
    """Wait for ``launch_serves``' processes: each exits 0 with tokens
    served on the card, and no compression unless ``compressing``.
    Returns each one's summary."""
    out = {}
    try:
        for name, proc in procs.items():
            text, err = proc.communicate(timeout=SUBPROCESS_DEADLINE)
            if proc.returncode != 0:
                raise AssertionError(f"{label}: the launcher for {name} "
                                     f"exited {proc.returncode}: {err[-2000:]}")
            res = json.loads(text)
            assert res["tokens"] > 0, res
            assert compressing or res["compressions"] == 0, res
            assert res["device"].startswith("cuda"), res["device"]
            log(label, f"launch.serve --arch {name} (reduced widths): "
                f"{res['tokens']} tokens in {res['steps']} steps, "
                f"{res['tps']:.1f} tok/s, {res['compressions']} "
                f"compressions, on {res['device']}")
            out[name] = res
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    return out


def rec_launchers(label):
    """14e: the serving launcher for both recurrent configs on the card,
    side by side: each exits 0 with tokens served and no compression."""
    return collect_launches(label, launch_serves(
        label, (RG_CONFIG, RWKV_CONFIG)))


def phase_recurrent(torch, dev, card):
    """Phase 14: 14a K1 and B4 at RecurrentGemma's layout, 14b card vs CPU
    at a few layers of both configs, 14c RecurrentGemma-2B and 14d
    RWKV6-3B served at full width and depth, 14e the serving launcher on
    both. Returns (summary, rows)."""
    from repro_torch.configs import get_config

    took, t = {}, time.monotonic()

    def lap(what):
        nonlocal t
        took[what] = time.monotonic() - t
        t = time.monotonic()

    rcfg = get_config(RG_CONFIG)
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        errs[str(dtype)] = check_rec_kernels(torch, dev, rcfg, dtype)
    lap("14a")
    card_cpu = {n: check_rec_logits(torch, dev, n)
                for n in (RG_CONFIG, RWKV_CONFIG)}
    lap("14b")
    rg, rows = recurrent_serve(torch, dev, card, RG_CONFIG,
                               errs[str(torch.bfloat16)])
    lap("14c")
    rwkv, _ = recurrent_serve(torch, dev, card, RWKV_CONFIG, {})
    lap("14d")
    launched = rec_launchers("recurrent launch")
    lap("14e")
    log("recurrent", "passed in " + ", ".join(f"{k} {v:.1f} s"
                                              for k, v in took.items()))
    return {"kernel_errs": errs, "card_vs_cpu": card_cpu, RG_CONFIG: rg,
            RWKV_CONFIG: rwkv, "launch": launched, "took": took}, rows


# ----------------------------------------------------------------------
# phase 15: the frontend configs (Whisper-tiny, InternVL2-26B)

WHISPER, INTERNVL = "whisper-tiny", "internvl2-26b"
#: 15b: InternVL2's layers on the card and the CPU (at full width), the
#: text tokens of its two rows after their 256 patch embeddings, and the
#: decode steps after each check's prefill
VLM_CPU_LAYERS = 2
VLM_TEXT_LENS = (32, 20)
FRONT_DECODE_STEPS = 6
#: 15b: Whisper's card-vs-CPU streams, greedy, with compression firing
WHISPER_STREAM_LENS, WHISPER_STREAM_TOKENS = (70, 96, 81, 110), 48
#: 15c: the swap engine's pool, too small for the 8 requests at once
#: without compression (n_max None: the full-KV baseline; with compression
#: on, the scheduler fits them in 12 blocks without preempting), so that
#: they preempt, by recompute (Whisper's cross KV is per slot)
WHISPER_TIGHT_POOL = 32


def frontend_embeds(torch, cfg, rows, device, seed):
    """A frontend's embeddings for ``rows`` rows, drawn from ``seed``:
    {"frame_embeds": (rows, cross_seq_len, d)} for Whisper, or
    {"prefix_embeds": (rows, num_prefix_embeds, d)} for InternVL2, fp32."""
    import numpy as np
    rng = np.random.default_rng(seed)
    if cfg.is_enc_dec:
        key, n = "frame_embeds", cfg.cross_seq_len
    else:
        key, n = "prefix_embeds", cfg.num_prefix_embeds
    a = rng.normal(size=(rows, n, cfg.d_model)).astype(np.float32)
    return {key: torch.from_numpy(a).to(device)}


def frontend_steps(torch, cfg, params, device, seqs, embeds):
    """15b on one device: one paged prefill of the prompts ``seqs`` (one
    a row, after their patch prefix or over their frames: ``embeds``),
    then FRONT_DECODE_STEPS greedy decode steps, each feeding the device's
    own argmax. Returns the logits of the prefill and of each decode step
    ((n, rows, V) on the CPU) and the greedy tokens."""
    from repro_torch.core import serve_model

    P, S = len(seqs), max(len(s) for s in seqs)
    npx = cfg.num_prefix_embeds if "prefix_embeds" in embeds else 0
    b = 16
    mb = -(-(npx + S + FRONT_DECODE_STEPS) // b)
    spec = serve_model.ServeSpec(
        n_slots=P, block_size=b, max_blocks=mb, n_total_blocks=P * mb,
        m_qslots=P, window=4, prefill_rows=P, prefill_len=S,
        dtype="float32")
    st = serve_model.make_state(cfg, spec, device)
    i32 = dict(dtype=torch.int32, device=device)
    st["block_tables"].copy_(torch.arange(P * mb, **i32).reshape(P, mb))
    st["qslot"].copy_(torch.arange(P, **i32))
    lens = [npx + len(s) for s in seqs]
    st["seq_lens"].copy_(torch.tensor(lens, **i32))
    prefill = serve_model.build_prefill_step(cfg, spec)
    decode = serve_model.build_decode_step(cfg, spec)
    toks = torch.zeros((P, S), dtype=torch.int64)
    for i, s in enumerate(seqs):
        toks[i, :len(s)] = torch.tensor(s)
    logits = prefill(params, st, toks.to(device), torch.arange(P, **i32),
                     torch.tensor([len(s) for s in seqs], **i32),
                     torch.zeros(P, **i32),
                     **{k: v.to(device) for k, v in embeds.items()})
    outs = [logits.cpu()]
    st["positions"].copy_(torch.tensor(lens, **i32))
    active = torch.ones(P, dtype=torch.bool, device=device)
    tok = outs[0].argmax(-1)
    toks = [tok]
    for _ in range(FRONT_DECODE_STEPS):
        logits = decode(params, st, tok.to(device), active).cpu()
        outs.append(logits)
        tok = logits.argmax(-1)
        toks.append(tok)
    return torch.stack(outs), torch.stack(toks).T.tolist()


def _card_cpu_close(phase, a, b):
    err = (a - b).abs()
    if bool((err > CARD_CPU_TOL + CARD_CPU_TOL * a.abs()).any()):
        raise AssertionError(f"{phase}: card vs cpu logits off by "
                             f"{float(err.max()):.3e}")
    return float(err.max())


def check_frontend_logits(torch, dev, name):
    """15b: Whisper-tiny at full width and depth, or InternVL2-26B at full
    width and VLM_CPU_LAYERS layers (vocabulary capped at CPU_VOCAB),
    fp32, random weights from the seed, on the card and on the CPU: a
    paged prefill over random frames (Whisper) or after 256 random patch
    embeddings (InternVL2), then greedy decode steps; the logits within
    CARD_CPU_TOL and the greedy tokens equal. InternVL2's prefill is also
    held against the card's own ``lm.forward(prefix_embeds=)`` last-token
    logits. Returns (max error, the card's params, the CPU's)."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import lm

    phase = f"frontends card-vs-cpu[{name}]"
    cfg = dataclasses.replace(get_config(name), dtype="float32")
    small = cfg if cfg.is_enc_dec else dataclasses.replace(
        cfg, num_layers=VLM_CPU_LAYERS,
        vocab_size=min(cfg.vocab_size, CPU_VOCAB))
    t = time.monotonic()
    p_dev = lm.init(small, torch.Generator(dev).manual_seed(SEED), dev)
    p_cpu = _tree_to(p_dev, "cpu")
    rng = np.random.default_rng(SEED + 17)
    lens = (45, 60) if cfg.is_enc_dec else VLM_TEXT_LENS
    seqs = [[int(x) for x in rng.integers(0, small.vocab_size, n)]
            for n in lens]
    embeds = frontend_embeds(torch, small, len(seqs), "cpu", SEED + 18)
    what = {k: tuple(v.shape) for k, v in embeds.items()}
    log(phase, f"{small.num_layers} of {cfg.num_layers} layers"
        + (f" (+ {cfg.encoder_layers} encoder layers)" if cfg.is_enc_dec
           else "") + f", d_model {cfg.d_model}, {cfg.num_heads}/"
        f"{cfg.num_kv_heads} heads of {cfg.head_dim}, vocabulary "
        f"{small.vocab_size} (of {cfg.vocab_size}), "
        f"{lm.param_count(p_cpu) / 1e9:.3f} B params fp32 on each side, "
        f"drawn in {time.monotonic() - t:.1f} s; {what}")
    res = {}
    for side, device, params in (("cpu", "cpu", p_cpu), ("card", dev, p_dev)):
        t = time.monotonic()
        res[side] = frontend_steps(torch, small, params, device, seqs, embeds)
        log(phase, f"{side}: prefill of {list(lens)} tokens, then "
            f"{FRONT_DECODE_STEPS} decode steps, in "
            f"{time.monotonic() - t:.1f} s")
    err = _card_cpu_close(phase, res["cpu"][0], res["card"][0])
    if res["cpu"][1] != res["card"][1]:
        raise AssertionError(f"{phase}: greedy tokens differ: cpu "
                             f"{res['cpu'][1]}, card {res['card'][1]}")
    log(phase, f"prefill + {FRONT_DECODE_STEPS} decode steps: "
        f"max_abs_err={err:.3e} (atol=rtol={CARD_CPU_TOL}), greedy tokens "
        f"equal ({res['card'][1][0]}) ok")
    if not cfg.is_enc_dec:
        pe = embeds["prefix_embeds"].to(dev)
        for i, s in enumerate(seqs):
            fwd = lm.forward(small, p_dev, torch.tensor([s], device=dev),
                             prefix_embeds=pe[i:i + 1])[0, -1].float().cpu()
            e = _card_cpu_close(f"{phase} forward vs prefill",
                                fwd, res["card"][0][0, i])
            log(phase, f"row {i}: {small.num_prefix_embeds} patch embeddings"
                f" + {len(s)} tokens, the card's lm.forward(prefix_embeds=) "
                f"last-token logits vs its paged prefill: max_abs_err="
                f"{e:.3e} ok")
    return err, p_dev, p_cpu


def check_frontend_streams(torch, dev, small, p_cpu, p_dev, phase):
    """15b: greedy streams of ``small`` through the facade (engine
    defaults but 4 slots, compression firing), card against CPU; the CPU
    serve records its near-ties (``TieRecorder``), and a stream that parts
    is excused only at a gap or margin under TIE_TOL where it parts."""
    import numpy as np
    from repro_torch.api import SamplingParams, Zipage

    rng = np.random.default_rng(SEED + 19)
    prompts = [[int(x) for x in rng.integers(0, small.vocab_size, n)]
               for n in WHISPER_STREAM_LENS]
    sp = SamplingParams(max_new_tokens=WHISPER_STREAM_TOKENS)
    outs = {}
    rec = TieRecorder()

    def serve(device, params):
        z = Zipage(small, params, device=device, max_batch=4)
        assert z.engine.compression_enabled and not z.engine.prefix_ok
        return z.generate(prompts, sp)

    for side, device, params in (("cpu", "cpu", p_cpu), ("card", dev, p_dev)):
        t = time.monotonic()
        if side == "cpu":
            with rec:                 # the engine is built under it
                outs[side] = serve(device, params)
        else:
            outs[side] = serve(device, params)
        n_comp = [o.metrics.compression.n_compressions for o in outs[side]]
        if min(n_comp) == 0:
            raise AssertionError(f"{phase}: {side}: a request never "
                                 f"compressed ({n_comp})")
        log(phase, f"{side}: {len(prompts)} greedy requests of "
            f"{WHISPER_STREAM_TOKENS} tokens in {time.monotonic() - t:.1f} s,"
            f" compressions {n_comp}")
    excused = []
    for i, (a, b) in enumerate(zip(outs["cpu"], outs["card"])):
        pos = first_difference(a.token_ids, b.token_ids)
        if pos is None:
            continue
        why = rec.explain(0, a.request_id, pos)
        if why is None:
            raise AssertionError(f"{phase}: stream {i} parts at token {pos} "
                                 f"with no near-tie: cpu {a.token_ids} card "
                                 f"{b.token_ids}")
        excused.append((i, pos, why))
    log(phase, f"{len(prompts)} greedy streams of {WHISPER_STREAM_TOKENS} "
        f"tokens: card == cpu" + (f" but {excused} (near-ties)" if excused
                                  else " for all") + " ok")
    return {"excused": excused}


def check_cross_graph(torch, dev, small, p_dev):
    """A fused decode chunk of 4 of the encoder-decoder ``small`` captured
    as a CUDA graph, then the slots' cross-attention KV rewritten in place
    by a prefill over new frames (rows of no tokens: only ``cross_kv``
    changes), then the chunk replayed and run eagerly on clones of one
    state: tokens, logprobs and the state (``cross_kv`` included) the same
    bits, and the logprobs not those of the state before the prefill (the
    replay read the new cross KV)."""
    from repro_torch.core import serve_model
    from repro_torch.core.decode_graphs import DecodeGraphs

    spec = serve_model.ServeSpec(n_slots=8, block_size=16, max_blocks=8,
                                 n_total_blocks=40, m_qslots=4, window=4,
                                 prefill_rows=2, prefill_len=16,
                                 dtype=small.dtype)
    st0 = _graph_state(torch, dev, small, spec, SEED + 20)
    g = torch.Generator(device=dev).manual_seed(SEED + 21)
    for t in st0["cross_kv"].values():
        t.normal_(generator=g)
    i32 = dict(dtype=torch.int32, device=dev)
    inp = [torch.zeros((), **i32), torch.full((8,), 8, **i32),
           torch.zeros(8, dtype=torch.int64, device=dev),
           torch.zeros(8, device=dev), torch.zeros(8, **i32),
           torch.ones(8, device=dev),
           torch.full((8, 1), -1, dtype=torch.int64, device=dev)]
    fused = serve_model.build_fused_decode_step(small, spec, 4, greedy=True)
    prefill = serve_model.build_prefill_step(small, spec)
    before, eager, replayed = (_tree_clone(st0) for _ in range(3))
    graphs = DecodeGraphs(lambda k, gr: fused(p_dev, replayed, *inp), inp[1])
    graphs.capture(4, True, 1)
    frames = frontend_embeds(torch, small, 2, dev, SEED + 22)
    for st in (eager, replayed):
        prefill(p_dev, st, torch.zeros((2, 16), dtype=torch.int64,
                                       device=dev),
                torch.tensor([1, 3], **i32), torch.zeros(2, **i32),
                torch.zeros(2, **i32), **frames)
    if bool(torch.equal(eager["cross_kv"]["k"], st0["cross_kv"]["k"])):
        raise AssertionError("cross graphs: the prefill left cross_kv as it "
                             "was")
    outs = {"before": fused(p_dev, before, *inp),
            "eager": fused(p_dev, eager, *inp),
            "graph": [t.clone() for t in graphs.replay(4, True, 1)]}
    torch.cuda.synchronize()
    pairs = [("tokens", outs["eager"][0], outs["graph"][0]),
             ("logprobs", outs["eager"][1], outs["graph"][1])]
    for name in ("seq_lens", "positions", "tokens_next"):
        pairs.append((name, eager[name], replayed[name]))
    for name in ("k", "v"):
        pairs.append((f"pools[{name}]", eager["pools"][name][:, :-1],
                      replayed["pools"][name][:, :-1]))
        pairs.append((f"cross_kv[{name}]", eager["cross_kv"][name],
                      replayed["cross_kv"][name]))
    for name, a, b in pairs:
        if not bool(torch.equal(_bits(torch, a), _bits(torch, b))):
            raise AssertionError(f"cross graphs: {name} differs between "
                                 "eager and replay")
    moved = [int(r) for r in range(8) if not bool(torch.equal(
        outs["before"][1][:, r], outs["eager"][1][:, r]))]
    if not {1, 3} <= set(moved):
        raise AssertionError(f"cross graphs: rows {moved} read the new cross "
                             "KV, expected 1 and 3")
    log("cross graphs", f"chunk of 4 at {small.num_layers} layers of "
        f"{small.name}, {small.dtype}: captured, cross_kv of slots 1 and 3 "
        "rewritten in place by a prefill, then replay == eager bit for bit "
        f"(tokens, logprobs, pools, cross_kv); rows {moved} changed "
        "against the old cross KV ok")


def frontend_rows(torch, name, rec, per_serve, serve, errs, tag):
    """The kernels-line rows of a frontend serve: K1 at its fullest decode
    state (``DecodeInputs``), held against its plain version there first,
    and for Whisper K2 (held against plain too), K3 and B6 at its recorded
    calls whose live work is largest (bf16), named ``<kernel>_<tag>``."""
    def pick(op, key):
        return _pick(rec.calls[op], key)

    def comp_live(a):
        return _live_entries(a[1], a[2], a[0].shape[1])

    def score_live(a):
        return _live_entries(a[2], a[3], a[1].shape[1])

    specs = [decode_spec(torch, "ragged_paged_attention", rec.decode_args)]
    if name == WHISPER:
        specs += [score_spec(torch, *pick("score_logits", score_live)),
                  redundancy_spec(torch, "lightning_redundancy",
                                  *pick("lightning_redundancy", comp_live)),
                  compaction_spec(torch, pick("compact", _live_rows)[0])]
    rows = []
    for spec in specs:
        if spec["name"] in ("ragged_paged_attention", "paged_score"):
            tol = BF16_OUT_TOL if spec["name"] == "ragged_paged_attention" \
                else BF16_TOL
            e = max_err(torch, spec["kernel"](), spec["plain"](),
                        f"{spec['name']}[{tag} serve input]", tol)
            errs[spec["name"]] = max(errs.get(spec["name"], 0.0), e)
        rows.append(dict(_row(torch, spec, per_serve, serve, errs,
                              label=f"{spec['name']}_{tag}"),
                         shapes=spec["shapes"]))
    return rows


def whisper_swap(torch, card, cfg, params, prompts, sps, audits):
    """15c: ``preemption_mode="swap"`` on Whisper warns and preempts by
    recompute, as the JAX engine does (the cross KV is per slot): on a
    pool of WHISPER_TIGHT_POOL blocks without compression the 8 requests
    preempt, every one still runs to its length, the sanitizer reports
    nothing, and the pool drains clean."""
    import warnings

    from repro_torch.api import Zipage

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        z = _sanitized(lambda: Zipage(cfg, params, dtype="bfloat16",
                                      preemption_mode="swap",
                                      swap_space_blocks=24, n_max=None,
                                      n_total_blocks=WHISPER_TIGHT_POOL))
    if not any("cannot swap" in str(w.message) for w in caught):
        raise AssertionError("whisper swap: no warning that it cannot swap")
    eng = z.engine
    assert eng.scheduler.p.preemption_mode == "recompute"
    assert eng.swap_pool is None and eng.bm.swap_space_blocks == 0
    audits.steps.clear()
    s0, m0 = eng.step_count, len(eng.metrics)
    outs = z.generate(prompts, sps)
    torch.cuda.synchronize()
    if audits.steps != list(range(s0 + 1, eng.step_count + 1)):
        raise AssertionError("whisper swap: a step went unaudited")
    n_pre = sum(m["n_preempted"] for m in eng.metrics[m0:])
    assert all(len(o.token_ids) == sp.max_new_tokens
               for o, sp in zip(outs, sps)), "whisper swap: short output"
    if n_pre == 0:
        raise AssertionError(f"whisper swap: {WHISPER_TIGHT_POOL} blocks "
                             "never preempted")
    z.bm.check_invariants()
    if z.num_free_blocks != WHISPER_TIGHT_POOL:
        raise AssertionError("whisper swap: blocks leaked")
    log("frontends whisper swap", f"preemption_mode='swap' warned and "
        f"recomputes: {n_pre} preemptions on a pool of "
        f"{WHISPER_TIGHT_POOL} blocks (no compression), {len(outs)} "
        f"requests to their length, {len(audits.steps)} audits, 0 "
        f"violations, pool drained clean, on {card} ok")
    del z, eng
    return n_pre


def frontend_serve(torch, card, name, errs_bf16):
    """15c / 15d: ``name`` at full width and depth in bf16 through
    ``Zipage.from_config`` at the engine defaults under ZIPAGE_SANITIZE=1,
    with compression on as the JAX engine runs it: phase 5's prompts, 8
    greedy requests of NEW_TOKENS tokens with logprobs (``run_serve``:
    compression fires, every compression goes through B6, K1, K2, K3 and
    B6 launch, no plain version runs, the sanitizer reports nothing), and
    again at ``decode_steps`` 8 (streams and logprobs equal bit for bit).
    Whisper also serves 2 requests through dense decode and flash
    redundancy and checks that swap warns and recomputes. Returns
    (summary, rows)."""
    from repro_torch.api import SamplingParams, Zipage
    from repro_torch.core.compression import CompressOptions
    from repro_torch.models import lm

    phase = f"frontends[{name}]"
    whisper = name == WHISPER
    tag = "whisper_bf16" if whisper else "internvl2_bf16"
    took, t = {}, time.monotonic()

    def lap(what):
        nonlocal t
        took[what] = time.monotonic() - t
        t = time.monotonic()

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    z = _sanitized(lambda: Zipage.from_config(name, param_seed=SEED,
                                              dtype="bfloat16"))
    torch.cuda.synchronize()
    eng, cfg = z.engine, z.cfg
    assert eng.sanitize, "the engine did not read ZIPAGE_SANITIZE"
    assert eng.compression_enabled and eng.prefix_ok == (not whisper)
    assert ("cross_kv" in eng.state) == whisper
    n_params = lm.param_count(eng.params)
    log(phase, f"{cfg.num_layers} layers"
        + (f" + {cfg.encoder_layers} encoder layers over {cfg.cross_seq_len}"
           " frames (zero frame embeddings, as the JAX engine)" if whisper
           else f" (the backbone, served on text)") + f", d_model "
        f"{cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads of "
        f"{cfg.head_dim} (g = {cfg.num_heads // cfg.num_kv_heads}), vocab "
        f"{cfg.vocab_size}; {n_params / 1e9:.3f} B params bf16 on the card")
    lap("build")
    prompts = make_prompts(cfg)
    sps = [SamplingParams(max_new_tokens=NEW_TOKENS, logprobs=True)] * \
        N_REQUESTS
    served, launches = {}, {}
    with Audits() as audits:
        rec, launches[1], served[1], outs1 = sanitized_serve(
            torch, card, z, f"{phase} K=1 sanitized", prompts, sps,
            MAIN_PATH, audits)
        lap("serve")
        z8 = _sanitized(lambda: Zipage(cfg, eng.params, dtype="bfloat16",
                                       decode_steps=8))
        _, launches[8], served[8], outs8 = sanitized_serve(
            torch, card, z8, f"{phase} K=8 sanitized", prompts, sps,
            MAIN_PATH, audits)
        del z8
        if _streams(outs1) != _streams(outs8):
            diff = [i for i, (a, b) in enumerate(zip(outs1, outs8))
                    if _streams([a]) != _streams([b])]
            raise AssertionError(f"{phase}: decode_steps 1 and 8 differ "
                                 f"(requests {diff})")
        log(phase, f"decode_steps 1 and 8: {len(prompts)} streams and their "
            "logprobs equal bit for bit ok")
        lap("serve K=8")
        if whisper:
            zd = _sanitized(lambda: Zipage(
                cfg, eng.params, dtype="bfloat16", decode_kernel="dense",
                compress=CompressOptions(window=eng.opts.window,
                                         redundancy="flash")))
            _, launches["dense"], served["dense"], _ = sanitized_serve(
                torch, card, zd, f"{phase} dense+flash sanitized",
                prompts[:2], sps[:2], ALG34_PATH, audits)
            del zd
            lap("serve dense+flash")
            served["swap"] = {"preemptions": whisper_swap(
                torch, card, cfg, eng.params, prompts, sps, audits)}
            lap("swap")
    peak = torch.cuda.max_memory_allocated()
    total = torch.cuda.get_device_properties(0).total_memory
    if peak >= total:
        raise AssertionError(f"{phase}: peak {peak} of {total} bytes")
    log(phase, f"peak memory allocated {peak / 1e9:.2f} GB of "
        f"{total / 1e9:.2f} GB on {card}")
    per_serve = {}
    for k, counts in launches.items():
        for n, c in counts.items():
            per_serve.setdefault(n, {})[f"{name} K={k}" if k in (1, 8)
                                        else f"{name} {k}"] = c
    rows = frontend_rows(torch, name, rec, per_serve, f"{name} K=1",
                         dict(errs_bf16), tag)
    del rec
    lap("timing")
    out = {"layers": cfg.num_layers, "params": n_params, "peak_bytes": peak,
           "serves": {str(k): v for k, v in served.items()},
           "k1_equals_k8": True, "took": took}
    del z, eng
    gc.collect()
    torch.cuda.empty_cache()
    return out, rows


def phase_frontends(torch, dev, card):
    """Phase 15: 15a the six kernels at Whisper's layout (g 1, h_kv 6,
    d 64) in fp32 and bf16, 15b card vs CPU (Whisper at full width and
    depth, InternVL2 at full width and 2 layers with 256 patch embeddings)
    and a graph-replayed Whisper chunk across a cross-KV rewrite, 15c
    Whisper-tiny and 15d InternVL2-26B served at full width and depth in
    bf16, 15e the serving launcher on both (started with 15b, collected
    after it). Returns (summary, rows)."""
    from repro_torch.configs import get_config
    from repro_torch.core.engine import EngineOptions

    took, t = {}, time.monotonic()

    def lap(what):
        nonlocal t
        took[what] = time.monotonic() - t
        t = time.monotonic()

    wcfg = dataclasses.replace(get_config(WHISPER), dtype="float32")
    opts = EngineOptions()
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        tag = "" if dtype == torch.float32 else " bf16"
        errs[str(dtype)] = phase_kernels(
            torch, dev, wcfg, opts, phase=f"frontends kernels{tag}[{WHISPER}"
            f": g = 1, h_kv = {wcfg.num_kv_heads}, d = {wcfg.head_dim}]",
            dtype=dtype)
        torch.cuda.empty_cache()
    lap("15a")
    launchers = launch_serves("frontends launch", (WHISPER, INTERNVL))
    card_cpu = {}
    card_cpu[WHISPER], p_dev, p_cpu = check_frontend_logits(torch, dev,
                                                            WHISPER)
    streams = check_frontend_streams(torch, dev, wcfg, p_cpu, p_dev,
                                     f"frontends card-vs-cpu[{WHISPER}]")
    check_cross_graph(torch, dev, wcfg, p_dev)
    del p_dev, p_cpu
    card_cpu[INTERNVL], p_dev, p_cpu = check_frontend_logits(torch, dev,
                                                             INTERNVL)
    del p_dev, p_cpu
    gc.collect()
    torch.cuda.empty_cache()
    lap("15b")
    launched = collect_launches("frontends launch", launchers,
                                compressing=True)
    lap("15e")
    whisper, rows = frontend_serve(torch, card, WHISPER,
                                   errs[str(torch.bfloat16)])
    lap("15c")
    vlm, rows_vlm = frontend_serve(torch, card, INTERNVL,
                                   errs[str(torch.bfloat16)])
    lap("15d")
    log("frontends", "passed in " + ", ".join(f"{k} {v:.1f} s"
                                              for k, v in took.items()))
    return {"kernel_errs": errs, "card_vs_cpu": card_cpu,
            "whisper_streams": streams, WHISPER: whisper, INTERNVL: vlm,
            "launch": launched, "took": took}, rows + rows_vlm


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    try:
        from repro_torch.configs import get_config
        from repro_torch.core.engine import EngineOptions
        from repro_torch.device import resolve_device
        from repro_torch.kernels import native
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return 2
    dev = resolve_device("cuda")
    t0 = time.monotonic()
    took = {}

    def lap(name):
        took[name] = time.monotonic() - t0 - sum(took.values())

    card = phase_env(torch, native)
    phase_build(native)
    lap("env+build")
    cfg = dataclasses.replace(get_config("qwen3-8b"), dtype="float32")
    opts = EngineOptions()
    errs, errs_bf16 = {}, {}
    for dtype, worst in ((torch.float32, errs), (torch.bfloat16, errs_bf16)):
        tag = "" if dtype == torch.float32 else " bf16"
        worst.update(phase_kernels(torch, dev, cfg, opts,
                                   phase=f"kernels{tag}", dtype=dtype))
        for name in LAYOUT_CONFIGS:
            lcfg = get_config(name)
            g = lcfg.num_heads // lcfg.num_kv_heads
            e = phase_kernels(torch, dev, dataclasses.replace(
                lcfg, dtype="float32"), opts, phase=f"kernels{tag}[{name}: "
                f"g = {g}, h_kv = {lcfg.num_kv_heads}]", dtype=dtype)
            worst.update({k: max(v, e[k]) for k, v in worst.items()})
            torch.cuda.empty_cache()
    lap("kernels")
    phase_card_vs_cpu(torch, dev, cfg)
    phase_card_vs_cpu_configs(torch, dev)
    lap("card-vs-cpu")
    phase_card_vs_cpu_bf16(torch, dev, cfg)
    lap("card-vs-cpu bf16")
    z, rec, launches, summary, main_outs = phase_serve(torch, card)
    lap("serve")
    z34, rec34, launches34, summary34 = phase_serve_alg34(torch, card, z)
    lap("serve-alg34")
    rows = phase_timing(torch, rec, rec34, launches, launches34, errs)
    del z34, rec34, rec
    torch.cuda.empty_cache()
    phase_long(torch, dev, cfg, opts, rows)
    torch.cuda.empty_cache()
    lap("timing")
    rows_bf16, bf16 = phase_bf16(torch, dev, card, z, main_outs, errs_bf16)
    lap("bf16")
    rows_fp16, fp16 = phase_fp16(torch, dev, card, z, main_outs)
    lap("fp16")
    prof = phase_profile(torch, z, card)
    lap("profile")
    paired = phase_paired(torch, card, z)
    lap("paired")
    served = phase_http(torch, card, z, main_outs, prof)
    lap("http")
    memory = phase_memory(torch, card, z, rows)
    lap("memory")
    del z                     # Qwen3-8B's weights make room for phase 8's
    gc.collect()
    torch.cuda.empty_cache()
    dense = phase_dense(torch, card, rows)
    lap("dense")
    train_eval = phase_train_eval(torch, dev, card, rows)
    lap("train+eval")
    moe_mla, rows_mla = phase_moe_mla(torch, dev, card, rows_bf16)
    lap("moe+mla")
    recurrent, rows_rec = phase_recurrent(torch, dev, card)
    lap("recurrent")
    frontends, rows_front = phase_frontends(torch, dev, card)
    lap("frontends")
    log("done", f"all phases passed in {time.monotonic() - t0:.1f} s ("
        + ", ".join(f"{k} {v:.1f} s" for k, v in took.items()) + ")")
    os.makedirs(ROOT / "chiprun_out", exist_ok=True)
    with open(ROOT / "chiprun_out" / "chip_smoke.json", "w") as f:
        json.dump({"card": card, "serve": summary, "serve_alg34": summary34,
                   "kernels": rows + rows_bf16 + rows_fp16 + rows_mla
                   + rows_rec + rows_front,
                   "profile": prof,
                   "paired": paired, "http": served, "memory": memory,
                   "bf16": bf16, "fp16": fp16,
                   "dense": dense, "train_eval": train_eval,
                   "moe_mla": moe_mla, "recurrent": recurrent,
                   "frontends": frontends,
                   "took_s": took}, f, indent=1)
    print(json.dumps({"kernels": rows + rows_bf16 + rows_fp16 + rows_mla
                      + rows_rec + rows_front}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
