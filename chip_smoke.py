#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero with no ``ok``
line):

1. device  — the card's name and power limit (``nvidia-smi``); build every
             CUDA source under ``src/repro_torch/kernels/csrc`` (one ``nvcc``
             each, all started together) and print the build seconds.
2. kernels — the scheduling chain's latency probe (the least time of one
             dependent ARRIVAL step and one FINISH/EVICT step on this card,
             the sched kernels' bound); each kernel against its plain
             PyTorch version on the same tensors on the card:
             ``sched_events`` and ``sched_step`` bitwise at F=40, W=1600,
             R=1024 (the path's chunk) and R=4096, with ns/event, and
             ``sched_events`` at W=100,000 (the large-state path);
             ``ssd_scan`` at mamba2-130m width (H=24, P=64, N=128,
             chunk=256) in float32 to atol=1e-4, rtol=1e-3 and in bfloat16
             to atol=rtol=5e-2, and with ngroups G=2 in float32, and at
             zamba2-2.7b width (H=80, P=64, N=64) in float32;
             ``ssd_scan_bwd`` from the forward kernel's scratch at the train
             shape (B=2, S=1,024) of mamba2-130m and of zamba2-2.7b, each in
             float32 (atol=1e-4, rtol=1e-3) and bfloat16 (5e-2), and at G=2
             with an initial state and a final state's gradient, against
             ``ssd_scan_bwd_ref`` and bit for bit across two runs, timed in
             CUDA events around back-to-back calls (no library call computes
             it);
             ``flash_attention`` at minicpm-2b prefill
             (B=1, S=1024, H=KH=36, hd=64, causal) and gemma3-4b width
             (S=2048, H=8, KH=4, hd=256, causal, with and without window
             1024), and ``decode_attention`` at both widths over a 2,048-long
             cache (valid_len 1,024 and 2,047, with and without the window,
             each as a Python int and as a 0-d int32 tensor on the card),
             in float32 to atol=rtol=2e-5 and in bfloat16 to 2e-2; then one
             ``decode_attention`` call with a tensor valid_len captured in a
             CUDA graph at each width and replayed with valid_len 7, 2,047
             and 1,500, each replay against the plain version; and
             ``decode_attention`` at the batch phase's shapes (llava width,
             B=8, seeded (B,) lengths, q in bfloat16) with a bfloat16 and
             an fp8 cache, to 2e-2.  Median times in CUDA events: the sched
             kernels around 10 back-to-back calls;
             ``ssd_scan``, the attention kernels, their plain versions and
             one ``scaled_dot_product_attention`` call (the library
             yardstick, timed here and never called by the port) from CUDA
             graphs of back-to-back calls, decode over 8 caches in turn so
             that its reads miss the L2 cache (``decode_timing``, which
             also prints the device time by kernel of one replay of that
             graph, from ``torch.profiler``; ``decode_batch_timing`` at the
             batch shapes, SDPA there on a bfloat16 copy of the cache).
             The shapes of the hybrid and moe paths, each against its plain
             version and timed the same way: ``flash_attention`` at
             zamba2-2.7b prefill (S=1024, H=KH=32, hd=80, float32) and
             mixtral-8x22b prefill (S=512, H=48, KH=8, hd=128, window 4096,
             bfloat16), ``decode_attention`` at zamba2-2.7b width (float32,
             2,048-long cache) and mixtral-8x22b batch width (B=8, H=48,
             KH=8, hd=128, bfloat16, window 4096).
3. sched   — the main scheduling path: ``sched_many_fused`` (chunk 1024)
             and ``sched_many_adaptive`` on a 65,536-event seeded stream at
             W=1600, F=40, both bitwise equal to ``sched_many`` on the CPU,
             with the events each kernel carried (from the stream's kinds and
             each run's chunks); then one fused run under
             ``torch.profiler``: the device's busy share and the scheduling
             kernels' share of it.
4. serve   — the main serving path: a ``ServingEngine`` on the card with
             three full-width mamba2-130m endpoints (24 layers, d_model 768,
             vocab 50280; random weights from seeds 0-2), 2 workers, hiku;
             8 requests with 1,024-token seeded prompts, gen_len 8.  A cold
             start materialises the weights and captures the decode step
             in a CUDA graph (one eager call first); every decode step is
             one replay.  Checks cold-then-warm on the same worker, that
             every prefill went through the ``ssd_scan`` kernel (24 launches
             each), 7 replays per request, and one request's replayed tokens
             against the eager loop's on the card and its logits and tokens
             against the plain path on the CPU.
5. dense   — the dense serving path: a ``ServingEngine`` on the card with
             three full-width minicpm-2b endpoints (40 layers, d_model 2304,
             vocab 122,753; random weights from seeds 0-2, max_cache_len
             2048, a 32 GiB pool per worker), 2 workers, hiku; the same 8
             requests with 1,024-token prompts, gen_len 8, decode captured
             as in phase 4.  Checks cold-then-warm, exactly 40
             ``flash_attention`` launches per prefill and 40
             ``decode_attention`` launches per replayed step (7 per request)
             and per cold start's eager call, and one request with a
             128-token prompt: replayed against eager tokens on the card,
             and against the plain path on the CPU.
6. launcher — ``repro_torch.launch.serve.main`` on the card with its tiny
             endpoints and ``--fail-at 2``.
7. profile — where a warm request's time goes, for mamba2-130m and for
             minicpm-2b: prefill and request time on the host clock; device
             time by kernel of one traced warm prefill and of one traced
             warm request, and the device's busy share, from
             ``torch.profiler`` ("not measured" if it sees none).
8. hybrid  — after the engines above are freed, a ``ServingEngine`` with
             three full-width zamba2-2.7b endpoints (54 Mamba2 layers,
             d_model 2560, 80 SSM heads of 64, d_state 64; 2 shared
             attention blocks of 32 heads x 80 applied 9 times; vocab
             32,000; 2.24 B parameters in float32 from seeds 0-2,
             max_cache_len 2048, a 32 GiB pool per worker), 2 workers, hiku,
             the same 8 requests.  Checks cold-then-warm, exactly 54
             ``ssd_scan`` and 9 ``flash_attention`` launches per prefill, 9
             ``decode_attention`` per cold start's eager call and per
             replay, 7 replays a request, one 128-token request against the
             plain path on the CPU; then profiles a warm request as in 7.
9. batch   — the continuous-batching path, after the engines above are
             freed: full-width llava-next-mistral-7b (32 layers, d_model
             4096, 32 heads / 8 kv heads of 128, d_ff 14,336, vocab 32,000;
             7.24 B parameters in bfloat16 from seed 0) behind a
             ``ContinuousBatcher`` of 8 slots x 1,024 positions; 16 seeded
             requests (prompts of 16-512 tokens, 8-64 new tokens) with a
             bfloat16 cache and then an fp8 one, each step one replay of
             the captured step.  Checks 32 ``decode_attention`` launches per
             replay, one replay per step, every request complete, step 200
             against the plain per-row path on the card (each layer's
             attention to 2e-2, the logits to a relative L2 of 2e-2), the
             fp8 cache's bytes half the bf16 cache's, and a solo request's
             tokens against the same request's beside 15 others; prints
             steps/s, tokens/s, ms a step, the device's idle share over 16
             traced steps and the peak device memory.
10. moe    — after the llava model is freed: mixtral-8x22b at full width,
             8 of its 56 layers (d_model 6144, 48 / 8 heads of 128, window
             4096, 8 experts top-2 of d_ff 16,384, vocab 32,768; 20.44 B
             parameters in bfloat16 from seed 0, router float32) behind the
             same batcher with a bfloat16 cache and the same 16 requests,
             with phase 9's checks (8 ``decode_attention`` a replay; the
             plain path at step 200 takes the kernel path's routing, since
             a top-2 choice flips on a last-bit difference); then a
             512-token prefill at B=1 (capacity 160 an expert), twice:
             exactly 8 ``flash_attention`` launches each, the last logits
             against the plain path (same routing) to a relative L2 of 2e-2,
             the assignments dropped per layer.
11. mla    — after the mixtral model is freed: deepseek-v3 at full width,
             4 of its 61 layers (its 3 dense layers and 1 MoE layer; d_model
             7168, 128 heads, MLA q_lora 1536 / kv_lora 512, qk 128 + 64, v
             128; 256 experts top-8 of d_ff 2048, sigmoid router, 1 shared
             expert; dense d_ff 18,432; vocab 129,280; MTP depth 1): 31.6 GB
             in bfloat16 from seed 0 (norms and router float32). One
             endpoint (``param_dtype=torch.bfloat16``, so a bfloat16
             latent cache, ``max_cache_len`` 2048) behind a ``ServingEngine`` with hiku and 2 workers, 4
             requests of 1,024 tokens, gen_len 8 (one cold): exactly 4
             ``flash_attention`` at (192, 128) a prefill and 4
             ``decode_attention_latent`` a replay; a 128-token request's
             replayed tokens against the eager loop's, and its prefill
             logits against the same weights' plain path on the CPU
             (bfloat16, the card's routing shared, to a row relative L2 of
             2e-2; the CPU's own routing printed beside); the warm request
             profiled as in 7; then the batch phase's batcher (8 slots x
             1,024, bf16 latent cache, the same 16 requests) with its
             checks on the latent kernel (4 a replay). Phase 2 also holds
             ``flash_attention`` at deepseek-v3 prefill (B=1, S=1024,
             H=KH=128, q/k 192, v 128 strided, bfloat16) and the latent
             decode at the engine's shape (B=1, bfloat16 cache of 2,048,
             valid_len 1,024) and the batcher's (B=8, bfloat16 cache, seeded
             lengths) against their plain versions, each timed with SDPA
             beside (on [c | r] joined once, for the latent decode).
12. whisper — after the deepseek model is freed: whisper-small whole (12
             encoder and 12 decoder layers, d_model 768, 12 heads of 64,
             d_ff 3072, vocab 51,865; 209.7 M parameters in float32 from
             seeds 0-2, position tables of 2,048 rows), three endpoints
             behind a ``ServingEngine`` with hiku and 2 workers, the 8
             requests of ``ORDER`` with 440-token prompts and gen_len 8 (440
             + 8 tokens fill whisper's text context of 448 positions; the
             encoder runs over 440 zero frames and decode cross-attends to
             8 rows of zero memory, as the reference's ``Instance`` does):
             exactly 36 ``flash_attention``
             a prefill (12 encoder, bidirectional; 12 self; 12 cross) and 24
             ``decode_attention`` a replay (12 self, 12 cross) and a cold
             start's eager call, one request against the CPU plain path
             (logits within TOL_LOGITS) and profiled as in 7.  Then the
             audio part on the first endpoint's weights: seeded frames of
             T=1,500 (30 s of audio) through ``Model.prefill`` with prompts
             of S=4 and 440 (cross-attention at Sk != S) and 8 greedy
             decode steps over the encoded memory, each against the CPU
             plain path (logits within TOL_LOGITS at every step, the same
             tokens), and the device time of one prefill at B=8; then the
             batch phase's batcher (8 slots x 1,024, float32 cache, 1,500
             rows of zero memory, the same 16 requests) with its checks (24
             ``decode_attention`` a replay).  Phase 2 also holds every
             attention of these three parts at its own shape (12 heads of
             64, float32), each against its plain version and timed with
             SDPA beside: ``flash_attention`` at the serve prefill (B=1,
             S=Sk=440, bidirectional and causal), at the audio prefills
             (encoder S=1,500 bidirectional, also in bfloat16; self S=4
             causal; cross S=440 and S=4 over Sk=1,500; and the same at B=8),
             and ``decode_attention`` at B=1 over a 2,048-row cache, over 8
             and over 1,500 memory rows, and at B=8 over the batcher's
             1,024-row cache (seeded lengths) and 1,500 memory rows.

13. train  — after the whisper model is freed, five models at full
             width in float32, each freed before the next, with ``remat``
             and AdamW on one Markov-LM batch of 2 x 1,024 tokens
             (``MarkovLM`` seed 0; lr 5e-4, the model's schedule, no
             warmup), weights from a seeded generator: minicpm-2b (40
             layers, d_model 2304, 36 heads of 64, vocab 122,753; 2.72 B
             parameters), mamba2-130m whole (24 layers, d_model 768, vocab
             50,280), zamba2-2.7b whole (54 Mamba2 layers, 2 shared blocks
             of 32 heads x 80 applied 9 times, vocab 32,000; 2.47 B
             parameters), mixtral-8x22b cut to 1 of its 56 layers (48 / 8
             heads of 128 under the 4,096 window, 8 experts of 16,384
             top-2, vocab 32,768; 2.91 B parameters) and deepseek-v3 cut to
             2 of its 61 layers, one dense (d_ff 18,432) and one MoE layer
             whose routed experts are cut from 256 to 16 (MLA with q/k heads
             of 192 and v heads of 128, v read at a head stride; top-8 of
             width 2,048, sigmoid router, 1 shared expert; MTP depth 1;
             vocab 129,280; 4.06 B parameters).  For each: the gradient
             through the kernels against the plain path's (every kernel the
             model reaches under autograd as its plain version:
             ``ref.flash_attention_ref``, and ``ssd_chunked`` for
             ``ssd_scan``) on the same weights, every leaf within a relative
             L2 of 1e-3; one AdamW step from each (the loss and grad_norm
             within 1e-4, the loss after the step within 1e-3); then the
             main path (``train``, ``train_mamba``, ``train_zamba``,
             ``train_mixtral``, ``train_mla``), 8 steps on that batch, the
             loss falling, with each layer's forward kernel launched twice
             a step (forward and remat recompute) and its backward once, at
             one shape each (an MTP block, outside the remat stacks, once
             each): minicpm-2b 80 ``flash_attention`` and 40
             ``flash_attention_bwd``; mamba2-130m 48 ``ssd_scan`` and 24
             ``ssd_scan_bwd``; zamba2 108 and 54, and 18 and 9; mixtral 2
             and 1; deepseek-v3 5 and 3; ms a step, tokens/s, peak device
             memory, the bound (8 x active parameters x tokens plus the
             attention's operations), and one step traced (busy and idle
             share).  Phase 2 also holds the forward with its LSE and
             ``flash_attention_bwd`` at minicpm-2b's shape (B=2, S=1,024,
             causal; float32, and bfloat16), at zamba2's (32 heads of 80),
             at mixtral's (48 / 8 heads of 128, window 4,096) and at
             deepseek-v3's ((192, 128), 128 heads, v strided; the backward
             also in bfloat16), float32 unless said, against their plain
             versions, two backward runs bit for bit, each timed with SDPA
             (its backward) beside; the float32 softcap backward at the GPU
             test's data (cap 50, logits of ~+-60); and the logit softcap
             (50) in the forward, the backward and ``decode_attention``.

The launch counters are set to 0 just before each main path (phases 3, 4,
5, 8, 9, 10, the five of 13 and the parts of 11 and 12) and read just after: the wrappers' own launches plus, for each
replay of a captured step, the launches recorded when it was captured
(``serving/captured.py``); launches made in phase 2 do not count.  Before the last line it prints one
JSON line ``{"kernels": [...]}``, and the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Needs one card and the CUDA toolkit; exits 2 without CUDA or outside a
checkout of the repository.

    python3 chip_smoke.py --sched-only

runs only the scheduling kernels' timings (no latency probe), phase 3 and its
trace, and prints no result line.  To compare the scheduling kernels of two
trees on one card, copy this script into a checkout of the other tree (a
``git archive`` unpacked under ``build/``) and run it there and here, in
turns, with ``--sched-only``.  ``--bwd-only`` does the same for the float32
``flash_attention_bwd`` rows at minicpm-2b's and zamba2-2.7b's train shapes
and at the softcap test's data.

In the ``{"kernels": [...]}`` line the ``ssd_scan``, ``ssd_scan_bwd``,
``flash_attention``, ``flash_attention_bwd`` and ``decode_attention`` rows
carry ``shapes``: the same numbers at the hybrid, moe, mla, whisper and
train paths' shapes (``ssd_scan_bwd``'s main row is mamba2-130m's train
shape, ``zamba2`` zamba2-2.7b's), each with the launches of its own path (``decode_attention``'s ``batch`` holds the llava-width rows, its
``mla_b1`` and ``mla_b8`` the latent entry's, counted under
``decode_attention_latent``, with the ``variant`` that ran, ``wgmma``
for its bfloat16 tensor-core kernel, and ``launch_ms``, the device time of
each of its CUDA launches in one call).  A ``batch`` or ``whisper_*`` row's launches
are those the wrappers counted at its own shape (``ops.SHAPE_LAUNCHES``,
and for replays ``captured.REPLAYED_SHAPES``) on the main paths; every
launch of the whisper paths falls in one of the ``whisper_*`` rows.  The two
scheduling rows also carry
``burst`` (the events of the timed burst, the path's chunk of 1,024),
``ns_per_event`` and ``ms_4096`` (the time of a 4,096-event burst): their
``ms`` is one 1,024-event burst, averaged over 10 back-to-back calls.
"""

from __future__ import annotations

import gc
import json
import statistics
import subprocess
import sys
import time
from contextlib import ExitStack, contextmanager, nullcontext
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12  # CUDA cores (the train step's float32 GEMMs, TF32 off)
# float32-accurate matrix products on the tensor cores: split-precision TF32,
# three TF32 products at 495 TFLOP/s (the kernels whose work is matrix products)
PEAK_F32_TC_OPS_PER_S = 495e12 / 3
PEAK_BF16_OPS_PER_S = 989e12  # tensor cores, dense

DEVICE = "cuda"
SCHED_CHUNK = 1024  # the burst the fused scheduling path launches
FULL_WIDTH = (24, 768, 50280)  # mamba2-130m: layers, d_model, vocab
DENSE_WIDTH = (40, 2304, 122753)  # minicpm-2b: layers, d_model, vocab
LLAVA_WIDTH = (32, 4096, 32000)  # llava-next-mistral-7b's backbone: layers, d_model, vocab
ZAMBA_WIDTH = (54, 2560, 32000)  # zamba2-2.7b: Mamba2 layers, d_model, vocab
MIXTRAL_WIDTH = (56, 6144, 32768)  # mixtral-8x22b: layers, d_model, vocab
MOE_LAYERS = 8  # of mixtral's 56: 20.44 B parameters in bfloat16 fit one card
MOE_PROMPT = 512  # the moe path's prefill: T=512, capacity 160 a expert (tokens drop)
MLA_WIDTH = (61, 7168, 129280)  # deepseek-v3-671b: layers, d_model, vocab
MLA_LAYERS = 4  # of deepseek-v3's 61: its 3 dense layers and 1 MoE layer, 31.6 GB in bfloat16
MLA_CACHE = 2048  # the mla endpoint's max_cache_len: 1,024-token prompts decode at 1,024-1,030
WHISPER_WIDTH = (12, 768, 51865)  # whisper-small: decoder layers, d_model, vocab
WHISPER_TEXT = 448  # whisper's text context: the positions dec_pos holds in the published model
WHISPER_PROMPT = 440  # the whisper serve and audio prompts: with 8 tokens generated, 448 positions
WHISPER_FRAMES = 1500  # encoder frames of 30 s of audio
WHISPER_CACHE = 2048  # the whisper endpoints' max_cache_len (and position tables)
BATCH_SLOTS, BATCH_MAX_LEN = 8, 1024  # the batch phase's cache: slots, positions a slot
ORDER = [0, 0, 1, 1, 2, 0, 1, 2]  # endpoint of each serve request

TOL_F32 = dict(atol=1e-4, rtol=1e-3)
TOL_BF16 = dict(atol=5e-2, rtol=5e-2)
TOL_LOGITS = dict(atol=1e-3, rtol=1e-3)  # 24-40 layers of float32 matmuls, card vs CPU order
TOL_ATTN = dict(atol=2e-5, rtol=2e-5)    # float32, as tests/test_kernels.py
TOL_ATTN_BF16 = dict(atol=2e-2, rtol=2e-2)
TOL_BWD = dict(atol=1e-4, rtol=1e-3)     # float32 gradients, sums over up to S queries
TOL_GRAD_REL = 1e-3    # each gradient leaf, kernel path vs plain path (relative L2)
TOL_STEP_REL = 1e-4    # loss and grad_norm of one step: 40 float32 layers, other sum orders
# loss after one AdamW step: the first step moves a weight by ~lr * sign(g), so
# where g is ~0 the two paths' weights may differ by 2 * lr
TOL_AFTER_REL = 1e-3

TRAIN_BATCH, TRAIN_SEQ = 2, 1024  # the train phase's batch: 2 sequences of 1,024 tokens
MIXTRAL_WINDOW = 4096  # mixtral-8x22b's sliding window, passed to the kernels at every length
MIXTRAL_TRAIN_LAYERS = 1  # of mixtral's 56: 2.91 B parameters, ~43 GiB with grads and AdamW
MLA_TRAIN_LAYERS = 2  # of deepseek-v3's 61: 1 dense and 1 MoE layer
MLA_TRAIN_EXPERTS = 16  # of the MoE layer's 256 routed experts: 4.06 B parameters, ~60.5 GiB
TRAIN_STEPS = 8
TRAIN_LR = 5e-4


def log(*a):
    print(*a, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def time_cuda(torch, fn, reps: int, warmup: int = 1, agg=statistics.median,
              calls: int = 1) -> float:
    """Median (or ``agg``) milliseconds of one call of ``fn`` over ``reps``
    runs of ``calls`` back-to-back calls each, in CUDA events.  With several
    calls the host's work for one call overlaps the device's work for the
    one before."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(calls):
            fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e) / calls)
    return agg(times)


def capture(torch, fns):
    """A CUDA graph that runs ``fns`` in turn, warmed up outside the capture
    and replayed once."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up outside the capture
        for f in fns:
            f()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for f in fns:
            f()
    graph.replay()
    torch.cuda.synchronize()
    return graph


def time_graph(torch, fns, reps: int = 20) -> float:
    """Median milliseconds of one call of ``fns`` (run in turn), from a CUDA
    graph that holds them all, replayed ``reps`` times between CUDA events.
    The host's launch overhead is not in it; each function may take its own
    inputs so that together they exceed the 50 MB L2 cache where the caller
    would find its inputs cold."""
    graph = capture(torch, fns)
    times = []
    for _ in range(reps):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        graph.replay()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e) / len(fns))
    return statistics.median(times)


def graph_kernels(torch, fns):
    """Device time by kernel of one replay of the graph of ``fns``, from
    ``torch.profiler``: [(kernel, launches, ms per call of fns)], largest
    first, with ("wall", 0, ms) first: the replay's first kernel start to its
    last kernel end, per call (so the gaps between kernels show); [] if the
    profiler saw no kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    graph = capture(torch, fns)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        graph.replay()
        torch.cuda.synchronize()
    evs = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not evs:
        return []
    n = len(fns)
    span = (max(e.time_range.end for e in evs) - min(e.time_range.start for e in evs)) / 1e3
    by = {}
    for e in evs:
        k = by.setdefault(e.name, [0, 0.0])
        k[0] += 1
        k[1] += (e.time_range.end - e.time_range.start) / 1e3
    rows = sorted(((name, c, ms / n) for name, (c, ms) in by.items()), key=lambda r: -r[2])
    return [("wall", 0, span / n)] + rows


def bound(nbytes: float, nops: float, peak_ops: float = PEAK_F32_TC_OPS_PER_S):
    """The least ms for ``nbytes`` moved and ``nops`` done at the card's peak
    rates (operations at ``peak_ops``: the peak for the inputs' type, float32
    matrix products at the tensor cores' split-precision rate)."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, nops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def peak_ops(torch, dtype) -> float:
    return PEAK_BF16_OPS_PER_S if dtype == torch.bfloat16 else PEAK_F32_TC_OPS_PER_S


def max_abs(a, b) -> float:
    return float((a.float().cpu() - b.float().cpu()).abs().max()) if a.numel() else 0.0


# ------------------------------------------------------------------ inputs
def sched_burst(np, R, F, W, seed, arrival_only=False):
    rng = np.random.default_rng(seed)
    kinds = np.zeros(R, np.int32) if arrival_only else rng.choice(
        np.array([0, 1, 2], np.int32), R, p=[0.5, 0.45, 0.05])
    funcs = ((rng.zipf(1.5, R) - 1) % F).astype(np.int32)
    workers = np.where(kinds == 0, -1, rng.integers(0, W, R)).astype(np.int32)
    idle = rng.integers(0, 3, (F, W)).astype(np.int32)
    conns = rng.integers(0, 5, W).astype(np.int32)
    return kinds, funcs, workers, idle, conns


def sched_stream(np, n, F, W, seed):
    """Zipf-like function ids; 16 windows of n/16 events, windows 0 and 8
    pure arrival bursts (flash crowds) and the rest mixed, so that the whole
    stream is ~50% ARRIVAL, ~45% FINISH, ~5% EVICT."""
    rng = np.random.default_rng(seed)
    win = n // 16
    kinds = rng.choice(np.array([0, 1, 2], np.int32), n, p=[0.4286, 0.5143, 0.0571])
    kinds[:win] = 0
    kinds[8 * win: 9 * win] = 0
    funcs = ((rng.zipf(1.5, n) - 1) % F).astype(np.int32)
    workers = np.where(kinds == 0, -1, rng.integers(0, W, n)).astype(np.int32)
    return np.stack([kinds, funcs, workers], 1).astype(np.int32)


def ssd_inputs(torch, B, S, H=24, P=64, N=128, seed=0, G=1):
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn(B, S, H, P, generator=g) * 0.5
    dt = torch.nn.functional.softplus(torch.randn(B, S, H, generator=g))
    A = -torch.exp(torch.randn(H, generator=g) * 0.3)
    Bm = torch.randn(B, S, G, N, generator=g) * 0.3
    Cm = torch.randn(B, S, G, N, generator=g) * 0.3
    return [t.to(DEVICE) for t in (x, dt, A, Bm, Cm)]


def ssd_counts(B, S, H, P, N, Q, elem):
    """Bytes each input read once / output written once, and float32
    operations counted once (C.B^T shared by the heads, ngroups=1)."""
    Sp = -(-S // Q) * Q
    nc = Sp // Q
    tri = Q * (Q + 1) // 2
    ops = B * nc * (2 * tri * N + H * (2 * tri * P + 4 * Q * N * P))
    nbytes = (2 * B * S * H * P * elem + 2 * B * S * N * elem + B * S * H * 4 + H * 4
              + B * H * P * N * 4)
    return nbytes, ops


def ssd_bwd_counts(B, S, H, P, N, G, Q, elem, d_final=False):
    """The gradient's least work, counted once: x, dy, B, C, dt, A read with
    the forward's scratch the backward starts from (the chunk cumsums, the
    states entering the chunks, C.B^T on and below the diagonal) and
    d_final_state where given; dx, dB, dC, ddt, dA and d_init_state written.
    Operations, per chunk: each head's dh = exp(cs) dy^T C, its carried dC
    = exp(cs) dy h, G B^T (dx's state term and dw), dB's state term w x^T G
    (each Q P N), D = dy x^T and dx's quadratic term (each Q(Q+1)/2 P); each
    group's dC and dB from dCB (each Q(Q+1)/2 N); two operations each."""
    Sp = -(-S // Q) * Q
    nc = Sp // Q
    tri = Q * (Q + 1) // 2
    ops = 2 * B * nc * (H * (4 * Q * P * N + 2 * tri * P) + G * 2 * tri * N)
    nbytes = (3 * B * Sp * H * P * elem + 4 * B * Sp * G * N * elem + 2 * B * Sp * H * 4
              + 2 * H * 4 + B * nc * H * (Q + N * P) * 4 + B * nc * G * tri * 4
              + (2 if d_final else 1) * B * H * P * N * 4)
    return nbytes, ops


def chain_bound(np, kinds, t_arr, t_step):
    """The serial-chain bound (ms) of one burst: every ARRIVAL is one
    dependent step of ``t_arr``; the FINISH/EVICT events between two ARRIVALs
    do not depend on each other, so each maximal run of them that an ARRIVAL
    follows adds one ``t_step``.  Returns (ms, ARRIVALs, runs)."""
    arr = np.flatnonzero(kinds == 0)
    upd = np.concatenate([[0], np.cumsum((kinds == 1) | (kinds == 2))])
    prev = np.concatenate([[0], arr[:-1] + 1])
    runs = int((upd[arr] > upd[prev]).sum())
    return len(arr) * t_arr + runs * t_step, len(arr), runs


def sched_counts(kinds, F, W):
    """Bytes (events read, idle/conns read and written, outputs written) and
    operations (two compares per worker per ARRIVAL of this run's data)."""
    R = len(kinds)
    nbytes = 3 * R * 4 + 2 * F * W * 4 + 2 * W * 4 + 2 * R * 4
    return nbytes, 2 * W * int((kinds == 0).sum())


# ------------------------------------------------------------------ phases
def phase_device(torch, build, names=None):
    q = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60)
    if q.returncode != 0:
        fail(f"nvidia-smi: {q.stderr.strip()}")
    card = q.stdout.strip().splitlines()[0]
    log(f"[device] {torch.cuda.get_device_name(0)} count={torch.cuda.device_count()} "
        f"torch={torch.__version__} cuda={torch.version.cuda}")
    names = names or build.SOURCES
    secs = build.build(names)
    log(f"[device] kernels built in {secs:.2f} s ({', '.join(names)})")
    return card


def chain_probe(torch, np, build):
    """The least time (ms) of one dependent step of the scheduling chain on
    this card, from ``sched_chain_probe_launch`` (``csrc/sched.cu``): an
    ARRIVAL step (one warp: a shared-memory read at an address that depends
    on the last step, ``__reduce_min_sync``, lane 0 publishes the result in
    shared memory) and a FINISH/EVICT step (one thread: dependent
    shared-memory load, add, store).  Each is the slope between chains of
    10,000 and 110,000 steps, the least of 5 runs each, so the launch cost
    drops out."""
    lib = build.load("sched")
    init = torch.from_numpy(np.random.default_rng(0).permutation(1024).astype(np.int32)).to(DEVICE)
    out = torch.empty(1, dtype=torch.int32, device=DEVICE)
    n1, n2 = 10_000, 110_000
    step = []
    for mode in (0, 1):
        def run(n, mode=mode):
            err = lib.sched_chain_probe_launch(init.data_ptr(), out.data_ptr(), n, mode,
                                               torch.cuda.current_stream().cuda_stream)
            if err:
                fail(f"sched_chain_probe_launch failed with CUDA error {err}")
        t1, t2 = (time_cuda(torch, lambda n=n: run(n), reps=5, agg=min) for n in (n1, n2))
        step.append((t2 - t1) / (n2 - n1))
    log(f"[kernels] sched chain probe: ARRIVAL step {step[0] * 1e6:.2f} ns, FINISH/EVICT step "
        f"{step[1] * 1e6:.2f} ns (least of 5, slope over {n1:,}-{n2:,} steps)")
    return tuple(step)


def sched_kernels(torch, np, ops, ref, probe=None):
    """``sched_events`` and ``sched_step`` bitwise against their plain versions
    at F=40, W=1600 for R=1024 (the main path's chunk) and R=4096, and
    ``sched_events`` at W=100,000 (the large-state path); ns/event in CUDA
    events around 10 back-to-back calls.  With ``probe`` = (t_arr, t_step)
    ms the bound is the burst's serial chain (``chain_bound``).  Returns the
    rows at R=1024, with the R=4096 time beside."""
    t = lambda a: torch.from_numpy(a).to(DEVICE)  # noqa: E731
    rows = {}
    F, W = 40, 1600
    for name, arrival_only in (("sched_events", False), ("sched_step", True)):
        for R in (SCHED_CHUNK, 4096):
            kinds, funcs, workers, idle, conns = (t(a) for a in sched_burst(
                np, R, F, W, seed=1, arrival_only=arrival_only))
            if arrival_only:
                kern = lambda: ops.sched_step(funcs, idle, conns)  # noqa: E731
                plain = lambda: ref.sched_step_ref(funcs, idle, conns)  # noqa: E731
            else:
                kern = lambda: ops.sched_events(kinds, funcs, workers, idle, conns)  # noqa: E731
                plain = lambda: ref.sched_events_ref(kinds, funcs, workers, idle, conns)  # noqa: E731
            got, want = kern(), plain()
            torch.cuda.synchronize()
            err = max(max_abs(a, b) for a, b in zip(got, want))
            if err != 0:
                fail(f"{name} R={R} differs from its plain version (max abs {err})")
            ms = time_cuda(torch, kern, reps=5, calls=10)
            k = kinds.cpu().numpy()
            nbytes, nops = sched_counts(k, F, W)
            line = (f"[kernels] {name} R={R} F={F} W={W}: bitwise equal; {ms:.4f} ms "
                    f"({ms * 1e6 / R:.1f} ns/event)")
            if probe is not None:
                b_ms, n_arr, runs = chain_bound(np, k, *probe)
                line += (f", latency bound {b_ms:.4f} ms ({b_ms * 1e6 / R:.1f} ns/event: "
                         f"{n_arr} ARRIVAL, {runs} runs of the other {R - n_arr})")
            line += (f"; bytes {nbytes / 1e6:.3f} MB ({bound(nbytes, 0)[0]:.6f} ms), operations "
                     f"{nops / 1e6:.2f} M ({nops / PEAK_F32_OPS_PER_S * 1e3:.6f} ms)")
            if R == SCHED_CHUNK:
                plain_ms = time_cuda(torch, plain, reps=2, warmup=0)
                line += f"; plain {plain_ms:.1f} ms"
                rows[name] = dict(
                    name=name, route="cuda", source="src/repro_torch/kernels/csrc/sched.cu",
                    replaces="src/repro/kernels/sched_step.py:" + ("68" if arrival_only else "152"),
                    max_abs_err=err, ms=ms, plain_ms=plain_ms,
                    bound_ms=b_ms if probe is not None else None, bound_by="latency",
                    library_ms=None, burst=R, ns_per_event=ms * 1e6 / R)
            else:
                rows[name]["ms_4096"] = ms
            log(line)

    # the 100k-worker anchor: the large-state path
    R, W = 4096, 100_000
    args = [t(a) for a in sched_burst(np, R, F, W, seed=2)]
    got, want = ops.sched_events(*args), ref.sched_events_ref(*args)
    torch.cuda.synchronize()
    err = max(max_abs(a, b) for a, b in zip(got, want))
    if err != 0:
        fail(f"sched_events at W={W} differs from its plain version (max abs {err})")
    ms = time_cuda(torch, lambda: ops.sched_events(*args), reps=3, calls=3)
    log(f"[kernels] sched_events R={R} F={F} W={W}: bitwise equal; {ms:.3f} ms "
        f"({ms * 1e6 / R:.0f} ns/event)")
    return rows


def phase_kernels(torch, np, build, ops, ref, rows):
    rows.update(sched_kernels(torch, np, ops, ref, chain_probe(torch, np, build)))

    # ssd_scan at mamba2-130m width
    H, P, N, Q = 24, 64, 128, 256
    main = None
    for B, S in ((1, 1024), (2, 1024), (1, 1000)):
        x, dt, A, Bm, Cm = ssd_inputs(torch, B, S, seed=B * 7 + S)
        y, st = ops.ssd_scan(x, dt, A, Bm, Cm, chunk=Q)
        yr, sr = ref.ssd_scan_ref(*pad_to(torch, (x, dt, A, Bm, Cm), S, Q), Q)
        torch.cuda.synchronize()
        yr = yr[:, :S]
        for got, want in ((y, yr), (st, sr)):
            if not torch.allclose(got, want, **TOL_F32):
                fail(f"ssd_scan f32 B={B} S={S}: max abs err {max_abs(got, want):.3e}")
        err = max(max_abs(y, yr), max_abs(st, sr))
        log(f"[kernels] ssd_scan f32 B={B} S={S}: max abs err {err:.3e} (atol 1e-4, rtol 1e-3)")
        if (B, S) == (1, 1024):
            main = (x, dt, A, Bm, Cm, err)
    x, dt, A, Bm, Cm, err = main
    xb, Bb, Cb = (v.to(torch.bfloat16) for v in (x, Bm, Cm))
    yb, sb = ops.ssd_scan(xb, dt, A, Bb, Cb, chunk=Q)
    yr, sr = ref.ssd_scan_ref(xb.float(), dt, A, Bb.float(), Cb.float(), Q)
    if not (torch.allclose(yb.float(), yr, **TOL_BF16) and torch.allclose(sb, sr, **TOL_BF16)):
        fail(f"ssd_scan bf16: max abs err {max(max_abs(yb, yr), max_abs(sb, sr)):.3e}")
    log(f"[kernels] ssd_scan bf16 B=1 S=1024: max abs err "
        f"{max(max_abs(yb, yr), max_abs(sb, sr)):.3e} (atol 5e-2, rtol 5e-2)")
    g = torch.Generator(device="cpu").manual_seed(12)
    B2, C2 = (torch.randn(1, 1024, 2, N, generator=g).to(DEVICE) * 0.3 for _ in range(2))
    y, st = ops.ssd_scan(x, dt, A, B2, C2, chunk=Q)
    yr, sr = ref.ssd_scan_ref(x, dt, A, B2, C2, Q)
    if not (torch.allclose(y, yr, **TOL_F32) and torch.allclose(st, sr, **TOL_F32)):
        fail(f"ssd_scan ngroups=2: max abs err {max(max_abs(y, yr), max_abs(st, sr)):.3e}")
    err = max(err, max_abs(y, yr), max_abs(st, sr))
    log(f"[kernels] ssd_scan f32 ngroups=2 B=1 S=1024: max abs err "
        f"{max(max_abs(y, yr), max_abs(st, sr)):.3e} (atol 1e-4, rtol 1e-3)")
    # times from CUDA graphs of back-to-back calls: the layer just wrote its
    # inputs, so they sit in L2; the wrapper's host overhead is not counted
    ms = time_graph(torch, [lambda: ops.ssd_scan(x, dt, A, Bm, Cm, chunk=Q)] * 10)
    plain_ms = time_graph(torch, [lambda: ref.ssd_scan_ref(x, dt, A, Bm, Cm, Q)] * 3)
    nbytes, nops = ssd_counts(1, 1024, H, P, N, Q, 4)
    b_ms, b_by = bound(nbytes, nops)
    rows["ssd_scan"] = dict(
        name="ssd_scan", route="cuda", source="src/repro_torch/kernels/csrc/ssd_scan.cu",
        replaces="src/repro/kernels/ssd_scan.py:62", max_abs_err=err, ms=ms, plain_ms=plain_ms,
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
    )
    log(f"[kernels] ssd_scan B=1 S=1024 H={H} P={P} N={N} Q={Q}: {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}: {nops / 1e9:.3f} GFLOP, "
        f"{nbytes / 1e6:.2f} MB)")
    # zamba2-2.7b's width as served, and both widths at the train paths'
    # shape (B=2, S=1,024): their forward and remat recompute
    zamba = (80, 64, 64, Q)
    rows["ssd_scan"]["shapes"] = {
        "zamba2": ssd_row(torch, ops, ref, 1, *zamba, "zamba2-2.7b"),
        "train_mamba": ssd_row(torch, ops, ref, TRAIN_BATCH, H, P, N, Q, "mamba2-130m train"),
        "train_zamba": ssd_row(torch, ops, ref, TRAIN_BATCH, *zamba, "zamba2-2.7b train")}

    # its gradient at the train phase's shape (B=2, S=1,024), mamba2-130m and
    # zamba2-2.7b width, float32 and bfloat16, and G=2 with both states
    f32, bf16 = torch.float32, torch.bfloat16
    mamba, zamba = (TRAIN_BATCH, TRAIN_SEQ, H, P, N, Q), (TRAIN_BATCH, TRAIN_SEQ, 80, 64, 64, Q)
    rows["ssd_scan_bwd"] = dict(
        name="ssd_scan_bwd", route="cuda", source="src/repro_torch/kernels/csrc/ssd_scan_bwd.cu",
        # no TPU kernel: the JAX package differentiates ssd_chunked by autodiff
        replaces="src/repro/models/mamba.py:80",
        **ssd_bwd_row(torch, ops, ref, "mamba2-130m train", mamba, f32, seed=21),
        shapes={"bf16": ssd_bwd_row(torch, ops, ref, "mamba2-130m train", mamba, bf16, seed=21),
                "g2": ssd_bwd_row(torch, ops, ref, "mamba2-130m train", mamba, f32, G=2, seed=22,
                                  state=True),
                "zamba2": ssd_bwd_row(torch, ops, ref, "zamba2-2.7b train", zamba, f32, seed=23),
                "zamba2_bf16": ssd_bwd_row(torch, ops, ref, "zamba2-2.7b train", zamba, bf16,
                                           seed=23)})


def ssd_row(torch, ops, ref, B, H, P, N, Q, label):
    """``ssd_scan`` at batch B, S=1024 and a model's width, float32: against
    its plain version (atol=1e-4, rtol=1e-3), then times from CUDA graphs as
    the main row's.  Returns the row for the kernels line."""
    x, dt, A, Bm, Cm = ssd_inputs(torch, B, 1024, H, P, N, seed=H + N)
    y, st = ops.ssd_scan(x, dt, A, Bm, Cm, chunk=Q)
    yr, sr = ref.ssd_scan_ref(x, dt, A, Bm, Cm, Q)
    if not (torch.allclose(y, yr, **TOL_F32) and torch.allclose(st, sr, **TOL_F32)):
        fail(f"ssd_scan {label}: max abs err {max(max_abs(y, yr), max_abs(st, sr)):.3e}")
    err = max(max_abs(y, yr), max_abs(st, sr))
    ms = time_graph(torch, [lambda: ops.ssd_scan(x, dt, A, Bm, Cm, chunk=Q)] * 10)
    plain_ms = time_graph(torch, [lambda: ref.ssd_scan_ref(x, dt, A, Bm, Cm, Q)] * 3)
    nbytes, nops = ssd_counts(B, 1024, H, P, N, Q, 4)
    b_ms, b_by = bound(nbytes, nops)
    log(f"[kernels] ssd_scan {label} B={B} S=1024 H={H} P={P} N={N} Q={Q} f32: max abs err "
        f"{err:.3e} (atol 1e-4, rtol 1e-3); {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
        f"{b_ms:.4f} ms ({b_by}: {nops / 1e9:.3f} GFLOP, {nbytes / 1e6:.2f} MB)")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None)


def ssd_bwd_row(torch, ops, ref, label, shape, dtype, G=1, seed=0, state=False):
    """``ssd_scan_bwd`` at ``shape`` (B, S, H, P, N, Q) with G groups in
    ``dtype`` (x, B, C and dy), from the forward kernel's scratch (its y
    and final state held against ``ssd_scan_ref`` first), with a seeded dy
    and, with ``state``, an initial state and a final state's gradient (the
    train path has neither): every gradient against
    ``ssd_scan_bwd_ref`` on the same tensors (TOL_BWD in float32, TOL_BF16
    in bfloat16) and bit for bit across two runs; then its time and the
    plain version's, each in CUDA events around back-to-back calls, and the
    bound from ``ssd_bwd_counts`` at the peak for the inputs' type.  No
    single PyTorch call computes it (library time none).  Returns the row."""
    B, S, H, P, N, Q = shape
    x, dt, A, Bm, Cm = ssd_inputs(torch, B, S, H, P, N, seed=seed, G=G)
    g = torch.Generator(device="cpu").manual_seed(seed + 1)
    dy = torch.randn(B, S, H, P, generator=g).to(DEVICE)
    h0, dfin = ((torch.randn(B, H, P, N, generator=g).to(DEVICE) for _ in range(2)) if state
                else (None, None))
    x, Bm, Cm, dy = (t.to(dtype) for t in (x, Bm, Cm, dy))
    y, st, saved = ops._ssd_forward(x, dt, A, Bm, Cm, Q, h0, keep=True)
    yr, sr = ref.ssd_scan_ref(x.float(), dt, A, Bm.float(), Cm.float(), Q, h0)
    y_tol = TOL_F32 if dtype == torch.float32 else TOL_BF16
    y_err = max(max_abs(y, yr), max_abs(st, sr))
    if not (torch.allclose(y.float(), yr, **y_tol) and torch.allclose(st, sr, **y_tol)):
        fail(f"ssd_scan {label}, its scratch kept: max abs err {y_err:.3e} ({y_tol})")
    args = (x, dt, A, Bm, Cm, Q, h0, dy, dfin)
    got, again = ops.ssd_scan_bwd(*args, saved), ops.ssd_scan_bwd(*args, saved)
    want = ref.ssd_scan_bwd_ref(x.float(), dt, A, Bm.float(), Cm.float(), Q, h0, dy.float(), dfin)
    tol = TOL_BWD if dtype == torch.float32 else TOL_BF16
    err = 0.0
    for name, a, b, w, t in zip(("dx", "ddt", "dA", "dB", "dC", "d_init_state"), got, again,
                                want, (x, dt, A, Bm, Cm, dt)):
        if not torch.equal(a, b):
            fail(f"ssd_scan_bwd {label}: {name} differs between two runs")
        if a.dtype != t.dtype or not torch.allclose(a.float(), w, **tol):
            fail(f"ssd_scan_bwd {label}: {name} max abs err {max_abs(a, w):.3e} ({tol})")
        err = max(err, max_abs(a, w))
    ms = time_cuda(torch, lambda: ops.ssd_scan_bwd(*args, saved), 5, calls=10)
    plain_ms = time_cuda(torch, lambda: ref.ssd_scan_bwd_ref(*args), 3, calls=3)
    nbytes, nops = ssd_bwd_counts(B, S, H, P, N, G, Q, x.element_size(), dfin is not None)
    b_ms, b_by = bound(nbytes, nops, peak_ops(torch, dtype))
    log(f"[kernels] ssd_scan_bwd {label} B={B} S={S} H={H} P={P} N={N} G={G} Q={Q} "
        f"{str(dtype)[6:]}{' init and final state' if state else ''}: max abs err {err:.3e} "
        f"({tol}; two runs bit for bit; the forward's y and state {y_err:.3e}); {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
        f"{b_ms:.4f} ms ({b_by}: {nops / 1e9:.3f} GFLOP, {nbytes / 1e6:.2f} MB)")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None)


def attn_inputs(torch, shapes, seed):
    g = torch.Generator(device="cpu").manual_seed(seed)
    return [torch.randn(*sh, generator=g).to(DEVICE) for sh in shapes]


def live_pairs(S, causal, window, Sk=None):
    """(query, key) pairs the masks leave live in one head, for S queries
    over Sk keys (S unless given; with Sk != S there is no mask)."""
    Sk = Sk or S
    n = 0
    for i in range(S):
        lo = max(0, i - window + 1) if window else 0
        n += (i if causal else Sk - 1) - lo + 1
    return n


def flash_counts(B, S, H, KH, hd, causal, window, elem, hd_v=None, Sk=None):
    """q, k, v read once and out written once; 2*hd + 2*hd_v operations (q.k
    and p*v) per live pair (hd_v: v's head dim, hd unless given; Sk: the
    keys' length, S unless given)."""
    hd_v, Sk = hd_v or hd, Sk or S
    nbytes = (B * S * H * (hd + hd_v) + B * Sk * KH * (hd + hd_v)) * elem
    return nbytes, 2 * (hd + hd_v) * B * H * live_pairs(S, causal, window, Sk)


def decode_counts(S, H, KH, hd, lengths, window, q_elem, cache_elem):
    """q and out at q's element size, and the live K/V rows only (the kernel
    reads no other) at the cache's, for one length a batch row; operations
    4*hd per query head and live row."""
    n_live = sum(max(0, min(n, S - 1) - (max(0, n - window + 1) if window else 0) + 1)
                 for n in lengths)
    B = len(lengths)
    return 2 * B * H * hd * q_elem + 2 * n_live * KH * hd * cache_elem, 4 * hd * H * n_live


def check_close(torch, name, got, want, dtype):
    tol = TOL_ATTN if dtype == torch.float32 else TOL_ATTN_BF16
    err = max_abs(got, want)
    if got.dtype != dtype or not torch.allclose(got.float(), want.float(), **tol):
        fail(f"{name} differs from its plain version: max abs err {err:.3e} ({tol})")
    return err


def phase_attention(torch, np, ops, ref, rows):
    """Both attention kernels against their plain versions at minicpm-2b and
    gemma3-4b width, then times at the shapes of the main paths."""
    f32, bf16 = torch.float32, torch.bfloat16
    MINI = (1, 36, 36, 64)   # B, H, KH, hd
    GEMMA = (1, 8, 4, 256)
    errs = {"flash_attention": [], "decode_attention": []}
    for label, (B, H, KH, hd), S, window in (("minicpm-2b", MINI, 1024, None),
                                             ("gemma3-4b", GEMMA, 2048, 1024),
                                             ("gemma3-4b", GEMMA, 2048, None)):
        q, k, v = attn_inputs(torch, [(B, S, H, hd), (B, S, KH, hd), (B, S, KH, hd)], S + hd)
        for dtype in (f32, bf16):
            qd, kd, vd = (t.to(dtype) for t in (q, k, v))
            got = ops.flash_attention(qd, kd, vd, True, window)
            err = check_close(torch, f"flash_attention {label} {dtype}", got,
                              ref.flash_attention_ref(qd, kd, vd, True, window), dtype)
            if dtype == f32:
                errs["flash_attention"].append(err)
            log(f"[kernels] flash_attention {label} S={S} H={H} KH={KH} hd={hd} causal "
                f"window={window} {str(dtype)[6:]}: max abs err {err:.3e}")
    for label, (B, H, KH, hd) in (("minicpm-2b", MINI), ("gemma3-4b", GEMMA)):
        S = 2048
        q, kc, vc = attn_inputs(torch, [(B, H, hd), (B, S, KH, hd), (B, S, KH, hd)], hd)
        for valid in (1024, 2047):
            for window in (None, 1024):
                for dtype in (f32, bf16):
                    qd, kd, vd = (t.to(dtype) for t in (q, kc, vc))
                    want = ref.decode_attention_ref(qd, kd, vd, valid, window)
                    tv = torch.tensor(valid, dtype=torch.int32, device=DEVICE)
                    err = max(check_close(torch, f"decode_attention {label} {dtype}",
                                          ops.decode_attention(qd, kd, vd, valid, window), want,
                                          dtype),
                              check_close(torch, f"decode_attention {label} {dtype} tensor "
                                          "valid_len", ops.decode_attention(qd, kd, vd, tv, window),
                                          want, dtype))
                    if dtype == f32:
                        errs["decode_attention"].append(err)
                    log(f"[kernels] decode_attention {label} cache {S} H={H} KH={KH} hd={hd} "
                        f"valid_len={valid} (int and tensor) window={window} {str(dtype)[6:]}: "
                        f"max abs err {err:.3e}")
        # one call captured with a tensor valid_len, replayed with new values
        window = 1024 if label == "gemma3-4b" else None
        tv = torch.tensor(1024, dtype=torch.int32, device=DEVICE)
        got = []
        graph = capture(torch, [lambda: got.append(ops.decode_attention(q, kc, vc, tv, window))])
        out = got[-1]
        for valid in (7, 2047, 1500):
            tv.fill_(valid)
            graph.replay()
            err = check_close(torch, f"decode_attention {label} graph replay valid_len={valid}",
                              out, ref.decode_attention_ref(q, kc, vc, valid, window), f32)
            errs["decode_attention"].append(err)
        log(f"[kernels] decode_attention {label} captured once with a tensor valid_len, "
            f"replayed at 7, 2047, 1500 (window={window}): max abs err {err:.3e}")

    # times: CUDA graphs of back-to-back calls (time_graph); prefill's q, k, v
    # were just written by the layer and sit in L2, a decode step's cache was
    # last touched a whole model ago, so decode cycles through 8 caches (> L2)
    main = flash_row(torch, ops, ref, "minicpm-2b", (1, 1024, 36, 36, 64), None, f32)
    flash_row(torch, ops, ref, "gemma3-4b", (1, 2048, 8, 4, 256), 1024, f32)
    rows["flash_attention"] = dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:75",
        **{**main, "max_abs_err": max(errs["flash_attention"])},
        shapes={"zamba2": flash_row(torch, ops, ref, "zamba2-2.7b", (1, 1024, 32, 32, 80), None,
                                    f32),
                "mixtral": flash_row(torch, ops, ref, "mixtral-8x22b", (1, MOE_PROMPT, 48, 8, 128),
                                     4096, torch.bfloat16)})
    # deepseek-v3's MLA: prefill at q/k heads of 192 against v heads of 128
    rows["flash_attention"]["shapes"]["mla"] = flash_row(
        torch, ops, ref, "deepseek-v3", (1, 1024, 128, 128, 192), None, torch.bfloat16, hd_v=128)
    # whisper-small, every prefill attention of its paths at its own shape:
    # the serve part's (440 tokens over 440 zero frames: encoder and cross
    # bidirectional at Sk = S, self causal), the audio part's over 30 s of
    # audio at B=1 (prompts of 440 and 4 tokens) and B=8 (440), and the
    # encoder in bfloat16 beside its float32
    T, P, WH = WHISPER_FRAMES, WHISPER_PROMPT, (12, 12, 64)
    for label, (B, S, causal, Sk, dtype) in {
            f"whisper_serve_bidir_{P}": (1, P, False, None, f32),
            f"whisper_self_{P}": (1, P, True, None, f32),
            "whisper_self_4": (1, 4, True, None, f32),
            "whisper_enc_f32": (1, T, False, None, f32),
            "whisper_enc_bf16": (1, T, False, None, bf16),
            f"whisper_cross_{P}": (1, P, False, T, f32),
            "whisper_cross_4": (1, 4, False, T, f32),
            "whisper_enc_b8": (8, T, False, None, f32),
            f"whisper_self_b8_{P}": (8, P, True, None, f32),
            f"whisper_cross_b8_{P}": (8, P, False, T, f32)}.items():
        rows["flash_attention"]["shapes"][label] = flash_row(
            torch, ops, ref, f"whisper-small {label[8:]}", (B, S, *WH), None, dtype,
            causal=causal, Sk=Sk)
    decode_timing(torch, ops, ref, rows)
    rows["decode_attention"]["max_abs_err"] = max(errs["decode_attention"])
    decode_batch_timing(torch, np, ops, ref, rows)
    # and its absorbed decode at the engine's shape (a bfloat16 cache of
    # MLA_CACHE, the first decode step of a 1,024-token request) and the
    # batcher's (bfloat16 cache, the batch phase's lengths)
    lengths = np.random.default_rng(7).integers(16, 577, BATCH_SLOTS).tolist()
    rows["decode_attention_shapes"].update(
        mla_b1=latent_row(torch, ops, ref, "deepseek-v3 engine", 1, MLA_CACHE, [1024],
                          torch.bfloat16, torch.bfloat16, 60, n=16),
        mla_b8=latent_row(torch, ops, ref, "deepseek-v3 batch", BATCH_SLOTS, BATCH_MAX_LEN,
                          lengths, torch.bfloat16, torch.bfloat16, 70))
    # training at minicpm-2b's width: the forward with its LSE written, and
    # the backward, in float32 (the train phase's) and in bfloat16; and the
    # forward and backward at zamba2-2.7b's shared blocks (hd 80)
    shape, zamba = (TRAIN_BATCH, TRAIN_SEQ, 36, 36, 64), (TRAIN_BATCH, TRAIN_SEQ, 32, 32, 80)
    # mixtral-8x22b's and deepseek-v3's train shapes: 48 heads on 8 kv heads
    # of 128 under the 4,096 window, and MLA's 128 heads at (192, 128), v
    # strided; the latter in bfloat16 too, which no path runs
    mixtral, mla = (TRAIN_BATCH, TRAIN_SEQ, 48, 8, 128), (TRAIN_BATCH, TRAIN_SEQ, 128, 128, 192)
    shapes = rows["flash_attention"]["shapes"]
    shapes["train"] = flash_lse_row(torch, ops, ref, "minicpm-2b train", shape, f32)
    shapes["train_zamba"] = flash_lse_row(torch, ops, ref, "zamba2-2.7b train", zamba, f32)
    shapes["train_mixtral"] = flash_lse_row(torch, ops, ref, "mixtral-8x22b train", mixtral, f32,
                                            window=MIXTRAL_WINDOW)
    shapes["train_mla"] = flash_lse_row(torch, ops, ref, "deepseek-v3 train", mla, f32, hd_v=128)
    rows["flash_attention_bwd"] = dict(
        name="flash_attention_bwd", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        # no TPU kernel: the JAX package differentiates its einsum attention
        replaces="src/repro/models/attention.py:84",
        **flash_bwd_row(torch, ops, ref, "minicpm-2b train", shape, f32),
        shapes={"bf16": flash_bwd_row(torch, ops, ref, "minicpm-2b train", shape, bf16),
                "zamba2": flash_bwd_row(torch, ops, ref, "zamba2-2.7b train", zamba, f32),
                "train_mixtral": flash_bwd_row(torch, ops, ref, "mixtral-8x22b train", mixtral,
                                               f32, window=MIXTRAL_WINDOW),
                "train_mla": flash_bwd_row(torch, ops, ref, "deepseek-v3 train", mla, f32,
                                           hd_v=128),
                "mla_bf16": flash_bwd_row(torch, ops, ref, "deepseek-v3 train", mla, bf16,
                                          hd_v=128),
                # the float32 softcap backward (no config sets a softcap), at
                # the GPU test's data
                "softcap": flash_bwd_row(torch, ops, ref, "softcap test data", (1, 200, 4, 2, 64),
                                         f32, softcap=50.0, inputs=softcap_bwd_inputs(torch, np))})
    softcap_checks(torch, ops, ref)


def flash_row(torch, ops, ref, label, shape, window, dtype, hd_v=None, causal=True, Sk=None):
    """``flash_attention`` at ``shape`` (B, S, H, KH, hd) in ``dtype``, causal
    unless ``causal=False``: against its plain version (the dtype's
    tolerance), then its time, the plain version's and one
    ``scaled_dot_product_attention`` call's (the library yardstick, never
    called by the port) from CUDA graphs of back-to-back calls; the bound at
    the peak for the inputs' type.  With ``hd_v`` (MLA) v has heads of that
    width, read in place as the tail of each head's [k_nope | v] row of 2 x
    hd_v, as ``mla_forward`` passes it; with ``Sk`` (cross-attention, not
    causal) k and v have Sk rows.  Returns the row for the kernels line, with
    ``key``: the call's shape as the wrapper counts it (``ops.shape_key``)."""
    B, S, H, KH, hd = shape
    Sk = Sk or S
    q, k, kv = (t.to(dtype) for t in attn_inputs(
        torch, [(B, S, H, hd), (B, Sk, KH, hd), (B, Sk, KH, 2 * hd_v if hd_v else hd)], 7))
    v = kv[..., hd_v:] if hd_v else kv
    want = ref.flash_attention_ref(q, k, v, causal, window)
    err = check_close(torch, f"flash_attention {label}",
                      ops.flash_attention(q, k, v, causal, window), want, dtype)
    lib = sdpa_call(torch, q, k, v, causal, window)
    lib_err = max_abs(lib().transpose(1, 2), want)
    ms = time_graph(torch, [lambda: ops.flash_attention(q, k, v, causal, window)] * 10)
    plain_ms = time_graph(torch, [lambda: ref.flash_attention_ref(q, k, v, causal, window)] * 3)
    lib_ms = time_graph(torch, [lib] * 10)
    nbytes, nops = flash_counts(B, S, H, KH, hd, causal, window, q.element_size(), hd_v, Sk)
    b_ms, b_by = bound(nbytes, nops, peak_ops(torch, dtype))
    log(f"[kernels] flash_attention {label} B={B} S={S} {f'Sk={Sk} ' if Sk != S else ''}H={H} "
        f"KH={KH} hd={hd} {f'hd_v={hd_v} (v strided) ' if hd_v else ''}"
        f"{'causal' if causal else 'bidirectional'} "
        f"window={window} {str(dtype)[6:]}: max abs err {err:.3e}; {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms (max abs diff {lib_err:.2e}), bound "
        f"{b_ms:.4f} ms ({b_by}: {nops / 1e9:.3f} GFLOP, {nbytes / 1e6:.2f} MB)")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib_ms, key=ops.shape_key(q, k, v, causal, window))


def decode_timing(torch, ops, ref, rows):
    """``decode_attention`` at minicpm-2b and gemma3-4b width over a 2,048-long
    cache: its time, its plain version's and one ``scaled_dot_product_attention``
    call's, from CUDA graphs over 8 caches in turn (a decode step's cache was
    last touched a whole model ago: > 50 MB, so L2 cold), and the device time
    by kernel of one replay of the kernel's graph.  Takes ``ops`` and ``ref``
    as arguments, so that it can time another tree's package."""
    F = torch.nn.functional
    MINI, GEMMA = (1, 36, 36, 64), (1, 8, 4, 256)
    for label, (B, H, KH, hd), valid, window in (("minicpm-2b", MINI, 1024, None),
                                                 ("gemma3-4b", GEMMA, 2047, 1024)):
        S, n = 2048, 8
        q, = attn_inputs(torch, [(B, H, hd)], 8)
        caches = [attn_inputs(torch, [(B, S, KH, hd), (B, S, KH, hd)], 9 + c) for c in range(n)]
        lo = max(0, valid - window + 1) if window else 0
        qt = q[:, :, None, :]
        live = [[t[:, lo:valid + 1].transpose(1, 2) for t in kv] for kv in caches]
        want = ref.decode_attention_ref(q, *caches[0], valid, window)
        lib_err = max_abs(F.scaled_dot_product_attention(qt, *live[0], enable_gqa=True)[:, :, 0], want)
        ms = time_graph(torch, [lambda kv=kv: ops.decode_attention(q, *kv, valid, window)
                                for kv in caches])
        plain_ms = time_graph(torch, [lambda kv=kv: ref.decode_attention_ref(q, *kv, valid, window)
                                      for kv in caches])
        lib_ms = time_graph(torch, [lambda kv=kv: F.scaled_dot_product_attention(
            qt, *kv, enable_gqa=True) for kv in live])
        nbytes, nops = decode_counts(S, H, KH, hd, [valid] * B, window, 4, 4)
        b_ms, b_by = bound(nbytes, nops)
        log(f"[kernels] decode_attention {label} cache {S} H={H} KH={KH} hd={hd} "
            f"valid_len={valid} window={window} f32, {n} caches in turn: {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms (max abs diff {lib_err:.2e}), bound "
            f"{b_ms:.5f} ms ({b_by}: {nbytes / 1e6:.2f} MB, {nops / 1e6:.2f} MFLOP)")
        if label == "minicpm-2b":
            rows["decode_attention"] = dict(
                name="decode_attention", route="cuda",
                source="src/repro_torch/kernels/csrc/decode_attention.cu",
                replaces="src/repro/kernels/decode_attention.py:71",
                ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)
        # what the card does around such a call: a graph node of one tiny
        # kernel (the floor of any launch), and a plain streaming kernel that
        # reads the same live K and V once and writes one of them
        tiny = torch.zeros(1, device=DEVICE)
        floor_ms = time_graph(torch, [lambda: tiny.add_(1)] * n)
        rows = [[t[:, lo:valid + 1] for t in kv] for kv in caches]
        buf = torch.empty_like(rows[0][0])
        stream_ms = time_graph(torch, [lambda kv=kv: torch.add(*kv, out=buf) for kv in rows])
        log(f"[kernels] decode_attention {label} yardsticks, {n} calls in turn: one tiny kernel "
            f"{floor_ms:.4f} ms; torch.add of the live K and V rows "
            f"({3 * buf.numel() * buf.element_size() / 1e6:.2f} MB moved) {stream_ms:.4f} ms")
        ks = graph_kernels(torch, [lambda kv=kv: ops.decode_attention(q, *kv, valid, window)
                                   for kv in caches])
        log(f"[kernels] decode_attention {label}, one replay of its {n}-call graph by kernel "
            "(torch.profiler, ms per call): " + ("; ".join(
                f"{name[:60]} x{c} {t:.5f}" if c else f"first start to last end {t:.5f}"
                for name, c, t in ks) or "not measured (the profiler saw no kernel)"))


def decode_batch_timing(torch, np, ops, ref, rows):
    """``decode_attention`` at the batch phase's shapes (llava width: B=8,
    H=32, KH=8, hd=128, 1,024-position cache, q in bfloat16, seeded (B,)
    lengths) with a bfloat16 and an fp8 cache (``rows["decode_attention_batch"]``),
    and at the new paths' shapes (``rows["decode_attention_shapes"]``):
    zamba2-2.7b width (B=1, H=KH=32, hd=80, float32, 2,048-position cache,
    valid_len 1,024), mixtral-8x22b batch width (the llava lengths, H=48,
    KH=8, hd=128, q and cache in bfloat16, window 4096) and whisper-small's
    (H=KH=12, hd=64, float32) self and cross shapes."""
    # seeded per-row lengths: what 8 slots hold in the middle of the batch run
    lengths = np.random.default_rng(7).integers(16, 577, BATCH_SLOTS).tolist()
    llava = (BATCH_SLOTS, BATCH_MAX_LEN, 32, 8, 128)
    rows["decode_attention_batch"] = {
        label: decode_row(torch, ops, ref, f"llava width {label} cache", llava, lengths, None,
                          torch.bfloat16, dtype, 30)
        for label, dtype in (("bf16", torch.bfloat16), ("fp8", torch.float8_e4m3fn))}
    rows["decode_attention_shapes"] = {
        "zamba2": decode_row(torch, ops, ref, "zamba2-2.7b width", (1, 2048, 32, 32, 80), [1024],
                             None, torch.float32, torch.float32, 50),
        "mixtral": decode_row(torch, ops, ref, "mixtral-8x22b batch width",
                              (BATCH_SLOTS, BATCH_MAX_LEN, 48, 8, 128), lengths, 4096,
                              torch.bfloat16, torch.bfloat16, 40),
        # whisper-small, every decode attention of its paths: self over the
        # endpoints' 2,048-row cache (serve and audio, B=1, the middle of
        # positions 440-447) and the batcher's (B=8, the llava lengths);
        # cross over the serve part's 8 rows of zero memory, the audio
        # part's 1,500 encoded rows (B=1) and the batch step's 1,500 (B=8)
        **{label: decode_row(torch, ops, ref, f"whisper-small {label[8:]}", (B, S, 12, 12, 64),
                             lens, None, torch.float32, torch.float32, seed, n=n)
           for label, (B, S, lens, seed, n) in {
               "whisper_self_b1": (1, WHISPER_CACHE, [WHISPER_PROMPT + 3], 80, 16),
               "whisper_cross_b1_8": (1, 8, [7], 100, 16),
               "whisper_cross_b1": (1, WHISPER_FRAMES, [WHISPER_FRAMES - 1], 120, 16),
               "whisper_self_b8": (BATCH_SLOTS, BATCH_MAX_LEN, lengths, 140, 8),
               "whisper_cross_b8": (BATCH_SLOTS, WHISPER_FRAMES,
                                    [WHISPER_FRAMES - 1] * BATCH_SLOTS, 160, 8)}.items()}}


def decode_row(torch, ops, ref, label, shape, lengths, window, q_dtype, cache_dtype, seed, n=8):
    """``decode_attention`` at ``shape`` (B, S, H, KH, hd) with (B,) lengths
    ``lengths`` on the card: against its plain version (q's tolerance), then
    its time, the plain version's and one ``scaled_dot_product_attention``
    call's with the per-row mask on a copy of the cache in q's dtype (the
    library yardstick; it takes no fp8), from CUDA graphs over ``n`` caches in
    turn (L2 cold); bound from the bytes of the live rows at the cache's
    element size.  Returns the row for the kernels line, with ``key``: the
    call's shape as the wrapper counts it (``ops.shape_key``)."""
    F = torch.nn.functional
    B, S, H, KH, hd = shape
    valid = torch.tensor(lengths, dtype=torch.int32, device=DEVICE)
    q, = attn_inputs(torch, [(B, H, hd)], seed)
    q = q.to(q_dtype)
    caches = [[t.to(cache_dtype) for t in attn_inputs(torch, [(B, S, KH, hd)] * 2, seed + 1 + c)]
              for c in range(n)]
    want = ref.decode_attention_ref(q, *caches[0], valid, window)
    err = check_close(torch, f"decode_attention {label}",
                      ops.decode_attention(q, *caches[0], valid, window), want, q_dtype)
    pos = torch.arange(S, device=DEVICE)
    live = pos[None, :] <= valid[:, None]
    if window:
        live &= valid[:, None] - pos[None, :] < window
    mask = live[:, None, None, :]
    lib_kv = [[t.to(q_dtype).transpose(1, 2) for t in kv] for kv in caches]
    qt = q[:, :, None, :]
    lib_err = max_abs(F.scaled_dot_product_attention(qt, *lib_kv[0], attn_mask=mask,
                                                     enable_gqa=True)[:, :, 0], want)
    ms = time_graph(torch, [lambda kv=kv: ops.decode_attention(q, *kv, valid, window)
                            for kv in caches])
    plain_ms = time_graph(torch, [lambda kv=kv: ref.decode_attention_ref(q, *kv, valid, window)
                                  for kv in caches])
    lib_ms = time_graph(torch, [lambda kv=kv: F.scaled_dot_product_attention(
        qt, *kv, attn_mask=mask, enable_gqa=True) for kv in lib_kv])
    nbytes, nops = decode_counts(S, H, KH, hd, lengths, window, q.element_size(),
                                 caches[0][0].element_size())
    b_ms, b_by = bound(nbytes, nops, peak_ops(torch, q_dtype))
    log(f"[kernels] decode_attention {label} B={B} cache {S} H={H} KH={KH} hd={hd} lengths "
        f"{lengths} window={window}, q {str(q_dtype)[6:]}, cache {str(cache_dtype)[6:]}, {n} "
        f"caches in turn: max abs err {err:.3e}; {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa "
        f"on a copy in q's dtype {lib_ms:.4f} ms (max abs diff {lib_err:.2e}), bound "
        f"{b_ms:.5f} ms ({b_by}: {nbytes / 1e6:.2f} MB, {nops / 1e6:.2f} MFLOP)")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib_ms, key=ops.shape_key(q, *caches[0], window))


def latent_counts(H, dc, dr, lengths, S, q_elem, cache_elem):
    """The latent decode's bytes (q_lat, q_rope and out at q's element size,
    the live c and r rows once at the cache's) and operations (2 x (dc + dr)
    for the score and 2 x dc for the value, per head and live row)."""
    n_live = sum(min(n, S - 1) + 1 for n in lengths)
    B = len(lengths)
    nbytes = B * H * (2 * dc + dr) * q_elem + n_live * (dc + dr) * cache_elem
    return nbytes, 2 * H * (2 * dc + dr) * n_live


def latent_row(torch, ops, ref, label, B, S, lengths, q_dtype, cache_dtype, seed, n=8):
    """``decode_attention_latent`` at deepseek-v3's dims (128 heads, latent
    512, rope 64) with (B,) lengths ``lengths`` over an S-long cache:
    against its plain version (q's tolerance), then its time, the plain
    version's and one ``scaled_dot_product_attention`` call's on q =
    [q_lat | q_rope] (B,128,1,576) against one kv head [c | r] (576) and c
    (512), joined once beforehand (the library yardstick; the port never
    joins them), from CUDA graphs over ``n`` caches in turn (L2 cold).
    Returns the row for the kernels line."""
    F = torch.nn.functional
    H, dc, dr = 128, 512, 64
    scale = ref.attn_scale(192)
    valid = torch.tensor(lengths, dtype=torch.int32, device=DEVICE)
    q_lat, q_rope = (t.to(q_dtype) for t in attn_inputs(torch, [(B, H, dc), (B, H, dr)], seed))
    caches = [[t.to(cache_dtype) for t in attn_inputs(torch, [(B, S, dc), (B, S, dr)],
                                                      seed + 1 + c)] for c in range(n)]
    want = ref.decode_attention_latent_ref(q_lat, q_rope, *caches[0], valid, scale)
    err = check_close(torch, f"decode_attention_latent {label}",
                      ops.decode_attention_latent(q_lat, q_rope, *caches[0], valid, scale), want,
                      q_dtype)
    pos = torch.arange(S, device=DEVICE)
    mask = (pos[None, :] <= valid[:, None])[:, None, None, :]
    qt = torch.cat([q_lat, q_rope], -1)[:, :, None, :]
    lib_kv = [(torch.cat([c, r], -1).to(q_dtype)[:, None], c.to(q_dtype)[:, None])
              for c, r in caches]
    lib = lambda kv: F.scaled_dot_product_attention(  # noqa: E731
        qt, *kv, attn_mask=mask, scale=scale, enable_gqa=True)
    lib_err = max_abs(lib(lib_kv[0])[:, :, 0], want)
    fns = [lambda kv=kv: ops.decode_attention_latent(q_lat, q_rope, *kv, valid, scale)
           for kv in caches]
    ms = time_graph(torch, fns)
    # the device time of each CUDA launch of one call (the tensor-core path
    # may launch more than one kernel a call)
    launch_ms = {name.replace("(anonymous namespace)::", "").split("(")[0].split("<")[0]
                 .split()[-1]: round(t, 5) for name, _, t in graph_kernels(torch, fns)[1:]}
    variant = "wgmma" if q_dtype == cache_dtype == torch.bfloat16 else "cuda-core"
    plain_ms = time_graph(torch, [lambda kv=kv: ref.decode_attention_latent_ref(
        q_lat, q_rope, *kv, valid, scale) for kv in caches])
    lib_ms = time_graph(torch, [lambda kv=kv: lib(kv) for kv in lib_kv])
    nbytes, nops = latent_counts(H, dc, dr, lengths, S, q_lat.element_size(),
                                 caches[0][0].element_size())
    b_ms, b_by = bound(nbytes, nops, peak_ops(torch, q_dtype))
    log(f"[kernels] decode_attention_latent {label} B={B} cache {S} H={H} latent {dc}+{dr} "
        f"lengths {lengths}, q {str(q_dtype)[6:]}, cache {str(cache_dtype)[6:]}, {n} caches in "
        f"turn: max abs err {err:.3e}; {variant} kernel {ms:.4f} ms (by launch {launch_ms}), "
        f"plain {plain_ms:.4f} ms, sdpa on the joined cache {lib_ms:.4f} ms (max abs diff "
        f"{lib_err:.2e}), bound {b_ms:.5f} ms ({b_by}: {nbytes / 1e6:.2f} MB, "
        f"{nops / 1e6:.2f} MFLOP)")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib_ms, variant=variant, launch_ms=launch_ms)


def run_launcher():
    """``python -m repro_torch.launch.serve --fail-at 2`` on the card, in
    process; checks its request lines, the failure/join line and the
    summary."""
    import contextlib
    import io

    from repro_torch.launch import serve as launch_serve

    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        launch_serve.main(["--fail-at", "2"])
    lines = out.getvalue().splitlines()
    reqs = [ln for ln in lines if ln.strip().startswith("[")]
    if len(reqs) != 24 or not any("failed; worker" in ln for ln in lines) \
            or not lines[-1].startswith("summary:") or f"device={DEVICE}" not in lines[0]:
        fail("launcher output is not as expected:\n" + "\n".join(lines))
    log(f"[launcher] 24 requests on the card in {time.perf_counter() - t0:.1f} s; "
        f"{next(ln.strip() for ln in lines if 'failed; worker' in ln)}; {lines[-1]}")


def pad_to(torch, ts, S, Q):
    pad = (-S) % Q
    if not pad:
        return ts
    x, dt, A, Bm, Cm = ts
    F = torch.nn.functional
    return (F.pad(x, (0, 0, 0, 0, 0, pad)), F.pad(dt, (0, 0, 0, pad)), A,
            F.pad(Bm, (0, 0, 0, 0, 0, pad)), F.pad(Cm, (0, 0, 0, 0, 0, pad)))


def kernel_events(kinds, segments):
    """The events each scheduling kernel carries when the stream's
    ``[lo, hi)`` segments are cut into ``chunk``-event bursts as
    ``core/sched.py::_fused`` cuts them (an all-ARRIVAL burst goes to
    ``sched_step``); ``segments`` is ``[(lo, hi, chunk), ...]``.  Returns
    ({name: events}, {name: bursts})."""
    events, bursts = {"sched_events": 0, "sched_step": 0}, {"sched_events": 0, "sched_step": 0}
    for lo, hi, chunk in segments:
        for a in range(lo, hi, chunk):
            k = kinds[a: min(a + chunk, hi)]
            name = "sched_step" if bool((k == 0).all()) else "sched_events"
            events[name] += len(k)
            bursts[name] += 1
    return events, bursts


def sched_inputs(torch, np):
    n, F, W = 65_536, 40, 1600
    return n, F, W, torch.from_numpy(sched_stream(np, n, F, W, seed=3))


def phase_sched(torch, np, core):
    """The scheduling path; returns ({kernel: events it carried}, {kernel:
    bursts}), the latter for a check against the launch counts."""
    n, F, W, ev = sched_inputs(torch, np)
    t0 = time.perf_counter()
    s_ref, (w_ref, warm_ref) = core.sched_many(core.init_state(F, W, "cpu"), ev)
    cpu_s = time.perf_counter() - t0

    def same(name, s, ws, warm):
        for a, b in ((ws, w_ref), (warm, warm_ref), (s.idle, s_ref.idle), (s.conns, s_ref.conns)):
            if not torch.equal(a.cpu(), b):
                fail(f"{name} differs from sched_many on the CPU")

    # per-window densities: bursts at windows 0 and 8, two quiet windows that
    # step event by event
    dens = [5000, 3000, 1500, 1200, 300, 0, 0, 300, 8000, 5000, 2000, 1000, 400, 300, 1500, 1500]
    seg = n // 16
    core.sched_many_fused(core.init_state(F, W), ev[:SCHED_CHUNK], chunk=SCHED_CHUNK)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s, (ws, warm) = core.sched_many_fused(core.init_state(F, W), ev, chunk=SCHED_CHUNK)
    torch.cuda.synchronize()
    fused_s = time.perf_counter() - t0
    same("sched_many_fused", s, ws, warm)

    t0 = time.perf_counter()
    s, (ws, warm) = core.sched_many_adaptive(core.init_state(F, W), ev, core.BurstDetector(),
                                             densities=dens, segment=seg)
    torch.cuda.synchronize()
    adaptive_s = time.perf_counter() - t0
    same("sched_many_adaptive", s, ws, warm)

    # the chunks of each run: the warm-up burst, the fused run, and the
    # adaptive run's window chunks, which a detector of its own replays
    det = core.BurstDetector()
    plan = [(0, SCHED_CHUNK, SCHED_CHUNK), (0, n, SCHED_CHUNK)] + [
        (i * seg, (i + 1) * seg, c) for i, c in enumerate(det.observe(d) for d in dens) if c > 1]
    events, bursts = kernel_events(ev[:, 0].numpy(), plan)
    log(f"[sched] {n} events W={W} F={F}: fused {n / fused_s:,.0f} ev/s, adaptive "
        f"{n / adaptive_s:,.0f} ev/s, plain scan on the CPU {n / cpu_s:,.0f} ev/s; "
        "both bitwise equal to the CPU scan")
    log(f"[sched] events carried: sched_events {events['sched_events']:,}, sched_step "
        f"{events['sched_step']:,}")
    return events, bursts


def trace_sched(torch, np, core):
    """One fused run of the scheduling stream under ``torch.profiler``: the
    device's busy share of its wall time and the scheduling kernels' share of
    the busy time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    n, F, W, ev = sched_inputs(torch, np)
    core.sched_many_fused(core.init_state(F, W), ev[:SCHED_CHUNK], chunk=SCHED_CHUNK)  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        core.sched_many_fused(core.init_state(F, W), ev, chunk=SCHED_CHUNK)
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3
    self_us = lambda e: getattr(e, "self_device_time_total", 0) or 0  # noqa: E731
    dev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(self_us(e) for e in dev) / 1e3
    if busy_ms == 0:
        log("[sched trace] device time: not measured (the profiler saw no kernel time)")
        return
    sched_ms = sum(self_us(e) for e in dev if "sched" in e.key) / 1e3
    log(f"[sched trace] traced fused run {traced_ms:.1f} ms: device busy {busy_ms:.2f} ms "
        f"({100 * busy_ms / traced_ms:.1f}%), of which scheduling kernels {sched_ms:.2f} ms "
        f"({100 * sched_ms / busy_ms:.1f}% of busy), {sum(e.count for e in dev)} device entries")
    for e in sorted(dev, key=self_us, reverse=True)[:6]:
        log(f"[sched trace]   {self_us(e) / 1e3:8.3f} ms  x{e.count:<5d} {e.key[:90]}")


def serve(torch, np, eng, prefix, vocab, label, order=None, prompt_len=1024):
    """Submit the 8 requests of ``ORDER`` (seeded prompts of ``prompt_len``
    tokens, gen_len 8) to ``eng``'s endpoints ``prefix0..2``, or one request
    to each endpoint name of ``order``; check cold then warm on the same
    worker.  Returns (worker of the first request, its prompt, the number of
    requests, the number of cold starts: each captures the decode step after
    one eager call of it)."""
    rng = np.random.default_rng(4)
    order = order or [f"{prefix}{i}" for i in ORDER]
    prompts = [torch.from_numpy(rng.integers(0, vocab, (1, prompt_len)).astype(np.int32))
               for _ in order]
    first = {}
    for func, tok in zip(order, prompts):
        r = eng.submit(func, tok, gen_len=8)
        if func not in first:
            first[func] = r
            if not r.cold:
                fail(f"first request to {func} was warm")
        elif r.cold or r.worker != first[func].worker:
            fail(f"repeat request to {func} was cold or left its warm worker")
    cold = [r.latency_ms for r in eng.records if r.cold]
    warm = [r.latency_ms for r in eng.records if not r.cold]
    log(f"[{label}] {len(order)} requests, {prompt_len}-token prompts, gen_len 8: cold "
        f"{statistics.median(cold):.1f} ms (median of {len(cold)}), warm "
        f"{statistics.median(warm):.1f} ms (median of {len(warm)}), scheduler overhead "
        f"{eng.summary()['sched_overhead_ms'] * 1e3:.1f} us; workers "
        f"{[r.worker for r in eng.records]}")
    return first[order[0]].worker, prompts[0], len(order), len(cold)


def full_width(get_config, name, width):
    cfg = get_config(name)
    if (cfg.n_layers, cfg.d_model, cfg.vocab) != width:
        fail(f"{name} is not at full width {width}")
    return cfg


def generate_with_logits(torch, inst, prompt, gen_len):
    """``Instance.generate``'s loop (prefill, then decode from a zero cache),
    also returning each step's logits."""
    model = inst.model
    prompt = prompt.to(inst.device)
    cache = inst.decode_cache(1)
    _, lg = model.prefill(inst.params, inst.prefill_batch(prompt))
    logits, out = [lg], [lg.argmax(-1)]
    idx = min(prompt.shape[1], inst.endpoint.max_cache_len - gen_len - 1)
    for i in range(gen_len - 1):
        lg, cache = model.decode_step(inst.params, out[-1][:, None], cache, idx + i)
        logits.append(lg)
        out.append(lg.argmax(-1))
    return torch.stack(out, 1).cpu(), [v.cpu() for v in logits]


def check_serve_against_cpu(torch, Instance, eng, wid, func, prompt, label):
    """One request re-run on the CPU copy of the same parameters, through the
    plain path: the prefill logits within TOL_LOGITS, and the same tokens up
    to the first step whose CPU top-2 logits are closer than the tolerance
    (a near-tie may rightly flip)."""
    inst = eng.workers[wid].idle[func][0]
    tokens = inst.generate(prompt, 8).cpu()  # each decode step one replay of the captured step
    gpu_tokens, gpu_logits = generate_with_logits(torch, inst, prompt, 8)  # eager
    if not torch.equal(tokens, gpu_tokens):
        fail(f"replayed tokens {tokens.tolist()} differ from the eager loop's "
             f"{gpu_tokens.tolist()} on the card")
    cpu = Instance(inst.endpoint, device="cpu", params=_to_cpu(inst.params))
    cpu_tokens, cpu_logits = generate_with_logits(torch, cpu, prompt, 8)
    err = max_abs(gpu_logits[0], cpu_logits[0])
    if not torch.allclose(gpu_logits[0], cpu_logits[0], **TOL_LOGITS):
        fail(f"prefill logits differ from the CPU plain path: max abs err {err:.3e}")
    agree = 8
    if not torch.equal(gpu_tokens, cpu_tokens):
        agree = int((gpu_tokens != cpu_tokens).int().argmax())
        top2 = cpu_logits[agree].topk(2).values[0]
        if float(top2[0] - top2[1]) > 2 * TOL_LOGITS["atol"]:
            fail(f"generated tokens differ from the CPU plain path at step {agree}: "
                 f"{gpu_tokens.tolist()} vs {cpu_tokens.tolist()}")
    log(f"[{label}] replayed tokens equal the eager loop's on the card; card vs CPU plain path "
        f"on the same weights, {prompt.shape[1]}-token prompt: prefill logits max abs err "
        f"{err:.3e} (atol 1e-3, rtol 1e-3); tokens equal for {agree}/8 steps "
        f"{gpu_tokens.tolist()[0]}")


def profile_warm_request(torch, eng, wid, func, prompt, label):
    """Where a warm request's time goes: prefill and the whole request on
    the host clock (each ending in a synchronize), then one request under
    ``torch.profiler`` for device time by kernel and the device's busy share
    of the request's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    inst = eng.workers[wid].idle[func][0]
    batch = inst.prefill_batch(prompt.to(inst.device))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    inst.model.prefill(inst.params, batch)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    inst.generate(prompt, 8)
    request_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        inst.generate(prompt, 8)
        traced_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof_prefill:
        inst.model.prefill(inst.params, batch)
        torch.cuda.synchronize()
    self_us = lambda e: getattr(e, "self_device_time_total", 0) or 0  # noqa: E731
    tag = f"[profile {label}]"
    pre = [e for e in prof_prefill.key_averages() if e.device_type == DeviceType.CUDA]
    pre_ms = sum(self_us(e) for e in pre) / 1e3
    if pre_ms == 0:
        log(f"{tag} prefill device time: not measured (the profiler saw no kernel time)")
    else:
        log(f"{tag} traced warm prefill: device busy {pre_ms:.2f} ms, "
            f"{sum(e.count for e in pre)} kernel launches")
        for e in sorted(pre, key=self_us, reverse=True)[:8]:
            log(f"{tag}   prefill {self_us(e) / 1e3:8.3f} ms  x{e.count:<5d} {e.key[:80]}")
    kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(self_us(e) for e in kern) / 1e3
    log(f"{tag} warm request ({prompt.shape[1]:,}-token prefill + 7 decode steps): "
        f"{request_ms:.1f} ms, "
        f"of which prefill {prefill_ms:.1f} ms (host clock)")
    if busy_ms == 0:
        log(f"{tag} device time: not measured (the profiler saw no kernel time)")
        return
    log(f"{tag} traced request {traced_ms:.1f} ms: device busy {busy_ms:.2f} ms "
        f"({100 * busy_ms / traced_ms:.1f}%), idle {100 * (1 - busy_ms / traced_ms):.1f}%, "
        f"{sum(e.count for e in kern)} kernel launches")
    for e in sorted(kern, key=self_us, reverse=True)[:8]:
        log(f"{tag}   {self_us(e) / 1e3:8.3f} ms  x{e.count:<5d} {e.key[:90]}")


def batch_requests(np, vocab, n=16, seed=6):
    """The batch phase's requests: seeded prompts of 16-512 tokens and
    ``max_new_tokens`` of 8-64."""
    rng = np.random.default_rng(seed)
    return [(f"r{i}", rng.integers(0, vocab, int(rng.integers(16, 513))).tolist(),
             int(rng.integers(8, 65))) for i in range(n)]


def plain_in_f32(plain):
    """An attention kernel's plain version (``ref.decode_attention_ref`` or
    ``ref.flash_attention_ref``) in the Pallas kernel's arithmetic (and the
    CUDA kernel's): q upcast to float32, every product in float32, one
    rounding to q's dtype at the end.  The plain versions on a bfloat16 q
    round the probabilities to bfloat16 before the product with V, as
    ``repro.kernels.ref`` and the models' ``sdpa`` do."""
    def f(q, *args):
        return plain(q.float(), *args).to(q.dtype)
    return f


def swapped(ops, fn, name="decode_attention"):
    """A context in which the model calls ``fn`` in place of ``ops.<name>``."""
    import contextlib

    @contextlib.contextmanager
    def cm():
        kernel = getattr(ops, name)
        setattr(ops, name, fn)
        try:
            yield
        finally:
            setattr(ops, name, kernel)

    return cm()


def rel_rows(a, b) -> float:
    """The largest relative L2 difference of a row of ``a`` from ``b``."""
    a, b = a.float(), b.float()
    return float(((a - b).norm(dim=-1) / b.norm(dim=-1)).max())


def recorder(route, out):
    """``route`` that also appends each call's result (gates, experts, aux)
    to ``out``."""
    def f(*args):
        r = route(*args)
        out.append(r)
        return r
    return f


def replayer(records):
    """A router that returns ``records`` in turn: another run's routing."""
    it = iter(records)
    return lambda *args: next(it)


def check_batch_step(torch, ops, ref, moe, b, snap, kernel="decode_attention"):
    """The step ``b`` just replayed, from ``snap`` (its cache as it was
    before the step) and the same tokens and lengths: (1) run eagerly with
    every call of the decode kernel ``kernel`` (``decode_attention``, or
    MLA's ``decode_attention_latent``) also made by its plain version in the
    Pallas kernel's arithmetic on the same inputs, each layer within
    atol=rtol=2e-2 (the bf16 tolerance of tests/test_kernels.py), and the
    eager logits equal to the replayed ones bit for bit; (2) the logits of
    the plain per-row path on the card (Pallas arithmetic), within a
    relative L2 of 2e-2 a row.  The logits are not held elementwise to
    2e-2: after 32 bfloat16 layers the two plain versions (probabilities
    rounded to bfloat16 or not) already differ by more than that.  In a MoE
    model the plain paths take the kernel path's routing (``moe.route``'s
    experts and gates, recorded in (1)): a top-k choice is a step function
    of its input, so a last-bit difference upstream can move a token to
    another expert and change its row entirely.  Such a plain path with its
    own routing is run too, and its differing choices and row error are
    returned for the record.  The comparison's own launches are taken off
    the counters.  Returns (largest layer error, logits' max abs err and
    row relative L2 against the plain path, the same between the two plain
    paths, and for a MoE model (expert choices that differ, choices made,
    row relative L2) with the plain path's own routing, else None)."""
    name = kernel
    kernel, plain_ref = getattr(ops, name), getattr(ref, f"{name}_ref")
    plain = plain_in_f32(plain_ref)
    layer_errs, routes = [], []

    def both(*args):
        out, want = kernel(*args), plain(*args)
        layer_errs.append(max_abs(out, want))
        if not torch.allclose(out.float(), want.float(), **TOL_ATTN_BF16):
            fail(f"batch step {b.steps}: {name} of layer {len(layer_errs) - 1} "
                 f"differs from its plain version by {layer_errs[-1]:.3e} (atol 2e-2, rtol 2e-2)")
        return out

    def step(attn, route):
        with swapped(ops, attn, name), swapped(moe, route, "route"), torch.no_grad():
            return b.model.decode_step(b.params, b.step_tokens.clone(), _clone(snap),
                                       b.step_lengths.clone())[0]

    counts = ops.launch_counts()
    eager = step(both, recorder(moe.route, routes))
    ops.restore_launches(counts)
    if not torch.equal(eager, b.logits):
        fail(f"batch step {b.steps}: the replayed logits differ from the eager step's by "
             f"{max_abs(eager, b.logits):.3e}")
    wants = [step(fn, replayer(routes)) for fn in (plain, plain_ref)]
    err, rel = max_abs(b.logits, wants[0]), rel_rows(b.logits, wants[0])
    if rel > 2e-2:
        fail(f"batch step {b.steps}: logits differ from the plain per-row path by a relative "
             f"L2 of {rel:.3e} in a row (max abs {err:.3e})")
    free = None
    if routes:
        own = []
        logits = step(plain, recorder(moe.route, own))
        free = (sum(int((a[1] != c[1]).sum()) for a, c in zip(routes, own)),
                sum(a[1].numel() for a in routes), rel_rows(b.logits, logits))
    return max(layer_errs), err, rel, max_abs(*wants), rel_rows(*wants), free


def drive_batcher(torch, ops, ref, moe, b, check_step, kernel="decode_attention"):
    """Step ``b`` until its queue and slots are empty.  Returns the host-clock
    seconds of each step (each ends in the argmax read-back, so it waits for
    the device) and ``check_batch_step``'s numbers for step ``check_step``
    with the step's lengths."""
    times, check = [], None
    while True:
        snap = _clone(b.mgr.cache) if b.steps == check_step else None
        t0 = time.perf_counter()
        running = b.step()
        times.append(time.perf_counter() - t0)
        if snap is not None:
            check = (*check_batch_step(torch, ops, ref, moe, b, snap, kernel),
                     b.step_lengths.tolist())
            del snap
        if running == 0 and not b.queue:
            return times, check


def trace_batch_steps(torch, np, b, GenRequest, vocab, n_steps=16):
    """``n_steps`` batcher steps with every slot busy, under
    ``torch.profiler``: (traced ms on the host clock, device busy ms, the
    device entries)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for rid, prompt, n in batch_requests(np, vocab, BATCH_SLOTS, seed=9):
        b.submit(GenRequest(f"trace-{rid}", prompt, max_new_tokens=n))
    for _ in range(2):  # admitted; every request holds its slot 23 steps or more
        b.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            b.step()
        traced_ms = (time.perf_counter() - t0) * 1e3
    self_us = lambda e: getattr(e, "self_device_time_total", 0) or 0  # noqa: E731
    dev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(self_us(e) for e in dev) / 1e3
    return traced_ms, busy_ms, dev


def run_batcher(torch, np, ops, ref, moe, serving, model, params, dtype, reqs, tag,
                kernel="decode_attention"):
    """``reqs`` through a ``ContinuousBatcher`` of 8 slots x 1,024 positions
    with a ``dtype`` cache, each step one replay of the captured step, then 16
    traced steps with every slot busy.  Checks ``decode_attention_calls()`` of
    the decode kernel ``kernel`` (``decode_attention``, or MLA's
    ``decode_attention_latent``) in the captured step, one replay per step,
    every request complete with its token count, and step 200 against the
    plain per-row path (``check_batch_step``); prints steps/s, tokens/s, ms a
    step and the traced idle share.  Returns ({request: tokens}, the cache's
    bytes, the replays made)."""
    L = model.decode_attention_calls()
    t0 = time.perf_counter()
    b = serving.ContinuousBatcher(model, params, n_slots=BATCH_SLOTS, max_len=BATCH_MAX_LEN,
                                  dtype=dtype)
    capture_s = time.perf_counter() - t0
    if b.captured.launches[kernel] != L:
        fail(f"the captured batch step holds {b.captured.launches} launches, not {L} {kernel}")
    for rid, prompt, n in reqs:
        b.submit(serving.GenRequest(rid, prompt, max_new_tokens=n))
    times, (layer_err, err, rel, spread, spread_rel, free, lengths) = drive_batcher(
        torch, ops, ref, moe, b, check_step=200, kernel=kernel)
    if b.captured.replays != b.steps:
        fail(f"{b.captured.replays} replays for {b.steps} batcher steps")
    done = b.completed
    if sorted(done) != sorted(r[0] for r in reqs) or any(
            len(done[rid].generated) != n for rid, _, n in reqs):
        fail(f"{tag}: requests incomplete or with the wrong token counts")
    wall = sum(times)
    gen = sum(n for _, _, n in reqs)
    fed = sum(len(p) + n - 1 for _, p, n in reqs)
    nbytes = b.mgr.bytes()
    log(f"{tag} cache ({nbytes / 1e9:.3f} GB): {len(reqs)} requests in "
        f"{b.steps} steps, {wall:.2f} s on the host clock: {b.steps / wall:.1f} steps/s, "
        f"{gen / wall:.1f} generated tokens/s, {fed / wall:.1f} tokens fed/s (prompts "
        f"through decode), {1e3 * wall / b.steps:.2f} ms a step (median "
        f"{1e3 * statistics.median(times):.2f}); capture {capture_s:.2f} s")
    log(f"{tag} step 200 (lengths {lengths}): each layer's {kernel} vs "
        f"its plain version on the same inputs max abs err {layer_err:.3e} (atol 2e-2, rtol "
        f"2e-2); replayed logits equal the eager step's; logits vs the plain per-row path "
        f"max abs err {err:.3e}, row relative L2 {rel:.2e} (limit 2e-2); the two plain "
        f"paths differ by {spread:.3e}, {spread_rel:.2e}" + (
            "" if free is None else f"; both plain paths take the kernel path's routing: with "
            f"its own, the plain path chose another expert {free[0]} times of {free[1]} (row "
            f"relative L2 {free[2]:.2e})"))
    traced_ms, busy_ms, dev = trace_batch_steps(torch, np, b, serving.GenRequest,
                                                model.cfg.vocab)
    if busy_ms:
        log(f"{tag} traced 16 steps, 8 busy slots: {traced_ms:.1f} ms, device busy "
            f"{busy_ms:.2f} ms ({100 * busy_ms / traced_ms:.1f}%), idle "
            f"{100 * (1 - busy_ms / traced_ms):.1f}%, {sum(e.count for e in dev)} device entries")
        self_us = lambda e: getattr(e, "self_device_time_total", 0) or 0  # noqa: E731
        for e in sorted(dev, key=self_us, reverse=True)[:6]:
            log(f"{tag}   {self_us(e) / 1e3:8.3f} ms  x{e.count:<5d} {e.key[:90]}")
    else:
        log(f"{tag} device time: not measured (the profiler saw no kernel time)")
    return {rid: done[rid].generated for rid, _, _ in reqs}, nbytes, b.captured.replays


def phase_batch(torch, np, ops, ref, get_config, Model, serving, captured, moe):
    """The batch path: full-width llava-next-mistral-7b (bfloat16 weights
    from seed 0) behind a ``ContinuousBatcher`` of 8 slots x 1,024
    positions, 16 seeded requests, first with a bfloat16 cache and then with
    an fp8 one.  Checks per cache: 32 ``decode_attention`` launches per
    replayed step (and one eager call, the capture's), one replay per step,
    every request complete with its token count, one step against the plain
    per-row path (``check_batch_step``); then the fp8 cache's bytes
    half the bf16
    cache; a solo request's tokens against the same request's beside its
    neighbours.  Returns {cache label: [replays, eager calls]} of the decode
    steps it made (each eager call is a capture's first call)."""
    cfg = full_width(get_config, "llava_next_mistral_7b", LLAVA_WIDTH)
    L = cfg.n_layers
    model = Model(cfg, param_dtype=torch.bfloat16)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=DEVICE).manual_seed(0))
    torch.cuda.synchronize()
    n_bytes = sum(t.numel() * t.element_size() for t in captured.tree_leaves(params))
    log(f"[batch] llava-next-mistral-7b {L}L d{cfg.d_model} {cfg.n_heads}H/{cfg.n_kv_heads}KV "
        f"hd{cfg.head_dim_} d_ff {cfg.d_ff} vocab {cfg.vocab}: {cfg.n_params() / 1e9:.2f} B "
        f"parameters, {n_bytes / 1e9:.2f} GB in bfloat16, drawn in "
        f"{time.perf_counter() - t0:.1f} s")
    reqs = batch_requests(np, cfg.vocab)
    out = {"bf16": [0, 0], "fp8": [0, 0]}
    nbytes, tokens = {}, {}
    for label, dtype in (("bf16", torch.bfloat16), ("fp8", torch.float8_e4m3fn)):
        tokens[label], nbytes[label], out[label][0] = run_batcher(
            torch, np, ops, ref, moe, serving, model, params, dtype, reqs, f"[batch] {label}")
        out[label][1] += 1
        torch.cuda.empty_cache()
    if 2 * nbytes["fp8"] != nbytes["bf16"]:
        fail(f"fp8 cache {nbytes['fp8']} bytes, bf16 {nbytes['bf16']}: not half")
    # isolation at full width: the first request alone gives the tokens it
    # gave beside its neighbours (slot 0 from step 0 in both runs)
    rid, prompt, n = reqs[0]
    for label, dtype in (("bf16", torch.bfloat16), ("fp8", torch.float8_e4m3fn)):
        b = serving.ContinuousBatcher(model, params, n_slots=BATCH_SLOTS, max_len=BATCH_MAX_LEN,
                                      dtype=dtype)
        b.submit(serving.GenRequest(rid, prompt, max_new_tokens=n))
        solo = b.run_to_completion(max_steps=BATCH_MAX_LEN)[rid]
        out[label][0] += b.captured.replays
        out[label][1] += 1
        if solo != tokens[label][rid]:
            fail(f"batch {label}: {rid} alone gave {solo}, beside its neighbours "
                 f"{tokens[label][rid]}")
        del b
    same = sum(x == y for r in tokens["bf16"] for x, y in zip(tokens["bf16"][r], tokens["fp8"][r]))
    log(f"[batch] fp8 cache {nbytes['fp8']:,} bytes = half of bf16's {nbytes['bf16']:,}; {rid} "
        f"({len(prompt)}-token prompt, {n} new) alone gives the tokens it gave beside 15 others, "
        f"with either cache; {same}/{sum(n for _, _, n in reqs)} tokens equal between the two "
        f"caches; peak device memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    return out


def phase_moe(torch, np, ops, ref, get_config, Model, serving, captured, moe):
    """The MoE path: mixtral-8x22b at full width (d_model 6144, 48 / 8 heads
    of 128, window 4096, 8 experts top-2 of d_ff 16,384, vocab 32,768), 8 of
    its 56 layers, bfloat16 weights from seed 0 (router float32), behind the
    batch phase's ``ContinuousBatcher`` (8 slots x 1,024 positions, bfloat16
    cache, the 16 seeded requests, ``run_batcher``'s checks); then one
    ``Model.prefill`` of a 512-token seeded prompt at B=1 (capacity 160 an
    expert, so tokens drop), twice (the second timed): its last logits
    against the same prefill with ``flash_attention`` swapped for its plain
    version in the kernel's arithmetic and the kernel path's routing (as in
    ``check_batch_step``), to a relative L2 of 2e-2, and the assignments
    dropped per layer.  Returns (replays, eager decode calls, prefills)
    made."""
    import dataclasses

    cfg = dataclasses.replace(full_width(get_config, "mixtral_8x22b", MIXTRAL_WIDTH),
                              n_layers=MOE_LAYERS)
    L, m = cfg.n_layers, cfg.moe
    model = Model(cfg, param_dtype=torch.bfloat16)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=DEVICE).manual_seed(0))
    torch.cuda.synchronize()
    n_bytes = sum(t.numel() * t.element_size() for t in captured.tree_leaves(params))
    tag = f"[moe] mixtral-8x22b {L} of 56 layers"
    log(f"{tag}: d{cfg.d_model} {cfg.n_heads}H/{cfg.n_kv_heads}KV hd{cfg.head_dim_} window "
        f"{cfg.sliding_window}, {m.n_experts} experts top-{m.top_k} d_ff {m.expert_dff}, vocab "
        f"{cfg.vocab}: {cfg.n_params() / 1e9:.2f} B parameters, {n_bytes / 1e9:.2f} GB in "
        f"bfloat16 (router float32), drawn in {time.perf_counter() - t0:.1f} s; weights bound a "
        f"step {n_bytes / PEAK_BYTES_PER_S * 1e3:.2f} ms")
    _, _, replays = run_batcher(torch, np, ops, ref, moe, serving, model, params,
                                torch.bfloat16, batch_requests(np, cfg.vocab), f"{tag} bf16")
    torch.cuda.empty_cache()

    # the prefill, where capacity drops tokens; each layer's routing recorded
    prompt = torch.from_numpy(np.random.default_rng(8).integers(0, cfg.vocab, (1, MOE_PROMPT))
                              .astype(np.int32)).to(DEVICE)
    C = moe._capacity(m.capacity_factor, MOE_PROMPT, m.top_k, m.n_experts)
    kernel_routes, plain_routes = [], []
    plain = plain_in_f32(ref.flash_attention_ref)
    with torch.no_grad():
        before = ops.LAUNCHES["flash_attention"]
        with swapped(moe, recorder(moe.route, kernel_routes), "route"):
            _, logits = model.prefill(params, {"tokens": prompt})
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.prefill(params, {"tokens": prompt})  # again, warm, for its time
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        if ops.LAUNCHES["flash_attention"] - before != 2 * L:
            fail(f"two moe prefills launched flash_attention "
                 f"{ops.LAUNCHES['flash_attention'] - before} times, not {L} each")
        # the plain path with the kernel path's routing (see check_batch_step),
        # then with its own for the record
        with swapped(ops, plain, "flash_attention"), swapped(moe, replayer(kernel_routes), "route"):
            _, want = model.prefill(params, {"tokens": prompt})
        with swapped(ops, plain, "flash_attention"), \
                swapped(moe, recorder(moe.route, plain_routes), "route"):
            _, own = model.prefill(params, {"tokens": prompt})
    moved = sum(int((a[1] != b[1]).sum()) for a, b in zip(kernel_routes, plain_routes))
    rel = rel_rows(logits, want)
    if not torch.isfinite(logits).all() or rel > 2e-2:
        fail(f"moe prefill's last logits differ from the plain path's by a relative L2 of "
             f"{rel:.3e} (limit 2e-2)")
    drops = [int(moe.dropped(idx, m.n_experts, C)) for _, idx, _ in kernel_routes]
    log(f"{tag} prefill B=1 T={MOE_PROMPT} (capacity {C} an expert): {prefill_ms:.1f} ms on the "
        f"host clock (warm), flash_attention {L} launches each; last logits vs flash_attention's plain "
        f"version (with the kernel path's routing) relative L2 {rel:.2e} (limit 2e-2), max abs "
        f"{max_abs(logits, want):.3e}; with its own routing the plain path chose another expert "
        f"{moved} times of {L * MOE_PROMPT * m.top_k} (relative L2 {rel_rows(logits, own):.2e}); "
        f"assignments dropped per layer {drops} of {MOE_PROMPT * m.top_k}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    return replays, 1, 2


def describe_mla(cfg, params, captured):
    """One log line of the mla phase's model and its parameters' bytes."""
    m, e = cfg.mla, cfg.moe
    n_bytes = sum(t.numel() * t.element_size() for t in captured.tree_leaves(params))
    n_mtp = sum(t.numel() for t in captured.tree_leaves(params["mtp"]))
    return (f"deepseek-v3-671b {cfg.n_layers} of 61 layers: d{cfg.d_model} {cfg.n_heads}H MLA "
            f"q_lora {m.q_lora_rank} kv_lora {m.kv_lora_rank} qk {m.qk_nope_head_dim}+"
            f"{m.qk_rope_head_dim} v {m.v_head_dim}, {e.n_dense_layers} dense layers of d_ff "
            f"{e.dense_dff}, {e.n_experts} experts top-{e.top_k} ({e.router} router, "
            f"{e.n_shared} shared) d_ff {e.expert_dff}, MTP depth {cfg.mtp_depth}, vocab "
            f"{cfg.vocab}: {cfg.n_params() / 1e9:.2f} B parameters by n_params + "
            f"{n_mtp / 1e9:.2f} B of MTP, {n_bytes / 1e9:.2f} GB in bfloat16 (norms and "
            f"router float32); weights bound a step {n_bytes / PEAK_BYTES_PER_S * 1e3:.2f} ms "
            f"(every weight but MTP's is read: the reference's dispatch reads every expert)")


def check_mla_against_cpu(torch, np, Model, moe, inst, label):
    """The mla endpoint's replayed tokens against the eager loop's on the
    card, then a 128-token prefill on the card against the same weights'
    plain path on the CPU (bfloat16 there too), the plain path taking the
    card's routing (``moe.route``'s experts and gates, recorded; a top-k
    choice is a step function of its input), within a row relative L2 of
    2e-2; the CPU path with its own routing is run beside for the record."""
    prompt = torch.from_numpy(np.random.default_rng(5).integers(0, inst.model.cfg.vocab, (1, 128))
                              .astype(np.int32))
    tokens = inst.generate(prompt, 8).cpu()
    eager_tokens, _ = generate_with_logits(torch, inst, prompt, 8)
    if not torch.equal(tokens, eager_tokens):
        fail(f"{label}: replayed tokens {tokens.tolist()} differ from the eager loop's "
             f"{eager_tokens.tolist()}")
    routes, own = [], []
    with torch.no_grad(), swapped(moe, recorder(moe.route, routes), "route"):
        _, logits = inst.model.prefill(inst.params, {"tokens": prompt.to(inst.device)})
    logits = logits.float().cpu()
    t0 = time.perf_counter()
    params = _to_cpu(inst.params)
    cpu = Model(inst.model.cfg, param_dtype=torch.bfloat16, device="cpu")
    copy_s = time.perf_counter() - t0
    shared = [tuple(t.cpu() for t in r) for r in routes]
    t0 = time.perf_counter()
    with torch.no_grad(), swapped(moe, replayer(shared), "route"):
        _, want = cpu.prefill(params, {"tokens": prompt})
    cpu_s = time.perf_counter() - t0
    with torch.no_grad(), swapped(moe, recorder(moe.route, own), "route"):
        _, want_own = cpu.prefill(params, {"tokens": prompt})
    del params
    rel = rel_rows(logits, want)
    if not torch.isfinite(logits).all() or rel > 2e-2:
        fail(f"{label}: prefill logits differ from the CPU plain path's by a relative L2 of "
             f"{rel:.3e} (limit 2e-2)")
    flips = sum(int((a[1] != b[1]).sum()) for a, b in zip(shared, own))
    log(f"{label} replayed tokens equal the eager loop's on the card {tokens.tolist()[0]}; "
        f"card vs CPU plain path (bfloat16) on the same weights, 128-token prefill, routing "
        f"shared: last logits row relative L2 {rel:.2e} (limit 2e-2), max abs "
        f"{max_abs(logits, want):.3e}; with its own routing the CPU path chose another expert "
        f"{flips} times of {sum(a[1].numel() for a in shared)} (relative L2 "
        f"{rel_rows(logits, want_own):.2e}); weights copied to the host in {copy_s:.1f} s, "
        f"one CPU prefill {cpu_s:.1f} s")


def greedy_decode(torch, model, params, cache, first, idx, steps):
    """``steps`` greedy ``decode_step``s from ``first`` (B,) at positions
    ``idx, idx + 1, ...`` on ``cache``: (tokens (B, steps + 1), each step's
    logits), on the host."""
    out, logits = [first], []
    for i in range(steps):
        lg, cache = model.decode_step(params, out[-1][:, None], cache, idx + i)
        logits.append(lg.cpu())
        out.append(lg.argmax(-1))
    return torch.stack(out, 1).cpu(), logits


def whisper_audio(torch, np, Model, frontends, inst, label):
    """whisper-small at its own shape, on the serve part's weights: seeded
    ``synth_audio_frames`` of T = 1,500 (30 s of audio) through
    ``Model.prefill`` with decoder prompts of S = 4 (the start sequence) and
    S = 440 (which the 8 decode steps take to the text context's 448
    positions), so that cross-attention runs with Sk != S;
    then 8 greedy ``decode_step``s from ``init_cache(1, 2048,
    memory_t=1500)`` holding the prefill's memory, enc_pos and self-attention
    rows [0, S), so that decode cross-attends to the encoded audio.  Each
    against the same weights' plain path on the CPU: the prefill's last
    logits and every step's within TOL_LOGITS, and the same tokens up to a
    near tie (as ``check_serve_against_cpu``).  Then the device time of one
    prefill at B=8 (T = 1,500, S = 440) from ``torch.profiler``.  Returns
    (prefills, decode steps) made on the card."""
    model, params, cfg = inst.model, inst.params, inst.model.cfg
    T, steps = WHISPER_FRAMES, 8
    gen = torch.Generator(device=DEVICE).manual_seed(11)
    frames = frontends.synth_audio_frames(gen, 8, T, cfg.d_model)
    rng = np.random.default_rng(12)
    t0 = time.perf_counter()
    cpu_params = _to_cpu(params)
    cpu = Model(cfg, device="cpu")
    copy_s = time.perf_counter() - t0
    n_prefill = n_steps = 0
    if WHISPER_PROMPT + steps > WHISPER_TEXT:
        fail(f"{label} decodes past whisper's {WHISPER_TEXT} text positions")
    for S in (4, WHISPER_PROMPT):
        tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (1, S)).astype(np.int32))
        runs = []
        for m, p, dev in ((model, params, DEVICE), (cpu, cpu_params, "cpu")):
            t0 = time.perf_counter()
            with torch.no_grad():
                pre, last = m.prefill(p, {"frames": frames[:1].to(dev), "tokens": tokens.to(dev)})
                cache = m.init_cache(1, WHISPER_CACHE, torch.float32, memory_t=T)
                cache["memory"].copy_(pre["memory"])
                cache["enc_pos"].copy_(pre["enc_pos"])
                for a, b in zip(cache["stack"], pre["stack"]):
                    a[:, :, :S] = b
                del pre
                toks, logits = greedy_decode(torch, m, p, cache, last.argmax(-1), S, steps)
            runs.append((toks, [last.cpu()] + logits, time.perf_counter() - t0))
        n_prefill, n_steps = n_prefill + 1, n_steps + steps
        (toks, logits, card_s), (want_toks, want, cpu_s) = runs
        agree = steps + 1
        if not torch.equal(toks, want_toks):
            agree = int((toks != want_toks).int().argmax())
            top2 = want[agree].topk(2).values[0]
            if float(top2[0] - top2[1]) > 2 * TOL_LOGITS["atol"]:
                fail(f"{label} S={S}: tokens differ from the CPU plain path at step {agree}: "
                     f"{toks.tolist()} vs {want_toks.tolist()}")
        errs = [max_abs(a, b) for a, b in zip(logits[:agree + 1], want[:agree + 1])]
        if not all(torch.isfinite(a).all() and torch.allclose(a, b, **TOL_LOGITS)
                   for a, b in zip(logits[:agree + 1], want[:agree + 1])):
            fail(f"{label} S={S}: logits differ from the CPU plain path: max abs errs {errs}")
        log(f"{label} T={T} frames, S={S} tokens: prefill + {steps} decode steps over the encoded "
            f"memory, card vs CPU plain path on the same weights: logits max abs err "
            f"{max(errs):.3e} over {len(errs)} steps (atol 1e-3, rtol 1e-3), tokens equal for "
            f"{min(agree, steps + 1)}/{steps + 1} {toks.tolist()[0]}; card {card_s:.2f} s, CPU "
            f"{cpu_s:.1f} s (host clock; weights copied to the host in {copy_s:.1f} s)")
    del cpu_params

    # the device time of one prefill at B=8: 8 x 30 s of audio, 440 tokens each
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    batch = {"frames": frames, "tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab, (8, WHISPER_PROMPT)).astype(np.int32)).to(DEVICE)}
    with torch.no_grad():
        model.prefill(params, batch)  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            model.prefill(params, batch)
            torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3
    n_prefill += 2
    self_us = lambda e: getattr(e, "self_device_time_total", 0) or 0  # noqa: E731
    dev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(self_us(e) for e in dev) / 1e3
    if busy_ms == 0:
        log(f"{label} B=8 prefill device time: not measured (the profiler saw no kernel time)")
    else:
        log(f"{label} one prefill at B=8, T={T}, S={WHISPER_PROMPT}: traced {traced_ms:.1f} ms, "
            f"device busy {busy_ms:.2f} ms ({100 * busy_ms / traced_ms:.1f}%), "
            f"{sum(e.count for e in dev)} kernel launches")
        for e in sorted(dev, key=self_us, reverse=True)[:8]:
            log(f"{label}   {self_us(e) / 1e3:8.3f} ms  x{e.count:<5d} {e.key[:90]}")
    return n_prefill, n_steps

# ------------------------------------------------------------------ training
def flash_bwd_counts(B, S, H, KH, hd, causal, window, elem, Sk=None, hd_v=None):
    """q, k, v, out and dout read once with the forward's lse, dq, dk and dv
    written once; five products per live pair (the scores again, since P
    is not kept, and dq and dk: 2*hd operations each; dO.v and dv: 2*hd_v
    each): the least work of the gradient.  Returns (bytes, operations, the
    kernel's operations: seven products, q.k and dO.v twice)."""
    Sk, hd_v = Sk or S, hd_v or hd
    nbytes = ((2 * hd + 2 * hd_v) * B * S * H + 2 * (hd + hd_v) * B * Sk * KH) * elem \
        + B * H * S * 4
    pairs = B * H * live_pairs(S, causal, window, Sk)
    return nbytes, 2 * (3 * hd + 2 * hd_v) * pairs, 2 * (4 * hd + 3 * hd_v) * pairs


def sdpa_call(torch, q, k, v, causal, window):
    """One ``scaled_dot_product_attention`` call computing ``flash_attention``
    on (B, S, heads, hd) tensors (transposed to its (B, heads, S, hd)): the
    library yardstick, never called by the port.  A window shorter than S
    goes in as a boolean mask."""
    F = torch.nn.functional
    B, S, H, _ = q.shape
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    gqa = dict(enable_gqa=True) if H != k.shape[2] else {}
    if window is None or window >= S:
        return lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal, **gqa)
    i = torch.arange(S, device=q.device)
    mask = (i[None, :] <= i[:, None]) & (i[:, None] - i[None, :] < window)
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, **gqa)


def train_attn_inputs(torch, shape, dtype, seed, hd_v=None, n=4):
    """q (B,S,H,hd), k (B,S,KH,hd), v and (n=4) dout at (B,S,·,hd_v) from a
    seeded generator; with ``hd_v`` (MLA) v is read in place as the tail of
    each head's [k_nope | v] row of 2 x hd_v, as ``mla_forward`` passes it."""
    B, S, H, KH, hd = shape
    hv = hd_v or hd
    ts = [t.to(dtype) for t in attn_inputs(
        torch, [(B, S, H, hd), (B, S, KH, hd), (B, S, KH, 2 * hv if hd_v else hd),
                (B, S, H, hv)][:n], seed)]
    if hd_v:
        ts[2] = ts[2][..., hd_v:]
    return ts


def flash_bwd_row(torch, ops, ref, label, shape, dtype, causal=True, window=None, hd_v=None,
                  softcap=None, inputs=None):
    """``flash_attention_bwd`` at ``shape`` (B, S, H, KH, hd) in ``dtype``
    (with ``hd_v``, v's head dim, v read at a head stride as MLA's; with
    ``softcap``, capped logits; ``inputs``: q, k, v, dout to use instead of
    seeded ones), from the forward kernel's output and LSE: both against
    their plain versions, the gradients against ``flash_attention_bwd_ref``
    (the dtype's tolerance) and bit for bit across two runs; then its time,
    the plain version's and the backward of one
    ``scaled_dot_product_attention`` call (the library yardstick, never
    called by the port; none computes a softcap), each in CUDA events around
    back-to-back calls (the autograd backward cannot be captured in a
    graph); the bound at the peak for the inputs' type.  Returns the row."""
    B, S, H, KH, hd = shape
    q, k, v, do = inputs or train_attn_inputs(torch, shape, dtype, 11, hd_v)
    out, lse = ops._flash_forward(q, k, v, causal, window, softcap, want_lse=True)
    want_lse = ref.flash_attention_lse_ref(q, k, causal, window, softcap)
    lse_err = max_abs(lse, want_lse)
    lse_tol = dict(atol=1e-4, rtol=2e-5) if softcap else TOL_ATTN
    if not torch.allclose(lse, want_lse, **lse_tol):
        fail(f"flash_attention's LSE {label}: max abs err {lse_err:.3e}")
    out_err = check_close(torch, f"flash_attention {label}", out,
                          ref.flash_attention_ref(q, k, v, causal, window, softcap), dtype)
    mask = (causal, window, softcap)
    got = ops.flash_attention_bwd(q, k, v, out, lse, do, *mask)
    again = ops.flash_attention_bwd(q, k, v, out, lse, do, *mask)
    want = ref.flash_attention_bwd_ref(q, k, v, out, lse, do, *mask)
    tol = TOL_BWD if dtype == torch.float32 else TOL_BF16
    err = 0.0
    for name, g, a, w in zip(("dq", "dk", "dv"), got, again, want):
        if not torch.equal(g, a):
            fail(f"flash_attention_bwd {label}: {name} differs between two runs")
        if g.dtype != dtype or not torch.allclose(g.float(), w.float(), **tol):
            fail(f"flash_attention_bwd {label}: {name} max abs err {max_abs(g, w):.3e} ({tol})")
        err = max(err, max_abs(g, w))
    ms = time_cuda(torch, lambda: ops.flash_attention_bwd(q, k, v, out, lse, do, *mask), 5,
                   calls=10)
    plain_ms = time_cuda(torch, lambda: ref.flash_attention_bwd_ref(q, k, v, out, lse, do, *mask),
                         3, calls=3)
    lib_ms, lib_note = None, "no library call computes a softcap"
    if not softcap:
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        o = sdpa_call(torch, *leaves, causal, window)().transpose(1, 2)
        lib_err = max(max_abs(g, w) for g, w in zip(
            torch.autograd.grad(o, leaves, do, retain_graph=True), want))
        lib_ms = time_cuda(torch, lambda: torch.autograd.grad(o, leaves, do, retain_graph=True),
                           5, calls=10)
        lib_note = f"sdpa backward {lib_ms:.4f} ms (max abs diff {lib_err:.2e})"
    nbytes, nops, kernel_ops = flash_bwd_counts(B, S, H, KH, hd, causal, window,
                                                q.element_size(), hd_v=hd_v)
    b_ms, b_by = bound(nbytes, nops, peak_ops(torch, dtype))
    log(f"[kernels] flash_attention_bwd {label} B={B} S={S} H={H} KH={KH} hd={hd} "
        f"{f'hd_v={hd_v} (v strided) ' if hd_v else ''}"
        f"{'causal' if causal else 'bidirectional'} window={window} "
        f"{f'softcap={softcap} ' if softcap else ''}{str(dtype)[6:]}: max abs err {err:.3e} "
        f"(out {out_err:.2e}, LSE {lse_err:.2e}; two runs bit for bit); {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, {lib_note}, bound {b_ms:.4f} ms ({b_by}: {nops / 1e9:.3f} GFLOP, "
        f"{nbytes / 1e6:.2f} MB; the kernel does {kernel_ops / 1e9:.3f} GFLOP, "
        f"{kernel_ops / ms / 1e9:.1f} TFLOP/s)")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib_ms,
                key=ops.shape_key(q, k, v, causal, window, *((softcap,) if softcap else ())))


def softcap_bwd_inputs(torch, np):
    """``tests/test_torch_gpu.py::test_softcap_kernels_match_plain``'s data:
    q, k, v, dout of (1, 200, 4|2, 64) from numpy seed 5, q x 8 (logits of
    ~+-60 under a softcap of 50)."""
    rng = np.random.default_rng(5)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(DEVICE)
                   for s in [(1, 200, 4, 64), (1, 200, 2, 64), (1, 200, 2, 64), (1, 200, 4, 64)])
    return q * 8, k, v, do


def flash_lse_row(torch, ops, ref, label, shape, dtype, window=None, hd_v=None):
    """``flash_attention``'s forward as training runs it (causal, the LSE
    written for the backward; with ``hd_v`` v read at a head stride as
    MLA's), against its plain version: out and LSE, then its time from a
    CUDA graph of back-to-back calls as ``flash_row``'s."""
    B, S, H, KH, hd = shape
    q, k, v = train_attn_inputs(torch, shape, dtype, 7, hd_v, n=3)
    out, lse = ops._flash_forward(q, k, v, True, window, None, want_lse=True)
    err = max(check_close(torch, f"flash_attention {label}", out,
                          ref.flash_attention_ref(q, k, v, True, window), dtype),
              check_close(torch, f"flash_attention {label} LSE", lse,
                          ref.flash_attention_lse_ref(q, k, True, window), torch.float32))
    ms = time_graph(torch, [lambda: ops._flash_forward(q, k, v, True, window, None, True)] * 10)
    plain_ms = time_graph(torch, [lambda: (ref.flash_attention_ref(q, k, v, True, window),
                                           ref.flash_attention_lse_ref(q, k, True, window))] * 3)
    lib_ms = time_graph(torch, [sdpa_call(torch, q, k, v, True, window)] * 10)
    nbytes, nops = flash_counts(B, S, H, KH, hd, True, window, q.element_size(), hd_v)
    nbytes += B * H * S * 4
    b_ms, b_by = bound(nbytes, nops, peak_ops(torch, dtype))
    log(f"[kernels] flash_attention {label} B={B} S={S} H={H} KH={KH} hd={hd} "
        f"{f'hd_v={hd_v} (v strided) ' if hd_v else ''}causal window={window}, LSE "
        f"written, {str(dtype)[6:]}: max abs err {err:.3e}; {ms:.4f} ms, plain {plain_ms:.4f} ms "
        f"(with its LSE), sdpa {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}: "
        f"{nops / 1e9:.3f} GFLOP, {nbytes / 1e6:.2f} MB)")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib_ms, key=ops.shape_key(q, k, v, True, window))


def softcap_checks(torch, ops, ref):
    """The logit softcap (cap = 50) in both attention kernels and the
    backward, against their plain versions at minicpm-2b's head shape."""
    cap = 50.0
    q, k, v, do = attn_inputs(torch, [(1, 512, 8, 64), (1, 512, 4, 64), (1, 512, 4, 64),
                                      (1, 512, 8, 64)], 13)
    q = q * 8  # logits of ~+-60, where the cap bends them
    out, lse = ops._flash_forward(q, k, v, True, None, cap, want_lse=True)
    err = max(check_close(torch, "flash_attention softcap", out,
                          ref.flash_attention_ref(q, k, v, True, None, cap), torch.float32),
              max_abs(lse, ref.flash_attention_lse_ref(q, k, True, None, cap)))
    for name, g, w in zip(("dq", "dk", "dv"),
                          ops.flash_attention_bwd(q, k, v, out, lse, do, True, None, cap),
                          ref.flash_attention_bwd_ref(q, k, v, out, lse, do, True, None, cap)):
        if not torch.allclose(g, w, **TOL_BWD):
            fail(f"flash_attention_bwd softcap: {name} max abs err {max_abs(g, w):.3e}")
        err = max(err, max_abs(g, w))
    err = max(err, check_close(torch, "decode_attention softcap",
                               ops.decode_attention(q[:, 300].contiguous(), k, v, 300, None, cap),
                               ref.decode_attention_ref(q[:, 300], k, v, 300, None, cap),
                               torch.float32))
    log(f"[kernels] softcap 50 (S=512, H=8, KH=4, hd=64, causal): flash forward, LSE, "
        f"backward and decode against their plain versions, max abs err {err:.3e}")


def _named_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _named_leaves(tree[k], f"{prefix}/{k}" if prefix else k)
    else:
        yield prefix, tree


def plain_ssd(torch, ref, sums="float32"):
    """``ops.ssd_scan``'s plain version on the card: padded to the chunk,
    ``ssd_chunked`` (torch operations, so autograd differentiates it), y
    cut back and in x's dtype, the state in float32.  ``sums``: "float32";
    "cumsum64", its cumsums summed in float64 and rounded to float32, as the
    kernel's chunk cumsum is (forward, and the reverse cumsum of its
    backward); or "float64", the whole scan in float64 (its inputs cast up)."""
    cumsum = torch.cumsum

    def cumsum_f64(t, dim, **kw):
        return cumsum(t.double(), dim, **kw).to(t.dtype)

    def f(x, dt, A, Bm, Cm, chunk=128, init_state=None):
        S = x.shape[1]
        args = pad_to(torch, (x, dt, A, Bm, Cm), S, chunk)
        if sums == "float64":
            args = [t.double() for t in args]
            init_state = None if init_state is None else init_state.double()
        with swapped(torch, cumsum_f64, "cumsum") if sums == "cumsum64" else nullcontext():
            y, st = ref.ssd_scan_ref(*args, chunk, init_state)
        return y[:, :S].to(x.dtype), st.float()
    return f


def worst_leaf(torch, got, want):
    """The leaf of ``got`` furthest from ``want``'s in relative L2: (name, value)."""
    return max(((name, float(torch.linalg.vector_norm(a - b)
                             / torch.linalg.vector_norm(b).clamp(min=1e-30)))
                for (name, a), (_, b) in zip(_named_leaves(got), _named_leaves(want))),
               key=lambda t: t[1])


def train_kernels(cfg):
    """The kernels a train step of ``cfg`` reaches, forward and backward."""
    attn = ("flash_attention", "flash_attention_bwd")
    ssd = ("ssd_scan", "ssd_scan_bwd")
    return {"ssm": ssd, "hybrid": ssd + attn}.get(cfg.family, attn)


def phase_train(torch, np, ops, ref, cfg, Model, training, data, counted, path_shapes,
                path="train"):
    """A training path: ``cfg`` at full width in float32 with ``remat`` and
    AdamW, on one seeded Markov-LM batch of TRAIN_BATCH x TRAIN_SEQ tokens.
    (1) the kernel path's gradient and the plain path's (every kernel the
    model reaches swapped for its plain version under autograd:
    ``ref.flash_attention_ref``, and ``ssd_chunked`` for ``ssd_scan``) on the
    same weights, every leaf within TOL_GRAD_REL relative L2; (2) one AdamW
    step from each, from the same weights and a zero state: the loss and
    grad_norm the steps report and the loss after them; (3) the main path,
    counted as ``path``: TRAIN_STEPS steps on that batch, the loss falling,
    each kernel's launches counted by shape; then one step traced.  Returns
    (losses, ms a step)."""
    tag = f"[{path}]"
    model = Model(cfg, device=DEVICE, remat=True)
    params = model.init(torch.Generator(device=DEVICE).manual_seed(0))
    n_params = sum(t.numel() for _, t in _named_leaves(params))
    lm = data.MarkovLM(data.DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                                       global_batch=TRAIN_BATCH, seed=0))
    batch = data.device_put_batch(lm.batch_at(0), device=DEVICE)
    kernels = train_kernels(cfg)

    @contextmanager
    def plain(sums="float32"):
        plain_of = {"flash_attention": ref.flash_attention_ref,
                    "ssd_scan": plain_ssd(torch, ref, sums)}
        with ExitStack() as stack:
            for name in kernels:
                if name in plain_of:
                    stack.enter_context(swapped(ops, plain_of[name], name))
            yield

    n_active = active_params(cfg, params)
    log(f"{tag} {cfg.name} {cfg.n_layers}L d{cfg.d_model} vocab {cfg.vocab}"
        f"{f' experts {cfg.moe.n_experts} top-{cfg.moe.top_k}' if cfg.moe else ''}: "
        f"{n_params / 1e9:.3f} B parameters in float32 ({n_active / 1e9:.3f} B active a token), "
        f"remat; batch {TRAIN_BATCH} x {TRAIN_SEQ} tokens (MarkovLM seed 0); kernels "
        f"{', '.join(kernels)}")

    # (1) gradients: kernel path against plain path, on the card
    loss_k, _, g_k = training.loss_and_grads(model, params, batch)
    with plain():
        loss_p, _, g_p = training.loss_and_grads(model, params, batch)
    worst = worst_leaf(torch, g_k, g_p)
    gn_k, gn_p = training.global_norm(g_k), training.global_norm(g_p)
    log(f"{tag} gradient, kernel path vs plain path: loss {float(loss_k):.6f} vs "
        f"{float(loss_p):.6f}, grad_norm {float(gn_k):.6f} vs {float(gn_p):.6f}; worst leaf "
        f"{worst[0]}: relative L2 {worst[1]:.3e} (limit {TOL_GRAD_REL:g}); peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    if worst[1] > TOL_GRAD_REL or not torch.isfinite(gn_k):
        fail(f"train gradient: leaf {worst[0]} relative L2 {worst[1]:.3e} > {TOL_GRAD_REL}")
    # how much of that gap is the plain scan's float32 rounding: the same
    # plain path with its cumsums summed as the kernel's, then with the
    # whole scan in float64
    for sums, what in (("cumsum64", "its scan's cumsums summed in float64"),
                       ("float64", "its whole scan in float64")):
        if "ssd_scan" not in kernels:
            break
        with plain(sums):
            _, _, g_64 = training.loss_and_grads(model, params, batch)
        k64, p64 = worst_leaf(torch, g_k, g_64), worst_leaf(torch, g_p, g_64)
        log(f"{tag} the plain path with {what}: worst leaf against the kernel path "
            f"{k64[0]} {k64[1]:.3e}, against the float32 plain path {p64[0]} {p64[1]:.3e}")
        del g_64
    del g_k, g_p
    gc.collect()
    torch.cuda.empty_cache()

    # (2) one AdamW step from each path, from the same weights and a zero state
    opt_cfg = training.OptConfig(lr=TRAIN_LR, warmup_steps=0, total_steps=TRAIN_STEPS,
                                 schedule=cfg.lr_schedule)
    step, evaluate = training.make_train_step(model, opt_cfg), training.make_eval_step(model)
    host = [t.to("cpu", copy=True) for _, t in _named_leaves(params)]

    def from_start():
        for (_, t), h in zip(_named_leaves(params), host):
            t.copy_(h)
        return training.init_opt_state(params)

    got = {}
    for route, ctx in (("kernel", nullcontext), ("plain", plain)):
        opt = from_start()
        with ctx():
            params, opt, m = step(params, opt, batch)
            got[route] = (float(m["loss"]), float(m["grad_norm"]),
                          float(evaluate(params, batch)["loss"]))
        del opt  # the moments (twice the parameters) go before the next state is made
    (lk, gk, ak), (lp, gp, ap) = got["kernel"], got["plain"]
    log(f"{tag} one AdamW step (lr {TRAIN_LR:g}) from each path: loss {lk:.6f} vs {lp:.6f}, "
        f"grad_norm {gk:.6f} vs {gp:.6f}, loss after the step {ak:.6f} vs {ap:.6f}")
    if abs(lk - lp) > TOL_STEP_REL * abs(lp) or abs(gk - gp) > TOL_STEP_REL * abs(gp):
        fail(f"train step: loss {lk} vs {lp}, grad_norm {gk} vs {gp} (relative {TOL_STEP_REL})")
    if abs(ak - ap) > TOL_AFTER_REL * abs(ap):
        fail(f"train step: loss after one step {ak} vs {ap} (relative {TOL_AFTER_REL})")

    # (3) the main path: TRAIN_STEPS steps on the batch, counted
    opt = from_start()
    del host
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []

    def run():
        nonlocal params, opt
        for _ in range(TRAIN_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt, m = step(params, opt, batch)
            losses.append(float(m["loss"]))  # waits for the step
            times.append((time.perf_counter() - t0) * 1e3)

    counted(path, kernels, run)
    peak = torch.cuda.max_memory_allocated() / 2**30
    ms = statistics.median(times[1:])
    tokens = TRAIN_BATCH * TRAIN_SEQ
    # 6 x active parameters x tokens, and the remat forward; and the attention
    n_attn = train_attn_ops(torch, ops, cfg)
    n_ops = 8 * n_active * tokens + n_attn
    log(f"{tag} {TRAIN_STEPS} steps on one batch, lr {TRAIN_LR:g} ({cfg.lr_schedule}, no "
        f"warmup): losses {', '.join(f'{x:.4f}' for x in losses)}")
    log(f"{tag} step times {', '.join(f'{t:.1f}' for t in times)} ms; median of steps 2-"
        f"{TRAIN_STEPS} {ms:.1f} ms, {tokens / ms * 1e3:.0f} tokens/s; peak device memory "
        f"{peak:.1f} GiB; bound {n_ops / 1e12:.1f} TFLOP ({n_attn / 1e12:.2f} of it the "
        f"attention) at {PEAK_F32_OPS_PER_S / 1e12:.0f} TFLOP/s = "
        f"{n_ops / PEAK_F32_OPS_PER_S * 1e3:.0f} ms a step (achieved {n_ops / ms / 1e9:.1f} "
        f"TFLOP/s)")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail(f"train: the loss did not fall over {TRAIN_STEPS} steps: {losses}")
    want = train_launches(torch, ops, cfg)
    if path_shapes[path] != want:
        fail(f"{path} path launched {path_shapes[path]}, not {want} (each layer's kernels "
             f"twice a step, forward and the remat recompute, and its backward once; an MTP "
             f"block's once each)")
    log(f"{tag} launches a step: " + ", ".join(f"{key[0]} {n // TRAIN_STEPS}"
                                              for key, n in want.items())
        + " (forward and the remat recompute, and the backward; an MTP block's forward once), "
          "at one shape each, as expected")
    # where the peak falls: one more step, its two halves measured apart
    torch.cuda.reset_peak_memory_stats()
    _, _, grads = training.loss_and_grads(model, params, batch)
    peak_grad = torch.cuda.max_memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    params, opt, _ = training.adamw_update(grads, opt, params, opt_cfg)
    del grads
    log(f"{tag} peak device memory in the gradient {peak_grad:.1f} GiB, in the AdamW update "
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB (parameters "
        f"{n_params * 4 / 2**30:.1f} GiB, moments twice that)")
    trace_train_step(torch, lambda: step(params, opt, batch), tag)
    return losses, ms


def train_launches(torch, ops, cfg):
    """The launches TRAIN_STEPS steps of ``cfg`` make, by shape: every
    attention layer (minicpm-2b's 40; zamba2's shared block at each of its 9
    applications; mixtral's under its window; deepseek-v3's MLA at (192,
    128)) and every Mamba2 layer launches its forward kernel twice a step
    (the forward and the remat recompute) and its backward once; an MTP
    block (deepseek-v3's, outside the remat stacks) its forward and its
    backward once each."""
    want = {}
    if cfg.family in ("ssm", "hybrid"):
        key = ops.shape_key(*_train_ssd(torch, cfg), cfg.ssm.chunk, None)
        want[("ssd_scan", *key)] = 2 * cfg.n_layers * TRAIN_STEPS
        want[("ssd_scan_bwd", *key)] = cfg.n_layers * TRAIN_STEPS
    for window, n_remat, n_once in _train_attn_layers(cfg):
        key = ops.shape_key(*_train_qkv(torch, cfg), True, window)
        for name, n in (("flash_attention", 2 * n_remat + n_once),
                        ("flash_attention_bwd", n_remat + n_once)):
            want[(name, *key)] = want.get((name, *key), 0) + n * TRAIN_STEPS
    return want


def _train_attn_layers(cfg):
    """(the kernels' window, layers under remat, layers run once) of each
    window a train step of ``cfg`` attends with."""
    if cfg.family == "ssm":
        return []
    if cfg.family == "hybrid":
        return [(None, cfg.n_layers // cfg.hybrid.every, 0)]
    from repro_torch.models.attention import _kernel_window
    from repro_torch.models.transformer import layer_meta

    windows = [_kernel_window(w) for w in layer_meta(cfg)[0]]
    out = [(w, windows.count(w), 0) for w in dict.fromkeys(windows)]
    if cfg.mtp_depth:  # the MTP block attends without a window, outside the remat stacks
        out = [(w, n, 1 if w is None else 0) for w, n, _ in out] if None in windows \
            else out + [(None, 0, 1)]
    return out


def train_attn_ops(torch, ops, cfg):
    """The attention's operations in one train step (not in 8 x parameters x
    tokens): each layer's forward twice (the remat recompute; an MTP block's
    once) and its backward once, each at the least work of
    ``flash_counts`` and ``flash_bwd_counts``."""
    q, k, v = _train_qkv(torch, cfg)
    B, S, H, hd = q.shape
    KH, hd_v = k.shape[2], v.shape[-1]
    total = 0
    for window, n_remat, n_once in _train_attn_layers(cfg):
        fwd = flash_counts(B, S, H, KH, hd, True, window, 4, hd_v)[1]
        bwd = flash_bwd_counts(B, S, H, KH, hd, True, window, 4, hd_v=hd_v)[1]
        total += (2 * n_remat + n_once) * fwd + (n_remat + n_once) * bwd
    return total


def active_params(cfg, params):
    """Parameters a token's step reads: all of them, but of each MoE
    layer's routed experts only top_k of n_experts."""
    n = sum(t.numel() for _, t in _named_leaves(params))
    if cfg.moe is None:
        return n
    experts = sum(t.numel() for name, t in _named_leaves(params)
                  if name.split("/")[-2:] in (["moe", "wi_gate"], ["moe", "wi_up"], ["moe", "wo"]))
    return n - experts + experts * cfg.moe.top_k // cfg.moe.n_experts


def _train_ssd(torch, cfg):
    """Tensors of the shape and dtype of a training step's scan inputs (x,
    dt, A, B, C; S padded to the chunk), on the meta device."""
    s = cfg.ssm
    H, P, N, G = s.nheads(cfg.d_model), s.headdim, s.d_state, s.ngroups
    Sp = -(-TRAIN_SEQ // s.chunk) * s.chunk
    shapes = [(TRAIN_BATCH, Sp, H, P), (TRAIN_BATCH, Sp, H), (H,), (TRAIN_BATCH, Sp, G, N),
              (TRAIN_BATCH, Sp, G, N)]
    return [torch.empty(sh, device="meta") for sh in shapes]


def _train_qkv(torch, cfg):
    """Tensors of the shape and dtype of a training step's q, k and v (on
    the meta device: only their shape key is read); MLA's at q/k heads of
    nope + rope and v heads of v_head_dim."""
    B, S, H = TRAIN_BATCH, TRAIN_SEQ, cfg.n_heads
    if cfg.mla is not None:
        m = cfg.mla
        shapes = [(B, S, H, m.qk_nope_head_dim + m.qk_rope_head_dim)] * 2 + \
            [(B, S, H, m.v_head_dim)]
    else:
        kv = (B, S, cfg.n_kv_heads, cfg.head_dim_)
        shapes = [(B, S, H, cfg.head_dim_), kv, kv]
    return tuple(torch.empty(sh, device="meta") for sh in shapes)


def trace_train_step(torch, fn, tag="[train]"):
    """One train step under ``torch.profiler``: the device's busy and idle
    share of its wall time, and the device time by kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    self_us = lambda e: getattr(e, "self_device_time_total", 0) or 0  # noqa: E731
    kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(self_us(e) for e in kern) / 1e3
    if busy_ms == 0:
        log(f"{tag} traced step: device time not measured (the profiler saw no kernel time)")
        return
    log(f"{tag} traced step {wall_ms:.1f} ms: device busy {busy_ms:.1f} ms "
        f"({100 * busy_ms / wall_ms:.1f}%), idle {100 * (1 - busy_ms / wall_ms):.1f}%, "
        f"{sum(e.count for e in kern)} kernel launches")
    for e in sorted(kern, key=self_us, reverse=True)[:10]:
        log(f"{tag}   {self_us(e) / 1e3:9.3f} ms  x{e.count:<5d} {e.key[:90]}")


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return tree.cpu()


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_clone(v) for v in tree)
    return tree.clone()


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sched-only", action="store_true",
                    help="run only the scheduling kernels' timings and the scheduling path "
                         "(with its trace), and print no result line: for comparing the "
                         "kernels of two trees on one card, run from a copy of this script "
                         "in each")
    ap.add_argument("--bwd-only", action="store_true",
                    help="run only the float32 flash_attention_bwd rows at minicpm-2b's and "
                         "zamba2-2.7b's train shapes and at the softcap test's data, and print "
                         "no result line: for comparing the backward kernels of two trees on "
                         "one card, as --sched-only")
    args = ap.parse_args(argv)
    try:
        import numpy as np
        import torch
    except ImportError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: run from a checkout of the repository ({ROOT}/src/repro_torch "
              "missing)", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import core, default_device
    from repro_torch.configs import get_config
    from repro_torch import serving
    from repro_torch.kernels import build, ops, ref
    from repro_torch.models import Model, moe
    from repro_torch.serving import Endpoint, Instance, ServingEngine, captured
    from repro_torch import training
    from repro_torch.training import data as train_data

    if args.bwd_only:
        card = phase_device(torch, build, ("flash_attention", "flash_attention_bwd"))
        for label, shape, kw in (
                ("minicpm-2b train", (TRAIN_BATCH, TRAIN_SEQ, 36, 36, 64), {}),
                ("zamba2-2.7b train", (TRAIN_BATCH, TRAIN_SEQ, 32, 32, 80), {}),
                ("softcap test data", (1, 200, 4, 2, 64),
                 dict(softcap=50.0, inputs=softcap_bwd_inputs(torch, np)))):
            flash_bwd_row(torch, ops, ref, label, shape, torch.float32, **kw)
        print(card)
        return 0
    if args.sched_only:
        card = phase_device(torch, build, ("sched",))
        sched_kernels(torch, np, ops, ref)
        ops.reset_launches()
        phase_sched(torch, np, core)
        log(f"[sched] launches {dict(ops.LAUNCHES)}")
        trace_sched(torch, np, core)
        print(card)
        return 0
    default_device()  # full float32 matmuls on the card (TF32 off)
    t_start = time.perf_counter()
    card = phase_device(torch, build)
    rows = {}
    phase_kernels(torch, np, build, ops, ref, rows)
    phase_attention(torch, np, ops, ref, rows)
    launches, path_launches, path_shapes = {}, {}, {}

    def counted(path, kernels, fn):
        """Drive one main path with the counters at 0 just before it and read
        just after: the wrappers' launches plus those of the replays of
        captured steps; each of ``kernels`` must have launched."""
        ops.reset_launches()
        captured.reset_replays()
        out = fn()
        torch.cuda.synchronize()
        got = captured.launches()
        path_launches[path] = (dict(ops.LAUNCHES), dict(captured.REPLAYED))
        path_shapes[path] = captured.launches_by_shape()
        log(f"[{path}] launches {got} (of which by {captured.REPLAYED['steps']} replays of "
            f"captured steps: { {k: v for k, v in captured.REPLAYED.items() if k != 'steps'} })")
        for name in kernels:
            if got[name] < 1:
                fail(f"the {path} path never launched {name}")
        for name, n in got.items():
            launches[name] = launches.get(name, 0) + n
        return out

    events, bursts = counted("sched", ("sched_events", "sched_step"),
                             lambda: phase_sched(torch, np, core))
    if any(launches[name] != n for name, n in bursts.items()):
        fail(f"the scheduling path launched {launches} for the bursts {bursts} of its plan")
    trace_sched(torch, np, core)

    mcfg = full_width(get_config, "mamba2_130m", FULL_WIDTH)
    m_eng = ServingEngine([Endpoint(f"mamba{i}", mcfg, seed=i) for i in range(3)],
                          n_workers=2, scheduler="hiku")
    m_wid, m_prompt, m_reqs, m_cold = counted(
        "serve", ("ssd_scan",), lambda: serve(torch, np, m_eng, "mamba", mcfg.vocab,
                                              f"serve mamba2-130m {mcfg.n_layers}L"))
    eager, replayed = path_launches["serve"]
    if eager["ssd_scan"] != m_reqs * mcfg.n_layers or replayed["steps"] != 7 * m_reqs:
        fail(f"serve path: ssd_scan {eager['ssd_scan']} for {m_reqs} prefills of "
             f"{mcfg.n_layers} layers, {replayed['steps']} decode replays for {m_reqs} x 7 steps")

    dcfg = full_width(get_config, "minicpm_2b", DENSE_WIDTH)
    d_eps = [Endpoint(f"minicpm{i}", dcfg, seed=i, max_cache_len=2048) for i in range(3)]
    d_eng = ServingEngine(d_eps, n_workers=2, scheduler="hiku", mem_pool_bytes=32 * 2**30)
    d_wid, d_prompt, d_reqs, d_cold = counted(
        "dense", ("flash_attention", "decode_attention"),
        lambda: serve(torch, np, d_eng, "minicpm", dcfg.vocab,
                      f"dense minicpm-2b {dcfg.n_layers}L d{dcfg.d_model} vocab {dcfg.vocab}"))
    L = dcfg.n_layers  # one launch per attention layer per prefill / per decode step
    eager, replayed = path_launches["dense"]
    # prefill eagerly per request; decode: one eager step per cold start (the
    # capture's first call), then 7 replays of L decode launches per request
    if (eager["flash_attention"] != L * d_reqs or eager["decode_attention"] != L * d_cold
            or replayed["steps"] != 7 * d_reqs or replayed["decode_attention"] != L * 7 * d_reqs):
        fail(f"dense path launched flash {eager['flash_attention']}, decode "
             f"{eager['decode_attention']} eagerly and {replayed['decode_attention']} in "
             f"{replayed['steps']} replays, for {d_reqs} requests of 7 decode steps and "
             f"{d_cold} cold starts")
    log(f"[dense] {d_reqs} requests, {d_cold} cold starts: flash_attention {L} x {d_reqs}; "
        f"decode_attention {L} x {d_cold} eager (each capture's first call) + {L} x 7 x "
        f"{d_reqs} in {replayed['steps']} replays, as expected; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")

    check_serve_against_cpu(torch, Instance, m_eng, m_wid, "mamba0", m_prompt, "serve")
    short = torch.from_numpy(np.random.default_rng(5).integers(0, dcfg.vocab, (1, 128))
                             .astype(np.int32))
    check_serve_against_cpu(torch, Instance, d_eng, d_wid, "minicpm0", short, "dense")
    run_launcher()
    profile_warm_request(torch, m_eng, m_wid, "mamba0", m_prompt, "mamba2-130m")
    profile_warm_request(torch, d_eng, d_wid, "minicpm0", d_prompt, "minicpm-2b")
    del m_eng, d_eng  # free the engines before the next full-width models
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    hcfg = full_width(get_config, "zamba2_2p7b", ZAMBA_WIDTH)
    h_eps = [Endpoint(f"zamba{i}", hcfg, seed=i, max_cache_len=2048) for i in range(3)]
    h_eng = ServingEngine(h_eps, n_workers=2, scheduler="hiku", mem_pool_bytes=32 * 2**30)
    h_wid, h_prompt, h_reqs, h_cold = counted(
        "hybrid", ("ssd_scan", "flash_attention", "decode_attention"),
        lambda: serve(torch, np, h_eng, "zamba", hcfg.vocab,
                      f"hybrid zamba2-2.7b {hcfg.n_layers}L d{hcfg.d_model} vocab {hcfg.vocab}"))
    G = hcfg.n_layers // hcfg.hybrid.every  # shared-block applications: one attention each
    eager, replayed = path_launches["hybrid"]
    if (eager["ssd_scan"] != hcfg.n_layers * h_reqs or eager["flash_attention"] != G * h_reqs
            or eager["decode_attention"] != G * h_cold or replayed["steps"] != 7 * h_reqs
            or replayed["decode_attention"] != G * 7 * h_reqs):
        fail(f"hybrid path launched ssd_scan {eager['ssd_scan']}, flash {eager['flash_attention']}, "
             f"decode {eager['decode_attention']} eagerly and {replayed['decode_attention']} in "
             f"{replayed['steps']} replays, for {h_reqs} requests of 7 decode steps and "
             f"{h_cold} cold starts")
    log(f"[hybrid] {h_reqs} requests, {h_cold} cold starts: ssd_scan {hcfg.n_layers} x {h_reqs}, "
        f"flash_attention {G} x {h_reqs}; decode_attention {G} x {h_cold} eager + {G} x 7 x "
        f"{h_reqs} in {replayed['steps']} replays, as expected; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    h_short = torch.from_numpy(np.random.default_rng(5).integers(0, hcfg.vocab, (1, 128))
                               .astype(np.int32))
    check_serve_against_cpu(torch, Instance, h_eng, h_wid, "zamba0", h_short, "hybrid")
    profile_warm_request(torch, h_eng, h_wid, "zamba0", h_prompt, "zamba2-2.7b")
    del h_eng
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    L = LLAVA_WIDTH[0]
    made = counted("batch", ("decode_attention",),
                   lambda: phase_batch(torch, np, ops, ref, get_config, Model, serving, captured,
                                       moe))
    eager, replayed = path_launches["batch"]
    n_replays = sum(r for r, _ in made.values())
    n_eager = sum(e for _, e in made.values())
    if (eager["decode_attention"] != L * n_eager or replayed["steps"] != n_replays
            or replayed["decode_attention"] != L * n_replays):
        fail(f"batch path launched decode {eager['decode_attention']} eagerly and "
             f"{replayed['decode_attention']} in {replayed['steps']} replays, for {n_eager} "
             f"captures and {n_replays} replays of {L} layers")
    log(f"[batch] decode_attention {L} x {n_eager} eager (each capture's first call) + {L} x "
        f"{n_replays} replays (bf16 cache {made['bf16'][0]}, fp8 {made['fp8'][0]}), as expected")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    L = MOE_LAYERS
    n_replays, n_eager, n_prefill = counted(
        "moe", ("flash_attention", "decode_attention"),
        lambda: phase_moe(torch, np, ops, ref, get_config, Model, serving, captured, moe))
    eager, replayed = path_launches["moe"]
    if (eager["flash_attention"] != L * n_prefill or eager["decode_attention"] != L * n_eager
            or replayed["steps"] != n_replays or replayed["decode_attention"] != L * n_replays):
        fail(f"moe path launched flash {eager['flash_attention']}, decode "
             f"{eager['decode_attention']} eagerly and {replayed['decode_attention']} in "
             f"{replayed['steps']} replays, for {n_prefill} prefill, {n_eager} capture and "
             f"{n_replays} replays of {L} layers")
    log(f"[moe] flash_attention {L} x {n_prefill}; decode_attention {L} x {n_eager} eager + {L} x "
        f"{n_replays} replays, as expected")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    # deepseek-v3 at full width, 4 of 61 layers in bfloat16: one endpoint
    # served cold and warm behind hiku, then the batcher on its weights
    import dataclasses

    L = MLA_LAYERS
    xcfg = dataclasses.replace(full_width(get_config, "deepseek_v3_671b", MLA_WIDTH), n_layers=L)
    x_eng = ServingEngine([Endpoint("deepseek0", xcfg, seed=0, max_cache_len=MLA_CACHE,
                                    param_dtype=torch.bfloat16)],
                          n_workers=2, scheduler="hiku", mem_pool_bytes=48 * 2**30)
    x_wid, x_prompt, x_reqs, x_cold = counted(
        "mla", ("flash_attention", "decode_attention_latent"),
        lambda: serve(torch, np, x_eng, "deepseek", xcfg.vocab,
                      f"mla deepseek-v3 {L} of 61 layers", order=["deepseek0"] * 4))
    eager, replayed = path_launches["mla"]
    if (eager["flash_attention"] != L * x_reqs or eager["decode_attention_latent"] != L * x_cold
            or replayed["steps"] != 7 * x_reqs
            or replayed["decode_attention_latent"] != L * 7 * x_reqs
            or eager["decode_attention"] or replayed["decode_attention"]):
        fail(f"mla path launched flash {eager['flash_attention']}, latent decode "
             f"{eager['decode_attention_latent']} eagerly and "
             f"{replayed['decode_attention_latent']} in {replayed['steps']} replays "
             f"(decode_attention {eager['decode_attention']} + {replayed['decode_attention']}), "
             f"for {x_reqs} requests of 7 decode steps and {x_cold} cold starts")
    inst = x_eng.workers[x_wid].idle["deepseek0"][0]
    log(f"[mla] {describe_mla(xcfg, inst.params, captured)}")
    log(f"[mla] {x_reqs} requests, {x_cold} cold start: flash_attention (hd 192, v 128) {L} x "
        f"{x_reqs}; decode_attention_latent {L} x {x_cold} eager (the capture's first call) + "
        f"{L} x 7 x {x_reqs} in {replayed['steps']} replays, as expected; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    check_mla_against_cpu(torch, np, Model, moe, inst, "[mla]")
    profile_warm_request(torch, x_eng, x_wid, "deepseek0", x_prompt, "deepseek-v3 4L")
    gc.collect()
    _, _, x_replays = counted(
        "mla_batch", ("decode_attention_latent",),
        lambda: run_batcher(torch, np, ops, ref, moe, serving,
                            Model(xcfg, param_dtype=torch.bfloat16), inst.params, torch.bfloat16,
                            batch_requests(np, xcfg.vocab), f"[mla] deepseek-v3 {L} of 61 layers",
                            kernel="decode_attention_latent"))
    eager, replayed = path_launches["mla_batch"]
    if (eager["decode_attention_latent"] != L or replayed["steps"] != x_replays
            or replayed["decode_attention_latent"] != L * x_replays):
        fail(f"mla batch path launched the latent decode {eager['decode_attention_latent']} "
             f"eagerly and {replayed['decode_attention_latent']} in {replayed['steps']} "
             f"replays, for one capture and {x_replays} replays of {L} layers")
    log(f"[mla] batch: decode_attention_latent {L} x 1 eager + {L} x {x_replays} replays, as "
        f"expected; peak device memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    del x_eng, inst
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    # whisper-small whole (12 encoder and 12 decoder layers) in float32: three
    # endpoints behind hiku (zero frames of the prompt's length, decode over 8
    # rows of zero memory, as the reference's Instance), then its own shape on
    # the first endpoint's weights (30 s of audio), then the batcher over the
    # reference's default 1,500 rows of zero memory
    wcfg = full_width(get_config, "whisper_small", WHISPER_WIDTH)
    w_eps = [Endpoint(f"whisper{i}", wcfg, seed=i, max_cache_len=WHISPER_CACHE)
             for i in range(3)]
    w_eng = ServingEngine(w_eps, n_workers=2, scheduler="hiku", mem_pool_bytes=32 * 2**30)
    w_wid, w_prompt, w_reqs, w_cold = counted(
        "whisper", ("flash_attention", "decode_attention"),
        lambda: serve(torch, np, w_eng, "whisper", wcfg.vocab,
                      f"whisper whisper-small {wcfg.n_encoder_layers}+{wcfg.n_layers}L "
                      f"d{wcfg.d_model} vocab {wcfg.vocab}", prompt_len=WHISPER_PROMPT))
    E, L = wcfg.n_encoder_layers, wcfg.n_layers
    per_prefill = E + 2 * L
    w_inst = w_eng.workers[w_wid].idle["whisper0"][0]
    per_step = w_inst.model.decode_attention_calls()
    eager, replayed = path_launches["whisper"]
    if (eager["flash_attention"] != per_prefill * w_reqs
            or eager["decode_attention"] != per_step * w_cold or replayed["steps"] != 7 * w_reqs
            or replayed["decode_attention"] != per_step * 7 * w_reqs):
        fail(f"whisper path launched flash {eager['flash_attention']}, decode "
             f"{eager['decode_attention']} eagerly and {replayed['decode_attention']} in "
             f"{replayed['steps']} replays, for {w_reqs} requests of 7 decode steps and "
             f"{w_cold} cold starts")
    log(f"[whisper] {wcfg.n_params() / 1e6:.1f} M parameters by n_params, "
        f"{sum(t.numel() * t.element_size() for t in captured.tree_leaves(w_inst.params)) / 1e9:.3f}"
        f" GB in float32 an endpoint (position tables of {WHISPER_CACHE} rows); {w_reqs} "
        f"requests, {w_cold} cold starts: flash_attention {per_prefill} a prefill ({E} encoder, "
        f"{L} self, {L} cross) x {w_reqs}; decode_attention {per_step} a step ({L} self, {L} "
        f"cross) x {w_cold} eager (each capture's first call) + x 7 x {w_reqs} in "
        f"{replayed['steps']} replays, as expected; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    check_serve_against_cpu(torch, Instance, w_eng, w_wid, "whisper0", w_prompt, "whisper")
    profile_warm_request(torch, w_eng, w_wid, "whisper0", w_prompt, "whisper-small")
    from repro_torch.models import frontends

    n_prefill, n_steps = counted(
        "whisper_audio", ("flash_attention", "decode_attention"),
        lambda: whisper_audio(torch, np, Model, frontends, w_inst, "[whisper audio]"))
    eager, replayed = path_launches["whisper_audio"]
    if (eager["flash_attention"] != per_prefill * n_prefill
            or eager["decode_attention"] != per_step * n_steps or replayed["steps"]):
        fail(f"whisper audio path launched flash {eager['flash_attention']}, decode "
             f"{eager['decode_attention']} ({replayed['steps']} replays), for {n_prefill} "
             f"prefills and {n_steps} decode steps")
    log(f"[whisper audio] flash_attention {per_prefill} x {n_prefill} prefills, "
        f"decode_attention {per_step} x {n_steps} steps, as expected; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    _, _, w_replays = counted(
        "whisper_batch", ("decode_attention",),
        lambda: run_batcher(torch, np, ops, ref, moe, serving, w_inst.model, w_inst.params,
                            torch.float32, batch_requests(np, wcfg.vocab),
                            f"[whisper] whisper-small batch, {WHISPER_FRAMES} memory rows, f32"))
    eager, replayed = path_launches["whisper_batch"]
    if (eager["decode_attention"] != per_step or replayed["steps"] != w_replays
            or replayed["decode_attention"] != per_step * w_replays
            or eager["flash_attention"] or replayed["flash_attention"]):
        fail(f"whisper batch path launched decode {eager['decode_attention']} eagerly and "
             f"{replayed['decode_attention']} in {replayed['steps']} replays, for one capture "
             f"and {w_replays} replays of {per_step}")
    log(f"[whisper] batch: decode_attention {per_step} x 1 eager + {per_step} x {w_replays} "
        f"replays, as expected; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    del w_eng, w_inst
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    # training at full width in float32, remat and AdamW: minicpm-2b, then
    # mamba2-130m whole and zamba2-2.7b whole, then the MoE family cut in
    # depth to fit one card with its gradients and moments: mixtral-8x22b at
    # 1 of 56 layers, deepseek-v3 at 2 of 61 (a dense and a MoE layer, its
    # routed experts cut from 256 to 16), each freed before the next
    mcfg = full_width(get_config, "mixtral_8x22b", MIXTRAL_WIDTH)
    if mcfg.sliding_window != MIXTRAL_WINDOW:
        fail(f"mixtral_8x22b's window is {mcfg.sliding_window}, not {MIXTRAL_WINDOW}")
    xcfg = full_width(get_config, "deepseek_v3_671b", MLA_WIDTH)
    train_paths = (
        ("train", full_width(get_config, "minicpm_2b", DENSE_WIDTH)),
        ("train_mamba", full_width(get_config, "mamba2_130m", FULL_WIDTH)),
        ("train_zamba", full_width(get_config, "zamba2_2p7b", ZAMBA_WIDTH)),
        ("train_mixtral", dataclasses.replace(mcfg, n_layers=MIXTRAL_TRAIN_LAYERS)),
        ("train_mla", dataclasses.replace(
            xcfg, n_layers=MLA_TRAIN_LAYERS,
            moe=dataclasses.replace(xcfg.moe, n_experts=MLA_TRAIN_EXPERTS,
                                    n_dense_layers=MLA_TRAIN_LAYERS - 1))))
    for path, cfg in train_paths:
        phase_train(torch, np, ops, ref, cfg, Model, training, train_data, counted, path_shapes,
                    path)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    # each row of the kernels line, and the launches of the path its shape is
    # on: a ``batch`` or ``whisper_*`` row's are those at its own shape
    path = {p: {k: e[k] + r[k] for k in e} for p, (e, r) in path_launches.items()}
    at_shape = {}
    for by_shape in path_shapes.values():
        for key, n in by_shape.items():
            at_shape[key] = at_shape.get(key, 0) + n
    whisper_keys = {key for p in ("whisper", "whisper_audio", "whisper_batch")
                    for key in path_shapes[p]}
    batch = rows.pop("decode_attention_batch")
    for c, sub in batch.items():
        sub["launches"] = at_shape.get(("decode_attention", *sub.pop("key")), 0)
        if sub["launches"] != LLAVA_WIDTH[0] * sum(made[c]):
            fail(f"the batch path launched decode_attention {sub['launches']} times at the "
                 f"{c} row's shape, not {LLAVA_WIDTH[0]} x {sum(made[c])} steps")
    rows["decode_attention"]["batch"] = batch
    rows["decode_attention"]["shapes"] = rows.pop("decode_attention_shapes")
    own = {"ssd_scan": ("serve", {"zamba2": "hybrid", "train_mamba": "train_mamba",
                                  "train_zamba": "train_zamba"}),
           "ssd_scan_bwd": ("train_mamba", {"bf16": None, "g2": None, "zamba2": "train_zamba",
                                            "zamba2_bf16": None}),
           "flash_attention": ("dense", {"zamba2": "hybrid", "mixtral": "moe", "mla": "mla",
                                         "train": "train", "train_zamba": "train_zamba",
                                         "train_mixtral": "train_mixtral",
                                         "train_mla": "train_mla"}),
           "flash_attention_bwd": ("train", {"bf16": None, "zamba2": "train_zamba",
                                             "train_mixtral": "train_mixtral",
                                             "train_mla": "train_mla", "mla_bf16": None,
                                             "softcap": None}),
           "decode_attention": ("dense", {"zamba2": "hybrid", "mixtral": "moe",
                                          "mla_b1": ("mla", "decode_attention_latent"),
                                          "mla_b8": ("mla_batch", "decode_attention_latent")})}
    kernels, loss = [], {}
    for name in ("sched_events", "sched_step", "ssd_scan", "ssd_scan_bwd", "flash_attention",
                 "flash_attention_bwd", "decode_attention"):
        row = rows[name]
        row["launches"] = launches[name]
        # time lost on the main paths beyond the bound: per event for the
        # scheduling kernels (timed at the path's chunk), per launch
        # otherwise, each shape's launches on its own path
        if name in events:
            loss[name] = events[name] * (row["ms"] - row["bound_ms"]) / SCHED_CHUNK
        else:
            main_path, shape_paths = own[name]
            for label, sub in row["shapes"].items():
                key = sub.pop("key", None)
                if label.startswith("whisper_"):
                    sub["launches"] = at_shape.get((name, *key), 0)
                    whisper_keys.discard((name, *key))
                    continue
                p, key = shape_paths[label] if isinstance(shape_paths[label], tuple) \
                    else (shape_paths[label], name)
                sub["launches"] = path[p][key] if p else 0  # None: a shape no path runs
            subs = [dict(launches=path[main_path][name], ms=row["ms"], bound_ms=row["bound_ms"]),
                    *row.get("batch", {}).values(), *row["shapes"].values()]
            loss[name] = sum(r["launches"] * (r["ms"] - r["bound_ms"]) for r in subs)
        kernels.append({k: row[k] for k in ("name", "route", "source", "replaces", "launches",
                                            "max_abs_err", "ms", "plain_ms", "bound_ms",
                                            "bound_by", "library_ms", "burst", "ns_per_event",
                                            "ms_4096", "batch", "shapes") if k in row})
    if whisper_keys:
        fail(f"the whisper paths launched at shapes that no whisper_* row holds: {whisper_keys}")
    log("[done] time over the bound on the main paths: " + ", ".join(
        f"{name} {ms:.2f} ms" for name, ms in sorted(loss.items(), key=lambda kv: -kv[1])))
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
