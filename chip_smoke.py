#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

Run from the repository root on a machine with a card and the CUDA toolkit:

    python3 chip_smoke.py

It imports nothing of JAX or of the reference package ``repro``.  Each
phase prints one JSON line:

  device   card name and count, torch and CUDA versions, SM count, the
           maximum SM clock, and ``nvidia-smi``'s name and power limit
           (also printed raw on a line of its own)
  build    nvcc wall time and the ptxas register/shared/spill lines of
           every kernel: csrc/*.cu, and the CUDA C++ that the megakernel
           emitter writes for each fused segment (FLOW, DESCRIPTOR and
           PYRAMID at 1920x1080 and at odd sizes, and a synthetic pipeline
           over every streamable op), all built from the checkout in one
           parallel batch, with each segment's tile and shared bytes; K4's
           registers and spills per kernel, type and head dim (and head
           group for the decode form's cluster and split kernels: the
           split kernel's 36 builds, 3 head dims x 2 types x groups of 1,
           2, 3, 4, 6 and 8, the cluster kernel's 30, its bf16 groups of 6
           and 8 left to the mma kernel; the mma kernel's 3, bf16 at D 64,
           128 and 256; the 2 merge kernels), with each prefill form's shared bytes, and
           K1's per form; K1, every K4 kernel, K2 and every generated
           segment must not spill
  kernel   per kernel: the CUDA kernel against its plain PyTorch version
           at the main path's shapes and at odd shapes, 3 frames each,
           which must agree exactly (max abs diff 0); K1 also at 1x1,
           11x2 and 2x16 taps (its general form) and with taps near 2^23
           whose int32 sums wrap (8x8 and 3x5); for K3, each app's
           segment at 1920x1080 with 1 frame and with 3, each app at an odd
           size and the synthetic pipeline, where integer leaves must agree
           exactly, float leaves within FLOAT_ULP_BOUND ULPs and DESCRIPTOR's
           exactly; then the kernel's device time (the profiler's kernel
           events, ``kernels/timing.py``) with its call time beside it
           (CUDA events around back-to-back calls, host work included), the
           plain version's, the library yardstick's, and the bound (the
           larger of bytes over 3.35 TB/s and the function's least
           operations over the SMs' lane rate at the maximum SM clock:
           integer ops on 64 lanes per SM, integer and f32 ops together on
           128; a box sum counts as a sliding sum)
  kernel   (K4) flash attention's three forms against the plain version:
           the bf16 prefill form on the tensor cores (prefill_wgmma at
           (Dk, Dv) = (64, 64), (128, 128), (192, 128) and (256, 256)),
           the f32 SIMT prefill form (prefill_simt) and
           the decode form, at the model's
           shapes (prefill B 4, S 1024, H 4, Hkv 1, D 256 in bf16, with
           window 512 and without, and the f32 check's B 2 local layer;
           decode over a 1024-key cache and over a 512-slot window span of
           a longer cache, with its split), a short decode span (64 keys),
           MHA decode in f32, tests/test_kernels.py's four coverage classes
           and its decode case at their tolerances, a ragged Skv, and bf16
           cases for the tensor-core form (D 64 and 256 at a ragged Sq and
           window, a non-causal ragged Skv, empty-band rows, GQA through
           head views of one wider tensor); f32 cases for the SIMT form
           (the f32 check's local and global layers at B 2, D 256 at a
           ragged Sq and window 70, GQA with g 4 at Sq 130, head views of
           one wider tensor, and a view whose rows are not 16-byte
           aligned), and the families' shapes (granite's GQA, D 64 and
           g 3, bf16 at 4 x 1024 and f32 at 2 x 64; its decode over
           serving's 4 x 160-slot cache and a 100-slot view of it in bf16
           and over the f32 loop's 2 x 64 keys, and its rows at an
           offset with the lse; the served dense archs' shapes (gemma-2b's
           MQA, g 8 at D 256; musicgen's MHA at D 64, Hkv 24; qwen2-vl's
           g 7 at D 128, Hkv 4; qwen2-72b's and jamba's g 8 and
           command-r-plus's g 12 at D 128, Hkv 8): the bf16 prefill at
           4 x 1024 and the f32 one at 2 x 64, causal, and bf16 decode at
           B 4 over serving's 160 keys, with gemma-2b's decode over 1024
           keys too; deepseek's MLA prefill with q, k at 192
           and v at 128 as K4 takes them unpadded, the scale
           1/sqrt(192), 128 heads, bf16 at 4 x 1024 and f32 at 2 x 64,
           and once more zero-padded to 256 as before K4 took Dv != Dk
           (the padded time, bounded by the same unpadded work, 2
           (Dk + Dv) flops a pair, the library given the unpadded
           operands)); each case
           must launch its own form, and a decode case exactly the
           kernels ``flash.ops.decode_kernel`` names by the profiler's
           events: up to 8 splits (merged in a cluster) the mma kernel for
           bf16 at g >= 5 (qwen2-vl's, qwen2-72b's, jamba's and
           command-r-plus's decodes over serving's 160 keys, and
           command-r-plus's and gemma-2b's over a 100-slot view), else the
           cluster kernel, more the split and merge kernels (gemma-2b's
           decodes over 160 and 1024 keys); per case the
           max abs error, K4's device ms (the profiler's kernel time),
           graph ms (CUDA events around replays of a CUDA graph of 20
           back-to-back calls: every kernel and gap, no host work) and
           call ms (CUDA events around back-to-back wrapper calls, host
           work included), plain ms, scaled_dot_product_attention's
           device, graph and call ms (the library yardstick, never on the
           path) and the bound (the larger of q,
           k, v and o once over 3.35 TB/s and 2 (Dk + Dv) flops per
           unmasked (q, k) pair over the type's peak: 989 TFLOP/s dense bf16,
           67 TFLOP/s f32); a bf16 prefill case also reads the SM clock
           (nvidia-smi every 10 ms) while it runs back to back, as each
           family's profiled bf16 prefill_fn does
  hw       the hardware half, on the host (the scalar engine): each app
           at the paper's size (compiled once, the hardware flow
           included, and reused by the phases below): compile_pipeline
           seconds, interface kind, effective T, modules, edges, cycles
           per frame, FIFO bits and solver, CLBs, DSPs and BRAMs, and check_schedule(), which must
           be True; CONVOLUTION at each fig. 9 throughput, whose effective
           T must be the paper's within 0.01 and its cycles within 1.1 %;
           each app's sim_case through the scalar cycle simulator (no
           deadlock) and optimize_fifos over 2 frames (proven), with the
           analytic and simulated FIFO bits and the seconds each took (the
           fig. 9 compiles and the sim cases in 6 worker processes)
  cycle    the cycle kernel (csrc/cyclesim.cu, a block per design: one
           warp, or modules over a block's threads past 96 modules or
           edges): against its plain version (hwsim/vector.py on the CPU,
           6 worker processes) at FLOW's, PYRAMID's and CONVOLUTION's
           sim_case, 1 and 2 frames, bounded and unbounded, event jump on
           and off, a zero-depth PYRAMID residue edge (a deadlock) and a
           horizon on CONVOLUTION's first frame boundary; against the
           scalar engine at all five sim_cases (2 frames); a population
           of 16 FLOW depth sets in one launch against 16 single runs;
           the kernel's device time on FLOW's sim_case (2 frames); the
           kernel against the plain version and the scalar engine on
           1920x1080 FLOW's first 40,000 cycles (its kernels line: device
           time, the plain version's host time, the form and its shared
           bytes, the chain bound from latencies probed on the card and
           the profiling build's split of a cycle,
           launch/cycle_profile.py), and the same on the paper-size
           STEREO's and DESCRIPTOR's first 40,000 cycles; then its own
           path, counters set to 0 just before and read just after:
           simulate() on the card at the paper's size, one frame and one
           launch, for all five apps (cycles beside
           cycles_per_frame(), seconds, ns a cycle), and
           explore_app("flow") with 16 points on the population engine;
           after the read, a frame whose profiled window missed the
           kernel profiled again, the whole CONVOLUTION and PYRAMID frames
           held against the scalar engine (every shared SimResult field;
           run in the worker pool since the phase began), the STEREO and
           DESCRIPTOR cuts against the plain version (every SimResult
           field) and the scalar engine, and the same sweep on
           the scalar engine on the host (the same points,
           cycles_skipped aside; points/s each); one simulate_ingest run
  path     CONVOLUTION 1920x1080, STEREO 720x400 nd=64, and FLOW,
           DESCRIPTOR and PYRAMID 1920x1080 through
           compile_pipeline(...).run and run_batch (4 frames) on the
           "kernels" backend, bit-exact against the golden models; the
           launch counters must rise by one per run and one per run_batch;
           run ms per frame (host clock, median of warm calls) and
           run_batch frames/s; and run_batch_device on inputs already on
           the card (4 frames and 1 frame), the device-side share of a
           call; then each app at its bench_case size, run and run_batch
           against the port's executor (backend="numpy"; integers exact,
           f32 within FLOAT_ULP_BOUND ULPs); then the External pipelines
           (kernels/megakernel/check.py ``external_pipelines``): ``clip``
           (a 3x3 box sum, the External's numpy clip, a point-op chain) at
           1920x1080, run and run_batch (4 frames) bit-exact against the
           torch backend on the card, a generated segment on each side of
           the External and none holding it, the model called once per
           frame in frame order, each segment against its plain version,
           and the External's host ms (the copies and the model) beside
           each segment's device ms; and every External case at 37x13
           against the executor
  profile  per app, the host-side operators of one warm run and one warm
           run_batch call (torch.profiler, CPU activity), by self time
  verify   the static verifier (``HWDesign.verify``, ``backend="kernels"``)
           on the card: each sim_case under fifo_solver "z3" and "sim",
           its oracle's cross-check on the cycle kernel (one launch each)
           held against the same check on the scalar engine (marks,
           bounds, violations), then FLOW and CONVOLUTION at the paper's
           size; every case must be ok; per case the verdict, modeled and
           total edges, declared and narrowed FIFO bits, host seconds and
           the cycle kernel's launches
  serve    the five paper-size designs behind one FrameServer on the card
           (``backend="kernels"``, ``ServeConfig(max_batch=8)``, a warm
           frame each): 32 seeded frames an app submitted interleaved
           across the three priorities, every future bounded; the launch
           counters set to 0 just before the traffic and read just after
           (K1, K2 and K3 must each launch), the window profiled (K1-K3's
           kernel events, the card's busy share); every served frame equal
           to run_batch of the same frames on the same design, two an app
           to the golden model; per app frames/s, p50 and p99 latency,
           batches, mean occupancy, shed and padded frames, and
           replay_trace_ingest's predicted queue mark; register and
           warmup seconds (the kernels' nvcc builds ran in the build
           phase; their cache is the one the server loads)
  llm      gemma3-1b at full width and depth (26 layers, random weights
           drawn on the card from seed 0, ``card_params``): the f32
           prefill_fn on 2 x 1024 tokens launching the SIMT prefill form
           26 times and the tensor-core form never; f32 decode_fn over
           the prompt's first 128 tokens against prefill_fn over them
           (atol 2e-3, rtol 1e-3);
           the model cut to 2 layers on the card against the same on the
           CPU; then, in bf16 and with the launch counters reset,
           prefill_fn on 4 x 1024 tokens (the tensor-core form 26 times,
           the SIMT form never) and launch.serve.serve (batch 4, prompt
           1024, 32 generated), with the decode form launched 26 times per
           decode step; one more bf16 prefill_fn call under the profiler
           for its device time, K4's share of it and its top kernels;
           init seconds, prefill ms, decode ms per step, tokens/s, and the
           card's top kernels over a profiled decode step, with K4's share
           of its device time and its split and merge kernels' calls (a
           merge a layer: gemma3-1b's spans take 32 splits; granite's
           profiled step must run none)
  families nine archs at full width with weights drawn on the card from
           a seeded generator (init_params's kinds and scales), each at an
           f32 cut for the checks and a serving cut: granite-moe-3b-a800m
           (MoE, 32 layers, 48 padded experts top-8), mamba2-1.3b (48
           Mamba2 layers), gemma-2b (MQA at D 256, a tied 256,000-entry
           head), musicgen-medium (embedding frames, LayerNorm, MHA) and
           qwen2-vl-7b (frames, M-RoPE over (3, B, S) positions, qkv bias)
           uncut; deepseek-v2-236b (MLA + MoE, 160 experts top-6 and a
           shared one) at 2 layers; qwen2-72b at 4 layers, command-r-
           plus-104b at 2 (both cuts), jamba-1.5-large-398b
           at 4 (its MoE at layer 3 alone in f32, the 16 padded experts
           of two MoE layers being 92 GB there; all of it in bf16): the
           f32 prefill_fn on a 64-token prompt (the SIMT form once per
           GQA layer), f32 decode_fn over its first 32 tokens against
           prefill_fn over them at capacity factor E/K (no drop; atol
           2e-3, rtol 1e-3), the decode form once per GQA layer a step
           (MLA decodes without K4, mamba2 has no attention); the f32
           cut's first two layers on the 64-token prompt (jamba's layers 2
           and 3, Mamba2 and attention with the MoE) on the card against
           the CPU at the config's capacity factor; every MoE layer's
           top-k sets and k-th/(k+1)-th gate gaps recorded on both paths
           (``RouteLog``): a root difference with a gap above 1e-5 fails,
           rows with a difference are left out of the comparison; the f32
           weights freed, the serving cut drawn in bf16; then with the
           counters reset, prefill_fn on 4 x 1024 tokens or frames (the
           tensor-core form once per attention layer, MLA's at Dk 192 and
           Dv 128 with no zero pad: the profiled call must run no
           aten::constant_pad_nd) and serve (4 x 128, 16 generated; the
           decode form once per GQA layer a step), held to finiteness and
           shapes; per arch init seconds, both cuts' peak memory,
           launches, prefill ms and its device ms (K4's share), decode ms
           per step, tokens/s, a profiled decode step and its seconds;
           then the phase's seconds
  train    gemma3-1b's training path (launch/train's loop): K4's row
           log-sum-exp in both prefill forms against the plain version's
           and the attention gradient (K4 with its lse, the plain
           block-recompute backward) against autograd through the plain
           version, at the path's shapes (bf16 4 x 1024, a local and a
           global layer) and the check's (f32 2 x 256), with the backward's
           device ms beside scaled_dot_product_attention's backward; the
           f32 loss and every gradient leaf of the model cut to 2 layers
           at full width, card against CPU; then bf16 uncut, 8 AdamW steps
           on 4 x 1024 tokens with an async checkpoint at step 4 and the
           final one (K4's counters set to 0 just before the loop: the
           tensor-core form 26 + 24 times a step, the 24 period layers
           again in the remat backward), a step alone for its launches and
           its device time, then the run resumed from step 4, whose
           losses must replay steps 5-8: step ms (host), device ms,
           tokens/s, peak memory
  train_families  K4's row log-sum-exp and the attention gradient at the
           families' training shapes (granite's GQA at D 64 on 4 x 1024,
           deepseek's MLA unpadded on 2 x 1024, and its lse call
           zero-padded to 256 once more as the earlier form; bf16) with
           the plain backward's ms beside scaled_dot_product_attention's
           backward;
           then granite-moe-3b-a800m and mamba2-1.3b uncut and
           deepseek-v2-236b cut to 1 layer, all at full width: one f32
           step of the model cut to 2 layers (deepseek 1) with K4 against
           the same step with the plain attention on the card (mamba2:
           card against CPU), loss and every gradient leaf; 4 bf16 AdamW
           steps (the in-place update) on 4 x 1024 tokens (deepseek 2 x
           1024), K4's counters
           set to 0 before each step and read after it (the tensor-core
           form once per attention layer and once more in the remat
           backward; deepseek's step runs no aten::constant_pad_nd),
           step ms (host and CUDA events), peak memory; then
           moe_ffn_a2a through a
           one-rank NCCL process group on a (1, 1) mesh, granite cut to 2
           layers in f32, loss and gradients against moe_ffn
  cells    the reference's shape cells (configs.SHAPES) through
           launch/cells.py's run_cell, full width and depth, each at the
           largest batch up to the reference's that the card holds
           (CELLS): gemma3-1b x prefill_32k, decode_32k (full caches, and
           the rolling window cache at the reference's batch), long_500k
           and train_4k; mamba2-1.3b x prefill_32k, decode_32k and
           long_500k; first K4 at their shapes against the plain version
           and timed: the bf16 and f32 prefill at S 32768, window 512 and
           causal, held on three windows of 1024 rows against the plain
           version on those rows alone; decode over 32768 keys at B 64
           and B 128, a 512-slot rolling cache at B 128 and 524288 keys at
           B 1 (132 splits, the merge kernel), each running the kernels
           ``ops.decode_kernel`` names and each failing a planted merge
           of half its splits; the prefill with its lse at the train
           cell's batch x 4096; each window, or each decode's output,
           also within 1e-2 of the plain version's largest magnitude
           there; then the model-level holds on cuts at full width
           (gemma3-1b's one period of 6 layers: bf16 prefill_fn at 32k
           against f32 within 2e-2, f32 decode_fn at index 32767 with full
           and rolling caches and at 524287 with rolling caches, card
           against CPU within 1e-4, one f32 train step at 4096 with K4
           against the plain
           attention, each leaf within 1e-4 of its largest; mamba2-1.3b
           cut to 2 layers: f32 prefill_fn at 32k and decode steps at
           B 128 and B 1, card against CPU within 1e-4); then each cell's
           line (seq, batch and the reference's, reduced, host and device
           ms, tokens/s, peak and reckoned GB, K4's launches from its
           counters, set to 0 just before the timed call, by form (held
           to the cell's layers) and by form and shape, and the forms
           whose kernels the profiler saw); each K4 case's entry on the
           kernels line counts its path's launches at its own form and
           shape
  seconds  after each phase, its wall seconds (``{"phase": "seconds",
           "of": ..., "s": ...}``); each K4 case's line carries its own
  total    the script's seconds so far
  kernels  one line: every kernel (K3 once per app segment, K4 once per
           form on gemma3-1b's path and once per form on each family's
           path that launches it, ``flash_attention:<form>:<arch>``, the
           training paths' ``flash_attention:prefill_wgmma:train`` and
           ``flash_attention:<form>:train:<arch>``, the cells'
           ``flash_attention:<form>:cells:<shape>[:<part>]``, the cycle
           kernel) with its launches on its main path (the counters
           are reset just before the cycle phase's path, the image path
           phase, each f32 prefill_fn call and each bf16 prefill_fn call;
           each K4 entry counts one path's launches beside the case at
           that path's shapes), its error against the plain version, and
           its times and bound

The last line is ``{"ok": true, "device": {...}}``.  Any mismatch, build
failure or launch error ends the script with a nonzero exit before it.
"""
from __future__ import annotations

import json
import re
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# the SMs' lanes a cycle; the memory rate and the flop peaks are
# kernels.timing's (HBM_BYTES_PER_S, PEAK_FLOPS, bound_ms)
INT32_LANES_PER_SM = 64
F32_LANES_PER_SM = 128
TPU_KERNELS = {"conv2d": "kernels/conv2d/kernel.py::_conv_kernel",
               "sad": "kernels/sad/kernel.py::_sad_kernel",
               "megakernel": "core/lowering/megakernel.py::emit_megakernel",
               "flash_attention": "kernels/flash/kernel.py::_flash_kernel",
               # no pallas_call: the reference's two XLA while_loops
               "cyclesim": "hwsim/vector.py::_segment_impl, "
                           "hwsim/population.py::_pop_impl"}
LLM_ARCH = "gemma3-1b"
LLM_BATCH, LLM_PROMPT, LLM_GEN = 4, 1024, 32
# the f32 decode-against-prefill check's prompt: decode_fn over its
# tokens one step at a time (host-bound, about 40 ms a step) against
# prefill_fn over the same; the path's f32 prefill_fn stays at 2 x 1024
LLM_F32_PROMPT = 128
# the families phase: each arch at full width, cut as ``reduced`` says:
# (arch, the f32 checks' cut, the bf16 serving cut).  The f32 cuts fit
# the card in f32 (at most 28 GB, jamba's 56), the serving cuts in bf16
# (jamba's 51 GB the most; qwen2-72b and command-r-plus serve at their f32
# cuts' depth, which keeps the phase short).  jamba's experts pad to 16 whatever their count
# (models.model.moe_experts_padded), so its 4 layers with two MoE layers
# are 92 GB in f32: its f32 cut keeps the MoE at layer 3 alone (every 4th
# layer from 3; layers 0-2 keep jamba's dense MLP)
FAMILIES = (("granite-moe-3b-a800m", {}, {}), ("mamba2-1.3b", {}, {}),
            ("deepseek-v2-236b", {"n_layers": 2}, {"n_layers": 2}),
            ("gemma-2b", {}, {}), ("musicgen-medium", {}, {}),
            ("qwen2-vl-7b", {}, {}),
            ("qwen2-72b", {"n_layers": 4}, {"n_layers": 4}),
            ("command-r-plus-104b", {"n_layers": 2}, {"n_layers": 2}),
            ("jamba-1.5-large-398b",
             {"n_layers": 4, "moe_every": 4, "moe_offset": 3},
             {"n_layers": 4}))
# the 2-layer card-against-CPU check takes the f32 cut's first two layers,
# or (first layer, the 2-layer config's changes): jamba's layers 2 and 3
# of its f32 cut (Mamba2 with the dense MLP, attention with the MoE), as
# a 2-layer model whose pattern is those two kinds
FAM_TWO_LAYERS = {"jamba-1.5-large-398b": (2, {
    "pattern": ("mamba", "attn"), "moe_every": 2, "moe_offset": 1})}
FAM_BATCH, FAM_PREFILL, FAM_PROMPT, FAM_GEN = 4, 1024, 128, 16
# the families' K4 decode cases' span: serving's last step's keys
FAM_CASE_KEYS = FAM_PROMPT + FAM_GEN
FAM_F32_PROMPT = 64     # the families' f32 checks' prompt
# the families' f32 decode-against-prefill check: decode_fn over the
# prompt's first tokens (host-bound steps) against prefill_fn over them
FAM_F32_DECODE = 32
ROUTE_GAP = 1e-5        # a routing difference at or below it is a near-tie
# the head dim MLA's q, k and v were zero-padded to before K4 took
# Dv != Dk: its "before" cases time that call once more
MLA_PADDED = 256
# K4's row log-sum-exp against the plain version's: f32 sums of up to 1024
# exponentials of f32 scores (bf16 products are exact in f32)
LSE_ATOL = 1e-4
# K4's prefill kernels by ``flash.ops.resources``' keys: the wgmma form
# and the SIMT form at each (Dk, Dv), MLA's (192, 128) included
K4_PREFILL_BUILDS = {
    "prefill_wgmma": ["bf16_d64", "bf16_d128", "bf16_d192_128", "bf16_d256"],
    "prefill_simt": ["f32_d64", "f32_d128", "f32_d192_128", "f32_d256"]}
# the bf16 prefill form on the tensor cores
K4_BF16_FORMS = ("prefill_wgmma",)
MK_APPS = ("flow", "descriptor", "pyramid")
# the served dense archs' K4 shapes, (H, Hkv, D) from their configs, by
# flash_phase's case key
SERVED_K4 = {"gemma_2b": "gemma-2b", "musicgen": "musicgen-medium",
             "qwen2_vl": "qwen2-vl-7b", "qwen2_72b": "qwen2-72b",
             "command_r_plus": "command-r-plus-104b"}
# each family with attention: the key of flash_phase's cases at its
# path's shapes and whether its serving decodes through K4 (mamba2 runs no
# attention, deepseek decodes MLA in latent space, jamba's attention layer
# has qwen2-72b's shapes); its K4 forms are family_forms'
FAMILY_K4 = {"granite-moe-3b-a800m": ("granite", True),
             "deepseek-v2-236b": ("mla", False),
             **{arch: (key, True) for key, arch in SERVED_K4.items()},
             "jamba-1.5-large-398b": ("qwen2_72b", True)}
# the K4 cases that the kernels line reads (each path's shapes) and MLA's
# rows at an offset, timed; the others are held to the plain version
# and their launches (a decode case also to the kernels the profiler saw)
# and not timed
K4_TIMED_CASES = {"main_local", "main_local_f32", "decode_full",
                  "mla_offset_lse_bf16", "train_local_bf16",
                  "train_granite_bf16", "train_mla_bf16",
                  *(f"{key}_{case}"
                    for key in ("granite", "mla", *SERVED_K4)
                    for case in ("prefill_bf16", "prefill_f32",
                                 "decode_bf16")),
                  # the cells phase's decode and lse cases (its 32k
                  # prefill cases, held on row windows, are always timed)
                  "cells_decode_32k_b64", "cells_decode_32k_b128",
                  "cells_decode_rolling_b128", "cells_long_500k",
                  "cells_train_4k_local", "cells_train_4k_global"}
# the decode form's builds by kernel: the split kernel's 3 head dims x 2
# types x head groups of 1, 2, 3, 4, 6 and 8 (ops.decode_head_group); the
# cluster kernel's the same but bf16 at 6 and 8, which the mma kernel takes
# (ops.decode_kernel); the mma kernel's 3 head dims in bf16; the merge
# kernel's 2 types
K4_DECODE_BUILDS = {"decode_split": 36, "decode_cluster": 30,
                    "decode_mma": 3, "decode_merge": 2}
# odd sizes that no tile divides (PYRAMID's strides must divide its frame)
MK_ODD = {"flow": (37, 13), "descriptor": (45, 19), "pyramid": (36, 20)}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def kernel_form(name: str):
    """K4's form whose kernel a profiler event's name is, or None."""
    from repro_torch.kernels.flash.ops import kernel_form as form
    return form(name)


def bf16_prefill_form(cfg) -> str:
    """The form K4 takes for a config's bf16 prefill: by its head dims
    (MLA's q, k at dn + dr and v at dv, as models.layers hands them)."""
    import torch
    from repro_torch.kernels.flash.ops import prefill_form
    if cfg.mla:
        return prefill_form(torch.bfloat16, cfg.qk_nope_dim + cfg.qk_rope_dim,
                            cfg.v_head_dim)
    return prefill_form(torch.bfloat16, cfg.hd, cfg.hd)


def family_forms(arch: str) -> tuple:
    """K4's forms on a family's path: its bf16 prefill's (by its head
    dims), the SIMT form's f32 prefill, and decode where it decodes
    through K4."""
    from repro_torch.configs import ARCHS
    decodes = FAMILY_K4[arch][1]
    return (bf16_prefill_form(ARCHS[arch]), "prefill_simt",
            *(("decode",) if decodes else ()))


def form_counts(**counts) -> dict:
    """K4's launches per form of ``flash.ops.FORMS``, 0 where not given."""
    from repro_torch.kernels.flash.ops import FORMS
    return {f: counts.get(f, 0) for f in FORMS}


def smi(query: str) -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def sm_clock_mhz(torch, call, reps: int = 1, seconds: float = 0.3) -> dict:
    """The SM clock (MHz) that nvidia-smi samples every 10 ms while
    ``call`` runs back to back (``reps`` calls a synchronize) for about
    ``seconds``: min, median and max of the samples and their count."""
    proc = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm",
                             "--format=csv,noheader,nounits", "-lms", "10"],
                            stdout=subprocess.PIPE, text=True)
    try:
        first = proc.stdout.readline()          # the sampler is running
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            for _ in range(reps):
                call()
            torch.cuda.synchronize()
    finally:
        proc.terminate()
        rest = proc.communicate(timeout=60)[0]
    mhz = [int(x) for x in (first + rest).split() if x.isdigit()]
    return {"min": min(mhz), "median": statistics.median(mhz),
            "max": max(mhz), "samples": len(mhz)}


def ptxas_summary(log: str):
    """ptxas's registers / shared memory / spill lines of one build."""
    return [ln.split(" : ", 1)[-1].strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln or "smem" in ln]


def check_equal(what: str, got, want) -> int:
    """Exact agreement of two integer tensors; returns the max abs diff."""
    import torch
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{what}: {tuple(got.shape)} {got.dtype} vs "
                             f"{tuple(want.shape)} {want.dtype}")
    err = int((got.long() - want.long()).abs().max().item()) \
        if got.numel() else 0
    if err != 0 or not torch.equal(got, want):
        raise AssertionError(f"{what}: max abs diff {err}")
    return err


def app_inputs(np, app: str, uf, rng, frames: int):
    """A batch of ``frames`` random frames for one app (FLOW's second
    image is the first shifted right)."""
    shape = (frames, uf.h, uf.w)
    x = rng.randint(0, 256, shape).astype(np.int64)
    if app == "stereo":
        return {"stereo.in": (x, np.roll(x, -9, axis=-1))}
    if app == "flow":
        return {"flow.in": (x, np.roll(x, 2, axis=-1))}
    return {f"{uf.name}.in": x}


def golden(np, app: str, uf, frame):
    """The golden model's output for one frame, as a list of arrays."""
    from repro_torch import apps
    (x,) = frame.values()
    if app == "convolution":
        return [apps.golden_convolution(x)]
    if app == "stereo":
        return [apps.golden_stereo(*x, nd=uf.nd)]
    if app == "flow":
        return list(apps.golden_flow(*x))
    if app == "descriptor":
        return list(apps.golden_descriptor(x, n_features=uf.n_features))
    return [apps.golden_pyramid(x, levels=uf.levels)]


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of one call, from CUDA events around ``iters``
    back-to-back calls after ``warmup`` calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: int, int_ops: int, peak_int_ops: float, f32_ops: int = 0):
    """The least time for the work: the larger of the bytes over the
    memory rate and the operations over the SMs' lane rate, where integer
    ops run on 64 INT32 lanes per SM and all ops together on at most 128
    (the FP32 lanes)."""
    from repro_torch.kernels.timing import HBM_BYTES_PER_S
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    peak_all = peak_int_ops * F32_LANES_PER_SM / INT32_LANES_PER_SM
    t_ops = max(int_ops / peak_int_ops, (int_ops + f32_ops) / peak_all) * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            t_bytes, t_ops)


def kernel_phase(torch, np, peak_int_ops):
    import torch.nn.functional as F
    from repro_torch.kernels.timing import device_ms
    from repro_torch.apps.convolution import SHIFT, default_kernel
    from repro_torch.kernels.conv2d.ops import conv2d_stencil
    from repro_torch.kernels.conv2d.ref import conv2d_ref
    from repro_torch.kernels.sad.ops import sad_disparity
    from repro_torch.kernels.sad.ref import sad_ref

    dev = torch.device("cuda")
    rng = np.random.RandomState(0)
    results = {}

    def u8(shape):
        return torch.from_numpy(rng.randint(0, 256, shape).astype(
            np.int32)).to(dev)

    # --- K1 conv2d: CONVOLUTION 1080p's site sees the padded 1088x1936
    # frame, so P is (1095, 1943) with the 8x8 bank, shift 11
    k_main = torch.from_numpy(default_kernel().astype(np.int32)).to(dev)
    cases = [("main", u8((3, 1095, 1943)), k_main, SHIFT)]
    k_odd = torch.from_numpy(rng.randint(0, 64, (3, 5)).astype(
        np.int32)).to(dev)
    cases += [(f"odd_shift{s}", u8((3, 13 + 2, 37 + 4)), k_odd, s)
              for s in (0, 11)]
    # the general form at other tap shapes, and sums that wrap: taps near
    # 2^23 make each product near 2^31, so the int32 sums overflow
    for kh, kw in ((1, 1), (11, 2), (2, 16)):
        k_g = torch.from_numpy(rng.randint(0, 64, (kh, kw)).astype(
            np.int32)).to(dev)
        cases.append((f"taps_{kh}x{kw}", u8((3, 13 + kh - 1, 37 + kw - 1)),
                      k_g, 11))
    for kh, kw in ((8, 8), (3, 5)):
        k_w = torch.from_numpy(rng.randint(2 ** 23 - 64, 2 ** 23, (
            kh, kw)).astype(np.int32)).to(dev)
        cases.append((f"wrap_{kh}x{kw}", u8((3, 40 + kh - 1, 96 + kw - 1)),
                      k_w, 11))
    err = 0
    for name, p, k, s in cases:
        err = max(err, check_equal(f"conv2d {name}", conv2d_stencil(p, k, s),
                                   conv2d_ref(p, k, s)))
    p1 = cases[0][1][:1].contiguous()
    out1 = conv2d_stencil(p1, k_main, SHIFT)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    # the yardstick's float inputs are made once, outside the timing: it
    # times cuDNN's conv2d, the cast back to int32, the shift and the mask
    p1_f, k_f = p1.float()[:, None], k_main.float()[None, None]

    def library():
        acc = F.conv2d(p1_f, k_f)
        return (acc[:, 0].to(torch.int32) >> SHIFT) & 0xFF

    check_equal("conv2d library yardstick", library(), out1)
    n, hp, wp = p1.shape
    kh, kw = k_main.shape
    nbytes = 4 * (p1.numel() + k_main.numel() + out1.numel())
    b_ms, b_by, t_bytes, t_ops = bound(nbytes, out1.numel() * kh * kw,
                                       peak_int_ops)
    results["conv2d"] = {
        "max_abs_err": err,
        # ms: the kernel's device time; call_ms: CUDA events around
        # back-to-back wrapper calls, host work included
        "ms": device_ms(lambda: conv2d_stencil(p1, k_main, SHIFT), 200),
        "call_ms": cuda_ms(lambda: conv2d_stencil(p1, k_main, SHIFT), 200),
        "plain_ms": cuda_ms(lambda: conv2d_ref(p1, k_main, SHIFT), 10),
        "library_ms": device_ms(library, 50),
        "library_call_ms": cuda_ms(library, 50),
        "bound_ms": b_ms, "bound_by": b_by,
        "bound_bytes_ms": t_bytes, "bound_ops_ms": t_ops,
        "shape": {"p": [n, hp, wp], "k": [kh, kw], "out": list(out1.shape)},
        "bytes": nbytes, "int_ops": out1.numel() * kh * kw,
    }
    emit({"phase": "kernel", "name": "conv2d", **results["conv2d"]})

    # --- K2 sad: STEREO 720x400, nd=64, 8x8 blocks -> L, R (407, 790)
    nd, bh, bw = 64, 8, 8
    l_main = u8((3, 400 + bh - 1, 720 + bw - 1 + nd - 1))
    r_main = torch.roll(l_main, 5, dims=2).contiguous()
    odd = (13, 37, 5, 3, 4)
    oh, ow, ond, obh, obw = odd
    l_odd = u8((3, oh + obh - 1, ow + obw - 1 + ond - 1))
    r_odd = u8(tuple(l_odd.shape))
    tie = torch.full((3, oh + obh - 1, ow + obw - 1 + ond - 1), 7,
                     dtype=torch.int32, device=dev)
    # R repeats every 5 columns, so disparities 5 apart tie: the first wins
    r_rep = l_main[:, :, :5].repeat(1, 1, -(-l_main.shape[2] // 5))[
        :, :, :l_main.shape[2]].contiguous()
    # blocks wider than a warp, which the kernel's general form takes
    wh, ww, wnd, wbh, wbw = 13, 300, 4, 60, 40
    l_wide = u8((3, wh + wbh - 1, ww + wbw - 1 + wnd - 1))
    r_wide = u8(tuple(l_wide.shape))
    err = 0
    for name, l, r, prm in [("main", l_main, r_main, (nd, bh, bw)),
                            ("period5_ties", l_main, r_rep, (nd, bh, bw)),
                            ("odd", l_odd, r_odd, (ond, obh, obw)),
                            ("all_tie", tie, tie.clone(), (ond, obh, obw)),
                            ("wide", l_wide, r_wide, (wnd, wbh, wbw))]:
        got = sad_disparity(l, r, nd=prm[0], bh=prm[1], bw=prm[2])
        err = max(err, check_equal(f"sad {name}", got,
                                   sad_ref(l, r, nd=prm[0], bh=prm[1],
                                           bw=prm[2])))
        if name == "all_tie" and bool(got.any()):
            raise AssertionError("sad all_tie: a disparity other than 0 won")
    l1, r1 = l_main[:1].contiguous(), r_main[:1].contiguous()
    out1 = sad_disparity(l1, r1, nd=nd, bh=bh, bw=bw)
    nbytes = 4 * (l1.numel() + r1.numel() + out1.numel())
    # The function's least work is a box filter per disparity: one |L-R|
    # per (padded pixel, d), counted as one operation; a sliding sum across
    # (add the new column, subtract the old) per (row-padded pixel, d) and
    # one down per (pixel, d); one compare per (pixel, d).  Integer sums are
    # exact and the compare order keeps the tie rule.
    _, h, w = out1.shape
    hp, wp = h + bh - 1, w + bw - 1
    int_ops = nd * (hp * wp + 2 * hp * w + 2 * h * w + h * w)
    # the direct sum's count: every block summed from its taps
    direct_ops = out1.numel() * nd * (bh * bw + 1)
    b_ms, b_by, t_bytes, t_ops = bound(nbytes, int_ops, peak_int_ops)
    results["sad"] = {
        "max_abs_err": err,
        "ms": device_ms(lambda: sad_disparity(l1, r1, nd=nd, bh=bh, bw=bw),
                        50),
        "call_ms": cuda_ms(lambda: sad_disparity(l1, r1, nd=nd, bh=bh,
                                                 bw=bw), 50),
        "plain_ms": cuda_ms(lambda: sad_ref(l1, r1, nd=nd, bh=bh, bw=bw),
                            2, warmup=1),
        "library_ms": None,
        "bound_ms": b_ms, "bound_by": b_by,
        "bound_bytes_ms": t_bytes, "bound_ops_ms": t_ops,
        "shape": {"l": list(l1.shape), "nd": nd, "block": [bh, bw],
                  "out": list(out1.shape)},
        "bytes": nbytes, "int_ops": int_ops,
        "direct_int_ops": direct_ops,
        "direct_ops_ms": direct_ops / peak_int_ops * 1e3,
    }
    emit({"phase": "kernel", "name": "sad", **results["sad"]})
    return results


def paper_designs():
    """Every app at the paper's size, compiled once (the hardware flow
    included) on the kernels backend: label -> (UserFunction, design,
    compile_pipeline seconds)."""
    from repro_torch import CompileOptions, compile_pipeline
    from repro_torch.apps import PIPELINES
    out = {}
    for app, cls in PIPELINES.items():
        uf = cls()
        t0 = time.perf_counter()
        design = compile_pipeline(uf, options=CompileOptions(
            backend="kernels"))
        out[app] = (uf, design, time.perf_counter() - t0)
    return out


def mk_designs(paper):
    """Every design whose fused segment K3 runs here: each app at
    1920x1080 (the main path) and at its odd size, and the all-ops
    pipeline, on the kernels backend."""
    from repro_torch import CompileOptions, compile_pipeline, core
    from repro_torch.apps import PIPELINES
    from repro_torch.kernels.megakernel.check import all_ops_pipeline
    opts = CompileOptions(backend="kernels")
    ufs = {}
    for app in MK_APPS:
        w, h = MK_ODD[app]
        ufs[f"{app}_{w}x{h}"] = PIPELINES[app](w=w, h=h)
    ufs["allops_37x13"] = all_ops_pipeline(core)
    out = {app: paper[app][:2] for app in MK_APPS}
    out.update({label: (uf, compile_pipeline(uf, options=opts))
                for label, uf in ufs.items()})
    return out


def bench_designs():
    """Every app at its bench_case size on the kernels backend, for the
    check against the port's executor: app -> (inputs_fn, design)."""
    from repro_torch import CompileOptions, compile_pipeline
    from repro_torch.apps import BENCH_CASES
    out = {}
    for app, case in BENCH_CASES.items():
        uf, inputs_fn = case()
        out[app] = (inputs_fn, compile_pipeline(
            uf, options=CompileOptions(backend="kernels")))
    return out


def external_designs():
    """The External pipelines (``external_pipelines``): ``clip`` at
    1920x1080 and every case at 37x13, on the kernels backend, each with
    the list its numpy model appends to once per call: label ->
    (UserFunction, design, log)."""
    from repro_torch import CompileOptions, compile_pipeline, core
    from repro_torch.kernels.megakernel.check import external_pipelines
    out = {}
    for w, h, names in ((1920, 1080, ("clip",)),
                        (37, 13, ("clip", "tuple", "wide"))):
        log = []
        ufs = external_pipelines(core, w, h, log)
        for name in names:
            out[f"{name}_{w}x{h}"] = (ufs[name], compile_pipeline(
                ufs[name], options=CompileOptions(backend="kernels")), log)
    return out


def build_phase(designs, extra):
    """csrc/*.cu and every design's generated segments (``designs``: one
    each; ``extra``: label -> design, as many as it has), one nvcc each,
    all in one parallel batch.  The segments come from the CPU lowering,
    whose emitted text is the card's; the card's lowering then loads the
    cached builds."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash import ops as flash_ops
    segments = {}
    for label, (_uf, design) in designs.items():
        lp = design.lower("kernels", device="cpu")
        if len(lp.megakernels) != 1:
            raise AssertionError(f"{label}: {len(lp.megakernels)} "
                                 f"megakernels, want 1: {lp.notes}")
        segments[label] = lp.megakernels[0]
    extra_src = {f"{label}:{mk.name}": mk.source
                 for label, design in extra.items()
                 for mk in design.lower("kernels", device="cpu").megakernels}
    from repro_torch.launch import cycle_profile
    t0 = time.perf_counter()
    with ThreadPoolExecutor(3) as pool:     # each waits on its nvcc runs
        csrc = pool.submit(_build.build_all)
        gen = pool.submit(_build.build_generated, {
            **{k: mk.source for k, mk in segments.items()}, **extra_src})
        # the cycle kernel's profiling build (-DCYCLESIM_PROFILE), for the
        # cycle phase's split and latency probes; never on a path
        prof = pool.submit(cycle_profile.profile_library)
        built, gen, prof = csrc.result(), gen.result(), prof.result()
    k4 = flash_ops.resources(built["flash_attn"], built["flash_decode"])
    if any(key.startswith("bf16") for key in k4.get("prefill_simt", {})):
        raise AssertionError("the SIMT prefill form has a bf16 build")
    for form, want in K4_PREFILL_BUILDS.items():
        dims = sorted(k4.get(form, {}))
        if dims != sorted(want):
            raise AssertionError(f"K4's {form} form built for {dims}, "
                                 f"want {sorted(want)}")
        for dim, use in k4[form].items():
            if use.get("spill_stores", 1) or use.get("spill_loads", 1):
                raise AssertionError(f"K4's {form} form spills at {dim}: "
                                     f"{use}")
    # K1's and K2's forms and every generated segment: a segment's launch
    # bounds name the blocks per SM its shared memory allows, which caps
    # its registers, so a spill there is one nobody chose
    for name, b in [("conv2d", built["conv2d"]), ("sad", built["sad"])] + [
            (f"megakernel {k}", g) for k, g in gen.items()]:
        for fn, use in _build.ptxas_usage(b.log).items():
            if use.get("spill_stores", 1) or use.get("spill_loads", 1):
                raise AssertionError(f"{name} spills in {fn}: {use}")
    built_decode = {form: len(k4.get(form, {})) for form in K4_DECODE_BUILDS}
    if built_decode != K4_DECODE_BUILDS:
        raise AssertionError(f"K4's decode kernels built {built_decode} "
                             f"times, want {K4_DECODE_BUILDS}")
    for form in K4_DECODE_BUILDS:
        for key, use in k4[form].items():
            if use.get("spill_stores", 1) or use.get("spill_loads", 1):
                raise AssertionError(f"K4's {form} kernel spills at {key}: "
                                     f"{use}")
    emit({"phase": "build", "wall_s": time.perf_counter() - t0,
          "k1": _build.ptxas_usage(built["conv2d"].log), "k4_forms": k4,
          "cyclesim": _build.ptxas_usage(built["cyclesim"].log),
          "cyclesim_profile_nvcc_s": prof.seconds,
          "kernels": {n: {"nvcc_s": b.seconds, "ptxas": ptxas_summary(b.log)}
                      for n, b in built.items()},
          "generated": {k: {"segment": mk.name, "nvcc_s": gen[k].seconds,
                            "ptxas": ptxas_summary(gen[k].log),
                            "tile": list(mk.tile), "smem_bytes": mk.smem_bytes,
                            "min_blocks": mk.min_blocks,
                            "phases": len(mk.levels),
                            "stored_windows": len(mk.stored),
                            "fused_nodes": mk.n_nodes,
                            "lines": mk.source.count("\n")}
                        for k, mk in segments.items()},
          "generated_extra": {k: {"nvcc_s": gen[k].seconds,
                                  "ptxas": ptxas_summary(gen[k].log)}
                              for k in extra_src}})


def megakernel_phase(torch, np, designs, peak_int_ops):
    """K3 against its plain version on every design, then its times at
    1920x1080, one frame."""
    from repro_torch.kernels.megakernel.check import check_leaves
    from repro_torch.kernels.megakernel.ops import megakernel_segment
    from repro_torch.kernels.megakernel.ref import megakernel_ref
    from repro_torch.kernels.timing import device_ms

    rng = np.random.RandomState(3)
    results = {}
    for label, (uf, design) in designs.items():
        app = label.split("_")[0]
        lp = design.lower("kernels")
        mk = lp.megakernels[0]
        checks = {}
        for frames in (1, 3) if label == app else (3,):
            batch = app_inputs(np, app, uf, rng, frames)
            seg_in = lp.segment_inputs(mk, batch)
            got = megakernel_segment(mk, *seg_in)
            torch.cuda.synchronize()
            want = megakernel_ref(mk, *seg_in)
            checks[frames] = check_leaves(f"megakernel {label} x{frames}",
                                          got, want,
                                          exact=app == "descriptor")
        line = {"phase": "kernel", "name": "megakernel", "design": label,
                "segment": mk.name, "tile": list(mk.tile),
                "smem_bytes": mk.smem_bytes,
                "checks": {str(f): c for f, c in checks.items()}}
        if label == app:
            seg1 = lp.segment_inputs(mk, app_inputs(np, app, uf, rng, 1))
            one = cuda_ms(lambda: megakernel_segment(mk, *seg1), 1, warmup=1)
            iters = max(3, min(100, int(500 / max(one, 1e-3))))
            # the function's least work: each box-sum chain a sliding sum,
            # f32 ops at the FP32 lanes' rate; the reference's count
            # (``flops``: every box-sum output summed directly, all ops at
            # the int32 rate) is kept beside it
            roof = lp.megakernel_stats()["rooflines"][0]
            int_ops, f32_ops = mk.least_ops()
            b_ms, b_by, t_bytes, t_ops = bound(roof["io_bytes"], int_ops,
                                               peak_int_ops, f32_ops)
            line.update({
                "max_abs_err": max(c["max_abs_err"] for c in checks.values()),
                "max_ulp": max(c["max_ulp"] for c in checks.values()),
                "ms": device_ms(lambda: megakernel_segment(mk, *seg1),
                                iters),
                "call_ms": cuda_ms(lambda: megakernel_segment(mk, *seg1),
                                   iters),
                "plain_ms": cuda_ms(lambda: megakernel_ref(mk, *seg1), 2,
                                    warmup=1),
                "library_ms": None,
                "bound_ms": b_ms, "bound_by": b_by,
                "bound_bytes_ms": t_bytes, "bound_ops_ms": t_ops,
                "bytes": roof["io_bytes"], "int_ops": int_ops,
                "f32_ops": f32_ops, "direct_ops": roof["flops"],
                "direct_ops_ms": roof["flops"] / peak_int_ops * 1e3,
                "shape": [uf.h, uf.w]})
            results[app] = line
        emit(line)
    return results


def _hw_fig9(t) -> dict:
    """CONVOLUTION at 1920x1080 compiled at throughput ``t`` (a Fraction;
    a worker process of the hw phase)."""
    from repro_torch import compile_pipeline
    from repro_torch.apps import Convolution
    t0 = time.perf_counter()
    d = compile_pipeline(Convolution(), T=t)
    sec = time.perf_counter() - t0
    return {"T": str(t), "T_eff": str(d.T), "cycles": d.cycles_per_frame(),
            "compile_s": sec, "check_schedule": d.check_schedule(),
            "clbs": d.resources.clbs, "brams": d.resources.brams}


def _hw_sim(app: str) -> dict:
    """One app's sim_case: compile, ``simulate()`` and
    ``optimize_fifos(SimOptions(frames=2))`` on the scalar engine (a
    worker process of the hw phase)."""
    from repro_torch import SimOptions, compile_pipeline
    from repro_torch.apps import SIM_CASES
    uf, T, _hand = SIM_CASES[app]()
    d = compile_pipeline(uf, T=T)
    t0 = time.perf_counter()
    res = d.simulate(options=SimOptions(engine="scalar"))
    sim_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    alloc = d.optimize_fifos(options=SimOptions(engine="scalar", frames=2))
    alloc_s = time.perf_counter() - t0
    bits = {(e.src, e.dst): e.token_bits for e in d.edges}
    return {"app": app, "shape": [uf.h, uf.w], "T": str(T),
            "sim_cycles": res.cycles, "sink_tokens": res.sink_tokens,
            "deadlock": res.deadlock, "engine": res.engine, "sim_s": sim_s,
            "alloc_frames": 2, "proven": alloc.proven,
            "analytic_fifo_bits": sum(n * bits[k]
                                      for k, n in alloc.analytic.items()),
            "sim_fifo_bits": alloc.total_bits(bits), "alloc_s": alloc_s}


def hw_phase(paper):
    """The hardware half on the host: each app at the paper's size (its
    compile seconds, interface kind, effective T, netlist, cycles per
    frame, FIFO bits and solver, resources, and ``check_schedule``, which
    must hold); CONVOLUTION at each fig. 9 throughput, against the paper's
    T (within 0.01) and cycles (within 1.1 %); and each app's sim_case
    through the scalar cycle simulator and the FIFO allocator (no
    deadlock, proven).  The fig. 9 compiles and the sim cases run in
    worker processes, several at once."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    from fractions import Fraction
    from repro_torch.apps import SIM_CASES
    from repro_torch.apps.convolution import PAPER_CONV
    apps = {}
    for app, (uf, d, sec) in paper.items():
        t0 = time.perf_counter()
        ok = d.check_schedule()
        r = d.resources
        apps[app] = {"compile_s": sec, "check_schedule_s":
                     time.perf_counter() - t0, "kind": d.kind,
                     "T_eff": str(d.T), "T_eff_float": float(d.T),
                     "modules": len(d.modules), "edges": len(d.edges),
                     "cycles_per_frame": d.cycles_per_frame(),
                     "fifo_bits": d.fifo.total_bits,
                     "fifo_solver": d.fifo.solver, "clbs": r.clbs,
                     "dsps": r.dsps, "brams": r.brams,
                     "check_schedule": ok}
        if not ok:
            raise AssertionError(f"{app}: check_schedule() is False")
    t0 = time.perf_counter()
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(6, mp_context=ctx) as pool:
        fig9 = pool.map(_hw_fig9, [t for t in PAPER_CONV if t != 1])
        sims = pool.map(_hw_sim, list(SIM_CASES))
        fig9, sims = list(fig9), list(sims)
    pool_s = time.perf_counter() - t0
    conv = paper["convolution"][1]
    fig9.append({"T": "1", "T_eff": str(conv.T),
                 "cycles": conv.cycles_per_frame(),
                 "compile_s": paper["convolution"][2],
                 "check_schedule": apps["convolution"]["check_schedule"],
                 "clbs": apps["convolution"]["clbs"],
                 "brams": apps["convolution"]["brams"]})
    for row in fig9:
        t_paper, cyc_paper = PAPER_CONV[Fraction(row["T"])]
        row["paper_T"], row["paper_cycles"] = t_paper, cyc_paper
        row["cycles_off"] = abs(row["cycles"] - cyc_paper) / cyc_paper
        if abs(float(Fraction(row["T_eff"])) - t_paper) >= 0.01 \
                or row["cycles_off"] >= 0.011 or not row["check_schedule"]:
            raise AssertionError(f"fig. 9 at T={row['T']}: {row}")
    for row in sims:
        if row["deadlock"] is not None or not row["proven"]:
            raise AssertionError(f"sim_case {row['app']}: {row}")
    line = {"phase": "hw", "apps": apps,
            "fig9": sorted(fig9, key=lambda r: Fraction(r["T"])),
            "sim_cases": sims, "workers": 6, "pool_wall_s": pool_s}
    emit(line)
    return line


# ---- the cycle phase: csrc/cyclesim.cu behind hwsim's engines ----

# the kernel against its plain version: per app's sim_case, (frames,
# unbounded, event jump)
CYCLE_APPS = ("flow", "pyramid", "convolution")
CYCLE_RUNS = ((1, False, True), (2, False, True), (2, False, False),
              (1, True, True))
# PYRAMID's residue edge at depth 0 wedges its diamond (a deadlock)
PYRAMID_RESIDUE = (6, 1)
CYCLE_POPULATION = 16
EXPLORE_POINTS = 16
# simulate() at the paper's size, one frame, for all five apps (at T = 1
# STEREO's and DESCRIPTOR's Serialize and Filter emit 64 and 4 tokens an
# input pixel, so their frames run 63x and 4x the analytic cycles;
# repro_torch.launch.cycle_check holds them against the scalar engine)
PAPER_SIM_APPS = ("convolution", "flow", "pyramid", "stereo", "descriptor")
# the path's witnesses: the scalar engine over a whole 1080p frame of
# these (about 35 s each on the host, in the worker pool) ...
PAPER_SCALAR_APPS = ("convolution", "pyramid")
# ... and the plain version and the scalar engine over the first cycles
# of these paper-size frames (their rings have 5-15 k rows: this wraps
# them several times; DESCRIPTOR is the path's only netlist in the (2, 2)
# warp instantiation; FLOW's cut is the kernels line's case)
PAPER_CUT_APPS = ("flow", "stereo", "descriptor")
PAPER_CUT_HORIZON = 40_000


def cycle_phase(torch, np, paper, peak_int_ops):
    """The cycle kernel (csrc/cyclesim.cu): against its plain version and
    the scalar engine at the sim_cases, a population of 16 designs in one
    launch against 16 single runs, the kernel against both on 1080p FLOW's
    first 40 k cycles (its kernels line) and on the paper-size STEREO's
    and DESCRIPTOR's, then its own path (counters set to 0 just before,
    read just after): ``simulate()`` on the card for each app at the
    paper's size (one frame, one launch), the whole CONVOLUTION and
    PYRAMID frames held against the scalar engine, and the explorer's
    population engine; the explorer on the host beside it, and one ingest
    model run.  The host engines run in 6 worker processes meanwhile."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    from fractions import Fraction
    from repro_torch import ExploreOptions, SimOptions
    from repro_torch.apps import SIM_CASES
    from repro_torch.explore import explore_app
    from repro_torch.hwsim import PopulationSim, VectorSim, simulate_ingest
    from repro_torch.kernels import registry
    from repro_torch.kernels.cyclesim import ops as cyc
    from repro_torch.kernels.timing import device_events
    from repro_torch.launch import cycle_check as cc
    from repro_torch.launch import cycle_profile

    kernel = registry.get_kernel("cyclesim")
    t_phase = time.perf_counter()
    cases = [dict(app=app, frames=f, unbounded=u, jump=j)
             for app in CYCLE_APPS for f, u, j in CYCLE_RUNS]
    cases += [dict(app="pyramid", frames=1, unbounded=False, jump=j,
                   zero=[PYRAMID_RESIDUE]) for j in (True, False)]
    scalar_cases = [dict(app=app, frames=2, unbounded=False, jump=True)
                    for app in SIM_CASES]
    cuts = {app: dict(app=app, size="paper", frames=1, unbounded=False,
                      jump=True, max_cycles=PAPER_CUT_HORIZON)
            for app in PAPER_CUT_APPS}
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(6, mp_context=ctx,
                             initializer=cc.worker_init) as pool:
        # the longest host runs first
        w_paper = {app: pool.submit(cc.run_case, dict(
            app=app, size="paper", frames=1, unbounded=False, jump=True),
            "scalar") for app in PAPER_SCALAR_APPS}
        w_cut = {(app, e): pool.submit(cc.run_case, c, e, "cpu")
                 for app, c in cuts.items() for e in ("vector", "scalar")}
        plain = [pool.submit(cc.run_case, c, "vector", "cpu")
                 for c in cases]
        scalar = [pool.submit(cc.run_case, c, "scalar") for c in scalar_cases]
        # the kernel in this process meanwhile
        got = [cc.run_case(c, "vector", "cuda") for c in cases]
        got_sc = [cc.run_case(c, "vector", "cuda") for c in scalar_cases]
        # the horizon on CONVOLUTION's first frame boundary
        conv2 = next(g for c, (g, _s) in zip(cases, got)
                     if c["app"] == "convolution" and c["frames"] == 2)
        hcase = dict(app="convolution", frames=2, unbounded=False, jump=True,
                     max_cycles=conv2["frame_ends"][0] + 1)
        h_plain = pool.submit(cc.run_case, hcase, "vector", "cpu")
        h_scalar = pool.submit(cc.run_case, hcase, "scalar")
        h_got = cc.run_case(hcase, "vector", "cuda")
        rows = []
        for c, (g, g_s), fut in zip(cases + [hcase], got + [h_got],
                                    plain + [h_plain]):
            want, p_s = fut.result()
            err = cc.summary_err(g, want)
            if g != want:
                raise AssertionError(f"cycle kernel != plain on {c}: "
                                     f"{g['cycles']} vs {want['cycles']}, "
                                     f"{g['deadlock']!r} vs "
                                     f"{want['deadlock']!r}, err {err}")
            rows.append({**{k: v for k, v in c.items() if k != "zero"},
                         "zero": [list(k) for k in c.get("zero", ())],
                         "cycles": g["cycles"], "deadlock": g["deadlock"],
                         "skipped": g["cycles_skipped"],
                         "saved": g["cycles_saved"], "max_abs_err": err,
                         "kernel_s": g_s, "plain_s": p_s})
        if not any(r["deadlock"] and r["saved"] for r in rows):
            raise AssertionError("the zero-depth PYRAMID did not deadlock "
                                 "with a jumped tail")
        if h_got[0]["cycles"] != hcase["max_cycles"] or \
                h_got[0]["frame_ends"] != conv2["frame_ends"][:1]:
            raise AssertionError(f"horizon case: {rows[-1]}")
        h_sc, _ = h_scalar.result()
        for label, (g, g_s), (want, w_s) in (
                [(c["app"], k, f.result()) for c, k, f in
                 zip(scalar_cases, got_sc, scalar)]
                + [("convolution-horizon", h_got, (h_sc, 0.0))]):
            if cc.scalar_view(g) != cc.scalar_view(want):
                raise AssertionError(f"cycle kernel != scalar on {label}")
            rows.append({"app": label, "against": "scalar", "frames": 2,
                         "cycles": g["cycles"], "kernel_s": g_s,
                         "scalar_s": w_s, "equal": True})
        emit({"phase": "cycle", "check": "kernel_vs_plain_and_scalar",
              "cases": rows, "s": time.perf_counter() - t_phase})

        # a population of 16 FLOW depth sets in one launch against 16
        # singles
        d = cc.design("flow")
        ana = dict(d.fifo.depth)
        keys = sorted(ana)
        rng = np.random.RandomState(0)
        sets = [ana] + [{k: int(round(v * f)) for k, v in ana.items()}
                        for f in (0, 0.25, 0.5, 0.75, 1.25, 1.5, 2)]
        while len(sets) < CYCLE_POPULATION:
            fac = rng.uniform(0.0, 1.6, size=len(keys))
            sets.append({k: int(round(ana[k] * fac[j]))
                         for j, k in enumerate(keys)})
        before = kernel.launches()
        t0 = time.perf_counter()
        pop = PopulationSim(d.modules, d.edges, sets, frames=2).run()
        pop_s = time.perf_counter() - t0
        if kernel.launches() != before + 1:
            raise AssertionError("the population took more than one launch")
        t0 = time.perf_counter()
        singles = [VectorSim(d.modules, d.edges, ds, frames=2).run()
                   for ds in sets]
        singles_s = time.perf_counter() - t0
        for k, (p, s1) in enumerate(zip(pop, singles)):
            if cc.summary(p) != cc.summary(s1):
                raise AssertionError(f"population design {k} != its single "
                                     "run")
        emit({"phase": "cycle", "check": "population", "app": "flow",
              "designs": len(sets), "launches": 1,
              "deadlocked": sum(r.deadlock is not None for r in pop),
              "cycles": [r.cycles for r in pop], "population_s": pop_s,
              "singles_s": singles_s})
        pop_case = (d, sets, pop)

        # the kernel's time a cycle on FLOW's sim_case, 2 frames
        vs = VectorSim(d.modules, d.edges, ana, frames=2)
        _total, by_name = device_events(vs.run, 3)
        k_ms = sum(v for n, v in by_name.items() if "cyclesim" in n)
        sim2 = next(g for c, (g, _s) in zip(scalar_cases, got_sc)
                    if c["app"] == "flow")
        emit({"phase": "cycle", "check": "sim_case_time",
              "case": "flow_sim_2f", "ms": k_ms, "cycles": sim2["cycles"],
              "ns_per_cycle": k_ms * 1e6 / sim2["cycles"],
              **cyc.layout(vs)})

        # the kernels line, at the path's shape: 1080p FLOW's first
        # PAPER_CUT_HORIZON cycles against the plain version and the
        # scalar engine (run in the pool meanwhile)
        fd = paper["flow"][1]
        vs = VectorSim(fd.modules, fd.edges, dict(fd.fifo.depth), frames=1)
        res_box = []
        _total, by_name = device_events(
            lambda: res_box.append(vs.run(max_cycles=PAPER_CUT_HORIZON)), 3)
        k_ms = sum(v for n, v in by_name.items() if "cyclesim" in n)
        call_ms = cuda_ms(lambda: vs.run(max_cycles=PAPER_CUT_HORIZON), 3,
                          warmup=1)
        got_cut = cc.summary(res_box[-1])
        (want_cut, plain_s), (sc_cut, sc_s) = (w_cut["flow", e].result()
                                               for e in ("vector", "scalar"))
        line_err = cc.summary_err(got_cut, want_cut)
        if got_cut != want_cut or \
                cc.scalar_view(got_cut) != cc.scalar_view(sc_cut):
            raise AssertionError("cycle kernel != plain or scalar on 1080p "
                                 f"FLOW's first {PAPER_CUT_HORIZON} cycles")
        # bytes: the packed netlist and the capacities read once, the final
        # state, scalars and frame ends written once
        net = cyc.pack(vs, torch.device("cuda"))
        executed = got_cut["cycles"] - got_cut["cycles_skipped"]
        nbytes = sum(t.numel() * 8 for t in net.values()) + 8 * (
            vs.E + 6 * vs.E + 3 * vs.M + len(cyc.SCALARS) + vs.frames)
        # least work: per executed cycle about ten int64 compares and adds
        # an edge and twelve a module, two int32 ops each
        ops = executed * (10 * vs.E + 12 * vs.M) * 2
        b_ms, b_by, _tb, _to = bound(nbytes, ops, peak_int_ops)
        # the chain bound: the form's dependent steps a simulated cycle
        # (cycle_profile.CHAIN_STEPS) at the latencies probed on this card;
        # and the profiling build's split of this case's loop iterations
        lay = cyc.layout(vs)
        prof = cycle_profile.profile_library()
        probe = cycle_profile.probes(prof)
        chain_ms = cycle_profile.chain_bound_ms(lay["form"], executed, probe)
        # the population's row (PERF.md section 6): its device time, the
        # operations bound over all its designs (counted as the line below
        # counts one) and the chain bound of its longest design
        pd_, psets, pres = pop_case
        one = VectorSim(pd_.modules, pd_.edges, psets[0], frames=2)
        _total, names = device_events(lambda: PopulationSim(
            pd_.modules, pd_.edges, psets, frames=2).run(), 1, warmup=0)
        execd = [r.cycles - r.cycles_skipped for r in pres]
        p_bytes = len(psets) * (sum(
            t.numel() * 8 for t in cyc.pack(one, torch.device("cuda")).values())
            + 8 * (7 * one.E + 3 * one.M + len(cyc.SCALARS) + one.frames))
        pb_ms, pb_by, _tb, _to = bound(
            p_bytes, sum(execd) * (10 * one.E + 12 * one.M) * 2, peak_int_ops)
        emit({"phase": "cycle", "check": "population_bound", "app": "flow",
              "designs": len(psets),
              "ms": sum(v for n, v in names.items() if "cyclesim" in n),
              "bound_ms": pb_ms, "bound_by": pb_by,
              "executed_cycles": sum(execd), "longest": max(execd),
              "chain_bound_ms": cycle_profile.chain_bound_ms(
                  cyc.layout(one)["form"], max(execd), probe)})
        split = cycle_profile.split(vs, PAPER_CUT_HORIZON, prof)
        line = {"max_abs_err": line_err, "ms": k_ms, "call_ms": call_ms,
                "plain_ms": plain_s * 1e3, "scalar_ms": sc_s * 1e3,
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                "chain_bound_ms": chain_ms,
                "share_of_chain_bound": chain_ms / k_ms,
                "chain_steps": cycle_profile.CHAIN_STEPS[lay["form"]],
                "latency_ns": {k: v["ns"] for k, v in probe["probe"].items()},
                "sm_mhz": probe["sm_mhz"], **split,
                "parent_split": "PERF.md section 6: launch/cycle_profile.py "
                                "on the earlier block-per-design kernel",
                "cycles": got_cut["cycles"],
                "deadlock": got_cut["deadlock"],
                "ns_per_cycle": k_ms * 1e6 / got_cut["cycles"],
                **lay, "modules": vs.M, "edges": vs.E}
        emit({"phase": "kernel", "name": "cyclesim",
              "case": f"flow_1080p_{PAPER_CUT_HORIZON}", **line})

        # the kernel on the other paper-size cuts, held against the pool's
        # plain and scalar runs after the path
        got_cuts = {}
        for app in PAPER_CUT_APPS[1:]:
            pd = paper[app][1]
            sim = VectorSim(pd.modules, pd.edges, dict(pd.fifo.depth),
                            frames=1)
            t0 = time.perf_counter()
            res = sim.run(max_cycles=PAPER_CUT_HORIZON)
            got_cuts[app] = (cc.summary(res), time.perf_counter() - t0,
                             cyc.layout(sim))

        # the cycle kernel's own path: simulate() at the paper's size, one
        # frame, and the explorer's population engine, through the entry
        # points a user calls; one launch a frame
        registry.reset_launch_counts()
        apps, results = {}, {}
        for app in PAPER_SIM_APPS:
            uf, design, _sec = paper[app]
            box = []
            before = kernel.launches()
            t0 = time.perf_counter()
            _tot, names = device_events(
                lambda: box.append(design.simulate(options=SimOptions())), 1,
                warmup=0)
            wall = time.perf_counter() - t0
            if kernel.launches() != before + 1:
                raise AssertionError(f"{app}: simulate() took "
                                     f"{kernel.launches() - before} launches"
                                     ", not one")
            dev_ms = sum(v for n, v in names.items() if "cyclesim" in n)
            res = results[app] = box[0]
            cpf = design.cycles_per_frame()
            if res.deadlock is not None or res.engine != "vector":
                raise AssertionError(f"{app} at paper size: {res.deadlock}, "
                                     f"{res.engine}")
            apps[app] = {"shape": [uf.h, uf.w], "cycles": res.cycles,
                         "cycles_per_frame": cpf,
                         "cycles_over_analytic": res.cycles / cpf,
                         "skipped": res.cycles_skipped, "wall_s": wall,
                         "kernel_ms": dev_ms,
                         "ns_per_cycle": dev_ms * 1e6 / res.cycles,
                         "modules": len(design.modules),
                         "edges": len(design.edges)}
        opts = dict(max_points=EXPLORE_POINTS, seed=0)
        card = explore_app("flow", ExploreOptions(**opts))
        launches = kernel.launches()
        if launches == 0:
            raise AssertionError("the cycle kernel was not launched on its "
                                 "path")
        host = explore_app("flow", ExploreOptions(**opts, engine="scalar",
                                                  device="cpu"))
        # a profiled window now and then records the copies but not the
        # kernel (seen once on FLOW's frame): that frame is profiled again,
        # after the count was read
        for app, row in apps.items():
            design = paper[app][1]
            while row["kernel_ms"] == 0:
                if row.setdefault("reprofiled", 0) == 3:
                    raise AssertionError(f"{app}: no cycle kernel in 4 "
                                         "profiled windows")
                _tot, names = device_events(
                    lambda: design.simulate(options=SimOptions()), 1,
                    warmup=0)
                row["kernel_ms"] = sum(v for n, v in names.items()
                                       if "cyclesim" in n)
                row["ns_per_cycle"] = row["kernel_ms"] * 1e6 / row["cycles"]
                row["reprofiled"] += 1
        # the path's whole frames against the scalar engine's
        for app, fut in w_paper.items():
            want, sc_s = fut.result()
            got_p = cc.summary(results[app])
            if cc.scalar_view(got_p) != cc.scalar_view(want):
                raise AssertionError(f"cycle kernel != scalar on {app} at "
                                     "the paper's size: "
                                     f"{cc.summary_err(got_p, want)}")
            apps[app].update(scalar_equal=True, scalar_s=sc_s,
                             scalar_us_per_cycle=sc_s * 1e6 / want["cycles"])
        # the other paper-size cuts against the plain version (every
        # SimResult field) and the scalar engine
        cut_rows = {}
        for app, (g, g_s, lay_c) in got_cuts.items():
            (want, p_s), (sc, s_s) = (w_cut[app, e].result()
                                      for e in ("vector", "scalar"))
            if g != want or cc.scalar_view(g) != cc.scalar_view(sc):
                raise AssertionError(
                    f"cycle kernel != plain or scalar on {app}'s first "
                    f"{PAPER_CUT_HORIZON} cycles at the paper's size: "
                    f"{cc.summary_err(g, want)}, {cc.summary_err(g, sc)}")
            cut_rows[app] = {"cycles": g["cycles"], "deadlock": g["deadlock"],
                             "skipped": g["cycles_skipped"],
                             "max_abs_err": cc.summary_err(g, want),
                             "kernel_s": g_s, "plain_s": p_s,
                             "scalar_s": s_s, **lay_c}

    def points(r):
        return [{k: v for k, v in p.as_dict().items()
                 if k != "cycles_skipped"} for p in r.points]

    if points(card) != points(host) or \
            card.hand.as_dict() != host.hand.as_dict():
        raise AssertionError("the explorer's points differ across engines")
    ing = simulate_ingest(512, 40.0, Fraction(1, 32), 16, seed=0)
    emit({"phase": "cycle", "check": "path", "simulate_paper": apps,
          f"paper_first_{PAPER_CUT_HORIZON}_cycles": cut_rows,
          "explore": {e: {"points": r.n_evaluated,
                          "eval_s": r.eval_seconds,
                          "wall_s": r.wall_seconds,
                          "points_per_s": r.points_per_sec,
                          "front": len(r.front.points),
                          "notes": r.notes}
                      for e, r in (("population_cuda", card),
                                   ("scalar_cpu", host))},
          "launches": launches,
          "ingest": {"hwm": ing.hwm, "capacity": ing.capacity,
                     "frames": ing.frames, "cycles": ing.cycles,
                     "rho": ing.utilization, "deadlock": ing.deadlock},
          "phase_s": time.perf_counter() - t_phase})
    return dict(line, launches=launches)


def _host_ms(fn, calls: int, warm: int = 2):
    import torch
    for _ in range(warm):
        fn()
    times = []
    for _ in range(calls):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), times


def _host_ops(torch, fn, top: int = 8):
    """One warm call of ``fn`` under torch.profiler (CPU activity): its
    host wall ms and its ``top`` operators by self CPU time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    ops = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    return {"wall_ms": wall, "ops": [
        {"op": e.key, "calls": e.count,
         "self_ms": e.self_cpu_time_total / 1e3,
         "total_ms": e.cpu_time_total / 1e3} for e in ops[:top]]}


def _aten_calls(torch, fn, op: str) -> int:
    """Calls of the operator ``op`` (``"aten::constant_pad_nd"``) in one
    call of ``fn`` under torch.profiler (CPU activity)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages() if e.key == op)


def path_phase(torch, np, paper):
    """Every app at the paper's sizes through the entry points a user
    calls, on the kernels backend: the launches of each app's kernel are
    read just before and just after its own calls."""
    from repro_torch.apps import KERNEL_OF
    from repro_torch.kernels import registry
    from repro_torch.kernels.megakernel.check import leaves

    rng = np.random.RandomState(1)
    runs = [(app,) + paper[app][:2] for app in ("convolution", "stereo")
            + MK_APPS]
    results = {}
    for app, uf, design in runs:
        entry = registry.get_kernel(KERNEL_OF[app])
        start = entry.launches()
        x = app_inputs(np, app, uf, rng, 5)
        frames = [{k: tuple(e[i] for e in v) if isinstance(v, tuple) else v[i]
                   for k, v in x.items()} for i in range(5)]
        batch = {k: tuple(e[1:] for e in v) if isinstance(v, tuple)
                 else v[1:] for k, v in x.items()}
        want = [golden(np, app, uf, f) for f in frames]

        def same(got, gold, what):
            got = leaves(got)
            if len(got) != len(gold) or any(
                    g.size != w.size or g.dtype != w.dtype
                    or not np.array_equal(g.reshape(w.shape), w)
                    for g, w in zip(got, gold)):
                raise AssertionError(f"{app}: {what} differs from the "
                                     f"golden model")

        one = design.run(frames[0], backend="kernels")
        if entry.launches() != start + 1:
            raise AssertionError(f"{app}: run launched {entry.name} "
                                 f"{entry.launches() - start} times")
        same(one, want[0], "run")
        many = design.run_batch(batch, backend="kernels")
        if entry.launches() != start + 2:
            raise AssertionError(f"{app}: run_batch launched {entry.name} "
                                 f"{entry.launches() - start - 1} times")
        for i in range(4):
            same([m[i] for m in leaves(many)], want[i + 1], f"run_batch[{i}]")
        run_ms, run_all = _host_ms(
            lambda: design.run(frames[0], backend="kernels"), 10)
        batch_ms, _ = _host_ms(
            lambda: design.run_batch(batch, backend="kernels"), 5)
        # the same batch with inputs already on the card and results kept
        # there: the device-side share of a run_batch call
        dev_batch = {k: tuple(torch.from_numpy(e).cuda() for e in v)
                     if isinstance(v, tuple) else torch.from_numpy(v).cuda()
                     for k, v in batch.items()}
        dev_ms, _ = _host_ms(
            lambda: design.run_batch_device(dev_batch, backend="kernels"), 5)
        dev_one = {k: tuple(e[:1] for e in v) if isinstance(v, tuple)
                   else v[:1] for k, v in dev_batch.items()}
        dev_one_ms, _ = _host_ms(
            lambda: design.run_batch_device(dev_one, backend="kernels"), 10)
        lp = design.lower("kernels")
        results[app] = {
            "shape": [uf.h, uf.w] + ([uf.nd] if app == "stereo" else []),
            "kernel": entry.name, "bit_exact": True,
            "run_ms": run_ms, "run_ms_all": run_all,
            "run_batch_frames": 4, "run_batch_ms": batch_ms,
            "run_batch_fps": 4e3 / batch_ms,
            "run_batch_device_ms": dev_ms,
            "run_device_ms": dev_one_ms,
            "megakernels": len(lp.megakernels),
            "plan": [ln.strip() for ln in lp.notes],
        }
        emit({"phase": "path", "app": app, **results[app]})
        emit({"phase": "profile", "app": app,
              "run": _host_ops(torch, lambda: design.run(
                  frames[0], backend="kernels")),
              "run_batch": _host_ops(torch, lambda: design.run_batch(
                  batch, backend="kernels"))})
        results[app]["launches"] = entry.launches() - start
    return results


def _check_against(what: str, got, want) -> dict:
    """Leaves of a card run against numpy leaves: as many, integers and
    booleans exact, float32 within FLOAT_ULP_BOUND ULPs; raises on a
    difference."""
    import numpy as np
    import torch
    from repro_torch.kernels.megakernel.check import check_leaves, leaves
    got = [torch.from_numpy(np.ascontiguousarray(g)) for g in leaves(got)]
    want = [torch.from_numpy(np.ascontiguousarray(w)) for w in leaves(want)]
    return check_leaves(what, got, want, exact=False)


def executor_case(torch, np, bench):
    """Each app at its bench_case size: run and run_batch (3 frames) on
    the card against the port's own executor (``backend="numpy"``)."""
    rng = np.random.RandomState(5)
    for app, (inputs_fn, design) in bench.items():
        one, many = inputs_fn(rng), inputs_fn(rng, frames=3)
        checks = [_check_against(f"{app} run", design.run(one),
                                 design.run(one, backend="numpy"))]
        checks.append(_check_against(
            f"{app} run_batch", design.run_batch(many),
            design.run_batch(many, backend="numpy")))
        first = one[next(iter(one))]
        first = first[0] if isinstance(first, tuple) else first
        emit({"phase": "path", "app": app, "case": "bench_vs_executor",
              "shape": list(first.shape),
              "max_abs_err": max(c["max_abs_err"] for c in checks),
              "max_ulp": max(c["max_ulp"] for c in checks)})


def external_case(torch, np, ext):
    """The External pipelines on the card.  ``clip`` at 1920x1080: run and
    run_batch (4 frames) on the kernels backend against the torch backend
    on the card, a megakernel on each side of the External and none
    holding it, the numpy model called once per frame in frame order,
    each segment against its plain version, its launches of the
    generated segments read just before and just after those two calls,
    the External's host ms beside each segment's device ms, and a
    profile of one run.  Every case at 37x13: run and run_batch (3
    frames) against the port's executor."""
    from repro_torch.core.lowering import lowerers
    from repro_torch.kernels import registry
    from repro_torch.kernels.megakernel.check import check_leaves, leaves
    from repro_torch.kernels.megakernel.ops import megakernel_segment
    from repro_torch.kernels.megakernel.ref import megakernel_ref
    from repro_torch.kernels.timing import device_ms

    k3 = registry.get_kernel("megakernel")
    rng = np.random.RandomState(6)
    line = {"phase": "path", "app": "external"}
    for label, (uf, design, log) in ext.items():
        key = f"{uf.name}.in"
        big = label.endswith("1920x1080")
        n = 4 if big else 3
        x = rng.randint(0, 256, (n + 1, uf.in_type.h, uf.in_type.w)
                        ).astype(np.int64)
        lp = design.lower("kernels")
        held = [m.name for m in lp.megakernels
                if any(nd.op == "External" for nd in m.nodes)]
        if held:
            raise AssertionError(f"{label}: External inside {held}")
        log.clear()
        start = k3.launches()
        one = design.run({key: x[0]})
        many = design.run_batch({key: x[1:]})
        k3_launches = k3.launches() - start
        calls = list(log)
        if len(calls) != 1 + n:
            raise AssertionError(f"{label}: the model ran {len(calls)} "
                                 f"times for {1 + n} frames")
        if big:
            if len(lp.megakernels) != 2:
                raise AssertionError(f"{label}: {len(lp.megakernels)} "
                                     f"megakernels, want 2: {lp.notes}")
            if k3_launches != 2 * 2:
                raise AssertionError(f"{label}: run and run_batch launched "
                                     f"{k3.name} {k3_launches} times, "
                                     f"want 4")
            log.clear()
            ref_one = design.run({key: x[0]}, backend="torch")
            ref_many = design.run_batch({key: x[1:]}, backend="torch")
            if log != calls:
                raise AssertionError(f"{label}: the model's calls differ "
                                     f"from the torch backend's")
            for what, a, b in (("run", one, ref_one),
                               ("run_batch", many, ref_many)):
                for i, (g, w) in enumerate(zip(leaves(a), leaves(b))):
                    if g.dtype != w.dtype or not np.array_equal(g, w):
                        raise AssertionError(f"{label} {what} leaf {i} "
                                             f"differs from torch")
            segs = {}
            for mk in lp.megakernels:
                seg_in = lp.segment_inputs(mk, {key: x[1:]})
                got = megakernel_segment(mk, *seg_in)
                torch.cuda.synchronize()
                chk = check_leaves(f"{label} {mk.name}", got,
                                   megakernel_ref(mk, *seg_in), exact=True)
                seg1 = lp.segment_inputs(mk, {key: x[:1]})
                segs[mk.name] = {"nodes": mk.n_nodes,
                                 "max_abs_err": chk["max_abs_err"],
                                 "ms": device_ms(lambda: megakernel_segment(
                                     mk, *seg1), 20)}
            host = []
            inner = lowerers.LOWERERS["External"]

            def timed(v, p, ins):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                r = inner(v, p, ins)
                torch.cuda.synchronize()
                host.append((time.perf_counter() - t0) * 1e3)
                return r

            lowerers.LOWERERS["External"] = timed
            try:
                for _ in range(7):
                    design.run({key: x[0]})
            finally:
                lowerers.LOWERERS["External"] = inner
            run_ms, _ = _host_ms(lambda: design.run({key: x[0]}), 5)
            line[label] = {"bit_exact_vs_torch": True, "model_calls": calls,
                           "k3_launches": k3_launches, "segments": segs,
                           "external_host_ms": statistics.median(host[2:]),
                           "external_host_ms_all": host, "run_ms": run_ms,
                           "run_profile": _host_ops(torch, lambda: design.run(
                               {key: x[0]}))}
        else:
            checks = [_check_against(f"{label} run", one,
                                     design.run({key: x[0]}, backend="numpy")),
                      _check_against(f"{label} run_batch", many,
                                     design.run_batch({key: x[1:]},
                                                      backend="numpy"))]
            line[label] = {"vs_executor_max_abs_err": max(
                c["max_abs_err"] for c in checks),
                "megakernels": len(lp.megakernels)}
    emit(line)
    return line


# ---- the verify phase: the static verifier, its oracle on the cycle kernel


VERIFY_PAPER_APPS = ("flow", "convolution")


def _verify_row(res, host_s: float, launches: int) -> dict:
    h = res.handshake
    return {"ok": res.ok, "verdict": h.verdict,
            "modeled_edges": sum(1 for e in h.edges if e.modeled),
            "edges": len(h.edges),
            "certified_edge_fraction": h.certified_edge_fraction,
            "wrap_free": res.ranges.wrap_free,
            "declared_fifo_bits": res.declared_fifo_bits,
            "narrowed_fifo_bits": res.narrowed_fifo_bits,
            "host_s": host_s, "cyclesim_launches": launches,
            "engine": res.cross.engine}


def verify_phase(torch, np, paper):
    """The static verifier (``HWDesign.verify``) on the card: each
    sim_case under fifo_solver "z3" and "sim", its oracle's cross-check on
    the cycle kernel held against the same check on the scalar engine
    (marks, bounds, violations), then FLOW and CONVOLUTION at the paper's
    size; every case must be ``ok`` and launch the kernel once."""
    from repro_torch import CompileOptions, compile_pipeline
    from repro_torch.analysis import cross_check
    from repro_torch.apps import SIM_CASES
    from repro_torch.kernels import registry

    kernel = registry.get_kernel("cyclesim")
    t_phase = time.perf_counter()
    rows = {}

    def run(label, design):
        n0 = kernel.launches()
        t0 = time.perf_counter()
        res = design.verify(backend="kernels")
        host_s = time.perf_counter() - t0
        n = kernel.launches() - n0
        if not res.ok or n != 1 or res.cross.engine != "vector":
            raise AssertionError(f"verify {label}: ok={res.ok}, {n} cycle "
                                 f"kernel launches, engine "
                                 f"{res.cross.engine}: "
                                 + "; ".join(res.report_lines()))
        rows[label] = _verify_row(res, host_s, n)
        return res

    for app in sorted(SIM_CASES):
        for solver in ("z3", "sim"):
            uf, T, _ = SIM_CASES[app]()
            design = compile_pipeline(uf, T=T, options=CompileOptions(
                fifo_solver=solver))
            res = run(f"{app}[{solver}]", design)
            host = cross_check(design, device="cpu")
            for key in ("hwm", "lower", "upper", "violations", "completed"):
                if getattr(res.cross, key) != getattr(host, key):
                    raise AssertionError(f"verify {app}[{solver}]: the "
                                         f"cross-check's {key} differs "
                                         "from the scalar engine's")
            rows[f"{app}[{solver}]"]["scalar_equal"] = True
    for app in VERIFY_PAPER_APPS:
        run(f"{app}[paper]", paper[app][1])
    line = {"phase": "verify", "cases": rows,
            "phase_s": time.perf_counter() - t_phase}
    emit(line)
    return line


# ---- the serve phase: the apps' frame server on the card


SERVE_FRAMES = 32                  # frames an app
SERVE_TIMEOUT_S = 300              # the longest any served frame may take
SERVE_PLAIN_FRAMES = 2             # frames a call of the plain lowering


def _rows(batch, rows):
    """The rows ``rows`` of a stacked batch's frame axis."""
    return {k: tuple(e[rows] for e in v) if isinstance(v, tuple) else v[rows]
            for k, v in batch.items()}


def _busy_ms(events) -> float:
    """The union of the device events' intervals, in ms."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, end = 0.0, None
    for s, t in spans:
        if end is None or s > end:
            busy += t - s
            end = t
        elif t > end:
            busy += t - end
            end = t
    return busy / 1e3


def serve_phase(torch, np, paper):
    """The five paper-size designs behind one ``FrameServer`` on the card
    (``backend="kernels"``, ``ServeConfig(max_batch=8)``, one warm frame
    each): 32 seeded frames an app, submitted interleaved across the three
    priorities, every future bounded and its completion time stamped; the
    launch counters set to 0 just before the traffic and read just after,
    and the window profiled.  Every served frame must equal ``run_batch``
    of the same frames on the same design, and every one must equal the
    plain lowering's (``backend="torch"``, 2 frames a call) within the
    kernels' tolerance (integers exact, f32 within
    FLOAT_ULP_BOUND ULPs); two an app the golden model too; and K1, K2
    and K3 must each launch in the window."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.apps import KERNEL_OF
    from repro_torch.kernels import registry
    from repro_torch.kernels.megakernel.check import leaves
    from repro_torch.serve import (FrameServer, Overloaded, ServeConfig,
                                   ServeTrace)

    apps = ("convolution", "stereo") + MK_APPS
    rng = np.random.RandomState(7)
    frames = {}
    for app in apps:
        x = app_inputs(np, app, paper[app][0], rng, SERVE_FRAMES)
        frames[app] = [{k: tuple(e[i] for e in v) if isinstance(v, tuple)
                        else v[i] for k, v in x.items()}
                       for i in range(SERVE_FRAMES)]
    cfg = ServeConfig(max_batch=8)
    srv = FrameServer(cfg)
    t0 = time.perf_counter()
    for app in apps:
        srv.register(paper[app][1], name=app, backend="kernels",
                     warm_inputs=[frames[app][0]])
    register_s = time.perf_counter() - t0
    sent, shed, done_at = [], {app: 0 for app in apps}, {}

    def stamp(key):
        return lambda fut: done_at.__setitem__(key, time.perf_counter())
    try:
        srv.start()
        registry.reset_launch_counts()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for i in range(SERVE_FRAMES):
                for j, app in enumerate(apps):
                    pri = ("high", "normal", "low")[(i + j) % 3]
                    try:
                        fut = srv.submit(frames[app][i], app=app,
                                         priority=pri)
                    except Overloaded:
                        shed[app] += 1
                        continue
                    fut.add_done_callback(stamp((app, i)))
                    sent.append((app, i, fut))
            outs = {}
            for app, i, fut in sent:
                outs[app, i] = fut.result(timeout=SERVE_TIMEOUT_S)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = {n: registry.get_kernel(n).launches()
                    for n in ("conv2d", "sad", "megakernel")}
        snap = srv.health.snapshot()
    finally:
        srv.close(timeout=SERVE_TIMEOUT_S)
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"serve: {name} was not launched")
    # the card's own events in the window; every app's segment kernel is
    # named mk<i>_kernel, so K3 is counted over the three apps together
    dev_events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
    kinds = {"conv2d": re.compile(r"conv2d_\w*kernel"),
             "sad": re.compile(r"sad_\w*kernel"),
             "megakernel": re.compile(r"\bmk\d+_kernel")}
    prof_launches = {k: sum(1 for e in dev_events if pat.search(e.name))
                     for k, pat in kinds.items()}
    busy_ms = copy_ms = None        # not read when the window is empty
    if not dev_events:
        prof_launches = None        # the profiler's known empty window
    elif any(v == 0 for v in prof_launches.values()):
        raise AssertionError(f"serve: the profiler saw {prof_launches}")
    else:
        busy_ms = _busy_ms(dev_events)
        copy_ms = _busy_ms([e for e in dev_events if "Memcpy" in e.name
                            or "Memset" in e.name])

    # every served frame against run_batch of the same frames (8 a call)
    # on the kernels and on the plain lowering, two an app against the
    # golden model
    per_app, plain = {}, {}
    for app in apps:
        uf, design, _ = paper[app]
        ids = sorted(i for a, i in outs if a == app)
        for k in range(0, len(ids), 8):
            chunk = ids[k:k + 8]
            batch = {key: tuple(np.stack([frames[app][i][key][e]
                                          for i in chunk])
                                for e in range(len(v)))
                     if isinstance(v, tuple) else
                     np.stack([frames[app][i][key] for i in chunk])
                     for key, v in frames[app][0].items()}
            want = leaves(design.run_batch(batch, backend="kernels"))
            for r, i in enumerate(chunk):
                got = leaves(outs[app, i])
                if len(got) != len(want) or any(
                        g.dtype != w.dtype or not np.array_equal(g, w[r])
                        for g, w in zip(got, want)):
                    raise AssertionError(f"serve {app}: frame {i} differs "
                                         "from run_batch")
            for q in range(0, len(chunk), SERVE_PLAIN_FRAMES):
                rows = slice(q, q + SERVE_PLAIN_FRAMES)
                sub = chunk[rows]
                chk = _check_against(
                    f"serve {app} frames {sub} vs torch",
                    tuple(np.stack([leaves(outs[app, i])[e] for i in sub])
                          for e in range(len(want))),
                    design.run_batch(_rows(batch, rows), backend="torch"))
                plain[app] = {k: max(plain.get(app, {}).get(k, 0), chk[k])
                              for k in ("max_abs_err", "max_ulp")}
        for i in ids[:2]:
            gold = golden(np, app, uf, frames[app][i])
            got = leaves(outs[app, i])
            if len(got) != len(gold) or any(
                    g.size != w.size or g.dtype != w.dtype
                    or not np.array_equal(g.reshape(w.shape), w)
                    for g, w in zip(got, gold)):
                raise AssertionError(f"serve {app}: frame {i} differs from "
                                     "the golden model")
        a = snap["apps"][app]
        occ = {int(k): v for k, v in a["batch_occupancy"].items()}
        padded = sum((min(1 << (n - 1).bit_length(), cfg.max_batch) - n) * c
                     for n, c in occ.items())
        fps = len(ids) / (max(done_at[app, i] for i in ids) - t0)
        trace = ServeTrace([e for e in srv.trace.events if e.app == app])
        ing = srv.replay_trace_ingest(service_fps=fps, trace=trace)
        per_app[app] = {
            "kernel": KERNEL_OF[app], "served": len(ids),
            "bit_exact_vs_run_batch": True, "vs_torch": plain[app],
            "golden_frames": len(ids[:2]),
            "frames_per_s": fps, "p50_ms": a["latency_p50_ms"],
            "p99_ms": a["latency_p99_ms"], "batches": a["batches"],
            "mean_batch": a["mean_batch"], "occupancy": occ,
            "shed": shed[app], "padded_frames": padded,
            "predicted_queue_hwm": ing.hwm, "predicted_rho": ing.utilization}
    st = srv.stats
    line = {"phase": "serve", "apps": per_app, "frames": len(outs),
            "shed": sum(shed.values()), "wall_s": wall,
            "frames_per_s": len(outs) / wall,
            "register_s": register_s, "warmup_s": st.warmup_s,
            "warmup_buckets": [st.warmup_done, st.warmup_total],
            "launches": launches, "profiler_launches": prof_launches,
            "device_busy_ms": busy_ms, "device_copy_ms": copy_ms,
            "device_busy_share": (None if busy_ms is None
                                  else busy_ms / (wall * 1e3)),
            "queue_hw": st.queue_hw, "inflight_hw": st.inflight_hw,
            "padded_frames": st.padded_frames,
            "predicted_queue_hwm": srv.replay_trace_ingest().hwm}
    emit(line)
    return line


def flash_case(torch, np, name, q, k, v, *, causal, window, decode, atol,
               scale=None, dims=None, lse=False, q_offset=0, rows=None,
               rel=None, min_kept=0.5):
    """K4 against its plain version on one case, then, for a case of
    K4_TIMED_CASES or with ``rows``, its time, the plain version's,
    scaled_dot_product_attention's and the bound.  ``dims`` =
    (Dk, Dv) are the real head dims of operands zero-padded to K4's D (MLA):
    the bound counts the unpadded work, 2 (Dk + Dv) flops a (q, k) pair,
    and the library call takes the unpadded operands.  ``lse``: the
    prefill with its row log-sum-exp (the training path's call), held to
    the plain version's within LSE_ATOL; the bound counts its bytes.
    ``q_offset``: query row i at key position i + q_offset (a
    context-parallel rank's rows).  Unpadded operands at Dv != Dk need no
    ``dims``: the head dims are q's and v's.  ``rows``: the row windows,
    [(lo, hi), ...], that a prefill too long for the plain version's whole
    score matrix (B x H x S^2 f32: 17 GB a sequence at S 32768) is held
    on, each against ``launch.cells.plain_rows`` on those rows alone; its
    plain ms is then over every row in windows of CELL_ROWS, and the
    library call takes k and v expanded to the query heads, the window as
    a band mask and no math backend (its S x S scores do not fit; null
    where no other backend takes the case; no graph ms).  Such a case's
    calls take 2 to 700 ms, one kernel each, and the profiler has dropped
    every record of them in three windows running (H100, K4's and SDPA's
    f32 calls at S 32768), so its ms and the library's are CUDA events
    around back-to-back calls (``ms_by``), which no host work bounds at
    that length, and its kernel is the form its counter saw.  ``rel``: each
    window, or the whole output, also held within ``rel`` of the plain
    version's largest magnitude there (``launch.cells.k4_limit``).
    ``min_kept``: ``device_events``' lost-record policy for K4's and the
    library's device ms."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash import flash_attention, flash_decode
    from repro_torch.kernels.flash.ops import (
        attention_pairs, decode_kernel, decode_split, form_launches,
        prefill_form)
    from repro_torch.kernels.timing import bound_ms, device_events, graph_ms
    from repro_torch.kernels.flash.ref import attention_ref
    from repro_torch.launch.cells import k4_limit, plain_rows

    t_case = time.perf_counter()
    form = "decode" if decode else prefill_form(q.dtype, q.shape[-1],
                                                v.shape[-1])
    if decode:
        run = lambda: flash_decode(q, k, v)                     # noqa: E731
        plain = plain_pair = lambda: attention_ref(             # noqa: E731
            q, k, v, causal=False)
    else:
        run = lambda: flash_attention(q, k, v, causal=causal,   # noqa: E731
                                      window=window, scale=scale,
                                      return_lse=lse, q_offset=q_offset)
        plain_pair = lambda: attention_ref(                     # noqa: E731
            q, k, v, causal=causal, window=window, scale=scale,
            return_lse=lse, q_offset=q_offset)
        plain = (lambda: plain_pair()[0]) if lse else plain_pair  # noqa: E731
    before = form_launches()
    got = run()
    torch.cuda.synchronize()
    lse_err = None
    if lse:
        got, got_lse = got
        lse_err = float((got_lse - plain_pair()[1]).abs().max())
        if not lse_err <= LSE_ATOL:
            raise AssertionError(f"flash_attention {name}: lse max abs err "
                                 f"{lse_err} above {LSE_ATOL}")
    after = form_launches()
    if any(after[f] - before[f] != (f == form) for f in after):
        raise AssertionError(f"flash_attention {name}: launched "
                             f"{ {f: after[f] - before[f] for f in after} }, "
                             f"want {form} once")
    errs, limits = [], []
    for lo, hi in rows or [(None, None)]:
        want = plain() if lo is None else plain_rows(
            q, k, v, lo, hi, causal=causal, window=window, scale=scale)
        errs.append(float((got[:, lo:hi].float() - want).abs().max()))
        limits.append(atol if rel is None else k4_limit(want, atol, rel))
        del want
    err = max(errs)
    if any(not e <= t for e, t in zip(errs, limits)):
        raise AssertionError(f"flash_attention {name}: max abs err {errs} "
                             f"above {limits} (rows {rows})")
    del got
    B, sq, H, D = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    dk, dv = dims or (D, v.shape[3])
    line = {"phase": "kernel", "name": "flash_attention", "case": name,
            "form": form,
            "shape": {"B": B, "Sq": sq, "Skv": skv, "H": H, "Hkv": hkv,
                      "D": D, "causal": causal and not decode,
                      "window": None if decode else window},
            "dtype": str(q.dtype).split(".")[-1], "max_abs_err": err,
            "tolerance": atol}
    if rows:
        line["rows_held"] = rows
    if rel is not None:
        line.update(rel=rel, limits=limits, errs=errs)
    if dims or dv != D:
        line["shape"].update({"Dk": dk, "Dv": dv, "scale": scale,
                              "zero_padded_to": D if dims else None})
    if q_offset:
        line["shape"]["q_offset"] = q_offset
    if lse:
        line.update({"lse": True, "lse_max_abs_err": lse_err,
                     "lse_tolerance": LSE_ATOL})
    if decode:
        kc, nsplit = decode_split(skv, B * hkv)
        kernel = decode_kernel(q.dtype, H // hkv, nsplit)
        line["split"] = {"kc": kc, "nsplit": nsplit, "kernel": kernel}

    def kernels_seen(iters, whole_calls=True):
        """The device ms and K4's kernels the profiler saw over ``iters``
        calls: a decode case must run the kernels decode_kernel names, the
        mma or the cluster kernel alone up to 8 splits, the split and
        merge kernels past a cluster."""
        ms, by_name = device_events(run, iters, whole_calls=whole_calls,
                                    min_kept=min_kept)
        seen = sorted(f for f in map(kernel_form, by_name) if f)
        if decode:
            want = (["decode_merge", "decode_split"]
                    if kernel == "decode_split" else [kernel])
            if seen != sorted(want):
                raise AssertionError(f"flash_attention {name}: the profiler "
                                     f"saw {seen}, want {sorted(want)}")
        return ms, seen

    if name not in K4_TIMED_CASES and not rows:
        if decode:
            # names only: a short window can lose a kernel's records
            line["kernels"] = kernels_seen(20, whole_calls=False)[1]
        line["s"] = time.perf_counter() - t_case
        return line
    one = cuda_ms(run, 1, warmup=1)
    iters = max(3, min(200, int(200 / max(one, 1e-3))))
    reps = max(2, min(20, int(40 / max(one, 1e-3))))
    pairs = B * H * (skv if decode else attention_pairs(
        sq, skv, causal, window, q_offset))
    elem = q.element_size()
    nbytes = elem * (B * sq * H * (dk + dv) + B * skv * hkv * (dk + dv))
    if lse:
        nbytes += 4 * B * H * sq
    flops = 2 * (dk + dv) * pairs
    bound, bound_by, t_bytes, t_ops = bound_ms(nbytes, flops, q.dtype)

    def plain_all():
        for r0 in range(0, sq, CELL_ROWS):
            plain_rows(q, k, v, r0, min(sq, r0 + CELL_ROWS), causal=causal,
                       window=window)

    # ms: the kernel's device time (the profiler's events); graph_ms: CUDA
    # events around replays of a CUDA graph of back-to-back calls (every
    # kernel of a call, the gaps between them, no host work); call_ms: CUDA
    # events around back-to-back wrapper calls, which the wrapper's host
    # work bounds when the kernel is short; the same three for the
    # library.  A kernel's ms is the mean of its recorded events times its
    # launches a call (the profiler can lose records)
    if rows:
        call_ms = cuda_ms(run, iters)
        line.update(ms=call_ms, ms_by="cuda events", kernels=[form],
                    call_ms=call_ms)
    else:
        ms, kernels = kernels_seen(iters)
        line.update(ms=ms, kernels=kernels, call_ms=cuda_ms(run, iters))
    line["graph_ms"] = graph_ms(run, calls=reps, replays=max(3, reps // 2))
    if rows:
        # a window's scores take up to 17 GB in one block
        torch.cuda.empty_cache()
        line.update(plain_ms=cuda_ms(plain_all, 1, warmup=0),
                    plain_over=f"every row, in windows of {CELL_ROWS}")
    else:
        line["plain_ms"] = cuda_ms(plain_pair, 5, warmup=1)
    # the library yardstick: one call of scaled_dot_product_attention on
    # (B, H, S, D) operands made outside the timing (at the real head
    # dims), GQA by enable_gqa (with rows: k and v expanded to the query
    # heads), the window as a boolean band mask
    mask = None
    if (window or q_offset) and not decode:
        i = q_offset + torch.arange(sq, device=q.device)[:, None]
        j = torch.arange(skv, device=q.device)[None]
        mask = (j <= i) & (j > i - window) if window else j <= i
    is_causal = causal and not decode and mask is None
    if rows:
        from torch.nn.attention import SDPBackend, sdpa_kernel
        qt = q.transpose(1, 2)
        kt, vt = (t.repeat_interleave(H // hkv, dim=2).transpose(1, 2)
                  for t in (k, v))

        def library():
            with sdpa_kernel([SDPBackend.FLASH_ATTENTION,
                              SDPBackend.EFFICIENT_ATTENTION,
                              SDPBackend.CUDNN_ATTENTION]):
                return F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mask, is_causal=is_causal)
    else:
        qt, kt, vt = (t[..., :d].transpose(1, 2).contiguous()
                      for t, d in ((q, dk), (k, dk), (v, dv)))

        def library():
            return F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, is_causal=is_causal,
                scale=scale, enable_gqa=True)

    lo = rows[-1][0] if rows else None
    try:
        lib_out = library().transpose(1, 2)[:, lo:]
    except RuntimeError as e:           # rows: no backend but the math one
        if not rows:
            raise
        lib_out, line["library_error"] = None, str(e).splitlines()[0][:200]
    if lib_out is not None:
        line["library_max_abs_err"] = float((lib_out.float() - (
            plain()[..., :dv] if lo is None else plain_rows(
                q, k, v, lo, sq, causal=causal, window=window))).abs().max())
    del lib_out
    if "library_error" in line:
        line.update(library_ms=None, library_graph_ms=None)
    elif rows:
        line.update(library_ms=cuda_ms(library, 2, warmup=1),
                    library_graph_ms=None)
    else:
        line.update({
            "library_ms": device_events(library, iters, warmup=1,
                                        whole_calls=True,
                                        min_kept=min_kept)[0],
            "library_graph_ms": graph_ms(library, calls=reps,
                                         replays=max(3, reps // 2)),
            "library_call_ms": cuda_ms(library, iters)})
    line.update({
        "bound_ms": bound, "bound_by": bound_by,
        "bound_bytes_ms": t_bytes, "bound_ops_ms": t_ops, "bytes": nbytes,
        "flops": flops, "pairs": pairs})
    line["share_of_bound"] = line["bound_ms"] / line["ms"]
    del qt, kt, vt, mask
    torch.cuda.empty_cache()
    line["s"] = time.perf_counter() - t_case
    return line


def flash_phase(torch, np):
    """K4 on every case; returns each form's line at its main path's
    shapes (a bf16 and an f32 local layer, window 512, and decode over
    1024 keys); every line is printed."""
    dev = torch.device("cuda")
    rng = np.random.RandomState(4)

    def randn(shape, dtype):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(
            dev).to(dtype)

    from repro_torch.configs import ARCHS
    cfg = ARCHS[LLM_ARCH]
    bf16, f32 = torch.bfloat16, torch.float32
    B, S, W = LLM_BATCH, LLM_PROMPT, cfg.sliding_window
    H, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = randn((B, S, H, D), bf16)
    k = randn((B, S, Hkv, D), bf16)
    v = randn((B, S, Hkv, D), bf16)
    lines = {}
    for name, window in (("main_local", W), ("main_global", None)):
        lines[name] = flash_case(torch, np, name, q, k, v, causal=True,
                                 window=window, decode=False, atol=3e-2)
    # decode: the prompt's keys, and a local layer's window span of the
    # serving cache at decode position S - 24 (a strided view of the
    # cache, as models.layers.decode_attention passes it)
    q1 = randn((B, 1, H, D), bf16)
    lines["decode_full"] = flash_case(
        torch, np, "decode_full", q1, k, v, causal=False, window=None,
        decode=True, atol=3e-2)
    kc = randn((B, S + LLM_GEN, Hkv, D), bf16)
    vc = randn((B, S + LLM_GEN, Hkv, D), bf16)
    span = slice(S - 24 - W + 1, S - 24 + 1)
    lines["decode_window_span"] = flash_case(
        torch, np, "decode_window_span", q1, kc[:, span], vc[:, span],
        causal=False, window=None, decode=True, atol=3e-2)
    # a short span (a few splits of 16 keys), and MHA (g 1) in f32 at the
    # model's head dim over the prompt's keys
    lines["decode_short"] = flash_case(
        torch, np, "decode_short", q1, k[:, :64], v[:, :64], causal=False,
        window=None, decode=True, atol=3e-2)
    lines["decode_g1_f32"] = flash_case(
        torch, np, "decode_g1_f32", randn((B, 1, H, D), f32),
        randn((B, S, H, D), f32), randn((B, S, H, D), f32), causal=False,
        window=None, decode=True, atol=2e-5)
    # tests/test_kernels.py:43-48 coverage classes and its decode case
    # (:60), at its tolerances; a ragged Skv no tile divides
    for name, (b, s, h, hkv, d, window, dtype, atol) in {
            "gqa_f32": (2, 48, 4, 2, 128, None, f32, 2e-5),
            "window_bf16": (2, 48, 4, 4, 128, 13, bf16, 3e-2),
            "mha_d256_f32": (1, 64, 8, 2, 256, None, f32, 2e-5),
            "ragged_bf16": (1, 40, 4, 1, 128, None, bf16, 3e-2)}.items():
        lines[name] = flash_case(
            torch, np, name, randn((b, s, h, d), dtype),
            randn((b, s, hkv, d), dtype), randn((b, s, hkv, d), dtype),
            causal=True, window=window, decode=False, atol=atol)
    lines["decode_f32"] = flash_case(
        torch, np, "decode_f32", randn((2, 1, 8, 128), f32),
        randn((2, 64, 2, 128), f32), randn((2, 64, 2, 128), f32),
        causal=False, window=None, decode=True, atol=2e-5)
    lines["ragged_skv"] = flash_case(
        torch, np, "ragged_skv", randn((2, 77, 4, 128), f32),
        randn((2, 1001, 2, 128), f32), randn((2, 1001, 2, 128), f32),
        causal=False, window=None, decode=False, atol=2e-5)
    lines["ragged_skv_decode"] = flash_case(
        torch, np, "ragged_skv_decode", randn((2, 1, 4, 128), f32),
        randn((2, 1001, 2, 128), f32), randn((2, 1001, 2, 128), f32),
        causal=False, window=None, decode=True, atol=2e-5)
    # the SIMT form at the llm phase's f32 check: a local and a global
    # layer, batch 2
    q32, k32, v32 = q[:2].float(), k[:2].float(), v[:2].float()
    lines["main_local_f32"] = flash_case(
        torch, np, "main_local_f32", q32, k32, v32, causal=True, window=W,
        decode=False, atol=2e-5)
    lines["main_global_f32"] = flash_case(
        torch, np, "main_global_f32", q32, k32, v32, causal=True,
        window=None, decode=False, atol=2e-5)
    del q32, k32, v32
    # the SIMT form's edges: D 256 at a ragged Sq and window, GQA with g 4
    # at a ragged Sq, head views of one wider f32 tensor (16-byte rows),
    # and a view whose rows are not 16-byte aligned (4-byte copies)
    for name, (b, sq, h, hkv, d, window) in {
            "ragged_window_d256_f32": (1, 200, 4, 1, 256, 70),
            "gqa4_ragged_d256_f32": (2, 130, 8, 2, 256, None)}.items():
        lines[name] = flash_case(
            torch, np, name, randn((b, sq, h, d), f32),
            randn((b, sq, hkv, d), f32), randn((b, sq, hkv, d), f32),
            causal=True, window=window, decode=False, atol=2e-5)
    qkv32 = randn((2, 150, 8 + 2 * 2, 128), f32)
    lines["gqa_head_views_f32"] = flash_case(
        torch, np, "gqa_head_views_f32", qkv32[:, :, :8], qkv32[:, :, 8:10],
        qkv32[:, :, 10:], causal=True, window=40, decode=False, atol=2e-5)
    wide = randn((2, 96, 4 * 64 + 1), f32)[:, :, 1:].unflatten(2, (4, 64))
    lines["misaligned_view_f32"] = flash_case(
        torch, np, "misaligned_view_f32", wide, wide[:, :, :2],
        wide[:, :, 2:], causal=True, window=None, decode=False, atol=2e-5)
    # the tensor-core form's edges: D 64 and 256 at a ragged Sq and
    # window, a non-causal ragged Skv, rows 25.. of Sq 40 with no key of
    # Skv 20 in their band (window 6), and GQA with q, k, v as head views
    # of one wider (B, S, H + 2 Hkv, D) tensor
    for name, (b, sq, skv, h, hkv, d, causal, window) in {
            "ragged_window_d64_bf16": (1, 200, 200, 4, 1, 64, True, 70),
            "ragged_window_d256_bf16": (1, 200, 200, 4, 1, 256, True, 70),
            "ragged_skv_bf16": (2, 77, 1001, 4, 2, 128, False, None),
            "empty_band_bf16": (2, 40, 20, 4, 2, 64, True, 6)}.items():
        lines[name] = flash_case(
            torch, np, name, randn((b, sq, h, d), bf16),
            randn((b, skv, hkv, d), bf16), randn((b, skv, hkv, d), bf16),
            causal=causal, window=window, decode=False, atol=3e-2)
    qkv = randn((2, 150, 8 + 2 * 2, 128), bf16)
    lines["gqa_head_views_bf16"] = flash_case(
        torch, np, "gqa_head_views_bf16", qkv[:, :, :8], qkv[:, :, 8:10],
        qkv[:, :, 10:], causal=True, window=40, decode=False, atol=3e-2)
    del qkv
    # the families phase's shapes: granite's GQA (D 64, 24 query heads on
    # 8 kv heads, g 3), in bf16 at the serving prefill's 4 x 1024 and in
    # f32 at the f32 check's 2 x 64, and its last 256 rows at offset 768
    # with the lse (grouped heads at an offset); deepseek's MLA prefill as
    # models.layers.mla_block hands it over (q, k at 192 and v at 128, the
    # scale 1/sqrt(192), 128 heads), in bf16 at 4 x 1024 and in f32 at the
    # f32 check's 2 x 64, and in bf16 once more zero-padded to 256, the
    # form it took before K4 took Dv != Dk (its time, for the record)
    g = ARCHS["granite-moe-3b-a800m"]
    for name, (b, s, dtype, atol) in {
            "granite_prefill_bf16": (FAM_BATCH, FAM_PREFILL, bf16, 3e-2),
            "granite_prefill_f32": (2, FAM_F32_PROMPT, f32, 2e-5)}.items():
        lines[name] = flash_case(
            torch, np, name, randn((b, s, g.n_heads, g.hd), dtype),
            randn((b, s, g.n_kv_heads, g.hd), dtype),
            randn((b, s, g.n_kv_heads, g.hd), dtype), causal=True,
            window=None, decode=False, atol=atol)
    lines["granite_offset_lse_bf16"] = flash_case(
        torch, np, "granite_offset_lse_bf16",
        randn((FAM_BATCH, FAM_PREFILL // 4, g.n_heads, g.hd), bf16),
        randn((FAM_BATCH, FAM_PREFILL, g.n_kv_heads, g.hd), bf16),
        randn((FAM_BATCH, FAM_PREFILL, g.n_kv_heads, g.hd), bf16),
        causal=True, window=None, decode=False, atol=3e-2, lse=True,
        q_offset=FAM_PREFILL * 3 // 4)
    # granite's decode as models.layers.decode_attention hands it over:
    # serving's last step over the whole 4 x 160-slot cache and a step
    # over the first 100 slots (a strided view) in bf16, and the f32
    # decode loop's last step over 2 x 64 keys
    kc = randn((FAM_BATCH, FAM_CASE_KEYS, g.n_kv_heads, g.hd), bf16)
    vc = randn((FAM_BATCH, FAM_CASE_KEYS, g.n_kv_heads, g.hd), bf16)
    q1 = randn((FAM_BATCH, 1, g.n_heads, g.hd), bf16)
    lines["granite_decode_bf16"] = flash_case(
        torch, np, "granite_decode_bf16", q1, kc, vc, causal=False,
        window=None, decode=True, atol=3e-2)
    lines["granite_decode_span_bf16"] = flash_case(
        torch, np, "granite_decode_span_bf16", q1, kc[:, :100], vc[:, :100],
        causal=False, window=None, decode=True, atol=3e-2)
    lines["granite_decode_f32"] = flash_case(
        torch, np, "granite_decode_f32", randn((2, 1, g.n_heads, g.hd), f32),
        randn((2, FAM_F32_PROMPT, g.n_kv_heads, g.hd), f32),
        randn((2, FAM_F32_PROMPT, g.n_kv_heads, g.hd), f32), causal=False,
        window=None, decode=True, atol=2e-5)
    del kc, vc, q1
    # the served dense archs' shapes as their paths hand them over
    # (SERVED_K4; jamba's attention layer is qwen2-72b's): the bf16
    # prefill at serving's 4 x 1024 and the f32 one at the f32 check's
    # 2 x 64, causal; decode at B 4 over serving's last 160 keys:
    # gemma-2b's MQA (g 8 at D 256, Hkv 1), musicgen's MHA (g 1 at D 64,
    # Hkv 24), qwen2-vl's g 7 at D 128 and Hkv 4 (one group of 8, a slot
    # idle), qwen2-72b's g 8 at Hkv 8 and command-r-plus's g 12 (two head
    # groups of 6); and gemma-2b's decode over 1024 keys (the merge kernel);
    # command-r-plus's and gemma-2b's over a 100-slot view of serving's
    # cache (the mma kernel at 5 and 6 splits), held but not timed
    for key, arch in SERVED_K4.items():
        c = ARCHS[arch]
        H, Hkv, D = c.n_heads, c.n_kv_heads, c.hd
        for name, (b, s, dtype, atol) in {
                f"{key}_prefill_bf16": (FAM_BATCH, FAM_PREFILL, bf16, 3e-2),
                f"{key}_prefill_f32": (2, FAM_F32_PROMPT, f32, 2e-5)}.items():
            lines[name] = flash_case(
                torch, np, name, randn((b, s, H, D), dtype),
                randn((b, s, Hkv, D), dtype), randn((b, s, Hkv, D), dtype),
                causal=True, window=None, decode=False, atol=atol)
        decodes = {f"{key}_decode_bf16": FAM_CASE_KEYS}
        if key == "gemma_2b":
            decodes["gemma_2b_decode_1024_bf16"] = LLM_PROMPT
        q1 = randn((FAM_BATCH, 1, H, D), bf16)
        for name, keys in decodes.items():
            lines[name] = flash_case(
                torch, np, name, q1, randn((FAM_BATCH, keys, Hkv, D), bf16),
                randn((FAM_BATCH, keys, Hkv, D), bf16), causal=False,
                window=None, decode=True, atol=3e-2)
        if key in ("command_r_plus", "gemma_2b"):
            kc = randn((FAM_BATCH, FAM_CASE_KEYS, Hkv, D), bf16)
            vc = randn((FAM_BATCH, FAM_CASE_KEYS, Hkv, D), bf16)
            lines[f"{key}_decode_span_bf16"] = flash_case(
                torch, np, f"{key}_decode_span_bf16", q1, kc[:, :100],
                vc[:, :100], causal=False, window=None, decode=True,
                atol=3e-2)
            del kc, vc
    m = ARCHS["deepseek-v2-236b"]
    dk, dv = m.qk_nope_dim + m.qk_rope_dim, m.v_head_dim
    for name, (b, s, dtype, atol) in {
            "mla_prefill_bf16": (FAM_BATCH, FAM_PREFILL, bf16, 3e-2),
            "mla_prefill_f32": (2, FAM_F32_PROMPT, f32, 2e-5)}.items():
        q, k, v = (randn((b, s, m.n_heads, d), dtype) for d in (dk, dk, dv))
        lines[name] = flash_case(
            torch, np, name, q, k, v, causal=True, window=None,
            decode=False, atol=atol, scale=dk ** -0.5)
        if name == "mla_prefill_bf16":
            padded = [torch.nn.functional.pad(t, (0, MLA_PADDED - d))
                      for t, d in ((q, dk), (k, dk), (v, dv))]
            lines["mla_prefill_padded_bf16"] = flash_case(
                torch, np, "mla_prefill_padded_bf16", *padded, causal=True,
                window=None, decode=False, atol=atol, scale=dk ** -0.5,
                dims=(dk, dv))
            del padded
        del q, k, v
    # MLA's rows on a context-parallel rank (models.layers._mla_attend
    # through _on_mesh): the last quarter of serving's 4 x 1024 at its
    # offset against every key, with the lse
    q, k, v = (randn((FAM_BATCH, s, m.n_heads, d), bf16)
               for s, d in ((FAM_PREFILL // 4, dk), (FAM_PREFILL, dk),
                            (FAM_PREFILL, dv)))
    lines["mla_offset_lse_bf16"] = flash_case(
        torch, np, "mla_offset_lse_bf16", q, k, v, causal=True, window=None,
        decode=False, atol=3e-2, scale=dk ** -0.5, lse=True,
        q_offset=FAM_PREFILL * 3 // 4)
    del q, k, v
    # a context-parallel rank's rows (models.layers._on_mesh): the last
    # quarter of a 1024-token sequence against the keys before it, with
    # the lse, and rows at an offset under a window
    for name, (b, sq, skv, h, hkv, d, off, window, dtype, atol) in {
            "offset_rows_bf16": (2, 256, 1024, 4, 1, 256, 768, None, bf16,
                                 3e-2),
            "offset_window_f32": (1, 200, 400, 8, 2, 64, 200, 70, f32,
                                  2e-5)}.items():
        lines[name] = flash_case(
            torch, np, name, randn((b, sq, h, d), dtype),
            randn((b, skv, hkv, d), dtype), randn((b, skv, hkv, d), dtype),
            causal=True, window=window, decode=False, atol=atol,
            lse=dtype == bf16, q_offset=off)
    torch.cuda.empty_cache()
    for line in lines.values():
        emit(line)
    # each path's cases by "<form>:<key>", the bf16 prefill's form as the
    # case launched it (the wgmma form, MLA's (192, 128) included)
    return {lines["main_local"]["form"]: lines["main_local"],
            "prefill_simt": lines["main_local_f32"],
            "decode": lines["decode_full"],
            **{f"{lines[f'{key}_prefill_bf16']['form']}:{key}":
               lines[f"{key}_prefill_bf16"]
               for key in ("granite", "mla", *SERVED_K4)},
            **{f"{form}:{key}": lines[f"{key}_{case}"]
               for key in ("granite", "mla", *SERVED_K4)
               for form, case in (("prefill_simt", "prefill_f32"),
                                  ("decode", "decode_bf16"))
               if f"{key}_{case}" in lines}}


def _sync_ms(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def prefill_device(torch, call, wall_ms: float) -> dict:
    """Where a bf16 prefill_fn call's device time goes: one call under the
    profiler, its device time against the unprofiled call's wall, K4's
    tensor-core kernels' share and the top kernels; the SM clock over
    calls back to back (to set beside K4's case alone, whose line reads
    it too)."""
    from repro_torch.kernels.timing import device_events
    with torch.no_grad():
        dev_ms, by_name = device_events(call, 1, warmup=1)
        clock = sm_clock_mhz(torch, call)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])
    return {"device_ms": dev_ms, "device_busy_share": dev_ms / wall_ms,
            "k4_device_ms": sum(ms for name, ms in by_name.items()
                                if kernel_form(name) in K4_BF16_FORMS),
            "sm_clock_mhz": clock,
            "top": [{"name": name[:80], "ms": ms} for name, ms in top[:8]]}


def decode_step_profile(torch, cfg, params, step_in, index: int,
                        kernel: str, layers: int) -> dict:
    """Where a decode step's time goes: one warm step on ``step_in`` (a
    decode_fn batch at position ``index``), then 3 steps at ``index``
    under the profiler (CPU and CUDA activity): the wall and device ms a
    step, K4's decode kernels' share and calls a step, the host's aten
    operators a step and the top device kernels.  A step's ``layers``
    K4 decodes must run exactly the kernels ``kernel`` (a
    ``flash.ops.decode_kernel`` name) stands for, and the merge kernel
    once a layer where that is the split kernel, else never."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import build_forward
    from repro_torch.models.model import zero_cache
    _, _, decode_fn = build_forward(cfg)
    cache = zero_cache(cfg, step_in["tokens"].shape[0], index + 8, "cuda")
    with torch.no_grad():
        decode_fn(params, cache, step_in, index=index)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(3):
                decode_fn(params, cache, step_in, index=index)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / 3
    # the card's own events (kernels, copies), not the host operators
    # that launched them
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.self_device_time_total > 0]
    events.sort(key=lambda e: -e.self_device_time_total)
    device_ms = sum(e.self_device_time_total for e in events) / 1e3 / 3
    k4_ms = sum(e.self_device_time_total for e in events
                if "flash_decode" in e.key) / 1e3 / 3
    k4_calls = {f: sum(e.count for e in events if kernel_form(e.key) == f)
                / 3 for f in ("decode_mma", "decode_cluster", "decode_split",
                              "decode_merge")}
    split = kernel == "decode_split"
    want = (set() if layers == 0 else {"decode_split", "decode_merge"}
            if split else {kernel})
    if {f for f, n in k4_calls.items() if n} != want or \
            k4_calls["decode_merge"] != (layers if split else 0):
        raise AssertionError(f"a decode step ran K4's kernels {k4_calls} "
                             f"times, want {sorted(want)} over {layers} "
                             f"layers")
    host_ops = sum(e.count for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CPU
                   and e.key.startswith("aten::")) / 3
    return {"wall_ms": wall, "device_ms": device_ms, "k4_device_ms": k4_ms,
            "k4_calls_per_step": k4_calls,
            "device_busy_share": device_ms / wall,
            "aten_ops_per_step": host_ops,
            "top": [{"name": e.key[:80], "calls_per_step": e.count / 3,
                     "ms_per_step": e.self_device_time_total / 1e3 / 3}
                    for e in events[:8]]}


def llm_phase(torch, np):
    """gemma3-1b at full width and depth: the f32 checks, then the bf16
    serving path with the launch counters reset just before it.  Returns
    the phase's line and K4's launches per form on the serving path."""
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import registry
    from repro_torch.kernels.flash.ops import form_launches
    from repro_torch.launch.serve import make_prompt, serve
    from repro_torch.models import build_forward
    from repro_torch.models.convert import cast_params
    from repro_torch.models.model import tree_map, zero_cache

    torch.backends.cuda.matmul.allow_tf32 = False   # f32 stays f32
    k4 = registry.get_kernel("flash_attention")
    cfg = ARCHS[LLM_ARCH]
    cfg32 = cfg.replace(dtype="float32")
    t0 = time.perf_counter()
    # drawn on the card: init_params's numpy draws took about 35 s of the
    # script's time limit (the CPU tests hold init_params to the
    # reference's, and the card tests run it on the card)
    params = card_params(torch, cfg32, 0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    line = {"phase": "llm", "arch": cfg.name, "n_layers": cfg.n_layers,
            "d_model": cfg.d_model, "heads": [cfg.n_heads, cfg.n_kv_heads],
            "head_dim": cfg.hd, "d_ff": cfg.d_ff, "vocab": cfg.vocab,
            "params": cfg.param_count(), "init_s": init_s}
    prompt = make_prompt(cfg, LLM_BATCH, LLM_PROMPT)
    toks = torch.from_numpy(prompt.tokens).cuda()

    def forms_were(what, **want):
        got = form_launches()
        if got != {f: want.get(f, 0) for f in got}:
            raise AssertionError(f"{what} launched K4's forms {got}, want "
                                 f"{want}")
        return got

    # f32: prefill_fn over the prompt, the SIMT form's path (26 launches,
    # the counters reset just before); then decode_fn over its first
    # LLM_F32_PROMPT tokens against prefill_fn over those (the
    # reference's tolerance, tests/test_models.py:83), 26 launches per
    # call and step
    _, prefill_fn, decode_fn = build_forward(cfg32)
    b32 = toks[:2]
    P = LLM_F32_PROMPT
    with torch.no_grad():
        registry.reset_launch_counts()
        prefill_fn(params, {"tokens": b32})
        n_simt = forms_were("f32 prefill_fn",
                            prefill_simt=cfg.n_layers)["prefill_simt"]
        if k4.launches() != cfg.n_layers:
            raise AssertionError(f"f32 prefill_fn launched K4 "
                                 f"{k4.launches()} times")
        registry.reset_launch_counts()
        full = prefill_fn(params, {"tokens": b32[:, :P]})
        cache = zero_cache(cfg32, 2, P, "cuda")
        for i in range(P):
            step, cache = decode_fn(params, cache, {
                "tokens": b32[:, i:i + 1],
                "positions": torch.full((2, 1), i, device="cuda")}, index=i)
        torch.cuda.synchronize()
    forms_were("f32 prefill_fn and decode loop", prefill_simt=cfg.n_layers,
               decode=cfg.n_layers * P)
    a, b = full.float(), step.float()
    err = float((a - b).abs().max())
    if not torch.allclose(b, a, atol=2e-3, rtol=1e-3):
        raise AssertionError(f"f32 decode against prefill: max abs diff "
                             f"{err}")
    line["f32_decode_vs_prefill"] = {"batch": 2, "prompt": P,
                                     "max_abs_diff": err,
                                     "max_abs_logit": float(a.abs().max()),
                                     "atol": 2e-3, "rtol": 1e-3}
    del cache

    # the model cut to 2 layers (its first two, both local), prefill on
    # the card (K4) and on the CPU (the plain version), same tokens
    cfg2 = cfg32.replace(n_layers=2)
    p2 = {"embed": params["embed"], "norm_f": params["norm_f"],
          "tail_slots": [tree_map(lambda t: t[0], params["period_slots"][s])
                         for s in range(2)]}
    pf2 = build_forward(cfg2)[1]
    with torch.no_grad():
        card = pf2(p2, {"tokens": b32}).float().cpu()
        cpu = pf2(tree_map(lambda t: t.cpu(), p2),
                  {"tokens": b32.cpu()}).float()
    err2 = float((card - cpu).abs().max())
    if not torch.allclose(card, cpu, atol=1e-4, rtol=1e-4):
        raise AssertionError(f"2-layer card against CPU: max abs diff {err2}")
    line["f32_2layer_card_vs_cpu"] = {"batch": 2, "prompt": LLM_PROMPT,
                                      "max_abs_diff": err2,
                                      "atol": 1e-4, "rtol": 1e-4}
    del p2, card, cpu

    # bf16 serving: the weights cast, the counters reset just before
    params = cast_params(params, cfg)
    torch.cuda.empty_cache()
    prefill_fn = build_forward(cfg)[1]
    with torch.no_grad():
        prefill_fn(params, {"tokens": toks})            # warm
        registry.reset_launch_counts()
        logits, prefill_ms = _sync_ms(
            torch, lambda: prefill_fn(params, {"tokens": toks}))
        n_prefill = k4.launches()
        form = bf16_prefill_form(cfg)
        forms_were("bf16 prefill_fn", **{form: cfg.n_layers})
        res = serve(cfg, params, prompt, LLM_GEN, "cuda")
        n_decode = k4.launches() - n_prefill
        forms_were("bf16 prefill_fn and serve", **{form: cfg.n_layers},
                   decode=n_decode)
    if n_prefill != cfg.n_layers:
        raise AssertionError(f"bf16 prefill_fn launched K4 {n_prefill} "
                             f"times, want {cfg.n_layers}")
    if n_decode != cfg.n_layers * res.steps:
        raise AssertionError(f"serve launched K4 {n_decode} times over "
                             f"{res.steps} steps")
    if res.tokens.shape != (LLM_BATCH, LLM_GEN + 1) or not bool(
            torch.isfinite(res.logits.float()).all()) or not bool(
            torch.isfinite(logits.float()).all()):
        raise AssertionError("serve: bad shapes or non-finite logits")
    # the serving path's logits after the prompt (1024 decode steps)
    # against prefill_fn's: bf16 activations round differently along the
    # two paths; 2e-2 is about ten bf16 ulps at the logits' 0.3
    bf16_err = float((res.prompt_logits.float()
                      - logits[:, -1].float()).abs().max())
    if not bf16_err <= 2e-2:
        raise AssertionError(f"bf16 serve against prefill_fn: max abs diff "
                             f"{bf16_err}")
    line.update({
        "f32_prefill_simt_launches": n_simt,
        "bf16_prefill": {"batch": LLM_BATCH, "prompt": LLM_PROMPT,
                         "ms": prefill_ms, "k4_launches": n_prefill,
                         "k4_form": form,
                         "tokens_per_s": LLM_BATCH * LLM_PROMPT
                         / prefill_ms * 1e3},
        "bf16_serve": {"batch": LLM_BATCH, "prompt": LLM_PROMPT,
                       "gen": LLM_GEN, "steps": res.steps,
                       "prompt_ms_per_step": res.prompt_s * 1e3 / LLM_PROMPT,
                       "decode_ms_per_step": res.decode_s * 1e3 / LLM_GEN,
                       "tokens_per_s": res.tokens_per_s,
                       "k4_launches": n_decode,
                       "prompt_logits_vs_prefill_max_abs_diff": bf16_err,
                       "prompt_logits_vs_prefill_atol": 2e-2,
                       "sampled_ids": res.tokens[:2, :8].tolist()},
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9})

    line["bf16_prefill"].update(prefill_device(
        torch, lambda: prefill_fn(params, {"tokens": toks}), prefill_ms))

    # where a decode step's device time goes: 3 steps under the profiler
    # (every layer's span, 1024 keys or a 512-slot window at 4 (b, kv
    # head) pairs, takes 32 splits: past a cluster, so the merge kernel)
    line["decode_step_profile"] = decode_step_profile(
        torch, cfg, params, {"tokens": toks[:, :1], "positions": torch.full(
            (LLM_BATCH, 1), LLM_PROMPT - 1, device="cuda")},
        LLM_PROMPT - 1, kernel="decode_split", layers=cfg.n_layers)
    emit(line)
    return line, form_counts(**{form: n_prefill}, prefill_simt=n_simt,
                             decode=n_decode)


# ---- the families phase: MoE, Mamba2 and MLA + MoE at full width ----


def card_params(torch, cfg, seed: int):
    """A parameter tree of ``cfg`` drawn on the card from a seeded
    torch.Generator (``models.model.draw_params``: init_params's kinds and
    scales, not the reference's numbers, which the CPU tests hold
    init_params to)."""
    from repro_torch.models.model import draw_params
    return draw_params(cfg, seed, "cuda")


class RouteLog:
    """Wraps ``models.layers.moe_ffn`` while it is open: each call's
    top-k expert set a token and the gap between its k-th and (k+1)-th
    gate, recomputed from the layer's input and router as moe_ffn computes
    them, then the call itself.  Kept on the device."""

    def __init__(self, torch):
        import repro_torch.models.layers as L
        self.torch, self.L, self.calls = torch, L, []

    def __enter__(self):
        torch, orig = self.torch, self.L.moe_ffn
        self.orig = orig

        def logged(x, p, cfg, **kw):
            K = cfg.moe_top_k
            with torch.no_grad():       # no graph kept under a gradient
                gates = torch.softmax(x.float() @ p["router"], dim=-1)
                top, idx = torch.topk(gates, K + 1, dim=-1)
                self.calls.append((idx[..., :K].sort(dim=-1).values,
                                   top[..., K - 1] - top[..., K]))
            return orig(x, p, cfg, **kw)

        self.L.moe_ffn = logged
        return self

    def __exit__(self, *exc):
        self.L.moe_ffn = self.orig

    def stacked(self, n_moe: int):
        """(sets (L, B, S, K), gaps (L, B, S)) on the host: prefill calls
        (one a layer) as they are, decode steps (S x L calls of one
        position) concatenated over positions."""
        torch = self.torch
        steps = len(self.calls) // max(1, n_moe)
        out = []
        for part in (0, 1):
            per_layer = [torch.cat([self.calls[t * n_moe + i][part]
                                    for t in range(steps)], dim=1)
                         for i in range(n_moe)]
            out.append(torch.stack(per_layer).cpu() if per_layer else None)
        return out


def compare_routes(torch, a: RouteLog, b: RouteLog, n_moe: int, batch: int):
    """The batch rows whose routes agree in every MoE layer at every
    position, and each root difference: one with no difference in its row
    at an earlier layer and a position at or before it (later ones follow
    from it through the residual stream).  A root whose smaller gap is
    above ROUTE_GAP is not a near-tie and fails."""
    if n_moe == 0:
        return list(range(batch)), []
    (sa, ga), (sb, gb) = a.stacked(n_moe), b.stacked(n_moe)
    if sa.shape != sb.shape:
        raise AssertionError(f"routes of shapes {tuple(sa.shape)} and "
                             f"{tuple(sb.shape)}")
    diff = (sa != sb).any(dim=-1)                     # (L, B, S)
    roots = []
    for layer, row, pos in diff.nonzero().tolist():
        if not bool(diff[:layer, row, :pos + 1].any()):
            gap = min(float(ga[layer, row, pos]), float(gb[layer, row, pos]))
            roots.append({"layer": layer, "row": row, "pos": pos,
                          "gap": gap})
    far = [r for r in roots if r["gap"] > ROUTE_GAP]
    if far:
        raise AssertionError(f"routes differ with a gap above {ROUTE_GAP}: "
                             f"{far[:4]}")
    rows = [r for r in range(batch) if not bool(diff[:, r].any())]
    if not rows:
        raise AssertionError(f"no batch row whose routes all agree: {roots}")
    return rows, roots


def _held(torch, what, got, want, rows, atol, rtol) -> dict:
    """``got`` within atol + rtol |want| of ``want`` on ``rows``."""
    g, w = got.float()[rows], want.float()[rows]
    err = float((g - w).abs().max())
    if g.shape != w.shape or not bool(torch.isfinite(g).all()) or \
            not torch.allclose(g, w, atol=atol, rtol=rtol):
        raise AssertionError(f"{what}: max abs diff {err} on rows {rows}")
    return {"max_abs_diff": err, "max_abs_logit": float(w.abs().max()),
            "rows_held": rows, "atol": atol, "rtol": rtol}


def model_batch(torch, cfg, prompt, batch: int, seq: int):
    """The first ``batch`` rows and ``seq`` positions of a make_prompt
    prompt on the card as prefill_fn takes them: token ids, or embedding
    frames rounded to bf16 (as serve feeds them), with the positions
    (M-RoPE's (3, B, S), as the reference's launcher builds them); and a
    function giving decode step i's batch from it."""
    x = torch.from_numpy(prompt.tokens[:batch, :seq].copy())
    if cfg.input_mode != "tokens":
        x = x.to(torch.bfloat16)
    x = x.cuda()
    lead = (3, batch) if cfg.mrope_sections else (batch,)
    full = {"tokens": x, "positions": torch.arange(
        seq, device="cuda").expand(*lead, seq)}

    def step(i: int):
        return {"tokens": x[:, i:i + 1],
                "positions": torch.full((*lead, 1), i, device="cuda")}

    return full, step


def layer_cut(params, cfg, cfg2, first: int):
    """cfg2's parameter tree from cfg's layers first, first + 1, ...,
    as views: a period-1 model's stacked leaves sliced, or the tail slots
    of a model shorter than its period laid out as cfg2's one period (or
    tail) wants them.  Held leaf for leaf to cfg2's shapes."""
    from repro_torch.models.model import param_specs, tree_leaves, tree_map
    n = cfg2.n_layers
    out = {k: v for k, v in params.items()
           if k not in ("period_slots", "tail_slots")}
    if cfg.period == 1:
        out["period_slots"] = [tree_map(lambda t: t[first:first + n],
                                        params["period_slots"][0])]
        out["tail_slots"] = []
    else:
        per = cfg2.period
        if cfg.n_layers >= cfg.period or n // per > 1:
            raise ValueError(f"layer_cut takes a period-1 model or tail "
                             f"slots into at most one period, not "
                             f"{cfg.n_layers} layers of period {cfg.period} "
                             f"into {n} of period {per}")
        layers = params["tail_slots"][first:first + n]
        out["period_slots"] = [tree_map(lambda t: t[None], layers[s])
                               for s in range(per)] if n // per else []
        out["tail_slots"] = layers[n // per * per:]
    got = [tuple(t.shape) for t in tree_leaves(out)]
    want = [tuple(p.shape) for p in tree_leaves(param_specs(cfg2))]
    if got != want:
        raise AssertionError(f"layer_cut: shapes {got} against {want}")
    return out


def layer_counts(cfg):
    """(attention layers, those that decode through K4 (MLA's do not),
    MoE layers) of ``cfg``."""
    attn = sum(cfg.layer_kind(i) == "attn" for i in range(cfg.n_layers))
    return (attn, 0 if cfg.mla else attn,
            sum(cfg.layer_is_moe(i) for i in range(cfg.n_layers)))


def family_prompt(torch, np, cfg):
    """``make_prompt(cfg, FAM_BATCH, FAM_PREFILL)``: its token ids, or its
    frames (the same RandomState(0) draws) beside an embedding stub of its
    kind, (vocab, d_model) normals times 0.02, drawn on the card from a
    seeded torch.Generator (numpy draws qwen2-vl's 545 M in about 18 s on
    an H100's host)."""
    from repro_torch.launch.serve import Prompt, make_prompt
    if cfg.input_mode == "tokens":
        return make_prompt(cfg, FAM_BATCH, FAM_PREFILL)
    frames = np.random.RandomState(0).randn(FAM_BATCH, FAM_PREFILL,
                                            cfg.d_model)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    stub = torch.randn((cfg.vocab, cfg.d_model), generator=gen,
                       device="cuda") * 0.02
    return Prompt(frames, stub.cpu().numpy())


def family(torch, np, arch: str, cut32: dict, cut: dict):
    """One arch at full width: the f32 checks on its f32 cut (``cut32``),
    whose weights are then freed, and bf16 serving on its serving cut
    (``cut``), drawn in bf16, with K4's counters set to 0 just before the
    prefill_fn call and read after ``serve``.  Returns the line and K4's
    launches per form on the serving path (the SIMT form's from the f32
    prefill_fn)."""
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import registry
    from repro_torch.kernels.flash.ops import (decode_kernel, decode_split,
                                               form_launches)
    from repro_torch.launch.serve import Prompt, serve
    from repro_torch.models import build_forward
    from repro_torch.models.model import (moe_experts_padded, tree_leaves,
                                          tree_map, zero_cache)

    base = ARCHS[arch]
    cfg = base.replace(**cut)
    E = moe_experts_padded(base) if base.moe_experts else 0
    # capacity factor E / K: C = S slots an expert, no token drops
    cfg32 = base.replace(**cut32, dtype="float32", moe_capacity_factor=(
        E / base.moe_top_k if E else base.moe_capacity_factor))
    n_attn32, n_gqa32, n_moe32 = layer_counts(cfg32)
    n_attn, n_gqa, n_moe = layer_counts(cfg)

    def forms_were(what, **want):
        got = form_launches()
        if got != {f: want.get(f, 0) for f in got}:
            raise AssertionError(f"{arch} {what} launched K4's forms {got}, "
                                 f"want {want}")
        return got

    t_arch = time.perf_counter()
    # one prompt for every batch below
    prompt = family_prompt(torch, np, cfg)
    prompt_s = time.perf_counter() - t_arch
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = card_params(torch, cfg32, 0)
    torch.cuda.synchronize()
    line = {"phase": "families", "arch": arch, "reduced": cut,
            "f32_reduced": cut32, "n_layers": cfg.n_layers,
            "f32_n_layers": cfg32.n_layers, "d_model": cfg.d_model,
            "heads": [cfg.n_heads, cfg.n_kv_heads], "head_dim": cfg.hd,
            "input_mode": cfg.input_mode, "attn_layers": n_attn,
            "f32_attn_layers": n_attn32, "mla": cfg.mla,
            "moe_layers": n_moe, "f32_moe_layers": n_moe32,
            "experts_padded": E, "top_k": cfg.moe_top_k,
            "f32_params": sum(t.numel() for t in tree_leaves(params)),
            "f32_init_s": time.perf_counter() - t0, "prompt_s": prompt_s}

    # f32: prefill_fn over the prompt, the SIMT form's path (its counters
    # reset just before); then decode_fn over its first FAM_F32_DECODE
    # tokens against prefill_fn over those, every MoE route recorded on
    # both paths (the reference's tolerance, tests/test_models.py:83)
    P = FAM_F32_DECODE
    full_in, step_in = model_batch(torch, cfg32, prompt, 2, FAM_F32_PROMPT)
    _, prefill_fn, decode_fn = build_forward(cfg32)
    with torch.no_grad():
        registry.reset_launch_counts()
        prefill_fn(params, full_in)
        torch.cuda.synchronize()
        n_simt = forms_were("f32 prefill_fn",
                            prefill_simt=n_attn32)["prefill_simt"]
        with RouteLog(torch) as r_pre:
            full = prefill_fn(params, model_batch(torch, cfg32, prompt, 2,
                                                  P)[0])
            torch.cuda.synchronize()
        cache = zero_cache(cfg32, 2, P, "cuda")
        registry.reset_launch_counts()
        with RouteLog(torch) as r_dec:
            for i in range(P):
                step, cache = decode_fn(params, cache, step_in(i), index=i)
            torch.cuda.synchronize()
        forms_were("f32 decode loop", decode=n_gqa32 * P)
    del cache
    rows, roots = compare_routes(torch, r_pre, r_dec, n_moe32, 2)
    line["f32_decode_vs_prefill"] = dict(
        _held(torch, "f32 decode against prefill", step, full, rows,
              2e-3, 1e-3), batch=2, prompt=P,
        capacity_factor=cfg32.moe_capacity_factor, route_roots=roots,
        simt_launches=n_simt, decode_launches=n_gqa32 * P)
    del full, step, r_pre, r_dec

    # the model cut to 2 layers (FAM_TWO_LAYERS), prefill_fn on the card
    # (K4) and on the CPU (the plain version), at the config's capacity
    # factor (drops held equal with the routes)
    first, changes = FAM_TWO_LAYERS.get(arch, (0, {}))
    cfg2 = cfg32.replace(n_layers=2, moe_capacity_factor=(
        base.moe_capacity_factor), **changes)
    p2 = layer_cut(params, cfg32, cfg2, first)
    pf2 = build_forward(cfg2)[1]
    t0 = time.perf_counter()
    with torch.no_grad():
        with RouteLog(torch) as r_card:
            card = pf2(p2, full_in).float().cpu()
        p2 = tree_map(lambda t: t.cpu(), p2)
        with RouteLog(torch) as r_cpu:
            cpu = pf2(p2, {k: v.cpu() for k, v in full_in.items()}).float()
    del p2
    rows2, roots2 = compare_routes(torch, r_card, r_cpu, layer_counts(
        cfg2)[2], 2)
    line["f32_2layer_card_vs_cpu"] = dict(
        _held(torch, "2-layer card against CPU", card, cpu, rows2, 1e-4,
              1e-4), batch=2, prompt=FAM_F32_PROMPT, first_layer=first,
        changes={k: list(v) if isinstance(v, tuple) else v
                 for k, v in changes.items()},
        capacity_factor=cfg2.moe_capacity_factor, route_roots=roots2,
        s=time.perf_counter() - t0)
    line["f32_peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del params, r_card, r_cpu
    torch.cuda.empty_cache()
    line["f32_s"] = time.perf_counter() - t_arch

    # bf16 serving: the serving cut drawn in bf16, the counters set to 0
    # just before the prefill_fn call and read after serve
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = card_params(torch, cfg, 0)
    torch.cuda.synchronize()
    line.update(params=sum(t.numel() for t in tree_leaves(params)),
                init_s=time.perf_counter() - t0)
    prefill_fn = build_forward(cfg)[1]
    p_in, p_step = model_batch(torch, cfg, prompt, FAM_BATCH, FAM_PREFILL)
    with torch.no_grad():
        # the warm call, profiled for MLA: it hands K4 its operands
        # unpadded, so the call pads nothing
        if cfg.mla:
            pads = _aten_calls(torch, lambda: prefill_fn(params, p_in),
                               "aten::constant_pad_nd")
        else:
            pads = None
            prefill_fn(params, p_in)
        if cfg.mla and pads:
            raise AssertionError(f"{arch} bf16 prefill_fn ran "
                                 f"aten::constant_pad_nd {pads} times")
        registry.reset_launch_counts()
        logits, prefill_ms = _sync_ms(torch, lambda: prefill_fn(params, p_in))
        form = bf16_prefill_form(cfg)
        n_tc = forms_were("bf16 prefill_fn", **{form: n_attn})[form]
        res = serve(cfg, params, Prompt(np.ascontiguousarray(
            prompt.tokens[:, :FAM_PROMPT]), prompt.emb_stub), FAM_GEN,
            "cuda")
        launched = forms_were("bf16 prefill_fn and serve",
                              **{form: n_attn}, decode=n_gqa * res.steps)
    V = cfg.padded_vocab
    if res.steps != FAM_PROMPT + FAM_GEN or logits.shape != (
            FAM_BATCH, 1, V) or res.tokens.shape != (
            FAM_BATCH, FAM_GEN + 1) or not all(bool(torch.isfinite(
                t.float()).all()) for t in (logits, res.logits,
                                            res.prompt_logits)):
        raise AssertionError(f"{arch} bf16 serving: bad shapes or "
                             f"non-finite logits")
    # a profiled step's spans (128 keys) take the kernel decode_kernel
    # names at their split: the mma kernel at bf16 g >= 5 (gemma-2b,
    # qwen2-vl, qwen2-72b, command-r-plus, jamba), else the cluster kernel
    step_kernel = decode_kernel(torch.bfloat16, cfg.n_heads // cfg.n_kv_heads,
                                decode_split(FAM_PROMPT,
                                             FAM_BATCH * cfg.n_kv_heads)[1])
    line.update({
        "bf16_prefill": dict(
            {"batch": FAM_BATCH, "prompt": FAM_PREFILL, "ms": prefill_ms,
             "capacity_factor": cfg.moe_capacity_factor,
             "k4_form": form, "k4_launches": n_tc,
             "constant_pad_nd_calls": pads,
             "tokens_per_s": FAM_BATCH * FAM_PREFILL / prefill_ms * 1e3},
            **prefill_device(torch, lambda: prefill_fn(params, p_in),
                             prefill_ms)),
        "bf16_serve": {"batch": FAM_BATCH, "prompt": FAM_PROMPT,
                       "gen": FAM_GEN, "steps": res.steps,
                       "prompt_ms_per_step": res.prompt_s * 1e3 / FAM_PROMPT,
                       "decode_ms_per_step": res.decode_s * 1e3 / FAM_GEN,
                       "tokens_per_s": res.tokens_per_s,
                       "k4_decode_launches": launched["decode"],
                       "sampled_ids": res.tokens[:2, :8].tolist()},
        "decode_step_profile": decode_step_profile(
            torch, cfg, params, p_step(FAM_PROMPT - 1), FAM_PROMPT - 1,
            kernel=step_kernel, layers=n_gqa),
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "arch_s": time.perf_counter() - t_arch})
    del params
    torch.cuda.empty_cache()
    emit(line)
    return line, form_counts(**{form: n_tc}, prefill_simt=n_simt,
                             decode=launched["decode"])


def families_phase(torch, np):
    """FAMILIES at full width, one after another; returns their lines
    and K4's launches per form on their serving paths."""
    torch.backends.cuda.matmul.allow_tf32 = False   # f32 stays f32
    t0 = time.perf_counter()
    lines, launches = {}, {}
    for arch, cut32, cut in FAMILIES:
        lines[arch], launches[arch] = family(torch, np, arch, cut32, cut)
    emit({"phase": "families", "archs": [a for a, _, _ in FAMILIES],
          "arch_s": {a: lines[a]["arch_s"] for a in lines},
          "phase_s": time.perf_counter() - t0})
    return lines, launches


# ---- the train phase: gemma3-1b's training path on the card ----

TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_CKPT = 4, 1024, 8, 4
CHECK_BATCH, CHECK_SEQ = 2, 256        # the f32 2-layer card-vs-CPU check
GRAD_REL = {"bfloat16": 3e-2, "float32": 1e-4}
LEAF_REL = 1e-4      # f32 gradient leaves, card against CPU
RESUME_ATOL = 1e-3   # the resumed run's losses against the uninterrupted


def attention_grad_case(torch, np, name, B, S, H, Hkv, D, window, dtype,
                        timed: bool, scale=None, dims=None, Dv=None):
    """The attention Function (K4 with its lse, the plain block-recompute
    backward) against autograd through attention_ref on the card: each
    gradient within GRAD_REL of its largest; then, if ``timed``, the
    backward's device ms (``flash_attention_bwd`` alone) beside
    scaled_dot_product_attention's backward on the same operands, both by
    CUDA events (the profiler misses the library's main backward kernel).
    ``dims`` = (Dk, Dv): operands zero-padded to D past them, with
    ``scale``; the library takes the unpadded operands and the flops count
    the unpadded work.  ``Dv``: v's and the output's own head dim (MLA's
    unpadded operands, D being q's and k's)."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash.ops import attention_pairs
    from repro_torch.kernels.flash.ref import attention_ref
    from repro_torch.kernels.timing import bound_ms, device_ms
    from repro_torch.models.layers import FlashAttention, flash_attention_bwd
    from repro_torch.kernels.flash import flash_attention
    rng = np.random.RandomState(S + H + D)

    def randn(shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)).cuda(
            ).to(dtype)

    dk, dv = dims or (D, Dv or D)
    Dpv = Dv or D                 # v's head dim as K4 receives it

    def padded(shape, d, to):
        return torch.nn.functional.pad(randn(shape[:-1] + (d,)), (0, to - d))

    q, k = padded((B, S, H, D), dk, D), padded((B, S, Hkv, D), dk, D)
    v, do = padded((B, S, Hkv, D), dv, Dpv), padded((B, S, H, D), dv, Dpv)

    def grads(fn):
        ts = [t.clone().requires_grad_(True) for t in (q, k, v)]
        fn(*ts).backward(do)
        return [t.grad for t in ts]

    got = grads(lambda a, b, c: FlashAttention.apply(a, b, c, True, window,
                                                     scale, 1024))
    want = grads(lambda a, b, c: attention_ref(
        a, b, c, causal=True, window=window, scale=scale).to(dtype))
    rel = GRAD_REL[str(dtype).split(".")[-1]]
    errs = []
    for which, g, w in zip("qkv", got, want):
        err = float((g.float() - w.float()).abs().max())
        big = float(w.float().abs().max())
        if not err <= rel * big:
            raise AssertionError(f"attention grad {name} d{which}: max abs "
                                 f"err {err}, {rel} of {big} allowed")
        errs.append(err / big)
    line = {"case": name, "dtype": str(dtype).split(".")[-1],
            "shape": {"B": B, "S": S, "H": H, "Hkv": Hkv, "D": D,
                      "Dv": Dpv, "window": window},
            "max_rel_err": max(errs), "tolerance_rel": rel}
    if not timed:
        return line
    out, lse = flash_attention(q, k, v, causal=True, window=window,
                               scale=scale, return_lse=True)
    bwd = lambda: flash_attention_bwd(                           # noqa: E731
        q, k, v, out, lse, do, causal=True, window=window,
        scale=D ** -0.5 if scale is None else scale, block_kv=1024)
    qt, kt, vt = (t[..., :d].transpose(1, 2).contiguous().requires_grad_(True)
                  for t, d in ((q, dk), (k, dk), (v, dv)))
    mask = None
    if window:
        i = torch.arange(S, device="cuda")[:, None]
        j = torch.arange(S, device="cuda")[None]
        mask = (j <= i) & (j > i - window)
    lib_out = F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, is_causal=mask is None, scale=scale,
        enable_gqa=True)
    dot = do[..., :dv].transpose(1, 2).contiguous()
    lib_bwd = lambda: torch.autograd.grad(                       # noqa: E731
        lib_out, (qt, kt, vt), dot, retain_graph=True)
    # the backward's five products a (q, k) pair in the band (s again, dv,
    # dp, dq, dk), 2 D flops each; the plain backward also computes the
    # pairs outside the band
    flops = 2 * (3 * dk + 2 * dv) * B * H * attention_pairs(S, S, True,
                                                            window)
    # the plain backward's device ms (the profiler's events) with its
    # CUDA-event ms beside them; the library's by CUDA events alone
    line.update({"bwd_ms": device_ms(bwd, 5), "bwd_call_ms": cuda_ms(bwd, 5),
                 "sdpa_bwd_call_ms": cuda_ms(lib_bwd, 5),
                 "bwd_flops": flops,
                 "bwd_bound_ops_ms": bound_ms(0, flops, dtype)[3]})
    return line


def train_phase(torch, np):
    """gemma3-1b's training path.  The checks: K4's lse and the attention
    gradient at the model's shapes, then the f32 loss and every gradient
    leaf of gemma3-1b cut to 2 layers at full width, card against CPU.
    The path: bf16 gemma3-1b uncut, TRAIN_STEPS AdamW steps of launch/
    train's loop on 4 x 1024 tokens, an async checkpoint at TRAIN_CKPT and
    the final one, with K4's counters set to 0 just before and read just
    after; then the run resumed from the step-TRAIN_CKPT checkpoint, whose
    losses must replay the uninterrupted run's (its async save, 2 steps in,
    reuses the first run's pinned buffers).  The line gives each save's
    stall on the step that carries it and the rates over the whole loop
    beside the median step's.  Returns the phase's line,
    the lse case at the path's shapes and K4's launches on the path."""
    import shutil
    from repro_torch.configs import ARCHS
    from repro_torch.data.pipeline import DataConfig, _batch_at
    from repro_torch.kernels import registry
    from repro_torch.kernels.flash.ops import form_launches
    from repro_torch.kernels.timing import device_events
    from repro_torch.launch.train import train
    from repro_torch.models import build_forward
    from repro_torch.models.model import tree_leaves, tree_map
    from repro_torch.train import build_train_step, value_and_grad

    torch.backends.cuda.matmul.allow_tf32 = False   # f32 stays f32
    t_phase = time.perf_counter()
    cfg = ARCHS[LLM_ARCH]
    H, Hkv, D, W = cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.sliding_window
    line = {"phase": "train", "arch": cfg.name, "batch": TRAIN_BATCH,
            "seq": TRAIN_SEQ, "steps": TRAIN_STEPS, "remat": cfg.remat}

    # K4's lse (both forms) and the attention gradient at the model's
    # shapes: bf16 at the path's 4 x 1024, f32 at the 2-layer check's
    rng = np.random.RandomState(24)

    def randn(shape, dtype):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)).cuda(
            ).to(dtype)

    cases = {}
    for name, (b, s_, dtype, window, atol) in {
            "train_local_bf16": (TRAIN_BATCH, TRAIN_SEQ, torch.bfloat16, W,
                                 3e-2),
            "train_global_bf16": (TRAIN_BATCH, TRAIN_SEQ, torch.bfloat16,
                                  None, 3e-2),
            "train_check_f32": (CHECK_BATCH, CHECK_SEQ, torch.float32, W,
                                2e-5)}.items():
        cases[name] = flash_case(
            torch, np, name, randn((b, s_, H, D), dtype),
            randn((b, s_, Hkv, D), dtype), randn((b, s_, Hkv, D), dtype),
            causal=True, window=window, decode=False, atol=atol, lse=True)
        emit(cases[name])
    # the backward timed at the path's shapes only
    line["attention_grad"] = [
        attention_grad_case(torch, np, n, b, s_, H, Hkv, D, w, dt,
                            timed=dt == torch.bfloat16)
        for n, (b, s_, w, dt) in {
            "train_local_bf16": (TRAIN_BATCH, TRAIN_SEQ, W, torch.bfloat16),
            "train_global_bf16": (TRAIN_BATCH, TRAIN_SEQ, None,
                                  torch.bfloat16),
            "check_local_f32": (CHECK_BATCH, CHECK_SEQ, W, torch.float32),
            "check_global_f32": (CHECK_BATCH, CHECK_SEQ, None,
                                 torch.float32)}.items()]
    line["checks_s"] = time.perf_counter() - t_phase
    torch.cuda.empty_cache()

    # f32, 2 layers at full width: the loss and every gradient leaf on the
    # card (K4's SIMT form with its lse) against the CPU (the plain version)
    cfg2 = cfg.replace(dtype="float32", n_layers=2)
    p2 = card_params(torch, cfg2, 1)
    host = _batch_at(DataConfig(CHECK_SEQ, CHECK_BATCH, cfg.vocab), 0, 0,
                     CHECK_BATCH)
    batch2 = {k: torch.from_numpy(v) for k, v in host.items()}
    loss_fn2 = build_forward(cfg2)[0]
    t0 = time.perf_counter()
    registry.reset_launch_counts()
    l_card, g_card = value_and_grad(loss_fn2, p2, {
        k: v.cuda() for k, v in batch2.items()})
    n_check = form_launches()
    if n_check != form_counts(prefill_simt=2):
        raise AssertionError(f"f32 2-layer loss_fn launched {n_check}")
    g_card = [g.cpu() for g in tree_leaves(g_card)]
    l_cpu, g_cpu = value_and_grad(loss_fn2, tree_map(lambda t: t.cpu(), p2),
                                  batch2)
    del p2
    loss_err = abs(float(l_card) - float(l_cpu))
    leaf_err = 0.0
    for a, b in zip(g_card, tree_leaves(g_cpu)):
        err = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
        leaf_err = max(leaf_err, err)
    if not (loss_err <= 1e-4 and leaf_err <= LEAF_REL):
        raise AssertionError(f"f32 2-layer loss and grads, card against CPU: "
                             f"loss diff {loss_err}, worst leaf {leaf_err}")
    line["f32_2layer_card_vs_cpu"] = {
        "batch": CHECK_BATCH, "seq": CHECK_SEQ, "loss": float(l_cpu),
        "loss_abs_diff": loss_err, "loss_atol": 1e-4, "leaves": len(g_card),
        "worst_leaf_rel_diff": leaf_err, "leaf_rel_tol": LEAF_REL,
        "simt_launches": n_check["prefill_simt"],
        "s": time.perf_counter() - t0}
    del g_card, g_cpu
    torch.cuda.empty_cache()

    # bf16, uncut: the launcher's loop with the counters set to 0 just
    # before it; K4's tensor-core form (the wgmma form at D 256) once per
    # layer in the forward and once more per period layer in the remat
    # backward
    form = bf16_prefill_form(cfg)
    n_per = cfg.n_layers // cfg.period
    per_step = cfg.n_layers + (n_per * cfg.period if cfg.remat else 0)
    ckpt_dir = ROOT / ".train_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    init = lambda c, dev: card_params(torch, c, 0)               # noqa: E731
    kw = dict(steps=TRAIN_STEPS, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
              ckpt_dir=str(ckpt_dir), ckpt_every=TRAIN_CKPT, log_every=1,
              device="cuda", init=init)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        registry.reset_launch_counts()
        t0 = time.perf_counter()
        res = train(cfg, **kw)
        run_s = time.perf_counter() - t0
        launches = form_launches()
        peak = torch.cuda.max_memory_allocated() / 1e9
        want = form_counts(**{form: TRAIN_STEPS * per_step})
        if launches != want:
            raise AssertionError(f"training launched K4's forms {launches}, "
                                 f"want {want}")
        if not (np.all(np.isfinite(res.losses))
                and np.all(np.isfinite(res.gnorms))):
            raise AssertionError(f"training: a non-finite loss or gradient "
                                 f"norm: {res.losses} {res.gnorms}")
        # one more step, by itself: K4's launches on a step, then its device
        # time and the top kernels under the profiler
        step = build_train_step(cfg)
        b = {k: torch.from_numpy(v).cuda() for k, v in _batch_at(
            DataConfig(TRAIN_SEQ, TRAIN_BATCH, cfg.vocab), TRAIN_STEPS, 0,
            TRAIN_BATCH).items()}
        registry.reset_launch_counts()
        step(res.params, res.opt, b)
        torch.cuda.synchronize()
        on_step = form_launches()
        if on_step != form_counts(**{form: per_step}):
            raise AssertionError(f"a train step launched {on_step}, want "
                                 f"{per_step} of {form}")
        t0 = time.perf_counter()
        dev_ms, by_name = device_events(lambda: step(res.params, res.opt, b),
                                        1, warmup=0)
        profile_s = time.perf_counter() - t0
        top = sorted(by_name.items(), key=lambda kv: -kv[1])
        losses, gnorms, step_s = res.losses, res.gnorms, res.step_s
        save_s = res.save_s
        del res, step
        torch.cuda.empty_cache()

        # resume from the step-TRAIN_CKPT checkpoint: the final one removed,
        # the launcher replays steps TRAIN_CKPT + 1 .. TRAIN_STEPS, with an
        # async save every 2 steps (one, into the first run's pinned buffers)
        shutil.rmtree(ckpt_dir / f"step_{TRAIN_STEPS}")
        registry.reset_launch_counts()
        t0 = time.perf_counter()
        res2 = train(cfg, **dict(kw, ckpt_every=2))
        resume_s = time.perf_counter() - t0
        resumed = form_launches()[form]
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    replay, replay_s, replay_save_s = res2.losses, res2.step_s, res2.save_s
    del res2
    torch.cuda.empty_cache()
    diff = float(np.max(np.abs(np.array(replay)
                               - np.array(losses[TRAIN_CKPT:]))))
    if len(replay) != TRAIN_STEPS - TRAIN_CKPT or not diff <= RESUME_ATOL:
        raise AssertionError(f"resumed losses {replay} against "
                             f"{losses[TRAIN_CKPT:]}")
    if resumed != (TRAIN_STEPS - TRAIN_CKPT) * per_step:
        raise AssertionError(f"the resumed run launched K4 {resumed} times")
    # a save's copy on the caller's thread falls in the next step's time:
    # the median of the steps after the first that carry none, each
    # carrying step beside it, and the rate over the whole loop
    steady_ms = 1e3 * float(np.median(
        [t for i, t in enumerate(step_s) if i and i != TRAIN_CKPT]))
    tokens = TRAIN_STEPS * TRAIN_BATCH * TRAIN_SEQ
    line.update({
        "losses": losses, "gnorms": gnorms,
        "step_ms_host": [1e3 * t for t in step_s],
        "step_ms_median": steady_ms,
        "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / steady_ms * 1e3,
        "tokens_per_s_loop": tokens / sum(step_s),
        "tokens_per_s_run": tokens / run_s,
        "save": {"step": TRAIN_CKPT, "caller_ms": 1e3 * save_s[0],
                 "step_ms": 1e3 * step_s[TRAIN_CKPT],
                 "stall_ms": 1e3 * step_s[TRAIN_CKPT] - steady_ms,
                 "first": True},
        "step_device_ms": dev_ms, "device_busy_share": dev_ms / steady_ms,
        "k4_device_ms": sum(ms for n, ms in by_name.items()
                            if kernel_form(n) in K4_BF16_FORMS),
        "top": [{"name": n[:80], "ms": ms} for n, ms in top[:10]],
        "k4_launches_per_step": on_step, "k4_launches_path": launches,
        "k4_launches_per_step_want": per_step,
        "peak_memory_gb": peak, "run_s": run_s, "profile_s": profile_s,
        "resume": {"from_step": TRAIN_CKPT, "losses": replay,
                   "max_abs_diff": diff, "atol": RESUME_ATOL,
                   "k4_launches": resumed, "s": resume_s,
                   "step_ms_host": [1e3 * t for t in replay_s],
                   "save": {"step": TRAIN_CKPT + 2,
                            "caller_ms": 1e3 * replay_save_s[0],
                            "step_ms": 1e3 * replay_s[2],
                            "stall_ms": 1e3 * replay_s[2] - steady_ms,
                            "first": False}},
        "phase_s": time.perf_counter() - t_phase})
    emit(line)
    return line, cases["train_local_bf16"], launches


# ---- the train_families phase: MoE, Mamba2 and MLA + MoE trained at full
# width, and the expert-parallel MoE through NCCL ----

# (arch, cut, batch): each at full width, deepseek-v2 cut to its first
# layer (one MLA and one 160-expert MoE layer, 5.02 B parameters) and
# trained on batch 2: at batch 4 its 60 GB of parameters, gradients and
# moments and the plain attention backward's f32 temporaries (128 heads)
# pass the card's 80 GB
TRAIN_FAMILIES = (("granite-moe-3b-a800m", {}, 4), ("mamba2-1.3b", {}, 4),
                  ("deepseek-v2-236b", {"n_layers": 1}, 2))
FAM_TRAIN_BATCH, FAM_TRAIN_SEQ, FAM_TRAIN_STEPS = 4, 1024, 4
FAM_CHECK_SEQ = {"granite-moe-3b-a800m": 128, "mamba2-1.3b": 128,
                 "deepseek-v2-236b": 64}    # the f32 checks' batch is 2
LOSS_ATOL = 1e-4     # f32 losses: K4 against the plain attention, a2a
A2A_RTOL, A2A_ATOL = 1e-5, 1e-4   # tests/test_perf_variants.py's


def _grads_held(torch, what, la, ga, lb, gb, atol, rtol=None):
    """The loss within LOSS_ATOL of ``lb``, and every gradient leaf finite
    and, with ``rtol``, within atol + rtol |b| elementwise, else within
    ``atol`` of the leaf's largest magnitude."""
    from repro_torch.models.model import tree_leaves
    loss_err = abs(float(la) - float(lb))
    worst, n = 0.0, 0
    for a, b in zip(tree_leaves(ga), tree_leaves(gb)):
        a, b, n = a.float(), b.float(), n + 1
        err = float((a - b).abs().max()) if a.numel() else 0.0
        if rtol is None:
            big = max(float(b.abs().max()) if b.numel() else 0.0, 1e-30)
            ok, worst = err <= atol * big, max(worst, err / big)
        else:
            ok = bool(torch.allclose(a, b, rtol=rtol, atol=atol))
            worst = max(worst, err)
        if not (ok and bool(torch.isfinite(a).all())):
            raise AssertionError(f"{what}: a gradient leaf off by {err}")
    if not loss_err <= LOSS_ATOL:
        raise AssertionError(f"{what}: loss {float(la)} against {float(lb)}")
    return {"loss": float(lb), "loss_abs_diff": loss_err,
            "loss_atol": LOSS_ATOL, "leaves": n, "worst_leaf_diff": worst,
            "leaf_atol": atol, "leaf_rtol": rtol}


def train_family(torch, np, arch: str, cut: dict, batch: int):
    """One family trained on the card: the f32 checks, then FAM_TRAIN_STEPS
    bf16 AdamW steps (the in-place update) on ``batch`` x FAM_TRAIN_SEQ
    tokens, K4's counters set to 0 before each step and read
    after it.  Returns the line and K4's launches on the training path."""
    from repro_torch.configs import ARCHS
    from repro_torch.data.pipeline import DataConfig, _batch_at
    from repro_torch.kernels import registry
    from repro_torch.kernels.flash.ops import form_launches
    from repro_torch.models import build_forward
    from repro_torch.models.model import moe_experts_padded, tree_leaves
    from repro_torch.optim import adamw_init
    from repro_torch.train import build_train_step, value_and_grad

    cfg = ARCHS[arch].replace(**cut)
    if cfg.period != 1:
        raise AssertionError(f"{arch}: the cuts take period 1")
    n_attn = sum(cfg.layer_kind(i) == "attn" for i in range(cfg.n_layers))
    n_moe = sum(cfg.layer_is_moe(i) for i in range(cfg.n_layers))
    E = moe_experts_padded(cfg) if cfg.moe_experts else 0
    t_arch = time.perf_counter()
    line = {"phase": "train_families", "arch": arch, "reduced": cut,
            "allocated_gb_at_start": torch.cuda.memory_allocated() / 1e9,
            "n_layers": cfg.n_layers, "d_model": cfg.d_model,
            "attn_layers": n_attn, "mla": cfg.mla, "moe_layers": n_moe,
            "experts_padded": E, "remat": cfg.remat}

    # f32, the model cut to 2 layers (deepseek: its 1), capacity factor
    # E / K (no drop): the loss and every gradient leaf with K4 (its SIMT
    # form, with the lse) against the same step with the plain attention
    # (attn_impl "naive"), both on the card; mamba2 has no attention and
    # holds the card against the CPU.  A batch row whose MoE routes differ
    # between the two (a near-tie, compare_routes) is left out and both
    # are taken again on the other rows.
    n2 = min(2, cfg.n_layers)
    cfg32 = cfg.replace(dtype="float32", n_layers=n2, moe_capacity_factor=(
        E / cfg.moe_top_k if E else cfg.moe_capacity_factor))
    n_attn2 = sum(cfg32.layer_kind(i) == "attn" for i in range(n2))
    n_moe2 = sum(cfg32.layer_is_moe(i) for i in range(n2))
    seq = FAM_CHECK_SEQ[arch]
    host = _batch_at(DataConfig(seq, 2, cfg.vocab), 0, 0, 2)
    p32 = card_params(torch, cfg32, 1)
    t0 = time.perf_counter()

    def run(c, params, rows, device):
        b = {k: torch.from_numpy(v[rows]).to(device) for k, v in host.items()}
        registry.reset_launch_counts()
        with RouteLog(torch) as log:
            out = value_and_grad(build_forward(c)[0], params, b)
            if device == "cuda":
                torch.cuda.synchronize()
        return out, log, form_launches()

    rows = [0, 1]
    # K4's SIMT form in the forward and the remat recompute, once each an
    # attention layer
    want = form_counts(prefill_simt=2 * n_attn2)
    for _ in range(2):
        (la, ga), log_a, n_a = run(cfg32, p32, rows, "cuda")
        if n_a != want:
            raise AssertionError(f"{arch} f32 step launched {n_a}, want "
                                 f"{want}")
        if n_attn2:
            (lb, gb), log_b, _ = run(cfg32.replace(attn_impl="naive"), p32,
                                     rows, "cuda")
            other = "plain attention on the card"
        else:
            from repro_torch.models.model import tree_map
            (lb, gb), log_b, _ = run(cfg32, tree_map(lambda t: t.cpu(), p32),
                                     rows, "cpu")
            other = "the CPU"
        kept, roots = compare_routes(torch, log_a, log_b, n_moe2, len(rows))
        if len(kept) == len(rows):
            break
        rows = [rows[r] for r in kept]
    ga = [g.cpu() for g in tree_leaves(ga)] if not n_attn2 else ga
    line["f32_step"] = dict(
        _grads_held(torch, f"{arch} f32 step, K4 against {other}", la, ga,
                    lb, gb, LEAF_REL),
        against=other, n_layers=n2, batch_rows=rows, seq=seq,
        capacity_factor=cfg32.moe_capacity_factor, route_roots=roots,
        simt_launches=n_a["prefill_simt"], s=time.perf_counter() - t0)
    del p32, ga, gb, log_a, log_b
    torch.cuda.empty_cache()

    # bf16 at full width: FAM_TRAIN_STEPS steps of build_train_step with
    # the in-place AdamW, then one more under the profiler
    per_step = n_attn + (cfg.n_layers // cfg.period * sum(
        cfg.layer_kind(i) == "attn" for i in range(cfg.period))
        if cfg.remat else 0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = card_params(torch, cfg, 0)
    opt = adamw_init(params)
    torch.cuda.synchronize()
    line["init_s"] = time.perf_counter() - t0
    line["params"] = sum(t.numel() for t in tree_leaves(params))
    step = build_train_step(cfg)
    dcfg = DataConfig(FAM_TRAIN_SEQ, batch, cfg.vocab)

    def batch_at(i):
        return {k: torch.from_numpy(v).cuda()
                for k, v in _batch_at(dcfg, i, 0, batch).items()}

    losses, gnorms, host_ms, event_ms, launches = [], [], [], [], []
    form = bf16_prefill_form(cfg)
    total = form_counts()
    for i in range(FAM_TRAIN_STEPS):
        b = batch_at(i)
        torch.cuda.synchronize()
        registry.reset_launch_counts()
        ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t1 = time.perf_counter()
        ev0.record()
        params, opt, metrics = step(params, opt, b)
        ev1.record()
        losses.append(float(metrics["loss"]))
        gnorms.append(float(metrics["gnorm"]))
        torch.cuda.synchronize()
        host_ms.append(1e3 * (time.perf_counter() - t1))
        event_ms.append(ev0.elapsed_time(ev1))
        n = form_launches()
        if n != form_counts(**{form: per_step}):
            raise AssertionError(f"{arch} train step {i} launched {n}, want "
                                 f"{per_step} of {form}")
        launches.append(n)
        total = {f: total[f] + n[f] for f in total}
    peak = torch.cuda.max_memory_allocated() / 1e9
    if not (np.all(np.isfinite(losses)) and np.all(np.isfinite(gnorms))):
        raise AssertionError(f"{arch} training: a non-finite loss or gradient "
                             f"norm: {losses} {gnorms}")
    # MLA's attention pads nothing under a gradient either
    pads = None
    if cfg.mla:
        pads = _aten_calls(torch, lambda: step(params, opt,
                                               batch_at(FAM_TRAIN_STEPS)),
                           "aten::constant_pad_nd")
        if pads:
            raise AssertionError(f"{arch} train step ran "
                                 f"aten::constant_pad_nd {pads} times")
    del params, opt, step
    torch.cuda.empty_cache()
    line.update({
        "batch": batch, "seq": FAM_TRAIN_SEQ,
        "steps": FAM_TRAIN_STEPS, "losses": losses, "gnorms": gnorms,
        "step_ms_host": host_ms, "step_ms_events": event_ms,
        "step_ms_median": float(np.median(host_ms[1:])),
        "k4_launches_per_step": launches[0],
        "k4_launches_per_step_want": per_step,
        "peak_memory_gb": peak,
        "constant_pad_nd_calls": pads,
        "arch_s": time.perf_counter() - t_arch})
    emit(line)
    return line, total


def a2a_case(torch, np):
    """``moe_ffn_a2a`` through NCCL: a one-rank process group and a (1, 1)
    DeviceMesh, granite cut to 2 layers at full width in f32, capacity
    factor 8: the loss and every gradient leaf of ``build_forward`` with
    the mesh (``_block`` takes moe_ffn_a2a, its all-to-alls and local_map
    at size 1) against ``moe_ffn`` without it, at the reference test's
    tolerances; the collectives counted by ``parallel.collective_bytes``."""
    import socket
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import ARCHS
    from repro_torch.data.pipeline import DataConfig, _batch_at
    from repro_torch.models import build_forward
    from repro_torch.parallel import collective_bytes
    from repro_torch.train import value_and_grad

    t0 = time.perf_counter()
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1,
                            device_id=torch.device("cuda", 0))
    try:
        mesh = init_device_mesh("cuda", (1, 1),
                                mesh_dim_names=("data", "model"))
        cfg = ARCHS["granite-moe-3b-a800m"].replace(
            n_layers=2, dtype="float32", moe_capacity_factor=8.0)
        params = card_params(torch, cfg, 2)
        b = {k: torch.from_numpy(v).cuda() for k, v in _batch_at(
            DataConfig(128, 2, cfg.vocab), 0, 0, 2).items()}
        la, ga = value_and_grad(build_forward(cfg)[0], params, b)
        with collective_bytes() as rec:
            lb, gb = value_and_grad(build_forward(
                cfg.replace(moe_impl="a2a"), mesh=mesh)[0], params, b)
            torch.cuda.synchronize()
        held = _grads_held(torch, "moe_ffn_a2a through NCCL against moe_ffn",
                           lb, gb, la, ga, A2A_ATOL, A2A_RTOL)
        if not rec.calls.get("all-to-all"):
            raise AssertionError(f"moe_ffn_a2a: no all-to-all counted "
                                 f"({rec.calls})")
        line = {"phase": "train_families", "check": "moe_a2a_nccl",
                "arch": cfg.name, "n_layers": 2, "batch": 2, "seq": 128,
                "mesh": [1, 1], "backend": dist.get_backend(),
                "capacity_factor": 8.0, **held,
                "collective_calls": rec.calls,
                "collective_bytes": rec.counts,
                "s": time.perf_counter() - t0}
        del params, ga, gb
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    emit(line)
    return line


def train_families_phase(torch, np):
    """K4's lse and the attention gradient at the families' training
    shapes (granite's at batch 4, MLA's at deepseek's batch 2), each
    family trained (train_family), and the NCCL a2a case.
    Returns K4's cases (granite's GQA D 64 and MLA's unpadded (192, 128))
    and each family's K4 launches on its training path; MLA's lse call
    zero-padded to 256 is timed once more beside them."""
    torch.backends.cuda.matmul.allow_tf32 = False   # f32 stays f32
    t_phase = time.perf_counter()
    from repro_torch.configs import ARCHS
    rng = np.random.RandomState(25)

    def randn(shape, dtype):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)).cuda(
            ).to(dtype)

    g, m = ARCHS["granite-moe-3b-a800m"], ARCHS["deepseek-v2-236b"]
    dk, dv = m.qk_nope_dim + m.qk_rope_dim, m.v_head_dim
    # each at its training path's batch
    B, S, bf16 = FAM_TRAIN_BATCH, FAM_TRAIN_SEQ, torch.bfloat16
    Bm = {a: b for a, _, b in TRAIN_FAMILIES}["deepseek-v2-236b"]
    cases = {"granite": flash_case(
        torch, np, "train_granite_bf16", randn((B, S, g.n_heads, g.hd), bf16),
        randn((B, S, g.n_kv_heads, g.hd), bf16),
        randn((B, S, g.n_kv_heads, g.hd), bf16), causal=True, window=None,
        decode=False, atol=3e-2, lse=True)}
    q, k, v = (randn((Bm, S, m.n_heads, d), bf16) for d in (dk, dk, dv))
    cases["mla"] = flash_case(
        torch, np, "train_mla_bf16", q, k, v, causal=True, window=None,
        decode=False, atol=3e-2, scale=dk ** -0.5, lse=True)
    padded = [torch.nn.functional.pad(t, (0, MLA_PADDED - d))
              for t, d in ((q, dk), (k, dk), (v, dv))]
    emit(flash_case(
        torch, np, "train_mla_padded_bf16", *padded, causal=True,
        window=None, decode=False, atol=3e-2, scale=dk ** -0.5,
        dims=(dk, dv), lse=True))
    del q, k, v, padded
    for c in cases.values():
        emit(c)
    grads = [attention_grad_case(torch, np, "train_granite_bf16", B, S,
                                 g.n_heads, g.n_kv_heads, g.hd, None, bf16,
                                 timed=True),
             attention_grad_case(torch, np, "train_mla_bf16", Bm, S,
                                 m.n_heads, m.n_heads, dk, None, bf16,
                                 timed=True, scale=dk ** -0.5, Dv=dv)]
    emit({"phase": "train_families", "attention_grad": grads})
    torch.cuda.empty_cache()
    lines, launches = {}, {}
    for arch, cut, batch in TRAIN_FAMILIES:
        lines[arch], launches[arch] = train_family(torch, np, arch, cut,
                                                   batch)
    a2a_case(torch, np)
    emit({"phase": "train_families",
          "archs": [a for a, _, _ in TRAIN_FAMILIES],
          "phase_s": time.perf_counter() - t_phase})
    return cases, launches


# ---- the cells phase: the reference's shape cells (configs.SHAPES) on
# one card, through launch/cells.py ----

# (arch, shape, batch, window_cache): full width and depth, each at the
# largest batch up to the reference's that the card holds (PERF.md §4:
# mamba2's prefill at 8 and gemma3-1b's train at 32 ran out of memory);
# gemma3-1b's decode_32k with full caches (B 64 of the reference's 128:
# 128 full caches are 111.7 GB) and with the rolling window cache at 128;
# train_4k at 28 of the 30 that a fresh process held (81.9 GB of 85),
# leaving room for what the earlier phases keep on the card
CELLS = (("gemma3-1b", "prefill_32k", 32, False),
         ("gemma3-1b", "decode_32k", 64, False),
         ("gemma3-1b", "decode_32k", 128, True),
         ("gemma3-1b", "long_500k", 1, False),
         ("gemma3-1b", "train_4k", 28, False),
         ("mamba2-1.3b", "prefill_32k", 7, False),
         ("mamba2-1.3b", "decode_32k", 128, False),
         ("mamba2-1.3b", "long_500k", 1, False))
CELL_HOLD_LAYERS = 6    # gemma3-1b's one-period cut: 5 local, 1 global
CELL_ROWS = 1024        # rows a window of a 32k launch is held on
CELL_BF16_ATOL = 2e-2   # bf16 prefill_fn against f32 (gemma3-1b serving's)
CELL_CPU_TOL = 1e-4     # an f32 step on the card against the CPU


def cell_batch(arch: str, shape: str) -> int:
    """The batch CELLS runs ``arch`` x ``shape`` at (its first entry)."""
    return next(b for a, sh, b, _ in CELLS if (a, sh) == (arch, shape))


def dropped_splits(torch, q, k, v, line, atol):
    """A planted fault, to show that a long-span decode case's hold sees
    it: the kernels ``line``'s split names, launched over only the first
    nsplit - max(1, nsplit // 2) of its chunks (``ops.decode_launch`` on
    those keys alone), which is what a merge that lost the other splits'
    partials returns.  Raises where the hold would pass it."""
    from repro_torch.kernels.flash.ops import decode_launch
    from repro_torch.kernels.flash.ref import attention_ref
    from repro_torch.launch.cells import K4_REL, k4_limit
    kc, nsplit = line["split"]["kc"], line["split"]["nsplit"]
    keep = nsplit - max(1, nsplit // 2)
    want = attention_ref(q, k, v, causal=False)
    got = decode_launch(q, k[:, :keep * kc], v[:, :keep * kc], kc, keep)
    err = float((got.float() - want).abs().max())
    limit = k4_limit(want, atol, K4_REL)
    if not err > limit:
        raise AssertionError(f"{line['case']}: the hold passes a merge of "
                             f"{keep} of {nsplit} splits (max abs err {err}"
                             f", limit {limit})")
    return {"kept_splits": keep, "of": nsplit, "max_abs_err": err,
            "limit": limit, "within_atol": err <= atol}


def cells_k4_cases(torch, np):
    """K4 at the cells' shapes, each against the plain version on the
    card (tests/test_kernels.py's tolerances, bf16 3e-2 and f32 2e-5, and
    on each window held within K4_REL of the plain version's largest
    magnitude there: ``launch.cells.k4_limit``) and timed: gemma3-1b's
    prefill at S 32768, window 512 and causal, in bf16 at the prefill
    cell's batch and in f32 at the f32 hold's batch 1, held on three
    windows of CELL_ROWS rows (the first, the middle and the last);
    decode over 32768 keys at B 64 (3 splits) and B 128 (2 splits), over
    a 512-slot rolling cache at B 128 (2 splits) and over 524288 keys at
    B 1 (132 splits: the split and merge kernels), each launching exactly
    the kernels ``ops.decode_kernel`` names and each failing a planted
    merge of half its splits (``dropped_splits``); and the prefill with
    its lse at the train cell's batch x 4096, window 512 and causal.
    Returns (cases, paths), keyed by the kernels line's suffix: a path
    is where the case's launches are counted, (the CELLS entry or
    "holds", form, B, Sq, the least and the most keys, window, causal)."""
    from repro_torch.configs import ARCHS, SHAPES
    from repro_torch.launch.cells import K4_REL, STEPS
    cfg = ARCHS["gemma3-1b"]
    H, Hkv, D, W = cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.sliding_window
    bf16, f32 = torch.bfloat16, torch.float32
    gen = torch.Generator(device="cuda")
    gen.manual_seed(33)

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    def cell(shape, wc=False):
        return next(c for c in CELLS if c[:2] == ("gemma3-1b", shape)
                    and c[3] == wc)

    cases, paths = {}, {}
    S = SHAPES["prefill_32k"][0]
    rows = [(0, CELL_ROWS), (S // 2 - CELL_ROWS // 2, S // 2 + CELL_ROWS // 2),
            (S - CELL_ROWS, S)]
    for dtype, atol, tag, where in (
            (bf16, 3e-2, "", cell("prefill_32k")), (f32, 2e-5, "_f32",
                                                    "holds")):
        B = 1 if where == "holds" else where[2]
        q, k, v = (randn((B, S, h, D), dtype) for h in (H, Hkv, Hkv))
        for kind, window in (("local", W), ("global", None)):
            key = f"prefill_32k{tag}:{kind}"
            cases[key] = flash_case(
                torch, np, f"cells_prefill_32k_{kind}{tag}", q, k, v,
                causal=True, window=window, decode=False, atol=atol,
                rows=rows, rel=K4_REL, min_kept=0)
            paths[key] = (where, cases[key]["form"], B, S, S, S, window,
                          True)
            emit(cases[key])
        del q, k, v
    S = SHAPES["decode_32k"][0]
    for name, key, where, keys in (
            ("cells_decode_32k_b64", "decode_32k:b64", cell("decode_32k"),
             S),
            ("cells_decode_32k_b128", "decode_32k:b128_window_cache",
             cell("decode_32k", True), S),
            ("cells_decode_rolling_b128", "decode_32k:b128_rolling",
             cell("decode_32k", True), W),
            ("cells_long_500k", "long_500k", cell("long_500k"),
             SHAPES["long_500k"][0])):
        B = where[2]
        q1 = randn((B, 1, H, D), bf16)
        kc, vc = (randn((B, keys, Hkv, D), bf16) for _ in range(2))
        line = flash_case(torch, np, name, q1, kc, vc, causal=False,
                          window=None, decode=True, atol=3e-2, rel=K4_REL,
                          min_kept=0)
        line["dropped_splits"] = dropped_splits(torch, q1, kc, vc, line,
                                                3e-2)
        del q1, kc, vc
        emit(line)
        cases[key] = line
        # a rolling cache's span stays at its slots; a full one grows a
        # key a step
        paths[key] = (where, "decode", B, 1, keys,
                      keys + (0 if keys == W else STEPS - 1), None, False)
    where = cell("train_4k")
    S, B = SHAPES["train_4k"][0], where[2]
    q, k, v = (randn((B, S, h, D), bf16) for h in (H, Hkv, Hkv))
    for kind, window in (("local", W), ("global", None)):
        key = f"train_4k:{kind}"
        cases[key] = flash_case(
            torch, np, f"cells_train_4k_{kind}", q, k, v, causal=True,
            window=window, decode=False, atol=3e-2, lse=True, rel=K4_REL,
            min_kept=0)
        paths[key] = (where, cases[key]["form"], B, S, S, S, window, True)
        emit(cases[key])
    del q, k, v
    torch.cuda.empty_cache()
    return cases, paths


def path_launches(shapes, form, B, sq, lo, hi, window, causal) -> int:
    """The launches of ``form`` at (B, sq, window, causal) over lo to hi
    keys in ``shapes``, the rows [form, B, Sq, Skv, H, Hkv, window,
    causal, n] of ``launch.cells``' ``k4_shapes``."""
    return sum(n for f, b, q, kv, _, _, w, c, n in shapes
               if (f, b, q, w, c) == (form, B, sq, window, causal)
               and lo <= kv <= hi)


def _cpu_step(torch, cfg, params, cache, batch, index):
    """decode_fn's step on the card and the same step on the CPU from a
    copy of the same weights and cache: (card logits, CPU logits)."""
    from repro_torch.models import build_forward
    from repro_torch.models.model import tree_map
    decode_fn = build_forward(cfg)[2]
    host = tree_map(lambda t: t.cpu(), cache)
    hp = tree_map(lambda t: t.cpu(), params)
    card = decode_fn(params, cache, batch, index=index)[0].float().cpu()
    cpu = decode_fn(hp, host, {k: v.cpu() for k, v in batch.items()},
                    index=index)[0].float()
    return card, cpu


def cells_holds(torch, np) -> dict:
    """The cells' paths held at model level on cuts of full width:
    gemma3-1b's one-period cut (CELL_HOLD_LAYERS layers, 5 local and 1
    global) in f32: prefill_fn at S 32768 (the SIMT form, its launches
    read), the same tokens through the cut cast to bf16 (the wgmma form)
    within CELL_BF16_ATOL of it; decode_fn at index 32767 (B 2), full
    caches and rolling window caches, and at 524287 (B 1), rolling window
    caches (the global layer's cache is full there too; the local
    layers' full 524288-slot caches would only lengthen the CPU's step),
    seeded as the cells seed them (``launch.cells.seeded_cache``), on the
    card against the same step on the CPU within CELL_CPU_TOL; one train
    step at S 4096
    (B 2) with K4 (the SIMT form with its lse) against the plain
    attention on the card, every gradient leaf within LEAF_REL of its
    largest; mamba2-1.3b cut to 2 layers in f32: prefill_fn at S 32768 on
    its first layer and a decode step at B 128 and at B 1 over seeded
    state, card against CPU within CELL_CPU_TOL.  Emits the line (each part's seconds under
    ``part_s``) and returns K4's launches on the f32 prefill by shape,
    as ``launch.cells``' ``k4_shapes``."""
    from repro_torch.configs import ARCHS, SHAPES
    from repro_torch.data.pipeline import DataConfig, _batch_at
    from repro_torch.kernels import registry
    from repro_torch.kernels.flash.ops import form_launches
    from repro_torch.launch.cells import k4_counts, seeded_cache
    from repro_torch.models import build_forward
    from repro_torch.models.convert import cast_params
    from repro_torch.models.model import tree_map
    from repro_torch.train import value_and_grad

    t0 = time.perf_counter()
    rng = np.random.RandomState(34)
    S = SHAPES["prefill_32k"][0]
    g = ARCHS["gemma3-1b"]
    cfg = g.replace(n_layers=CELL_HOLD_LAYERS, dtype="float32")
    n_local = sum(cfg.layer_window(i) is not None
                  for i in range(cfg.n_layers))
    params = card_params(torch, cfg, 1)
    toks = torch.from_numpy(rng.randint(2, g.vocab, (1, S)).astype(
        np.int32)).cuda()
    line = {"phase": "cells", "check": "holds", "gemma3_cut": {
        "n_layers": cfg.n_layers, "local": n_local}, "part_s": {}}

    def part(name):
        line["part_s"][name] = time.perf_counter() - t0 - sum(
            line["part_s"].values())

    def forms_were(what, **want):
        got = form_launches()
        if got != {f: want.get(f, 0) for f in got}:
            raise AssertionError(f"{what} launched K4's forms {got}, want "
                                 f"{want}")

    with torch.no_grad():
        registry.reset_launch_counts()
        f32 = build_forward(cfg)[1](params, {"tokens": toks}).float()
        forms_were("f32 prefill_fn at 32k", prefill_simt=cfg.n_layers)
        shapes = k4_counts()["k4_shapes"]
        part("f32_prefill")
        for index, B, wcs in ((SHAPES["decode_32k"][0] - 1, 2,
                               (False, True)),
                              (SHAPES["long_500k"][0] - 1, 1, (True,))):
            for wc in wcs:
                c = cfg.replace(window_cache=wc)
                cache = seeded_cache(c, B, index + 1, 35, "cuda")
                batch = {"tokens": torch.from_numpy(rng.randint(
                    2, g.vocab, (B, 1)).astype(np.int32)).cuda(),
                    "positions": torch.full((B, 1), index, device="cuda")}
                registry.reset_launch_counts()
                card, cpu = _cpu_step(torch, c, params, cache, batch, index)
                forms_were("f32 decode step", decode=cfg.n_layers)
                line[f"decode_{index}_{'window' if wc else 'full'}"] = dict(
                    _held(torch, "f32 decode step, card against CPU", card,
                          cpu, list(range(B)), CELL_CPU_TOL, CELL_CPU_TOL),
                    batch=B, index=index)
                del cache
            part(f"decode_{index}")
    torch.cuda.empty_cache()
    # one f32 train step at S 4096, K4 (forward and remat recompute)
    # against the plain attention
    seq = SHAPES["train_4k"][0]
    b = {k: torch.from_numpy(v).cuda() for k, v in _batch_at(
        DataConfig(seq, 2, g.vocab), 0, 0, 2).items()}
    registry.reset_launch_counts()
    la, ga = value_and_grad(build_forward(cfg)[0], params, b)
    torch.cuda.synchronize()
    forms_were("f32 train step", prefill_simt=2 * cfg.n_layers)
    lb, gb = value_and_grad(build_forward(cfg.replace(
        attn_impl="naive"))[0], params, b)
    line["train_step"] = dict(_grads_held(
        torch, "f32 train step at 4096, K4 against the plain attention",
        la, ga, lb, gb, LEAF_REL), batch=2, seq=seq)
    del ga, gb
    part("train_step")
    torch.cuda.empty_cache()
    # the same 32k tokens through the cut in bf16
    with torch.no_grad():
        p16 = cast_params(params, cfg.replace(dtype="bfloat16"))
        registry.reset_launch_counts()
        bf = build_forward(cfg.replace(dtype="bfloat16"))[1](
            p16, {"tokens": toks}).float()
        forms_were("bf16 prefill_fn at 32k", prefill_wgmma=cfg.n_layers)
    err = float((bf - f32).abs().max())
    if not (bool(torch.isfinite(bf).all()) and err <= CELL_BF16_ATOL):
        raise AssertionError(f"bf16 prefill_fn at 32k against f32: max abs "
                             f"diff {err}")
    line["bf16_vs_f32_prefill"] = {"batch": 1, "seq": S, "max_abs_diff": err,
                                   "max_abs_logit": float(f32.abs().max()),
                                   "atol": CELL_BF16_ATOL}
    del params, p16, bf, f32
    part("bf16_prefill")
    torch.cuda.empty_cache()
    # mamba2-1.3b cut to 2 layers in f32, its first layer alone for the
    # 32k prefill (the CPU's side: 20 s at 2 layers on an H100's host)
    m = ARCHS["mamba2-1.3b"].replace(n_layers=2, dtype="float32")
    pm = card_params(torch, m, 2)
    toks = torch.from_numpy(rng.randint(2, m.vocab, (1, S)).astype(
        np.int32)).cuda()
    m1 = m.replace(n_layers=1)
    p1 = layer_cut(pm, m, m1, 0)
    pf = build_forward(m1)[1]
    with torch.no_grad():
        card = pf(p1, {"tokens": toks}).float().cpu()
        cpu = pf(tree_map(lambda t: t.cpu(), p1),
                 {"tokens": toks.cpu()}).float()
        del p1
        line["mamba2_prefill"] = dict(_held(
            torch, "mamba2 f32 prefill_fn at 32k, card against CPU", card,
            cpu, [0], CELL_CPU_TOL, CELL_CPU_TOL), batch=1, seq=S,
            n_layers=m1.n_layers, ssd_chunks=S // m.ssm_chunk)
        part("mamba2_prefill")
        for shape in ("decode_32k", "long_500k"):
            B, index = cell_batch("mamba2-1.3b", shape), SHAPES[shape][0] - 1
            cache = seeded_cache(m, B, 1, 36, "cuda")
            batch = {"tokens": torch.from_numpy(rng.randint(
                2, m.vocab, (B, 1)).astype(np.int32)).cuda(),
                "positions": torch.full((B, 1), index, device="cuda")}
            card, cpu = _cpu_step(torch, m, pm, cache, batch, index)
            line[f"mamba2_{shape}"] = dict(_held(
                torch, "mamba2 f32 decode step, card against CPU", card, cpu,
                list(range(B)), CELL_CPU_TOL, CELL_CPU_TOL), batch=B,
                index=index)
            del cache
    del pm
    torch.cuda.empty_cache()
    part("mamba2_decode")
    line["s"] = time.perf_counter() - t0
    emit(line)
    return shapes


def cell_k4_want(cfg, kind: str, batch: int, seq: int, steps: int):
    """K4's launches a cell's timed run must count by form, and the forms
    whose kernels its profiled call must run: (counters by form, sorted
    forms)."""
    import torch
    from repro_torch.kernels.flash.ops import decode_kernel, decode_split
    attn = [i for i in range(cfg.n_layers) if cfg.layer_kind(i) == "attn"]
    if not attn:
        return form_counts(), []
    form = bf16_prefill_form(cfg)
    if kind == "prefill":
        return form_counts(**{form: len(attn)}), [form]
    if kind == "train":
        n_per = cfg.n_layers // cfg.period
        per = [i for i in attn if i < cfg.period]
        return form_counts(**{form: len(attn) + n_per * len(per)}), [form]
    kernels = set()
    g = cfg.n_heads // cfg.n_kv_heads
    for i in attn:
        w = cfg.layer_window(i)
        span = seq if w is None else min(w, seq)
        kern = decode_kernel(torch.bfloat16, g, decode_split(
            span, batch * cfg.n_kv_heads)[1])
        kernels.update(("decode_split", "decode_merge")
                       if kern == "decode_split" else (kern,))
    return form_counts(decode=len(attn) * steps), sorted(kernels)


def cells_phase(torch, np):
    """The cells at full width and depth (launch/cells.py's run_cell, one
    line each), K4 at their shapes first (cells_k4_cases), then the
    model-level holds (cells_holds).  Each cell's K4 counters (set to 0
    just before its timed call) must be cell_k4_want's, and the forms
    whose kernels its profiled call ran too.  Returns K4's cases and, by
    the same key, their launches on their paths: the counters' launches
    at each case's form and shape (``path_launches``), none of them 0."""
    from repro_torch.configs import ARCHS
    from repro_torch.launch.cells import STEPS, run_cell
    torch.backends.cuda.matmul.allow_tf32 = False   # f32 stays f32
    t_phase = time.perf_counter()
    cases, paths = cells_k4_cases(torch, np)
    shapes = {"holds": cells_holds(torch, np)}
    lines = []
    for entry in CELLS:
        arch, shape, batch, wc = entry
        line = run_cell(arch, shape, batch, window_cache=wc, seed=0,
                        device="cuda")
        counts, kernels = cell_k4_want(ARCHS[arch], line["kind"], batch,
                                       line["seq"], STEPS)
        if line["k4_launches"] != counts or line["k4_kernels"] != kernels:
            raise AssertionError(f"{arch} x {shape} launched K4 "
                                 f"{line['k4_launches']} (the profiler saw "
                                 f"{line['k4_kernels']}), want {counts} "
                                 f"({kernels})")
        shapes[entry] = line["k4_shapes"]
        emit({"phase": "cells", **line})
        lines.append(line)
        torch.cuda.empty_cache()
    launches = {key: path_launches(shapes[where], *rest)
                for key, (where, *rest) in paths.items()}
    if not all(launches.values()):
        raise AssertionError(f"K4 cases with no launch on their path: "
                             f"{launches}")
    emit({"phase": "cells", "cells": [
        {k: ln[k] for k in ("arch", "shape", "batch", "ref_batch",
                            "window_cache", "host_ms", "device_ms",
                            "tokens_per_s", "peak_gb")} for ln in lines],
        "case_launches": launches,
        "nvidia_smi": smi("name,power.limit"),
        "phase_s": time.perf_counter() - t_phase})
    return cases, launches


def main() -> int:
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False: no card",
              file=sys.stderr)
        return 2
    import numpy as np
    from repro_torch.kernels import _build, registry

    name_power = smi("name,power.limit")
    max_clock_mhz = float(smi("clocks.max.sm").split()[0])
    props = torch.cuda.get_device_properties(0)
    peak_int_ops = props.multi_processor_count * INT32_LANES_PER_SM \
        * max_clock_mhz * 1e6
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    emit({"phase": "device", **device, "torch": torch.__version__,
          "cuda": torch.version.cuda, "sms": props.multi_processor_count,
          "max_sm_clock_mhz": max_clock_mhz,
          "peak_int32_ops_per_s": peak_int_ops, "nvidia_smi": name_power})
    print(name_power, flush=True)

    def timed(phase, fn, *args):
        """fn(*args), then a line with the phase's wall seconds."""
        t0 = time.perf_counter()
        out = fn(*args)
        emit({"phase": "seconds", "of": phase,
              "s": time.perf_counter() - t0})
        return out

    paper = timed("compile", paper_designs)
    designs = mk_designs(paper)
    bench = bench_designs()
    ext = external_designs()
    timed("build", build_phase, designs,
          {**{f"bench_{a}": d for a, (_f, d) in bench.items()},
           **{f"ext_{k}": d for k, (_u, d, _l) in ext.items()}})
    timed("hw", hw_phase, paper)
    # the cycle kernel's checks and its own path (counters set to 0 just
    # before the path, read just after)
    kern_cycle = timed("cycle", cycle_phase, torch, np, paper, peak_int_ops)

    kern = timed("kernel", kernel_phase, torch, np, peak_int_ops)
    kern_mk = timed("megakernel", megakernel_phase, torch, np, designs,
                    peak_int_ops)
    kern_k4 = timed("flash", flash_phase, torch, np)
    registry.reset_launch_counts()          # the main path's launches only
    path = timed("path", path_phase, torch, np, paper)
    launches = {n: e.launches() for n, e in registry.KERNELS.items()}
    # each app's bench_case against the executor, then the External
    # pipelines (their own path: counters set to 0 just before it)
    timed("executor", executor_case, torch, np, bench)
    registry.reset_launch_counts()
    timed("external", external_case, torch, np, ext)
    # the static verifier on the card, then the apps' frame server (its
    # counters set to 0 just before the served traffic, read just after)
    timed("verify", verify_phase, torch, np, paper)
    timed("serve", serve_phase, torch, np, paper)
    # the model's paths: llm_phase and each family reset the counters just
    # before the f32 prefill_fn call (the SIMT form's path) and just before
    # the bf16 prefill_fn call and serving (the tensor-core and decode
    # forms'); each K4 entry of the kernels line reports one path's
    # launches beside the case at that path's shapes, so no launch is
    # counted twice
    _, llm_launches = timed("llm", llm_phase, torch, np)
    _, fam_launches = timed("families", families_phase, torch, np)
    # the training path: its counters set to 0 just before launch/train's
    # loop and read just after
    _, kern_train, train_launches = timed("train", train_phase, torch, np)
    # the families' training paths: counters set to 0 before each step and
    # read after it
    kern_fam_train, fam_train_launches = timed(
        "train_families", train_families_phase, torch, np)
    # the reference's shape cells: each cell's counters set to 0 just
    # before its timed call and read just after (launch/cells.py)
    kern_cells, cell_launches = timed("cells", cells_phase, torch, np)
    from repro_torch.configs import ARCHS
    llm_form = bf16_prefill_form(ARCHS[LLM_ARCH])
    for arch, n in fam_launches.items():
        forms = family_forms(arch) if arch in FAMILY_K4 else ()
        if any(n[f] != 0 for f in n if f not in forms) or \
                any(n[f] == 0 for f in forms):
            raise AssertionError(f"{arch}: K4 launched {n} on its path, "
                                 f"want exactly the forms {forms}")
    launches["flash_attention"] = sum(llm_launches.values()) + sum(
        sum(n.values()) for n in fam_launches.values()) + sum(
        train_launches.values()) + sum(
        sum(n.values()) for n in fam_train_launches.values()) + sum(
        cell_launches.values())
    launches["cyclesim"] = kern_cycle["launches"]
    for n, count in launches.items():
        if count == 0:
            raise AssertionError(f"kernel {n} was not launched on the path")
    for app in MK_APPS:
        if path[app]["megakernels"] != 1 or path[app]["launches"] == 0:
            raise AssertionError(f"{app}: no megakernel on the path "
                                 f"({path[app]['plan']})")

    def k4_line(name, k, n_launch):
        source = {"decode": "flash_decode.cu",
                  "prefill_wgmma": "flash_attn_wgmma.cuh"}.get(k["form"])
        source = {"source": f"src/repro_torch/csrc/{source}"} \
            if source else {}
        # a decode entry's split and the kernels the profiler saw run it
        # (decode_kernel's: the mma kernel at the wide groups)
        decode = {"split": k["split"]} if "split" in k else {}
        return dict(line(name, registry.get_kernel("flash_attention"), k,
                         n_launch), **source, **decode,
                    kernels=k["kernels"],
                    equal=False, tolerance=k["tolerance"], case=k["case"],
                    share_of_bound=k["share_of_bound"],
                    graph_ms=k["graph_ms"],
                    library_graph_ms=k["library_graph_ms"])

    def line(name, e, k, n_launch):
        return {"name": name, "route": "cuda", "source": e.source,
                "replaces": e.replaces, "tpu": TPU_KERNELS[e.name],
                "launches": n_launch, "equal": k["max_abs_err"] == 0,
                "max_abs_err": k["max_abs_err"], "ms": k["ms"],
                "call_ms": k["call_ms"],
                "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
                "bound_by": k["bound_by"], "library_ms": k["library_ms"]}

    mk = registry.get_kernel("megakernel")
    emit({"phase": "total", "s": time.perf_counter() - t_start})
    emit({"kernels": [line(n, registry.get_kernel(n), kern[n], launches[n])
                      for n in ("conv2d", "sad")]
          + [dict(line(f"megakernel:{app}", mk, kern_mk[app],
                       path[app]["launches"]),
                  segment=kern_mk[app]["segment"],
                  max_ulp=kern_mk[app]["max_ulp"])
             for app in MK_APPS]
          + [k4_line(f"flash_attention:{form}", kern_k4[form],
                     llm_launches[form])
             for form in (llm_form, "prefill_simt", "decode")]
          + [k4_line(f"flash_attention:{form}:{arch}",
                     kern_k4[f"{form}:{key}"], fam_launches[arch][form])
             for arch, (key, _) in FAMILY_K4.items()
             for form in family_forms(arch)]
          + [dict(k4_line(f"flash_attention:{llm_form}:train", kern_train,
                          train_launches[llm_form]),
                  lse_max_abs_err=kern_train["lse_max_abs_err"],
                  lse_tolerance=kern_train["lse_tolerance"])]
          + [dict(k4_line(f"flash_attention:{family_forms(arch)[0]}:train:"
                          f"{arch}", kern_fam_train[key],
                          fam_train_launches[arch][family_forms(arch)[0]]),
                  lse_max_abs_err=kern_fam_train[key]["lse_max_abs_err"],
                  lse_tolerance=kern_fam_train[key]["lse_tolerance"])
             for arch, key in (("granite-moe-3b-a800m", "granite"),
                               ("deepseek-v2-236b", "mla"))]
          + [dict(k4_line(f"flash_attention:{k['form']}:cells:{key}", k,
                          cell_launches[key]),
                  **({"lse_max_abs_err": k["lse_max_abs_err"],
                      "lse_tolerance": k["lse_tolerance"]}
                     if k.get("lse") else {}))
             for key, k in kern_cells.items()]
          + [dict(line("cyclesim", registry.get_kernel("cyclesim"),
                       kern_cycle, kern_cycle["launches"]),
                  case=f"flow 1920x1080, 1 frame, first "
                       f"{PAPER_CUT_HORIZON} cycles",
                  **{k: kern_cycle[k] for k in (
                      "ns_per_cycle", "chain_bound_ms",
                      "share_of_chain_bound", "form", "slots", "threads",
                      "ring", "smem_bytes", "split_clocks_per_loop",
                      "parent_split")})]})
    emit({"ok": True, "device": device})
    return 0


if __name__ == "__main__":
    sys.exit(main())
