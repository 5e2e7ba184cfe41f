#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA Hopper card.

    python3 chip_smoke.py [--report PATH] [--profile]

Drives the port (``src/repro_torch``) on the card, in twenty phases,
each printing one line that starts with ``phase``:

1. device and build: the card's name and power limit (nvidia-smi), and
   the build of every CUDA source with nvcc, timed;
2. every kernel against its plain PyTorch version on the card, at the
   serving path's shapes (M in {8, 256} rows against each projection
   shape of qwen2-0.5b, a ragged shape, a per-group case):
   ``fused_dequant_mm`` within 2 gamma_K (|x| @ |w|) elementwise (see
   ``csrc/fused_dequant.cu``), the three exact kernels ``torch.equal``,
   ``mp_matmul`` bit-equal in three IPU configs and groups of 3, 40
   and 64, both modes and both roundings, on "wide" f16 operands with
   zeros, subnormals and an all-zero K-group, on group maxima that rise
   (every group a record) and fall, under forced launch plans, at
   misaligned pointers and ragged M, N and K, and over repeated
   launches and CUDA-graph replays; ``qmm`` (the tensor-core kernel)
   also at M in {1, 8, 16, 17, 256}, ragged shapes, misaligned pointers, all -128
   operands and a forced split of 1; ``fused_qmm`` (int8, int4 and
   int4_packed) and ``qmm_packed`` (their shared tensor-core kernel)
   also at M in {1, 17}, ragged shapes with 1, 3 and 8 K ranges,
   misaligned pointers, -128 weights, packed nibbles 0x7 and 0x8,
   clamped activations and quantize ties, forced and default plans,
   and bit-identical over repeated launches and CUDA-graph replays;
   ``fused_dequant_mm`` also at M in
   {1, 16, 17}, G = 7 and 38, misaligned pointers, each kind's largest
   codes, the fewest and the most K ranges, K deeper than one launch
   takes, and bit-identical over repeated launches and CUDA-graph
   replays; then each kernel's time
   over one decode step's projections (24 layers x 7 projections at
   M = 8), eager and replayed from a CUDA graph, beside its plain
   version's (for ``mp_matmul``: one layer's seven projections), the
   card's least time for the same bytes and operations, and a library
   call where one computes the same function (``torch._int_mm`` for
   ``qmm``, eager and replayed, at M = 8 on rows padded to 32 and at
   256 rows in turns with the kernel); ``fused_qmm`` over int8 rows and
   over packed int4 (the two exact routes); ``fused_dequant_mm``,
   ``fused_qmm``, ``qmm_packed`` and ``mp_matmul`` also at 256 rows over
   one layer and per call on the host; and the launch plans of ``qmm``,
   ``fused_qmm``, ``fused_dequant_mm`` and ``mp_matmul`` compared per
   projection shape; then every kernel at the projection shapes of
   gemma2-9b and qwen3-moe-30b-a3b (K and N up to 14336) at M in {8,
   256} (``mp_matmul`` at gemma2's wk, M = 8), and at those of
   rwkv6-1.6b, recurrentgemma-9b, internvl2-1b's projector and
   seamless-m4t-medium (also at M = 1024: its encoder and its
   cross-attention's K and V), with each shape's launch plans printed;
3. full-width qwen2-0.5b (24 layers, d_model 896, vocab 151936, random
   weights from a seed) served by the port's ``ServingEngine`` under
   ``int4_serving`` with calibrated act scales and the fused executors:
   16 requests at decode_block 1 and 4, identical greedy streams, then
   briefly under ``int8_serving``. The engine replays its programs from
   CUDA graphs: each route serves a first wave (captures), the same
   requests again (replays only) and an eager wave (the engine's
   private eager calls), all three with the same streams and the same
   kernel launches, and prints tok/s, TTFT, captures, replays, capture
   seconds and ``torch.cuda.memory_reserved`` for each; one replay of
   each of the four programs (prefill wave, decode step, selection,
   decode block), greedy and sampled, is held bit-identical to its
   eager run on cloned state;
4. the exact int routes at full width: fused on vs off under
   ``fidelity_int8`` and an exact int4 policy, identical greedy streams,
   graphed against eager as in phase 3;
5. one chunked prefill and one decode step at full width under
   ``int8_serving`` on the card (kernels) and on the CPU (plain
   versions), logits and caches compared;
6. full-width qwen2-0.5b served under ``fidelity_fp16_ipu``: every
   projection through ``mp_matmul`` (the paper's bit-exact IPU(w)
   emulation), 8 requests at decode_block 1 and 4, graphed against
   eager as in phase 3, identical greedy streams, no other kernel
   launched, and the largest |x| that entered ``mp_matmul``;
7. full-width qwen2-0.5b served from the committed plan
   (``results/plans/qwen2_0_5b.json``, ``act_calibration="auto"`` takes
   its scales): its routes, exactly 6 x 24 ``fused_dequant_mm`` launches
   per decode step and no other kernel; a two-replica fleet (the plan
   and ``bf16``) behind the plan-aware router, 16 requests (8-64-token
   prompts, 16 new tokens, every other one tagged "accuracy"), each
   placed where the reference's rule puts it (tagged ones on bf16), its
   greedy stream equal to its replica serving it alone, a first and a
   warm wave, then the same requests under online cost correction; the
   replicas' ``replica_cost`` and its seconds; an ``int4_serving``
   engine saved with ``save_engine_checkpoint`` and rebuilt by
   ``build_engine`` on the card with no weight quantization, no
   calibration, bit-equal leaves and the saved engine's streams, and a
   flipped byte refused with ``ChecksumError`` naming its leaf;
8. qwen3-moe-30b-a3b at full width (d_model 2048, 32/4 heads of 128,
   128 experts, top-8, d_expert 768, vocab 151936, untied) cut to 16 of
   its 48 layers (48 layers of f32 parameters are about 122 GB), random
   weights from a seed, calibrated and prepared by one engine under
   ``int4_serving`` after which only the prepared tree is kept (the raw
   f32 expert stacks are released; ``memory_allocated`` before and
   after), then 8 requests (8-64-token prompts, 8 new tokens) at
   decode_block 1 and 4, each graphed (first and warm waves) against
   eager as in phase 3, identical greedy streams, exactly 4 x 16
   ``fused_dequant_mm`` launches per decode step and no other kernel;
   tok/s, TTFT, ``memory_reserved``, ``max_memory_allocated``, the
   (token, k) assignments the eager wave's prefill dropped at capacity;
   layer 0's MoE block alone on the card and on the CPU for a 32-token
   chunk and a decode step (identical expert ids, queue positions and
   ``fits``; outputs within phase 5's first-layer tolerance); and a
   replayed decode step against the expert stacks' dequantization
   alone;
9. gemma2-9b whole at full width (42 layers, d_model 3584, 16/8 heads of
   256, d_ff 14336, vocab 256000, tied; local/global attention,
   softcaps, zero-centered RMSNorm, post norms, GeGLU) under
   ``int4_serving``, prepared the same way, 4 requests at decode_block
   1 and 4 graphed against eager, identical streams, exactly 7 x 42
   ``fused_dequant_mm`` launches per decode step, and a replayed decode
   step's time;
10-12. internvl2-1b (vlm), rwkv6-1.6b (rwkv) and recurrentgemma-9b
   (griffin) whole at full width, random weights from a seed, under
   ``int4_serving``, calibrated and prepared the same way; 6, 6 and 4
   requests (8-32-token prompts, 8 new tokens) admitted by teacher
   forcing (``teacher_forced_tokens`` equal to the summed prompt length
   less one a request, no prefill wave), served graphed (a first and a
   warm wave, the warm one from a fresh state for rwkv and griffin)
   against eager with identical streams and launches, at decode_block 1
   and 4 for vlm and 1 for the others (4 asserted to raise); exactly
   168, 192 and 240 ``fused_dequant_mm`` launches per decode step and no
   other kernel; rwkv's layer 0, each block of griffin's first (rec,
   rec, attn) group (with what each of its projections saw) and the
   group chained, one decode step from a random state, and internvl2's
   prefill behind 256 patches
   (its projector through ``fused_dequant_mm`` at 512 rows), on the card
   against the CPU; tok/s, TTFT, a replayed decode step's time and
   ``memory_allocated`` raw, prepared and peak;
13. seamless-m4t-medium (encdec) whole at full width (12 encoder and 12
   decoder layers of 1024, 16 heads of 64, d_ff 4096, vocab 256206,
   frontend 160), random weights from a seed: first a decode step after
   a prefill of S tokens against a prefill of S + 1 at f32 compute
   (bf16 policy; ``test_prefill_decode_consistency``'s 2e-2 as a
   relative RMS, on the card and on the CPU), then
   calibrated (random path, with frames) and prepared under
   ``int4_serving`` and ``int8_serving`` with only the prepared trees
   kept; per policy, 8 rows of 32-token prompts behind 128 frames, 16
   greedy new tokens, cache 64, through the fused executors: exactly 217
   ``fused_dequant_mm`` launches a prefill and 132 a decode step (the
   cross-attention's K and V are projected again every step) and no
   other kernel, the decode steps eager and replayed from one CUDA graph
   (equal streams, bit-identical logits), the first encoder and decoder
   blocks card against CPU within phase 5's first-layer tolerance and
   the whole prefill's logits and encoder output within its whole-model
   gates; prefill and decode step times (eager, replayed), tok/s of a
   greedy run, ``memory_allocated`` raw, prepared and peak;
14. the serving smoke (``repro_torch.serving.smoke.main`` with the
   reference's defaults and ``--trace``) on the card: exit 0, every
   contract of the reference's smoke, and a trace
   ``validate_chrome_trace`` finds no fault in; its contract numbers.
15. the paper's studies and the examples on the card: Fig. 3's whole
   grid (48 cells of 400 x 64 f16 inner products, no cache) through
   ``repro_torch.core.ipu`` on the card and on the CPU, its rows equal
   (``json.dumps(sort_keys=True)``) and its five claims true, the
   seconds on each device; every cell's 400 raw accumulators (``hi``,
   ``lo``, exponent) on the card equal to the CPU's, since the rows are
   medians; for each cell, the diagonal of ``mp_matmul``
   over the cell's operands bit-equal to ``fp16_inner_product`` on the
   card (48 launches); ``repro_torch.exp.smoke`` (cold, warm and
   ``--jobs 2``); ``repro_torch.examples.quickstart`` printing the same
   text on the card as with ``--device cpu``; ``serve_lm`` serving
   full-width qwen2-0.5b (weights from seed 0) under ``int4_serving``
   calibrated at decode_block 4 (``fused_dequant_mm`` the only kernel
   launched), from ``results/plans/qwen2_0_5b.json``, and as a router
   over ``int8_serving`` and that plan, every request completing its
   ``max_new`` tokens; tok/s, TTFT and launches per route; and
   ``repro_torch.tools.trace_report`` over phase 14's trace, exit 0;
16. the precision planner: ``python -m repro_torch.autotune search``
   for qwen2-0.5b at full shapes with the default candidates (six
   modes, fp16_ipu at w 12/16/20/28) and the divergence probe on the
   card, cold with ``--jobs 1`` (every fp16_ipu probe below w = 28
   through ``mp_matmul``: exactly 3 widths x 7 projections x 2 layers
   of the reduced probe model, 42 launches, and no other kernel; each
   of the 42 calls recorded and held bit-equal to its plain version on
   its own operands), then warm with ``--jobs 2`` (0 points executed,
   the same plan file), then the same search on the CPU in its own
   cache: cycles and efficiency rows ``==``, accuracy rows' divergence
   within the probe's bound (``objectives.PROBE_KL_RTOL`` and
   ``PROBE_KL_ATOL``), and whether the CPU selects the same assignment
   (printed); the probe's numpy-drawn weights and tokens hashing to
   ``PROBE_DRAW_SHA256``, the value ``tests/test_torch_autotune.py``
   holds on the CPU (the torch draw's hash printed beside it);
   ``score --plan`` giving back the plan's metrics from the warm cache,
   ``repro_torch.tools.plan_report`` rendering it (exit 0); then
   full-width qwen2-0.5b (weights from seed 0) served from the card's
   plan (``plan:<file>``,
   ``act_calibration="auto"``), 8 requests at decode_block 1 and 4,
   graphed against eager as in phase 3, identical greedy streams, each
   decode step's launches equal to the count the plan's rules imply and
   no other kernel; tok/s, TTFT, the cold and warm search seconds, and
   whether the plan equals the committed reference plan (printed; the
   probe's weights are another draw than the reference's).
17. the serving fabric at full width: qwen2-0.5b (weights from seed 0)
   prepared and calibrated once under ``int4_serving`` (8 slots, a
   256-token cache, decode_block 4), saved as a serve-ready checkpoint
   and rebuilt by ``build_engine`` with 0 weight quantizations, 0
   calibrations and the saved engine's streams; then a port
   ``Controller`` on a ManualClock with two in-process workers and one
   TCP subprocess worker (``python -m repro_torch.fabric worker
   --register --resume``, its checkpoint from the RegisterAck) on the
   same card serves phase 3's 16 requests twice (a first and a warm
   wave): streams equal to the single engine's, online correction on
   transported stats, every worker routed; then an in-process worker
   dies silently mid-flight (an injected ``WorkerFailure``, declared
   dead by the heartbeat timeout) and then the subprocess is killed
   mid-flight (``proc.kill()``): each requeues (> 0), loses nothing and
   keeps the streams; then the chaos contract
   (``repro_torch.fabric.chaos_smoke.check_contract``) at full width:
   drops, duplicates, partial writes, a heartbeat stall, a partition
   and a kill with zero loss and exact streams, the partition alone
   resumed in place (requeued 0) and two runs identical; exactly 7 x
   24 ``fused_dequant_mm`` launches per worker decode step and no other
   kernel; seconds per part, fleet tok/s beside phase 3's warm
   single-engine tok/s, the controller's host ms per tick, the codec's
   microseconds per StatsSnapshot and Heartbeat encode and decode, and
   seconds from each kill to the last completion.
18. training on the card, which launches none of the five kernels
   (asserted: every counter stays 0 through the phase): (a) qwen2-0.5b
   at full width (weights from seed 0) through the trainer CLI's code
   path (``repro_torch.launch.train.run``: FaultTolerantLoop, a
   checkpoint at the last step, the state as DTensors on the CLI's
   (1, 1) mesh), ``bf16, batch 8 of 128 tokens of
   the Markov stream, 30 steps at ``--lr 3e-3``: every loss finite,
   every step's ``finite`` 1, the mean of the last five losses below
   the first five's; the median step ms over steps 2-29 (the card
   synchronized around each), tokens/s, the first step's seconds,
   ``max_memory_allocated``, the losses beside log(151936) and the
   chain's log 16, and the last step under ``torch.profiler`` (device
   busy ms, the top eight kernels, the idle share against the median
   step); (b) ``repro_torch.examples.train_lm`` at its
   defaults (it asserts the last loss below the first; whether it
   reached 0.8 of the first is printed); (c) one step of each reduced
   family (qwen2, rwkv6, recurrentgemma, mixtral, internvl2,
   seamless-m4t; numpy-drawn weights and batch) on the card and on the
   CPU under the trainer's numerics: loss, every gradient leaf and the
   parameters after the step within the family's bounds
   (``TRAIN_CARD_VS_CPU``, set from this comparison's own readings);
   (d) the CLI on reduced qwen2-0.5b killed by ``fail_at_step`` and
   resumed: losses and final state bit-equal to an uninterrupted run;
   (e) full-width qwen2-0.5b steps from one state under the trainer's
   numerics, without and with torch's deterministic algorithms, in
   five pairs of alternating order: the median and quartiles of each
   mode's step ms, and whether the runs are bit-equal (the trainer's,
   without the mode, must repeat and give the mode's bits).
19. sharding on a one-card mesh: a one-rank NCCL process group and a
   (1, 1) ("data", "model") ``DeviceMesh``, destroyed at the end. (a)
   full-width qwen2-0.5b, ``bf16``, phase 18's state at step 0 and its
   first batches: 3 steps of ``make_train_step(api, tc, mesh)`` on
   DTensors (every leaf asserted one) beside 3 plain steps, twice each
   in turns: equal losses and the state within ``MESH_TRAIN_PARAM_BOUND``
   (0: bit-equal); each step's ms against the plain step's and phase
   18's, and each run's peak memory above its start; (b)
   ``make_serve_fns`` under ``fidelity_fp16_ipu`` and ``fidelity_int8``
   (raw weights): 8 prompts prefilled, 16 greedy tokens, streams equal
   to the plain ``api.prefill``/``api.decode_step`` loop's; ``mp_matmul``
   and ``qmm`` launched on local shards exactly 168 times a forward
   (asserted), tok/s of both; (c) a checkpoint of the plain state
   (full widths, 2 layers) restored onto the mesh by
   ``FaultTolerantLoop.run(shardings=)``, 4 steps, then the same run
   killed at step 3 and resumed by a new loop: losses and state
   bit-equal to the uninterrupted run's. Its launches join the kernel
   table.
20. the block-FP pod exchange and the dry-run, which launch none of
   the five kernels (asserted). The gradients of one plain full-width
   qwen2-0.5b step (``bf16``, phase 18's state at step 0 and its first
   batch of 8 x 128): (a) ``blockfp_quantize``/``blockfp_dequantize``
   at w = 8 and 4 on the card bit-equal to the CPU's for every leaf,
   and the whole tree's ms against its byte bound; (b) on a one-rank
   NCCL group and a (1, 1, 1) ("pod", "data", "model") mesh,
   ``make_pod_exchange`` with f32, int8 and blockfp8, outputs bit-equal
   to the same functions on the CPU (a one-rank gloo group), the
   recorder seeing the all-gathers (0 wire bytes at group size 1), ms
   per exchange; (c) ``TrainConfig(compression="blockfp8")`` refused
   on that mesh and, on a (1, 1) mesh, the ``"none"`` step's loss and
   state bit for bit; (d) on a fake process group of one rank, the
   dry-run's per-device estimate of the same 8 x 128 step against one
   real plain step: its Parameter and Optstate bytes equal to the
   state's on the card, and the estimate within ``DRYRUN_MEMORY_RATIO``
   of the step's ``max_memory_allocated`` above what was resident
   before it plus the state and batch bytes (earlier phases' leftovers
   drop out), its activations and temporaries within the same window
   of that increment; and the production cell (qwen2-0.5b
   ``train_4k`` on a fake 256-rank (16, 16) mesh) through ``python -m
   repro_torch.launch.dryrun`` in a process of its own to ``status:
   "ok"``, its seconds. The timed parts of (a) and (b) run first,
   alone; the cell then traces in a process of its own beside (c),
   (d) and the CPU's side of (a) and (b), which time nothing and get
   all but one of the host's cores.

Phases 8-13 assert that f32 matmuls do not run on TF32 (a TF32
router moves expert selection); each phase frees its model before the
next.

Any failure raises and exits non-zero. The line before the last is
``{"kernels": [...]}`` (the kernel table), the last line
``{"ok": true, "device": {...}}``. Without a CUDA device, or without
the repository around it, it exits non-zero before printing either.
``--report`` also writes every number to a JSON file; ``--profile``
adds a torch.profiler breakdown of one decode block, replayed from its
graph and run eagerly, under ``int4_serving`` (phase 3),
``fidelity_int8`` fused (phase 4), ``fidelity_fp16_ipu`` (phase 6) and
``int4_serving`` for the models of phases 8-12, and (phase 13) one
replayed decode step of seamless-m4t-medium under each policy.
"""
import argparse
import contextlib
import dataclasses
import hashlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))

# published dense peaks (NVIDIA data sheets): memory bytes/s, f32 FMA
# outside the tensor cores FLOP/s, int8 tensor-core OP/s, SMs (the int32
# CUDA-core peak is SMs x 64 lanes x the SM clock nvidia-smi reports)
CARDS = {
    "H100 PCIe": {"bytes_per_s": 2.0e12, "f32": 51e12, "int8": 1513e12,
                  "sms": 114},
    "H100 NVL": {"bytes_per_s": 3.9e12, "f32": 60e12, "int8": 1671e12,
                 "sms": 132},
    "H100": {"bytes_per_s": 3.35e12, "f32": 67e12, "int8": 1979e12,
             "sms": 132},
    "H200": {"bytes_per_s": 4.8e12, "f32": 67e12, "int8": 1979e12,
             "sms": 132},
}
INT32_LANES_PER_SM = 64
U32 = 2.0 ** -24
# card vs CPU at full width (phase 5). The two differ in the order of
# every f32 sum, so a bf16 rounding can flip (2^-8 of the value), and so
# can an int8 act code at a rounding boundary (1/127 of the input's
# range). Random weights amplify such a difference layer by layer (the
# phase prints the K cache's relative RMS difference for every layer),
# so the first layer, before any amplification, is held to 1% relative
# RMS, and the logits only to what tells a faithful computation from a
# wrong one: 10% of their range elementwise and 15% relative RMS. A
# wrong decode, scale or layout moves them by their whole range.
FIRST_LAYER_REL_RMS = 1e-2
CPU_LOGIT_MAX_OF_RANGE = 0.10
CPU_LOGIT_REL_RMS = 0.15

REPORT = {"phases": {}}
REPORT_PATH = []
T_START = time.perf_counter()


def log(phase, **numbers):
    numbers["elapsed_s"] = time.perf_counter() - T_START
    REPORT["phases"][str(phase)] = numbers
    print(f"phase {phase} " + json.dumps(numbers, default=float), flush=True)
    write_report()


def write_report():
    """Rewrite the --report file (after every phase, so a failure still
    leaves what was measured before it)."""
    for path in REPORT_PATH:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            json.dump(REPORT, f, indent=1, default=float)


def card_rates(name):
    for key in CARDS:                 # most specific names first
        if key in name:
            return key, CARDS[key]
    return "H100", CARDS["H100"]


def median_ms(fn, reps=10, warm=2):
    """Median of ``reps`` CUDA-event timings of ``fn`` after warm-up."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def capture(fn):
    """(``fn`` captured once in a CUDA graph, its output tensors), warmed
    up on a side stream first, as capture wants."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    return graph, out


def graph_ms(fn, reps=10):
    """Median replay time of ``fn`` captured once in a CUDA graph: the
    kernels' own time without the wrappers' host cost."""
    graph, _ = capture(fn)
    ms = median_ms(graph.replay, reps=reps)
    del graph
    return ms


# ------------------------------------------------------------- phase 1

def _smi(query):
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]


def phase_build():
    from repro_torch.kernels import _build
    name = torch.cuda.get_device_name(0)
    smi = _smi("name,power.limit")
    print(smi, flush=True)
    # the SM clock the int32 peak is computed from
    REPORT["clocks_max_sm"] = _smi("clocks.max.sm")
    t0 = time.perf_counter()
    reports = _build.build_all()
    for src in _build.SOURCES:
        _build.library(src)
    build_s = time.perf_counter() - t0
    ptxas = {}
    for src, text in reports.items():
        ptxas[src] = [ln.strip() for ln in text.splitlines()
                      if "registers" in ln or "spill" in ln]
    REPORT["ptxas"] = ptxas
    log(1, device=name, nvidia_smi=smi, build_s=build_s,
        built=sorted(reports), torch=torch.__version__,
        cuda=torch.version.cuda)
    return name, smi


# ------------------------------------------------------------- phase 2

LAYER = (("wq", 896, 896), ("wk", 896, 128), ("wv", 896, 128),
         ("wo", 896, 896), ("w_gate", 896, 4864), ("w_up", 896, 4864),
         ("w_down", 4864, 896))
N_LAYERS = 24


def _stored(gen, k, n, kind, groups=1):
    """(stored weight, (G, N) scales) of a random f32 weight, made by
    the port's own quantizers on the card."""
    from repro_torch.kernels import ops
    from repro_torch.quant.quantize import (FP4_E2M1, FP8_E4M3,
                                            fp_quantize, quantize_symmetric)
    w = torch.randn((k, n), generator=gen, device="cuda") / k ** 0.5
    wg = w.reshape(groups, k // groups, n)
    if kind in ("fp8", "fp4", "fp4_packed"):
        q, s = fp_quantize(wg, FP8_E4M3 if kind == "fp8" else FP4_E2M1,
                           axis=-2)
    else:
        q, s = quantize_symmetric(wg, 8 if kind == "int8" else 4, axis=-2)
    q = q.reshape(k, n)
    if kind == "int4_packed":
        q = ops.pack_int4(q)
    elif kind == "fp4_packed":
        q = ops.pack_u4(q)
    return q.contiguous(), s.reshape(groups, n).contiguous()


def _sum_bound(x, w, sw, sa, kind, act):
    """2 gamma_K (|x'| @ |w'|) in f64: the most two f32 summation orders
    of the same products can differ by."""
    from repro_torch.kernels import ref
    xp = x
    if act != "none":
        xp = ref.quantize_act_ref(x, sa)
        if act == "qdq":
            xp = xp * sa
    wf = ref.decode_weight_ref(w, kind)
    k, n = wf.shape
    g = sw.shape[0]
    wf = (wf.reshape(g, k // g, n) * sw[:, None, :]).reshape(k, n)
    absdot = xp.abs().double() @ wf.abs().double()
    if act == "quant":
        absdot = absdot * sa.double()
    gamma = k * U32 / (1 - k * U32)
    return 2 * gamma * absdot


def _check_kernels(gen):
    """Every kernel against its plain version at the serving shapes;
    returns {kernel: max |kernel - plain|} and the comparison count."""
    from repro_torch.kernels import fused, ops, ref
    err = {"fused_dequant_mm": 0.0, "fused_qmm": 0.0, "qmm": 0.0,
           "qmm_packed": 0.0}
    n_cmp = 0
    shapes = [(m, k, n, 1) for m in (8, 256) for _, k, n in LAYER]
    shapes += [(5, 200, 72, 1), (8, 896, 896, 7), (256, 4864, 896, 38)]
    for m, k, n, groups in shapes:
        x = torch.randn((m, k), generator=gen, device="cuda") * 2
        sa = (x.abs().amax() / 127).reshape(())
        for kind in fused.KINDS:
            w, sw = _stored(gen, k, n, kind, groups)
            for act in fused.ACTS:
                got = ops.fused_dequant_matmul(x, w, sw, sa, kind=kind,
                                               act=act)
                want = ops.fused_dequant_matmul(x, w, sw, sa, kind=kind,
                                                act=act, backend="ref")
                diff = (got.double() - want.double()).abs()
                bound = _sum_bound(x, w, sw, sa, kind, act)
                if not bool((diff <= bound).all()):
                    raise AssertionError(
                        f"fused_dequant_mm {kind}/{act} at {(m, k, n)} "
                        f"G={groups}: max diff {float(diff.max())} over "
                        f"its bound")
                err["fused_dequant_mm"] = max(err["fused_dequant_mm"],
                                              float(diff.max()))
                n_cmp += 1
            if groups > 1 or kind not in ("int8", "int4", "int4_packed"):
                continue
            got = ops.fused_quantized_matmul(x, w, sw, sa, kind=kind)
            want = ops.fused_quantized_matmul(x, w, sw, sa, kind=kind,
                                              backend="ref")
            if not torch.equal(got, want):
                raise AssertionError(f"fused_qmm {kind} at {(m, k, n)}: "
                                     f"not bit-equal to its plain version")
            n_cmp += 1
            a = ref.quantize_act_ref(x, sa).to(torch.int8)
            name, fn = (("qmm_packed", ops.int4_matmul_packed)
                        if kind == "int4_packed"
                        else ("qmm", ops.int8_matmul))
            if not torch.equal(fn(a, w), fn(a, w, backend="ref")):
                raise AssertionError(f"{name} {kind} at {(m, k, n)}: not "
                                     f"bit-equal to its plain version")
            n_cmp += 1
    torch.cuda.synchronize()
    return err, n_cmp


def _misaligned(t, offset):
    """A contiguous copy of ``t`` whose data pointer lies ``offset`` bytes
    past the allocator's (16-byte aligned) start."""
    buf = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)
    out = buf[offset:].view(t.shape)
    out.copy_(t)
    return out


def _check_qmm(gen):
    """``qmm`` (the tensor-core kernel) ``torch.equal`` to its plain
    version: M in {1, 8, 16, 17, 256} x the seven projection shapes,
    ragged shapes, a misaligned activation and a misaligned weight
    pointer, all -128 operands at K = 4864, and the split forced to 1
    against the default plan. Returns the comparison count."""
    from repro_torch.kernels import qmm, ref
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def int8(shape):
        return torch.randint(-128, 128, shape, generator=gen, device="cuda",
                             dtype=torch.int8)

    def unsplit(a, b):
        (m, k), n = a.shape, b.shape[1]
        return qmm.plan_qmm(m, n, k, sms, splits=1)

    def same(a, b, what, a0=None, b0=None, plan=None):
        want = ref.qmm_ref(a if a0 is None else a0, b if b0 is None else b0)
        if not torch.equal(qmm.qmm(a, b, plan=plan), want):
            raise AssertionError(f"qmm {what} {plan}: not bit-equal to its "
                                 f"plain version")
        return 1

    n_cmp = 0
    for m in (1, 8, 16, 17, 256):
        for _, k, n in LAYER:
            n_cmp += same(int8((m, k)), int8((k, n)), (m, k, n))
    for m, k, n in ((5, 200, 72), (33, 128, 130), (17, 100, 30)):
        n_cmp += same(int8((m, k)), int8((k, n)), (m, k, n))
    for m, k, n in ((8, 896, 896), (17, 4864, 896)):
        a0, b0 = int8((m, k)), int8((k, n))
        n_cmp += same(_misaligned(a0, 1), b0, f"{(m, k, n)} act at +1",
                      a0=a0)
        n_cmp += same(a0, _misaligned(b0, 3), f"{(m, k, n)} weight at +3",
                      b0=b0)
    lo = torch.full((8, 4864), -128, dtype=torch.int8, device="cuda")
    hi = torch.full((4864, 896), -128, dtype=torch.int8, device="cuda")
    n_cmp += same(lo, hi, "all -128 at K = 4864")
    n_cmp += same(lo, hi, "all -128 at K = 4864", plan=unsplit(lo, hi))
    a, b = int8((8, 4864)), int8((4864, 896))
    if not torch.equal(qmm.qmm(a, b, plan=unsplit(a, b)), qmm.qmm(a, b)):
        raise AssertionError("qmm: split 1 and the default plan differ")
    n_cmp += 1
    torch.cuda.synchronize()
    return n_cmp


# the kernel of fused_qmm and qmm_packed: (wrapper, weight kind), the
# int4_exact route's fused kind included
INT_TC = (("fused_qmm", "int8"), ("fused_qmm", "int4"),
          ("fused_qmm", "int4_packed"), ("qmm_packed", "int4_packed"))


def _int_tc_operands(gen, kernel, kind, m, k, n):
    """(x, w, sw, sa): f32 acts, a stored weight, its scales and the act
    scale for ``fused_qmm``; int8 acts and random packed bytes (sw, sa
    None) for ``qmm_packed``."""
    if kernel == "qmm_packed":
        return (torch.randint(-128, 128, (m, k), generator=gen,
                              device="cuda", dtype=torch.int8),
                torch.randint(-128, 128, (k // 2, n), generator=gen,
                              device="cuda", dtype=torch.int8), None, None)
    w, sw = _stored(gen, k, n, kind)
    x = torch.randn((m, k), generator=gen, device="cuda") * 2
    return x, w, sw, (x.abs().amax() / 127).reshape(())


def _int_tc(kernel, kind, operands, plan=None):
    from repro_torch.kernels import fused, qmm
    x, w, sw, sa = operands
    if kernel == "qmm_packed":
        return qmm.qmm_packed(x, w, plan=plan)
    return fused.fused_qmm(x, w, sw, sa, kind=kind, plan=plan)


def _int_tc_plain(kernel, kind, operands):
    from repro_torch.kernels import ref
    x, w, sw, sa = operands
    if kernel == "qmm_packed":
        return ref.qmm_ref(x, ref.unpack_int4_ref(w))
    return ref.fused_qmm_ref(x, w, sw, sa, kind=kind)


def _int_tc_plan(kind, operands, splits=None, **kw):
    from repro_torch.kernels import qmm
    x, w = operands[:2]
    (m, k), n = x.shape, w.shape[1]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return qmm.plan_int_tc(m, n, k, kind == "int4_packed", sms, splits, **kw)


def _check_int_tc(gen):
    """``fused_qmm`` (int8, int4, int4_packed) and ``qmm_packed`` (the
    tensor-core kernel int_tc_kernel) ``torch.equal`` to their plain
    versions beyond ``_check_kernels``' shapes (M in {8, 256}): M in
    {1, 17} x the seven projection shapes; ragged M, N and K with 1, 3
    and 8 K ranges; x (or a) and w misaligned by 1, 3, 4 and 5 elements;
    int8 -128 weights, packed nibbles 0x7 and 0x8 in every pairing,
    activations past the clamp and at quantize ties (x = (j + 1/2) sa at
    sa 0.125 and 0.1) at K = 4864; every forced number of K ranges and
    1, 2 and 4 blocks per SM; and three launches, a graph replay and two
    replays in a row bit-identical at split plans. Returns the
    comparison count."""
    n_cmp = 0

    def same(kernel, kind, operands, what, plan=None, want=None):
        nonlocal n_cmp
        if want is None:
            want = _int_tc_plain(kernel, kind, operands)
        if not torch.equal(_int_tc(kernel, kind, operands, plan), want):
            raise AssertionError(f"{kernel} {kind} {what} {plan}: not "
                                 f"bit-equal to its plain version")
        n_cmp += 1

    for kernel, kind in INT_TC:
        for m in (1, 17):
            for _, k, n in LAYER:
                ops_ = _int_tc_operands(gen, kernel, kind, m, k, n)
                same(kernel, kind, ops_, (m, k, n))
        for m, k, n in ((5, 200, 72), (33, 128, 130), (17, 100, 30),
                        (1, 32, 7), (9, 192, 129), (3, 8, 2), (40, 4864, 36)):
            ops_ = _int_tc_operands(gen, kernel, kind, m, k, n)
            want = _int_tc_plain(kernel, kind, ops_)
            same(kernel, kind, ops_, (m, k, n), want=want)
            for splits in (1, 3, 8):
                same(kernel, kind, ops_, (m, k, n),
                     _int_tc_plan(kind, ops_, splits), want)
        for m, k, n in ((8, 896, 128), (17, 256, 64), (5, 200, 72)):
            x0, w0, sw, sa = _int_tc_operands(gen, kernel, kind, m, k, n)
            want = _int_tc_plain(kernel, kind, (x0, w0, sw, sa))
            for ox, ow in ((1, 0), (0, 1), (0, 4), (3, 5)):
                ops_ = (_misaligned(x0, ox), _misaligned(w0, ow), sw, sa)
                for splits in (None, 1):
                    same(kernel, kind, ops_, f"{(m, k, n)} at +{(ox, ow)}",
                         _int_tc_plan(kind, ops_, splits), want)
        _check_int_tc_extremes(kernel, kind, same)
        ops_ = _int_tc_operands(gen, kernel, kind, 8, 4864, 896)
        want = _int_tc_plain(kernel, kind, ops_)
        for splits in range(1, 9):
            same(kernel, kind, ops_, "forced", _int_tc_plan(kind, ops_,
                                                            splits), want)
        for per_sm in (1, 2, 4):
            same(kernel, kind, ops_, "forced",
                 _int_tc_plan(kind, ops_, blocks_per_sm=per_sm), want)
        for m, k, n in ((8, 4864, 896), (8, 896, 128), (256, 896, 896)):
            ops_ = _int_tc_operands(gen, kernel, kind, m, k, n)
            want = _int_tc_plain(kernel, kind, ops_)

            def call():
                return _int_tc(kernel, kind, ops_)
            outs = [call(), call(), call(), *_graph_twice(call)]
            if not all(torch.equal(o, want) for o in outs):
                raise AssertionError(f"{kernel} {kind} at {(m, k, n)}: "
                                     f"launches and graph replays differ")
            n_cmp += len(outs)
    torch.cuda.synchronize()
    return n_cmp


def _check_int_tc_extremes(kernel, kind, same):
    """``_check_int_tc``'s extreme operands at K = 4864, N = 896, under
    the default plan and K unsplit."""
    m, k, n = 8, 4864, 896
    if kind == "int4_packed":
        ws = [torch.full((k // 2, n), byte, dtype=torch.uint8,
                         device="cuda").view(torch.int8)
              for byte in (0x77, 0x88, 0x78, 0x87)]
    else:
        lo = -128 if kind == "int8" else -8
        ws = [torch.full((k, n), lo, dtype=torch.int8, device="cuda"),
              torch.where(torch.arange(n, device="cuda") % 2 == 0, lo,
                          -lo - 1).to(torch.int8).expand(k, n).contiguous()]
    sw = torch.linspace(0.01, 2.0, n, device="cuda").reshape(1, n)
    j = torch.arange(k, device="cuda", dtype=torch.float32) % 300 - 150
    acts = []
    for sa in (0.125, 0.1):
        sa_t = torch.tensor(sa, device="cuda")
        big = torch.full((m, k), 1e4, device="cuda")
        big[1::2] = -1e4
        acts += [(((j + 0.5) * sa).expand(m, k).contiguous(), sa_t),
                 (big, sa_t)]
    from repro_torch.kernels import ref
    for w in ws:
        if kernel == "qmm_packed":
            cases = [(torch.full((m, k), -128, dtype=torch.int8,
                                 device="cuda"), None, None),
                     (ref.quantize_act_ref(*acts[0]).to(torch.int8), None,
                      None)]
        else:
            cases = [(x, sw, sa) for x, sa in acts]
        for x, s, sa in cases:
            for splits in (None, 1):
                ops_ = (x, w, s, sa)
                same(kernel, kind, ops_, "extremes",
                     _int_tc_plan(kind, ops_, splits))


def _time_int_tc_plans(gen, kernel, kind):
    """Per projection shape at M in {8, 256}, for ``kernel`` over weights
    of ``kind``: the graph-replayed time of one launch in us, averaged
    over N_LAYERS weights (4 at 256 rows), under the default plan
    (listed with its block count), planned for 1 and 4 blocks per SM,
    with K unsplit, and with the most K ranges (8)."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = {}
    for m, count in ((8, N_LAYERS), (256, 4)):
        for name, k, n in LAYER:
            ops_ = [_int_tc_operands(gen, kernel, kind, m, k, n)
                    for _ in range(count)]
            # one activation per shape, as a decode step serves it
            ops_ = [ops_[0][:1] + o[1:] for o in ops_]
            default = _int_tc_plan(kind, ops_[0])
            plans = {"default": default,
                     "per_sm_1": _int_tc_plan(kind, ops_[0], blocks_per_sm=1),
                     "per_sm_4": _int_tc_plan(kind, ops_[0], blocks_per_sm=4),
                     "split_1": _int_tc_plan(kind, ops_[0], 1),
                     "splits_8": _int_tc_plan(kind, ops_[0], 8)}
            key = f"{m} {name}"
            out[key] = {
                label: graph_ms(lambda: [_int_tc(kernel, kind, o, p)
                                         for o in ops_]) / count * 1e3
                for label, p in plans.items()}
            out[key]["plan"] = dict(default._asdict(),
                                    blocks=default.blocks(m, n))
    return out


def _fd_same(x, w, sw, sa, kind, act, what, plan=None):
    """``fused_dequant_mm`` within 2 gamma_K of its plain version (the
    kernel's output is returned)."""
    from repro_torch.kernels import fused, ref
    got = fused.fused_dequant_mm(x, w, sw, sa, kind=kind, act=act, plan=plan)
    want = ref.fused_dequant_mm_ref(x, w, sw, sa, kind=kind, act=act)
    diff = (got.double() - want.double()).abs()
    if not bool((diff <= _sum_bound(x, w, sw, sa, kind, act)).all()):
        raise AssertionError(f"fused_dequant_mm {kind}/{act} {what} {plan}: "
                             f"max diff {float(diff.max())} over its bound")
    return got, float(diff.max())


def _graph_twice(fn):
    """fn's output from a CUDA graph, replayed once and then twice more."""
    graph, out = capture(fn)
    graph.replay()
    torch.cuda.synchronize()
    once = out.clone()
    graph.replay()
    graph.replay()
    torch.cuda.synchronize()
    return once, out.clone()


def _check_fused_dequant(gen):
    """``fused_dequant_mm`` against its plain version beyond
    ``_check_kernels``' shapes (M in {8, 256}): M in {1, 16, 17} x the
    seven projection shapes x every kind and act; G = 38 at M = 8 and
    G = 7 at M = 16; the fewest and the most K ranges at M in {8, 256}
    for three kind/act pairs; misaligned x, w and sw pointers (bit-equal
    to the aligned result too); each kind's largest codes at K = 4864;
    K deeper than one launch takes (18464 at M = 16, 36896 at M = 8);
    and two launches, a graph replay and two replays in a row
    ``torch.equal`` at split plans. Returns (comparisons, max |kernel -
    plain|)."""
    from repro_torch.kernels import fused
    n_cmp, err = 0, 0.0

    def same(*args, **kw):
        nonlocal n_cmp, err
        got, e = _fd_same(*args, **kw)
        n_cmp += 1
        err = max(err, e)
        return got

    cases = [(m, k, n, 1) for m in (1, 16, 17) for _, k, n in LAYER]
    cases += [(8, 4864, 896, 38), (16, 896, 896, 7)]
    for m, k, n, groups in cases:
        x = torch.randn((m, k), generator=gen, device="cuda") * 2
        sa = (x.abs().amax() / 127).reshape(())
        for kind in fused.KINDS:
            w, sw = _stored(gen, k, n, kind, groups)
            for act in fused.ACTS:
                same(x, w, sw, sa, kind, act, (m, k, n, groups))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for m in (8, 256):                   # the fewest and the most K ranges
        for _, k, n in LAYER:
            x = torch.randn((m, k), generator=gen, device="cuda") * 2
            sa = (x.abs().amax() / 127).reshape(())
            for kind, act in (("int4_packed", "qdq"), ("fp8", "none"),
                              ("int8", "quant")):
                w, sw = _stored(gen, k, n, kind)
                for splits in (_fewest_splits(m, k, kind), fused.MAX_SPLITS):
                    plan = fused.plan_fused_dequant(m, n, k, 1, kind, sms,
                                                    splits)
                    same(x, w, sw, sa, kind, act, (m, k, n), plan=plan)
    for m, k, n in ((8, 896, 896), (16, 4864, 200), (5, 200, 72)):
        x0 = torch.randn((m, k), generator=gen, device="cuda") * 2
        sa = (x0.abs().amax() / 127).reshape(())
        for kind in ("int8", "int4_packed", "fp8", "fp4_packed"):
            w0, sw0 = _stored(gen, k, n, kind)
            want = fused.fused_dequant_mm(x0, w0, sw0, sa, kind=kind,
                                          act="qdq")
            for ox, ow, os_ in ((1, 0, 0), (0, 1, 0), (0, 4, 0), (0, 0, 1),
                                (3, 5, 2)):
                got = same(_misaligned(x0, ox), _misaligned(w0, ow),
                           _misaligned(sw0, os_), sa, kind, "qdq",
                           f"{(m, k, n)} at +{(ox, ow, os_)}")
                if not torch.equal(got, want):
                    raise AssertionError(f"fused_dequant_mm {kind} at "
                                         f"+{(ox, ow, os_)}: not the aligned "
                                         f"result")
    largest = {"int8": (torch.int8, -128), "int4": (torch.int8, -8),
               "int4_packed": (torch.int8, -120), "fp8": (torch.uint8, 0x7F),
               "fp4": (torch.uint8, 0xF), "fp4_packed": (torch.uint8, 0x77)}
    x = torch.full((8, 4864), 3.0, device="cuda")
    x[1::2] = -3.0
    sa = torch.tensor(3.0 / 127, device="cuda")
    for kind, (dtype, code) in largest.items():
        rows = 2432 if kind in fused.PACKED_KINDS else 4864
        w = torch.full((rows, 896), code, dtype=dtype, device="cuda")
        sw = torch.full((1, 896), 0.5, device="cuda")
        for act in fused.ACTS:
            same(x, w, sw, sa, kind, act, "largest codes")
    # K deeper than one launch takes: a launch per K slice (one scale
    # group past the edge at 16 and at 8 register rows)
    for m, k, groups in ((16, 18464, 1), (16, 18464, 577), (8, 36896, 1)):
        x = torch.randn((m, k), generator=gen, device="cuda") * 2
        sa = (x.abs().amax() / 127).reshape(())
        for kind in ("int8", "int4_packed", "fp4_packed"):
            w, sw = _stored(gen, k, 64, kind, groups)
            for act in fused.ACTS:
                same(x, w, sw, sa, kind, act, f"deep K {(m, k, groups)}")
    for m, k, n in ((8, 4864, 896), (8, 896, 896), (16, 896, 4864)):
        x = torch.randn((m, k), generator=gen, device="cuda") * 2
        sa = (x.abs().amax() / 127).reshape(())
        w, sw = _stored(gen, k, n, "int4_packed")

        def call():
            return fused.fused_dequant_mm(x, w, sw, sa, kind="int4_packed",
                                          act="qdq")
        first = call()
        outs = [call(), *_graph_twice(call)]
        if not all(torch.equal(first, o) for o in outs):
            raise AssertionError(f"fused_dequant_mm at {(m, k, n)}: launches "
                                 f"and graph replays differ")
        n_cmp += 3
    torch.cuda.synchronize()
    return n_cmp, err


def _fewest_splits(m, k, kind):
    """The fewest K ranges whose activation slices fit, at some width."""
    from repro_torch.kernels import fused
    rows = min(fused.ROW_LIMIT, 1 << (m - 1).bit_length())
    return -(-k // max(fused.max_kc(rows, bn, kind)
                       for bn in fused.DECODE_WIDTHS))


def _time_fused_plans(gen):
    """Per projection shape at M = 8 (int4_packed, qdq): the
    graph-replayed time of one ``fused_dequant_mm`` launch in us,
    averaged over N_LAYERS weights, under the default plan (listed with
    its block count), planned for 1, 2 and 4 blocks per SM, and with K
    split into the fewest ranges whose activation slice fits ("fewest":
    unsplit where K fits); and at M = 256 (four weights per shape) the
    default plan and the fewest ranges."""
    from repro_torch.kernels import fused
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    m, kind = 8, "int4_packed"
    x = {k: torch.randn((m, k), generator=gen, device="cuda") * 2
         for k in (896, 4864)}
    sa = {k: (v.abs().amax() / 127).reshape(()) for k, v in x.items()}
    out = {}
    for name, k, n in LAYER:
        ws = [_stored(gen, k, n, kind) for _ in range(N_LAYERS)]
        plans = {"default": fused.plan_fused_dequant(m, n, k, 1, kind, sms)}
        plans.update({f"per_sm_{b}": fused.plan_fused_dequant(
            m, n, k, 1, kind, sms, blocks_per_sm=b) for b in (1, 2, 4)})
        plans["fewest"] = fused.plan_fused_dequant(
            m, n, k, 1, kind, sms, splits=_fewest_splits(m, k, kind))
        out[f"{m} {name}"] = {
            label: graph_ms(lambda: [fused.fused_dequant_mm(
                x[k], w, sw, sa[k], kind=kind, act="qdq", plan=p)
                for w, sw in ws]) / len(ws) * 1e3
            for label, p in plans.items()}
        out[f"{m} {name}"]["plan"] = dict(
            plans["default"]._asdict(), blocks=plans["default"].blocks(m, n))
        out[f"{m} {name}"]["fewest_plan"] = dict(plans["fewest"]._asdict())
    # the prefill-wave shape, 4 weights per shape: the default plan and
    # the fewest K ranges
    m = 256
    xw = {k: torch.randn((m, k), generator=gen, device="cuda") * 2
          for k in (896, 4864)}
    saw = {k: (v.abs().amax() / 127).reshape(()) for k, v in xw.items()}
    for name, k, n in LAYER:
        ws = [_stored(gen, k, n, kind) for _ in range(4)]
        plans = {"default": fused.plan_fused_dequant(m, n, k, 1, kind, sms),
                 "fewest": fused.plan_fused_dequant(
                     m, n, k, 1, kind, sms, _fewest_splits(m, k, kind))}
        out[f"{m} {name}"] = {
            label: graph_ms(lambda: [fused.fused_dequant_mm(
                xw[k], w, sw, saw[k], kind=kind, act="qdq", plan=p)
                for w, sw in ws]) / len(ws) * 1e3
            for label, p in plans.items()}
        out[f"{m} {name}"]["plan"] = dict(
            plans["default"]._asdict(), blocks=plans["default"].blocks(m, n))
    return out


def _time_qmm_plans(gen):
    """Per projection shape at M in {8, 256}: the graph-replayed time of
    one ``qmm`` launch (its zeroing memset included), in us, averaged
    over N_LAYERS weights, under the default plan (listed with its block
    count), with K unsplit, and planned for 1, 2 and 4 blocks per SM:
    what the planner's choice rests on; and the output's zeroing alone
    (``torch.zeros``, which a split plan needs)."""
    from repro_torch.kernels import qmm
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = {}
    for m in (8, 256):
        a = {k: torch.randint(-128, 128, (m, k), generator=gen,
                              device="cuda", dtype=torch.int8)
             for k in (896, 4864)}
        for name, k, n in LAYER:
            ws = [torch.randint(-128, 128, (k, n), generator=gen,
                                device="cuda", dtype=torch.int8)
                  for _ in range(N_LAYERS)]
            plans = {"default": qmm.plan_qmm(m, n, k, sms),
                     "split_1": qmm.plan_qmm(m, n, k, sms, splits=1)}
            plans.update({f"per_sm_{b}": qmm.plan_qmm(m, n, k, sms,
                                                      blocks_per_sm=b)
                          for b in (1, 2, 4)})
            out[f"{m} {name}"] = {
                label: graph_ms(lambda: [qmm.qmm(a[k], w, plan=p)
                                         for w in ws]) / len(ws) * 1e3
                for label, p in plans.items()}
            out[f"{m} {name}"]["zeroing_alone"] = graph_ms(
                lambda: [torch.zeros((m, n), dtype=torch.int32,
                                     device="cuda") for _ in ws]
            ) / len(ws) * 1e3
            out[f"{m} {name}"]["plan"] = dict(
                plans["default"]._asdict(),
                blocks=plans["default"].blocks(m, n))
    return out


class _Sweep:
    """One decode step's projections: 24 layers x 7 projection shapes of
    qwen2-0.5b at M rows, every layer its own weights (so the weights
    come from device memory, as in the serving path, not from L2)."""

    def __init__(self, gen, m, kind):
        self.m, self.kind = m, kind
        self.layers = [[_stored(gen, k, n, kind) for _, k, n in LAYER]
                       for _ in range(N_LAYERS)]
        self.x = {k: torch.randn((m, k), generator=gen, device="cuda") * 2
                  for k in (896, 4864)}
        self.sa = {k: (v.abs().amax() / 127).reshape(())
                   for k, v in self.x.items()}
        from repro_torch.kernels import ref
        self.a = {k: ref.quantize_act_ref(v, self.sa[k]).to(torch.int8)
                  for k, v in self.x.items()}

    def run(self, call):
        for layer in self.layers:
            for (_, k, _), (w, sw) in zip(LAYER, layer):
                call(k, w, sw)

    def traffic(self, act_bytes, out_bytes, with_scales):
        """(bytes, operations) of one sweep: every input read once and
        every output written once."""
        nbytes = ops_ = 0
        for layer in self.layers:
            for (_, k, n), (w, sw) in zip(LAYER, layer):
                nbytes += w.numel() * w.element_size()
                nbytes += self.m * k * act_bytes + self.m * n * out_bytes
                if with_scales:
                    nbytes += sw.numel() * 4 + 4
                ops_ += 2 * self.m * k * n
        return nbytes, ops_


def _time_kernels(gen, rates):
    """Per kernel: the sweep's median time, eager and replayed from a
    CUDA graph, the plain version's, the least time the card could take,
    and a library call's where one takes the same inputs."""
    from repro_torch.kernels import ops
    out = {}
    m = 8
    sweeps = {"int4_packed": _Sweep(gen, m, "int4_packed"),
              "int8": _Sweep(gen, m, "int8")}
    plans = {
        # kernel: (sweep, kernel call, plain call, act bytes, out
        # bytes, scales read, peak key)
        "fused_dequant_mm": (
            "int4_packed",
            lambda s, be: lambda k, w, sw: ops.fused_dequant_matmul(
                s.x[k], w, sw, s.sa[k], kind="int4_packed", act="qdq",
                backend=be),
            4, 4, True, "f32"),
        "fused_qmm": (
            "int8",
            lambda s, be: lambda k, w, sw: ops.fused_quantized_matmul(
                s.x[k], w, sw, s.sa[k], kind="int8", backend=be),
            4, 4, True, "int8"),
        # the int4_exact route's fused kernel
        "fused_qmm_int4_packed": (
            "int4_packed",
            lambda s, be: lambda k, w, sw: ops.fused_quantized_matmul(
                s.x[k], w, sw, s.sa[k], kind="int4_packed", backend=be),
            4, 4, True, "int8"),
        "qmm": (
            "int8",
            lambda s, be: lambda k, w, sw: ops.int8_matmul(
                s.a[k], w, backend=be),
            1, 4, False, "int8"),
        "qmm_packed": (
            "int4_packed",
            lambda s, be: lambda k, w, sw: ops.int4_matmul_packed(
                s.a[k], w, backend=be),
            1, 4, False, "int8"),
    }
    for name, (sk, make, act_b, out_b, scales, peak) in plans.items():
        s = sweeps[sk]
        ms = median_ms(lambda: s.run(make(s, "kernel")))
        g_ms = graph_ms(lambda: s.run(make(s, "kernel")))
        plain_ms = median_ms(lambda: s.run(make(s, "ref")), reps=5)
        nbytes, nops = s.traffic(act_b, out_b, scales)
        t_bytes = nbytes / rates["bytes_per_s"] * 1e3
        t_ops = nops / rates[peak] * 1e3
        library_ms = None
        if name == "qmm":
            library_ms = _int_mm_ms(s)
        out[name] = {"ms": ms, "graph_ms": g_ms, "plain_ms": plain_ms,
                     "bound_ms": max(t_bytes, t_ops),
                     "bound_by": "bytes" if t_bytes >= t_ops
                     else "operations",
                     "library_ms": library_ms, "bytes": nbytes,
                     "operations": nops, "calls": N_LAYERS * len(LAYER),
                     "rows": m}
    out["qmm"]["library_rows"] = INT_MM_MIN_ROWS
    # graph against graph: the kernel's graph_ms beside the library's
    out["qmm"]["library_graph_ms"] = _int_mm_ms(sweeps["int8"], graph=True)
    out["fused_dequant_mm"]["host_us"] = _fused_host_us(
        sweeps["int4_packed"], plans["fused_dequant_mm"][1])
    for name in ("fused_qmm", "fused_qmm_int4_packed", "qmm_packed"):
        sk, make = plans[name][:2]
        out[name]["host_us"] = _host_us(lambda: sweeps[sk].run(
            make(sweeps[sk], "kernel")))
        # the prefill-wave shape (8 slots x a 32-token chunk), one layer
        wave = _Sweep(gen, 256, sk)
        wave.layers = wave.layers[:1]
        big = lambda: wave.run(make(wave, "kernel"))    # noqa: E731
        out[f"{name}_at_256_rows"] = {
            "ms": median_ms(big), "graph_ms": graph_ms(big),
            "plain_ms": median_ms(lambda: wave.run(make(wave, "ref")),
                                  reps=5),
            "calls": len(LAYER)}
    # the prefill-wave shape, one layer: chunks of 16 register rows
    wave4 = _Sweep(gen, 256, "int4_packed")
    wave4.layers = wave4.layers[:1]
    big = lambda: wave4.run(plans["fused_dequant_mm"][1](    # noqa: E731
        wave4, "kernel"))
    out["fused_dequant_mm_at_256_rows"] = {
        "ms": median_ms(big), "graph_ms": graph_ms(big),
        "plain_ms": median_ms(lambda: wave4.run(
            plans["fused_dequant_mm"][1](wave4, "ref")), reps=5),
        "calls": len(LAYER)}
    # the prefill-wave shape (8 slots x a 32-token chunk), one layer:
    # qmm and torch._int_mm in turns (kernel, library, library, kernel)
    wave = _Sweep(gen, 256, "int8")
    wave.layers = wave.layers[:1]
    kernel = lambda: wave.run(                          # noqa: E731
        lambda k, w, sw: ops.int8_matmul(wave.a[k], w))
    turns = [median_ms(kernel), _int_mm_ms(wave), _int_mm_ms(wave),
             median_ms(kernel)]
    out["qmm_at_256_rows"] = {
        "turns_ms": turns, "ms": statistics.mean([turns[0], turns[3]]),
        "int_mm_ms": statistics.mean([turns[1], turns[2]]),
        "graph_ms": graph_ms(kernel),
        "int_mm_graph_ms": _int_mm_ms(wave, graph=True)}
    return out


def _host_us(sweep, calls=N_LAYERS * len(LAYER)):
    """The host's time per call (us): the median of five enqueues of the
    decode sweep, each drained before the next."""
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sweep()
        times.append((time.perf_counter() - t0) / calls * 1e6)
    torch.cuda.synchronize()
    return statistics.median(times)


def _fused_host_us(s, make):
    """The host's time per ``fused_dequant_mm`` call, beside what the
    wrapper no longer does per call: enter the device's context when it
    is current, and copy ``sa`` through ``torch.as_tensor``."""
    call = make(s, "kernel")
    calls = N_LAYERS * len(LAYER)
    per_call = _host_us

    def contexts():
        for _ in range(calls):
            with torch.cuda.device(0):
                pass

    def as_tensors():
        for _ in range(calls):
            torch.as_tensor(s.sa[896], dtype=torch.float32, device="cuda")

    return {"call": per_call(lambda: s.run(call)),
            "device_context": per_call(contexts),
            "sa_as_tensor": per_call(as_tensors)}


# torch._int_mm refuses 16 rows or fewer
INT_MM_MIN_ROWS = 32


def _int_mm_ms(s, graph=False):
    """torch._int_mm over the sweep (a yardstick, never used by the
    port), eager or replayed from a CUDA graph. Below INT_MM_MIN_ROWS
    rows it refuses the shape, so the activations are padded with zero
    rows to that count first, outside the timed region: the call then
    does 4x the rows of a decode step but reads the same weights."""
    a = s.a
    if s.m < INT_MM_MIN_ROWS:
        a = {k: torch.cat([v, v.new_zeros(INT_MM_MIN_ROWS - s.m, k)])
             for k, v in a.items()}
    return (graph_ms if graph else median_ms)(
        lambda: s.run(lambda k, w, sw: torch._int_mm(a[k], w)))


# ------------------------------------------------- phase 2: mp_matmul

def _wide_f16(gen, shape):
    """The 'wide' operands of tests/test_kernels.py: normal values times
    2^[-10, 12), as f16, on the card."""
    x = torch.randn(shape, generator=gen, device="cuda")
    e = torch.randint(-10, 12, shape, generator=gen, device="cuda")
    return torch.ldexp(x, e).to(torch.float16).nan_to_num(0, 0, 0)


def _mp_operands(gen, m, k, n):
    """Wide operands with a zero row, -0s, a row of subnormals, a column
    with an all-zero first K-group and a row with an all-zero group."""
    a, b = _wide_f16(gen, (m, k)), _wide_f16(gen, (k, n))
    a[0] = 0
    a[1 % m, ::3] = -0.0
    sub = torch.randint(-1023, 1024, (k,), generator=gen, device="cuda")
    a[2 % m] = (sub * 2.0 ** -24).to(torch.float16)
    b[:16, 1 % n] = 0
    a[3 % m, 16:32] = 0
    return a.contiguous(), b.contiguous()


def _as_bits(y):
    return y.view(torch.int16 if y.element_size() == 2 else torch.int32)


def _ordered_f16(gen, m, k, n, g, step):
    """Operands whose group maxima rise (step 1) or fall (step -1): a's
    exponent constant in a K-group and one apart from one group to the
    next, clamped to f16's normal range, b's exponent 0. Rising, every
    group of every output is a record (the fold's worst case) up to the
    29th; falling, only the first is."""
    e = (-14 if step > 0 else 15) + step * (torch.arange(k, device="cuda")
                                            // g)
    e = e.clamp(-14, 15).expand(m, k)

    def unit(shape):
        # [1, 1.5) in f16 keeps exponent 0; a random sign
        sign = torch.randint(0, 2, shape, generator=gen, device="cuda")
        return (torch.rand(shape, generator=gen, device="cuda") * 0.5 + 1
                ) * (sign * 2 - 1)
    a = torch.ldexp(unit((m, k)), e)
    return a.to(torch.float16).contiguous(), unit((k, n)).to(
        torch.float16).contiguous()


def _mp_same(a, b, c, fused, what, plan=None):
    """``mp_matmul`` bit-equal to its plain version; returns its output."""
    from repro_torch.kernels import mpmm, ref
    got = mpmm.mp_matmul(a, b, c, fused=fused, plan=plan)
    want = ref.mp_matmul_blocked_ref(a, b, c, fused=fused)
    if got.dtype != want.dtype or not torch.equal(_as_bits(got),
                                                  _as_bits(want)):
        raise AssertionError(
            f"mp_matmul n={c.n} w={c.w} {c.accum} {c.rounding} "
            f"fused={fused} {what} {plan}: not bit-equal to its plain "
            f"version")
    return got


def _check_mpmm(gen, cfg):
    """``mp_matmul`` against its plain version, bit for bit: the
    fidelity config ``cfg`` at M in {8, 256} x the seven projection
    shapes and ragged M, N and K; the other two test configs of
    tests/test_kernels.py (f16 output included) and groups of 3, 40 and
    64 (a group staged in two chunks); the fused mode and floor
    rounding; ascending (every group a record) and descending group
    maxima; forced plans (one K range, the most ranges, the narrowest
    and the widest blocks); misaligned a and b pointers (bit-equal to
    the aligned result too); and two launches and two CUDA-graph
    replays bit-identical."""
    from repro_torch.core.ipu import IPUConfig
    from repro_torch.kernels import mpmm
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    other = [IPUConfig(n=16, w=28, accum="fp32"),
             IPUConfig(n=8, w=12, accum="fp16")]
    odd = [IPUConfig(n=3, w=16, accum="fp32"),
           IPUConfig(n=40, w=16, accum="fp32", rounding="floor"),
           IPUConfig(n=64, w=20, accum="bf16", sw_precision=12)]
    floor = dataclasses.replace(cfg, rounding="floor")
    cases = [(cfg, False, (m, k, n)) for m in (8, 256) for _, k, n in LAYER]
    cases += [(cfg, False, s) for s in ((5, 200, 72), (9, 77, 33),
                                        (1, 7, 1), (3, 1003, 129),
                                        (17, 14336, 40))]
    cases += [(c, False, (8, 896, 896)) for c in other + odd]
    cases += [(c, True, (8, 896, 128)) for c in [cfg, floor] + other + odd]
    cases += [(floor, False, (8, 896, 128)), (floor, False, (8, 4864, 896))]
    n_cmp = 0
    for c, fused, (m, k, n) in cases:
        a, b = _mp_operands(gen, m, k, n)
        _mp_same(a, b, c, fused, (m, k, n))
        n_cmp += 1
    for c in (cfg, floor, other[1]):
        for step in (1, -1):
            for m, k, n in ((8, 4864, 896), (8, 29 * c.n, 4864),
                            (3, 300, 70)):
                a, b = _ordered_f16(gen, m, k, n, c.n, step)
                for fused in (False, True):
                    _mp_same(a, b, c, fused, f"step {step} {(m, k, n)}")
                    n_cmp += 1
    for m, k, n in ((8, 4864, 896), (8, 896, 4864), (256, 896, 128),
                    (5, 200, 72)):
        a, b = _mp_operands(gen, m, k, n)
        for force in ({"splits": 1}, {"splits": mpmm.MAX_SPLITS},
                      {"bn": 32}, {"bn": 256}):
            plan = mpmm.plan_mpmm(m, n, k, cfg.n, sms, **force)
            _mp_same(a, b, cfg, False, (m, k, n), plan=plan)
            n_cmp += 1
    for m, k, n in ((8, 896, 896), (5, 200, 72), (8, 4864, 130)):
        a0, b0 = _mp_operands(gen, m, k, n)
        want = mpmm.mp_matmul(a0, b0, cfg)
        for oa, ob in ((1, 0), (0, 1), (0, 2), (3, 5)):
            got = _mp_same(_misaligned(a0, oa), _misaligned(b0, ob), cfg,
                           False, f"{(m, k, n)} at +{(oa, ob)}")
            if not torch.equal(_as_bits(got), _as_bits(want)):
                raise AssertionError(f"mp_matmul at +{(oa, ob)}: not the "
                                     f"aligned result")
            n_cmp += 1
    for m, k, n in ((8, 4864, 896), (8, 896, 4864), (256, 896, 896)):
        a, b = _mp_operands(gen, m, k, n)
        first = mpmm.mp_matmul(a, b, cfg)
        outs = [mpmm.mp_matmul(a, b, cfg),
                *_graph_twice(lambda: mpmm.mp_matmul(a, b, cfg))]
        if not all(torch.equal(_as_bits(first), _as_bits(o)) for o in outs):
            raise AssertionError(f"mp_matmul at {(m, k, n)}: launches and "
                                 f"graph replays differ")
        n_cmp += 3
    torch.cuda.synchronize()
    return n_cmp


def _active_products(x16, w16, cfg):
    """Products of x16 @ w16 that the EHU keeps (alignment shift within
    cfg.mask_threshold of the group's largest product exponent): the
    data-dependent part of the kernel's work, counted on the card, eight
    rows at a time."""
    from repro_torch.core import fp16 as fpmod
    _, ea, _ = fpmod.decompose(x16, fpmod.FP16)
    _, eb, _ = fpmod.decompose(w16, fpmod.FP16)
    m, k = ea.shape
    g = cfg.n
    eb = eb.reshape(k // g, g, -1)
    total = 0
    for r in range(0, m, 8):
        c = ea[r:r + 8].reshape(-1, k // g, g)[:, :, :, None] + eb[None]
        shift = c.amax(dim=2, keepdim=True) - c      # (rows, G, g, n)
        total += int((shift <= cfg.mask_threshold).sum())
    return total


def _mp_bound(layers, x, cfg, rates):
    """The least time for ``mp_matmul`` over ``layers`` with activations
    ``x``: f16 weights and activations read once, f32 outputs written
    once; operations: per product the EHU's add, max, subtract and
    compare (4), and per product it keeps 9 plane products of a
    multiply, a shift and an add (27), on the int32 CUDA cores."""
    nbytes = products = active = 0
    for layer in layers:
        for (_, k, n), w in zip(LAYER, layer):
            m = x[k].shape[0]
            nbytes += w.numel() * 2 + m * k * 2 + m * n * 4
            products += m * k * n
            active += _active_products(x[k], w, cfg)
    nops = 4 * products + 27 * active
    t_bytes = nbytes / rates["bytes_per_s"] * 1e3
    t_ops = nops / rates["int32"] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "operations": nops, "products": products,
            "active_products": active}


def _mp_plans_us(layers, x, cfg, sms, force=()):
    """Per projection shape (wq, wk, w_gate, w_down): the graph-replayed
    time of one ``mp_matmul`` launch in us, averaged over ``layers``,
    under the default plan (listed with its block count and rounds) and
    under each forced plan of ``force``."""
    from repro_torch.kernels import mpmm
    out = {}
    for i, (name, k, n) in enumerate(LAYER):
        if name not in ("wq", "wk", "w_gate", "w_down"):
            continue
        ws = [layer[i] for layer in layers]
        m = x[k].shape[0]
        plans = {"default": mpmm.plan_mpmm(m, n, k, cfg.n, sms)}
        for f in force:
            plans["_".join(f"{a}{b}" for a, b in f.items())] = \
                mpmm.plan_mpmm(m, n, k, cfg.n, sms, **f)
        row = {label: graph_ms(lambda: [mpmm.mp_matmul(
            x[k], w, cfg, plan=p) for w in ws], reps=5) / len(ws) * 1e3
            for label, p in plans.items()}
        d = plans["default"]
        row["plan"] = dict(d._asdict(), blocks=d.blocks(m, n),
                           rounds=d.rounds(k, cfg.n))
        out[f"{m} {name}"] = row
    return out


def _mp_host_us(layers, x, cfg):
    """The host's time per ``mp_matmul`` call (us, median of five
    enqueues of the decode sweep, each drained before the next), beside
    what the wrapper no longer does per call: look the library up and
    enter the device's context when it is current."""
    from repro_torch.kernels import _build, mpmm
    calls = sum(len(layer) for layer in layers)

    def per_call(fn):
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
        return statistics.median(times)

    def sweep():
        for layer in layers:
            for (_, k, _), w in zip(LAYER, layer):
                mpmm.mp_matmul(x[k], w, cfg)

    def lookups():
        for _ in range(calls):
            _build.library("mpmm")

    def contexts():
        for _ in range(calls):
            with torch.cuda.device(0):
                pass

    return {"call": per_call(sweep), "library_lookup": per_call(lookups),
            "device_context": per_call(contexts)}


def _time_mpmm(gen, rates, cfg):
    """``mp_matmul`` over one decode step's 168 projections at M = 8 (f16
    weights, each layer its own), eager and graph-replayed, its plain
    version over one layer's seven projections, the bound, the
    exact=False route's f32 matmul on the same f16 operands (context:
    the price of bit-exact emulation, not a yardstick), per launch and
    plan, per call on the host; and one layer at 256 rows (the prefill
    wave) with its own bound and plans."""
    from repro_torch.kernels import ops
    from repro_torch.layers.mplinear import _dot_f32
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    m = 8
    layers = [[(torch.randn((k, n), generator=gen, device="cuda")
                / k ** 0.5).to(torch.float16) for _, k, n in LAYER]
              for _ in range(N_LAYERS)]
    x = {k: (torch.randn((m, k), generator=gen, device="cuda") * 2
             ).to(torch.float16) for k in (896, 4864)}

    def sweep(call, depth=N_LAYERS, xs=x):
        for layer in layers[:depth]:
            for (_, k, _), w in zip(LAYER, layer):
                call(xs[k], w)

    ms = median_ms(lambda: sweep(lambda a, w: ops.mp_matmul(a, w, cfg)))
    g_ms = graph_ms(lambda: sweep(lambda a, w: ops.mp_matmul(a, w, cfg)),
                    reps=5)
    layer_ms = median_ms(lambda: sweep(
        lambda a, w: ops.mp_matmul(a, w, cfg), depth=1))
    plain_layer_ms = median_ms(lambda: sweep(
        lambda a, w: ops.mp_matmul(a, w, cfg, backend="ref"), depth=1),
        reps=3, warm=1)
    dense_ms = median_ms(lambda: sweep(
        lambda a, w: _dot_f32(a, w, torch.float16)))
    out = {"ms": ms, "graph_ms": g_ms, "plain_ms": plain_layer_ms,
           "plain_scope": "one layer (7 projections), 3 reps",
           "ms_one_layer": layer_ms, "library_ms": None,
           **_mp_bound(layers, x, cfg, rates),
           "int32_ops_per_s": rates["int32"],
           "exact_false_f32_matmul_ms": dense_ms,
           "calls": N_LAYERS * len(LAYER), "rows": m}
    out["plans_us"] = _mp_plans_us(layers, x, cfg, sms, force=(
        {"splits": 1}, {"splits": 8}, {"bn": 32}))
    out["host_us"] = _mp_host_us(layers, x, cfg)
    # the prefill wave: one layer at 256 rows
    xw = {k: (torch.randn((256, k), generator=gen, device="cuda") * 2
              ).to(torch.float16) for k in (896, 4864)}
    wave = lambda: sweep(                                 # noqa: E731
        lambda a, w: ops.mp_matmul(a, w, cfg), depth=1, xs=xw)
    out["at_256_rows"] = {
        "ms": median_ms(wave, reps=5), "graph_ms": graph_ms(wave, reps=5),
        **_mp_bound(layers[:1], xw, cfg, rates), "calls": len(LAYER),
        "plans_us": _mp_plans_us(layers[:1], xw, cfg, sms,
                                 force=({"splits": 1},))}
    return out


# the projection shapes of the models phases 8-13 serve (K, N)
NEW_SHAPES = (
    ("gemma2-9b", (("wq", 3584, 4096), ("wk", 3584, 2048),
                   ("wv", 3584, 2048), ("wo", 4096, 3584),
                   ("w_gate", 3584, 14336), ("w_up", 3584, 14336),
                   ("w_down", 14336, 3584))),
    ("qwen3-moe-30b-a3b", (("wq", 2048, 4096), ("wk", 2048, 512),
                           ("wv", 2048, 512), ("wo", 4096, 2048))),
    ("rwkv6-1.6b", (("w_r", 2048, 2048), ("c_key", 2048, 7168),
                    ("c_val", 7168, 2048))),
    ("recurrentgemma-9b", (("w_in_rnn", 4096, 4096), ("wk", 4096, 256),
                           ("w_gate", 4096, 12288),
                           ("w_down", 12288, 4096))),
    ("internvl2-1b", (("projector/fc1", 1024, 896),)),
    ("seamless-m4t-medium", (("frontend_proj", 160, 1024),
                             ("wq", 1024, 1024), ("w_gate", 1024, 4096),
                             ("w_down", 4096, 1024))),
)
# rows (M) each model's shapes run at; 8 and 256 by default.
# seamless-m4t-medium's encoder and its decoder's cross-attention K and V
# (phase 13) run at 8 rows x 128 frames
SHAPE_ROWS = {"seamless-m4t-medium": (8, 256, 1024)}


def _check_new_shapes(gen, cfg, err):
    """Every kernel against its plain version at the projection shapes
    of gemma2-9b and qwen3-moe-30b-a3b (head_dim 256 and 128, K and N up
    to 14336), rwkv6-1.6b (2048 <-> 7168), recurrentgemma-9b (4096 <->
    12288, MQA wk 4096 -> 256), internvl2-1b's projector (1024 -> 896)
    and seamless-m4t-medium (its frontend 160 -> 1024, 1024 <-> 4096),
    M in {8, 256} (and 1024 for seamless-m4t-medium):
    ``fused_dequant_mm`` over int4_packed and int8 under each act step
    within 2 gamma_K, ``fused_qmm`` (int8 and
    int4_packed), ``qmm`` and ``qmm_packed`` bit-equal; ``mp_matmul``
    bit-equal at gemma2's wk at M = 8. Returns (comparisons, each
    shape's launch plans)."""
    from repro_torch.kernels import fused, mpmm, ops, qmm, ref
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plans, n_cmp = {}, 0
    for arch, layer in NEW_SHAPES:
        for name, k, n in layer:
            for m in SHAPE_ROWS.get(arch, (8, 256)):
                x = torch.randn((m, k), generator=gen, device="cuda") * 2
                sa = (x.abs().amax() / 127).reshape(())
                a = ref.quantize_act_ref(x, sa).to(torch.int8)
                shape = {}
                what = f"{arch} {name} {(m, k, n)}"
                for kind in ("int4_packed", "int8"):
                    w, sw = _stored(gen, k, n, kind)
                    for act in fused.ACTS:
                        _, diff = _fd_same(x, w, sw, sa, kind, act, what)
                        err["fused_dequant_mm"] = max(
                            err["fused_dequant_mm"], diff)
                        n_cmp += 1
                    slices = fused.k_slices(m, k, 1, kind)
                    shape[f"fused_dequant_mm/{kind}"] = {
                        "k_slices": slices,
                        "plans": [fused.plan_fused_dequant(
                            m, n, k1 - k0, 1, kind, sms)._asdict()
                            for k0, k1 in slices]}
                    packed = kind == "int4_packed"
                    pairs = [("fused_qmm", kind, lambda be: (
                        ops.fused_quantized_matmul(x, w, sw, sa, kind=kind,
                                                   backend=be)))]
                    pairs.append(("qmm_packed", kind, lambda be: (
                        ops.int4_matmul_packed(a, w, backend=be)))
                                 if packed else ("qmm", kind, lambda be: (
                                     ops.int8_matmul(a, w, backend=be))))
                    for kname, kk, call in pairs:
                        if not torch.equal(call("kernel"), call("ref")):
                            raise AssertionError(
                                f"{kname} {kk} {what}: not bit-equal to "
                                f"its plain version")
                        n_cmp += 1
                    shape[f"fused_qmm/{kind}"] = qmm.plan_int_tc(
                        m, n, k, packed, sms)._asdict()
                    if packed:
                        shape["qmm_packed"] = qmm.plan_int_tc(
                            m, n, k, True, sms)._asdict()
                    else:
                        shape["qmm"] = qmm.plan_qmm(m, n, k, sms)._asdict()
                plans[f"{arch}/{name}/M{m}"] = shape
    m, (_, k, n) = 8, NEW_SHAPES[0][1][1]
    a16, b16 = _mp_operands(gen, m, k, n)
    _mp_same(a16, b16, cfg, False, f"gemma2-9b wk {(m, k, n)}")
    plans[f"gemma2-9b/wk/M{m}"]["mp_matmul"] = mpmm.plan_mpmm(
        m, n, k, cfg.n, sms)._asdict()
    torch.cuda.synchronize()
    return n_cmp + 1, plans


def phase_kernels(rates):
    from repro_torch.core.policy import get_policy
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1234)
    fidelity = get_policy("fidelity_fp16_ipu").default.ipu
    err, n_cmp = _check_kernels(gen)
    n_fd, fd_err = _check_fused_dequant(gen)
    err["fused_dequant_mm"] = max(err["fused_dequant_mm"], fd_err)
    n_qmm = _check_qmm(gen)
    n_int_tc = _check_int_tc(gen)
    n_cmp += n_fd + n_qmm + n_int_tc + _check_mpmm(gen, fidelity)
    n_new, new_plans = _check_new_shapes(gen, fidelity, err)
    print("phase 2 plans at the shapes of the models phases 8-13 serve: "
          + json.dumps(new_plans), flush=True)
    qmm_plans = _time_qmm_plans(gen)
    fused_qmm_plans = {kind: _time_int_tc_plans(gen, "fused_qmm", kind)
                       for kind in ("int8", "int4_packed")}
    packed_plans = _time_int_tc_plans(gen, "qmm_packed", "int4_packed")
    fd_plans = _time_fused_plans(gen)
    err["mp_matmul"] = 0.0             # every comparison was bit-equal
    timing = _time_kernels(gen, rates)
    timing["mp_matmul"] = _time_mpmm(gen, rates, fidelity)
    print(f"mp_matmul context: the exact=False route (f32 matmul of the "
          f"same f16 operands) takes "
          f"{timing['mp_matmul']['exact_false_f32_matmul_ms']:.3f} ms over "
          f"the decode step's projections, mp_matmul "
          f"{timing['mp_matmul']['ms']:.3f} ms", flush=True)
    log(2, comparisons=n_cmp + n_new, qmm_comparisons=n_qmm,
        int_tc_comparisons=n_int_tc, fused_dequant_comparisons=n_fd,
        new_shape_comparisons=n_new, new_shape_plans=new_plans,
        max_abs_err=err, timing=timing, qmm_plans_us=qmm_plans,
        fused_qmm_plans_us=fused_qmm_plans, qmm_packed_plans_us=packed_plans,
        fused_dequant_plans_us=fd_plans)
    return err, timing


# ------------------------------------------------------------- phase 3

def _requests(cfg, n, lo, hi, max_new, seed):
    from repro_torch.serving import Request
    rng = np.random.default_rng(seed)
    return [Request(rid=i, prompt=rng.integers(
                0, cfg.vocab, int(rng.integers(lo, hi + 1)), dtype=np.int32),
                max_new_tokens=max_new) for i in range(n)]


def _graph_seconds(stats):
    """{program: [capture seconds per signature]} and the totals of the
    engine's program cache (``ServingEngine.metrics()["graphs"]``)."""
    progs = stats["programs"].values()
    return (sum(sum(p["capture_s"]) for p in progs),
            sum(sum(p["warmup_s"]) for p in progs))


def _reserved_after():
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return torch.cuda.memory_reserved()


def _serve(cfg, api, params, config, reqs, eng=None, eager=False):
    """Serve ``reqs`` to the end on ``eng`` (a new engine when None) and
    measure the wave: tok/s, TTFT, the engine's counters, and what the
    program cache did (graphs captured and replayed, seconds of warm-up
    and capture, ``torch.cuda.memory_reserved`` before and after, the
    kernels' launches). ``memory_reserved`` is read after
    ``empty_cache``, so it holds live tensors and the graphs' pool.
    ``eager`` runs the engine's programs eagerly (its private eager
    calls), the comparison for the graphs."""
    import contextlib
    from repro_torch.kernels import ops
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.graphs import count_delta
    from repro_torch.serving.metrics import percentiles, request_metrics
    if eng is None:
        eng = ServingEngine(cfg, api, params, config=config)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()    # reserved: live tensors and graph pools
    reserved = torch.cuda.memory_reserved()
    counts, counters = ops.launch_counts(), dict(eng.counters)
    stats0 = eng.metrics()["graphs"]
    calls = (eng._graphs._eager_calls() if eager
             else contextlib.nullcontext())
    t0 = time.perf_counter()
    with calls:
        for r in reqs:
            eng.submit(r)
        eng.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for r in reqs:
        if not r.done or r.new_tokens != r.budget:
            raise AssertionError(f"request {r.rid} ended with "
                                 f"{r.new_tokens}/{r.budget} tokens")
    stats = eng.metrics()["graphs"]
    new = sum(r.new_tokens for r in reqs)
    ttft = percentiles([request_metrics(r)["ttft_s"] for r in reqs])
    capture_s, warmup_s = (a - b for a, b in zip(_graph_seconds(stats),
                                                 _graph_seconds(stats0)))
    numbers = {"mode": "eager" if eager else "graphs",
               "requests": len(reqs), "new_tokens": new, "wall_s": wall,
               "tok_per_s": new / wall, "ttft_p50_s": ttft["p50"],
               "ttft_max_s": ttft["max"],
               **{k: eng.counters[k] - counters[k]
                  for k in ("host_syncs", "decode_steps", "prefill_calls",
                            "teacher_forced_tokens")},
               "captures": stats["captures"] - stats0["captures"],
               "replays": stats["replays"] - stats0["replays"],
               "capture_s": capture_s, "warmup_s": warmup_s,
               "reserved_before": reserved,
               "reserved_after": _reserved_after(),
               "launches": count_delta(counts, ops.launch_counts())}
    if not eager and stats0["captures"] == 0:
        numbers["capture_s_by_program"] = {
            k: v["capture_s"] for k, v in stats["programs"].items()}
    if eager and (numbers["captures"] or numbers["replays"]):
        raise AssertionError(f"an eager wave touched the graphs: {numbers}")
    return eng, {r.rid: list(r.tokens) for r in reqs}, numbers


def _fresh_state(eng):
    """Write a fresh decode state into ``eng``'s, in place (its graphs
    stay bound). The engine, as the reference's, never resets a slot's
    recurrent state between requests (rwkv, griffin), so a second wave
    serves the first one's streams only from a fresh state."""
    from repro_torch.serving import graphs
    fresh = eng.api.init_cache(eng.b, eng.cache_len, eng.device)
    for (_, dst), (_, src) in zip(graphs.leaves(eng.caches),
                                  graphs.leaves(fresh)):
        dst.copy_(src)


def _graphs_vs_eager(cfg, api, params, config, make_reqs, results, key,
                     eager_probe=None):
    """One route three ways: a new engine's first wave (captures), the
    same requests again on it (replays only), and a new engine's eager
    wave (inside ``eager_probe``, a context manager, where given). Holds
    all three to the same streams and the same kernel launches, and the
    second wave to no capture. The warm wave serves KV caches as the
    first wave left them (position tags must hide what a slot held
    before, under replay too), and recurrent state (rwkv, griffin) from
    a fresh state. Returns (the graphed engine, its streams)."""
    import contextlib
    eng, streams, results[key] = _serve(cfg, api, params, config,
                                        make_reqs())
    if cfg.family in RECURRENT_FAMILIES:
        _fresh_state(eng)
    _, warm, results[f"{key}_warm"] = _serve(cfg, api, params, config,
                                             make_reqs(), eng=eng)
    eager_config = dataclasses.replace(config,
                                       act_calibration=eng.act_scales)
    with eager_probe or contextlib.nullcontext():
        _, eager, results[f"{key}_eager"] = _serve(
            cfg, api, params, eager_config, make_reqs(), eager=True)
    if not (streams == warm == eager):
        raise AssertionError(f"{key}: the graphed waves and the eager wave "
                             f"give different streams")
    if results[f"{key}_warm"]["captures"] or not results[f"{key}_warm"][
            "replays"] or not results[key]["captures"]:
        raise AssertionError(f"{key}: each signature must be captured once "
                             f"and replayed after that: "
                             f"{results[key]} / {results[f'{key}_warm']}")
    for wave in (key, f"{key}_warm"):
        if results[wave]["launches"] != results[f"{key}_eager"]["launches"]:
            raise AssertionError(
                f"{wave}: launches {results[wave]['launches']} against "
                f"eager {results[f'{key}_eager']['launches']}")
    return eng, streams


def phase_serving(name, smi, params, cfg_full, profile):
    from repro_torch.kernels import ops
    from repro_torch.models import registry
    from repro_torch.serving import EngineConfig
    cfg = dataclasses.replace(cfg_full, precision_policy="int4_serving")
    api = registry.build(cfg)
    raw = sum(4 * w.numel() for _, w in _projections(cfg, params))
    results, streams = {}, {}
    scales = "auto"
    ops.reset_launch_counts()
    for blk in (1, 4):
        eng, streams[blk] = _graphs_vs_eager(
            cfg, api, params, EngineConfig(
                batch_slots=8, cache_len=256, prefill_chunk=32,
                decode_block=blk, act_calibration=scales,
                fused_executors="on"),
            lambda: _requests(cfg, 16, 8, 64, 16, seed=7), results,
            f"int4_block{blk}")
        scales = eng.act_scales
    launches = ops.launch_counts()
    # one replay of each program against its eager run on cloned state
    replay_checks = {kind: eng._check_replays(kind == "sampled")
                     for kind in ("greedy", "sampled")}
    bad = {k: {p: v for p, v in c.items() if v}
           for k, c in replay_checks.items()}
    if any(bad.values()):
        raise AssertionError(f"graph replays differ from eager runs: {bad}")
    if launches["fused_dequant_mm"] <= 0:
        raise AssertionError(f"the serving path launched no "
                             f"fused_dequant_mm: {launches}")
    if streams[1] != streams[4]:
        raise AssertionError("greedy streams differ between decode_block "
                             "1 and 4")
    staged = eng.staged_trace_count()
    wq = eng.weight_quant_trace_count()
    if staged or wq:
        raise AssertionError(f"staged={staged} weight_quant={wq}: the fused "
                             f"path must stage and quantize nothing")
    proj = eng.weight_bytes()["projections"]
    if proj > raw / 6:
        raise AssertionError(f"int4 projections hold {proj} bytes, over "
                             f"1/6 of fp32's {raw}")
    profile_numbers = _profile(eng, cfg) if profile else None

    cfg8 = dataclasses.replace(cfg_full, precision_policy="int8_serving")
    api8 = registry.build(cfg8)
    reqs = _requests(cfg8, 8, 8, 64, 8, seed=8)
    eng8, _, results["int8_block4"] = _serve(
        cfg8, api8, params, EngineConfig(
            batch_slots=8, cache_len=256, prefill_chunk=32, decode_block=4,
            act_calibration="auto", fused_executors="on"), reqs)
    log(3, card=smi, launches=launches, projection_bytes=proj,
        fp32_projection_bytes=raw, staged=staged, weight_quant=wq,
        act_quant=eng.act_quant_trace_count(), runs=results,
        replay_checks={k: sorted(c) for k, c in replay_checks.items()},
        profile=profile_numbers)
    return launches, eng8.act_scales


def _projections(cfg, params):
    from repro_torch.models import registry
    from repro_torch.quant.prepare import iter_projection_weights
    return list(iter_projection_weights(params,
                                        registry.projection_paths(cfg)))


def _profile(eng, cfg):
    """One decode block of a full batch under torch.profiler, replayed
    from its graph and run eagerly (the engine's private eager calls)."""
    return {"graphs": _profile_block(eng, cfg, eager=False),
            "eager": _profile_block(eng, cfg, eager=True)}


def _kernel_rows(prof):
    """(kernel, device ms, calls) of a profile, the longest first."""
    rows = []
    for ev in prof.key_averages():
        dev = getattr(ev, "device_time_total", None)
        if dev is None:
            dev = getattr(ev, "cuda_time_total", 0)
        if dev and ev.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((ev.key, dev / 1e3, ev.count))
    rows.sort(key=lambda r: -r[1])
    return rows


def _profile_block(eng, cfg, eager):
    """Kernel time by name and the device's busy share over one decode
    block of a full batch. One block runs before it, so a graphed block
    is a replay, never a capture."""
    import contextlib
    from torch.profiler import ProfilerActivity, profile
    calls = (eng._graphs._eager_calls() if eager
             else contextlib.nullcontext())
    with calls:
        for r in _requests(cfg, 8, 8, 8, 12, seed=9):
            eng.submit(r)
        while any(r is None or r.next_input is None for r in eng.slot_req):
            eng.step()                   # admit and prefill all eight
        # a block first, so the profiled one's graph is warm; timed
        # without the profiler (the same work as the profiled block)
        torch.cuda.synchronize()
        replays = eng.metrics()["graphs"]["replays"]
        t0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        plain_wall = time.perf_counter() - t0
        plain_replayed = eng.metrics()["graphs"]["replays"] - replays
        replays = eng.metrics()["graphs"]["replays"]
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            eng.step()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        replayed = eng.metrics()["graphs"]["replays"] - replays
        eng.run_until_drained()
    if replayed != (0 if eager else 1):
        raise AssertionError(f"the profiled block replayed {replayed} "
                             f"graphs (eager={eager})")
    rows = _kernel_rows(prof)
    busy_ms = sum(r[1] for r in rows)
    return {"mode": "eager" if eager else "graphs",
            "wall_ms": wall * 1e3, "decode_steps": eng.decode_block,
            "device_busy_ms": busy_ms,
            "kernel_launches": sum(r[2] for r in rows),
            "device_idle_share": (1 - busy_ms / (wall * 1e3))
            if rows else None,
            "unprofiled_block": {
                "wall_ms": plain_wall * 1e3, "replays": plain_replayed,
                "device_idle_share": (1 - busy_ms / (plain_wall * 1e3))
                if rows else None},
            "top_kernels_ms": [[k, t, c] for k, t, c in rows[:15]]}


# ------------------------------------------------------------- phase 4

def phase_exact(params, cfg_full, profile):
    from repro_torch.core.policy import (PrecisionPolicy, PrecisionSpec,
                                         register_policy)
    from repro_torch.kernels import ops
    from repro_torch.models import registry
    from repro_torch.quant.calibrate import calibrate_act_scales
    from repro_torch.serving import EngineConfig
    register_policy(PrecisionPolicy("int4_exact",
                                    default=PrecisionSpec("int4",
                                                          exact=True)))
    out, launches, profiles = {}, {}, {}
    for policy in ("fidelity_int8", "int4_exact"):
        cfg = dataclasses.replace(cfg_full, precision_policy=policy)
        api = registry.build(cfg)
        scales = calibrate_act_scales(cfg, api, params)
        streams = {}
        ops.reset_launch_counts()
        for mode in ("on", "off"):
            eng, streams[mode] = _graphs_vs_eager(
                cfg, api, params, EngineConfig(
                    batch_slots=8, cache_len=256, prefill_chunk=32,
                    decode_block=4, act_calibration=scales,
                    fused_executors=mode),
                lambda: _requests(cfg, 8, 8, 64, 8, seed=11), out,
                f"{policy}_{mode}")
            if profile and policy == "fidelity_int8" and mode == "on":
                profiles[f"{policy}_{mode}"] = _profile(eng, cfg)
        launches[policy] = ops.launch_counts()
        if streams["on"] != streams["off"]:
            raise AssertionError(f"{policy}: fused on and off give "
                                 f"different greedy streams")
    need = {"fidelity_int8": ("fused_qmm", "qmm"),
            "int4_exact": ("fused_qmm", "qmm_packed")}
    for policy, kernels in need.items():
        for k in kernels:
            if launches[policy][k] <= 0:
                raise AssertionError(f"{policy} launched no {k}: "
                                     f"{launches[policy]}")
    log(4, launches=launches, runs=out, profile=profiles or None)
    return launches


# ------------------------------------------------------------- phase 5

def phase_card_vs_cpu(params, cfg_full, scales):
    from repro_torch.convert import to_numpy, tree_to
    from repro_torch.core.policy import get_policy
    from repro_torch.layers.mplinear import executor_variant
    from repro_torch.models import registry
    cfg = dataclasses.replace(cfg_full, precision_policy="int8_serving")
    api = registry.build(cfg)
    prepared = api.prepare(params, get_policy("int8_serving"),
                           act_scales=scales)
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, cfg.vocab, (2, 32), dtype=np.int32)
    lengths = np.array([32, 20], np.int32)
    results = {}
    for where, dev, tree in (("card", "cuda", prepared),
                             ("cpu", "cpu", tree_to(prepared, "cpu"))):
        caches = api.init_cache(2, 64, dev)
        t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
        t0 = time.perf_counter()
        with torch.no_grad(), executor_variant("fused"):
            caches = api.prefill_chunk(
                tree, {"tokens": t(tokens), "offsets": t(np.zeros(2, np.int32)),
                       "lengths": t(lengths)}, caches)
            logits, caches = api.decode_step(
                tree, {"token": t(tokens[:, -1:]), "pos": t(lengths)}, caches)
        results[where] = (to_numpy(logits), to_numpy(caches["b0"]),
                        time.perf_counter() - t0)
    lg, lc = results["card"][0], results["cpu"][0]
    if not np.all(np.isfinite(lg)) or lg.shape != (2, cfg.padded_vocab):
        raise AssertionError(f"card logits: shape {lg.shape}, finite "
                             f"{bool(np.all(np.isfinite(lg)))}")
    real = slice(0, cfg.vocab)          # padded columns are -1e30 on both
    lg, lc = lg[:, real], lc[:, real]
    span = float(lc.max() - lc.min())
    diff = float(np.abs(lg - lc).max())
    rel_rms = float(np.sqrt(np.mean((lg - lc) ** 2) / np.mean(lc ** 2)))
    kc, kp = results["card"][1], results["cpu"][1]
    valid = kp[2][0] >= 0                 # the slots the chunk wrote
    k_rms = [float(np.sqrt(np.mean((kc[0][i][valid] - kp[0][i][valid]) ** 2)
                           / np.mean(kp[0][i][valid] ** 2)))
             for i in range(kc[0].shape[0])]
    log(5, logit_max_abs_diff=diff, logit_range=span,
        max_tolerance=CPU_LOGIT_MAX_OF_RANGE * span, logit_rel_rms=rel_rms,
        rel_rms_tolerance=CPU_LOGIT_REL_RMS,
        greedy_tokens_equal=bool(np.array_equal(lg.argmax(-1),
                                                lc.argmax(-1))),
        k_cache_rel_rms_by_layer=k_rms,
        card_s=results["card"][2], cpu_s=results["cpu"][2])
    if not np.array_equal(kc[2], kp[2]):
        raise AssertionError("card and CPU caches hold different positions")
    if k_rms[0] > FIRST_LAYER_REL_RMS:
        raise AssertionError(f"card vs CPU first-layer K cache: relative "
                             f"RMS {k_rms[0]} (tolerance "
                             f"{FIRST_LAYER_REL_RMS})")
    if diff > CPU_LOGIT_MAX_OF_RANGE * span or rel_rms > CPU_LOGIT_REL_RMS:
        raise AssertionError(
            f"card vs CPU logits: max diff {diff} over range {span} "
            f"(tolerance {CPU_LOGIT_MAX_OF_RANGE * span}), relative RMS "
            f"{rel_rms} (tolerance {CPU_LOGIT_REL_RMS})")


# ------------------------------------------------------------- phase 6

class _InputAbsMax:
    """While open, keeps the largest |a| given to ``ops.mp_matmul`` (the
    f16 activations, after the executor's cast), on the card without a
    host sync: an overflow of the f16 cast shows as inf. The maximum
    accumulates in place in one tensor, so a CUDA graph captured while
    open updates it on every replay; the graphs that hold the probe must
    not outlive this object."""

    def __enter__(self):
        from repro_torch.kernels import ops
        self.ops, self.orig = ops, ops.mp_matmul
        self.amax = torch.zeros((), dtype=torch.float32, device="cuda")

        def probe(a, b, *args, **kwargs):
            torch.maximum(self.amax, a.detach().abs().amax().float(),
                          out=self.amax)
            return self.orig(a, b, *args, **kwargs)
        ops.mp_matmul = probe
        return self

    def __exit__(self, *exc):
        self.ops.mp_matmul = self.orig


def phase_fidelity(params, cfg_full, profile):
    """Full-width qwen2-0.5b under fidelity_fp16_ipu: every projection
    through ``mp_matmul``, at decode_block 1 and 4."""
    from repro_torch.kernels import ops
    from repro_torch.models import registry
    from repro_torch.serving import EngineConfig, ServingEngine
    cfg = dataclasses.replace(cfg_full, precision_policy="fidelity_fp16_ipu")
    api = registry.build(cfg)
    results, streams = {}, {}
    config = lambda blk: EngineConfig(  # noqa: E731
        batch_slots=8, cache_len=256, prefill_chunk=32, decode_block=blk)
    ops.reset_launch_counts()
    with _InputAbsMax() as probe:
        for blk in (1, 4):
            eng, streams[blk] = _graphs_vs_eager(
                cfg, api, params, config(blk),
                lambda: _requests(cfg, 8, 8, 32, 8, seed=12), results,
                f"block{blk}")
        amax = float(probe.amax)
        routes = sorted(set(eng.routing_report().values()))
        fused = eng.fused
        del eng                           # its graphs write probe.amax
    launches = ops.launch_counts()
    # profiled on an engine without the probe's reductions
    profile_numbers = (_profile(ServingEngine(cfg, api, params, config(4)),
                                cfg) if profile else None)
    log(6, launches=launches, mp_matmul_input_absmax=amax, routes=routes,
        fused=fused, runs=results, profile=profile_numbers)
    if launches["mp_matmul"] <= 0:
        raise AssertionError(f"fidelity_fp16_ipu launched no mp_matmul: "
                             f"{launches}")
    others = {k: v for k, v in launches.items() if k != "mp_matmul" and v}
    if others or routes != ["fp16_ipu"]:
        raise AssertionError(f"every projection must route to fp16_ipu: "
                             f"routes {routes}, other kernels {others}")
    if streams[1] != streams[4]:
        raise AssertionError("fidelity_fp16_ipu: greedy streams differ "
                             "between decode_block 1 and 4")
    if not np.isfinite(amax):
        raise AssertionError(f"an activation overflowed the f16 cast: "
                             f"largest |x| {amax}")
    return launches


# ------------------------------------------------------------- phase 7

PLAN_FILE = os.path.join(HERE, "results", "plans", "qwen2_0_5b.json")
PLAN_ROUTES = {"wq": "int8", "wk": "int8", "wv": "int8", "wo": "bf16",
               "w_gate": "int8", "w_up": "int8", "w_down": "int8"}


def _tagged_requests(cfg, n, lo, hi, max_new, seed):
    """``_requests`` with every other request tagged ``("accuracy",)``."""
    reqs = _requests(cfg, n, lo, hi, max_new, seed)
    for r in reqs[1::2]:
        r.tags = ("accuracy",)
    return reqs


def _fresh(reqs):
    """New requests with the same ids, prompts, budgets and tags."""
    from repro_torch.serving import Request
    return [Request(rid=r.rid, prompt=r.prompt,
                    max_new_tokens=r.max_new_tokens, tags=r.tags)
            for r in reqs]


def _route_wave(router, reqs):
    """Submit ``reqs`` through ``router``, each checked against the
    reference's rule as read here (``repro/serving/router.py:302-305``):
    an accuracy-tagged request to the least ``acc_proxy``, any other to
    the least ``cost * (1 + load)`` (lowest index on a tie). Drain as
    ``Router.step`` does (each replica with work steps once a tick),
    timing each replica's steps, and return ({rid: replica name},
    {rid: tokens}, wall seconds, {replica name: seconds in its
    steps})."""
    placed = {}
    for r in reqs:
        reps = router.replicas
        if "accuracy" in r.tags:
            want = min(range(len(reps)),
                       key=lambda i: (reps[i].cost["acc_proxy"],
                                      reps[i].load, i))
        else:
            costs = router._effective_costs()
            want = min(range(len(reps)),
                       key=lambda i: (costs[i] * (1.0 + reps[i].load), i))
        got = router.submit(r)
        if got is not reps[want]:
            raise AssertionError(f"request {r.rid} {r.tags} went to "
                                 f"{got.name}, the rule says "
                                 f"{reps[want].name}")
        placed[r.rid] = got.name
    busy = {rep.name: 0.0 for rep in router.replicas}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while router.has_pending():
        for rep in router.replicas:
            if rep.has_pending():
                t1 = time.perf_counter()
                rep.step()
                torch.cuda.synchronize()
                busy[rep.name] += time.perf_counter() - t1
    wall = time.perf_counter() - t0
    for r in reqs:
        if not r.done or r.new_tokens != r.budget:
            raise AssertionError(f"request {r.rid} ended with "
                                 f"{r.new_tokens}/{r.budget} tokens")
    return placed, {r.rid: list(r.tokens) for r in reqs}, wall, busy


def _wave_numbers(placed, reqs, wall, busy):
    """tok/s of the fleet over the wave's wall time, and of each replica
    over the seconds of its own steps (the replicas step in turns)."""
    from repro_torch.serving.metrics import percentiles, request_metrics
    new = {}
    for r in reqs:
        new[placed[r.rid]] = new.get(placed[r.rid], 0) + r.new_tokens
    total = sum(new.values())
    ttft = percentiles([request_metrics(r)["ttft_s"] for r in reqs])
    return {"wall_s": wall, "new_tokens": total, "tok_per_s": total / wall,
            "ttft_p50_s": ttft["p50"], "ttft_max_s": ttft["max"],
            "routed": {k: sum(1 for v in placed.values() if v == k)
                       for k in new},
            "replica_step_s": busy,
            "replica_tok_per_s": {k: v / busy[k] for k, v in new.items()}}


def _solo_streams(reps, reqs):
    """{replica name: {rid: tokens}}: every request served alone on every
    replica's engine."""
    out = {}
    for rep in reps:
        out[rep.name] = {}
        for r in _fresh(reqs):
            rep.engine.submit(r)
            rep.engine.run_until_drained()
            out[rep.name][r.rid] = list(r.tokens)
    return out


def _check_placed(placed, streams, solo, what):
    bad = [rid for rid, name in placed.items()
           if streams[rid] != solo[name][rid]]
    if bad:
        raise AssertionError(f"{what}: requests {bad} differ from their "
                             f"replica serving them alone")


def _plan_replica(rep):
    """The plan replica's checks: routing, the scales it took, and one
    decode step's launches (``fused_dequant_mm`` once per int8
    projection, nothing else)."""
    from repro_torch.autotune.plan import load_act_scales
    eng = rep.engine
    routes = {p.rsplit("/", 1)[1]: m for p, m in eng.routing_report().items()}
    if routes != PLAN_ROUTES or not eng.fused:
        raise AssertionError(f"plan replica: routes {routes}, fused "
                             f"{eng.fused}")
    if eng.act_scales != load_act_scales(PLAN_FILE):
        raise AssertionError("act_calibration='auto' did not take the "
                             "plan's scales")
    step = _step_launches(eng, {"fused_dequant_mm": 6 * eng.cfg.n_layers})
    return routes, step, dict(eng.act_scales)


def _leaves_equal(a, b):
    from repro_torch.quant.prepare import tree_manifest
    from repro_torch.serving.graphs import same_bits
    la, lb = tree_manifest(a)[1], tree_manifest(b)[1]
    return len(la) == len(lb) and all(
        x.device == y.device and same_bits(x, y) for x, y in zip(la, lb))


def _checkpoint_round_trip(params, cfg_full, config):
    """An int4_serving engine, fused and calibrated, saved and rebuilt:
    no rework on rebuild, bit-equal leaves, the same streams, and a
    flipped byte refused."""
    import shutil
    import tempfile
    from repro_torch.checkpoint import (ChecksumError, restore_checkpoint)
    from repro_torch.fabric import build_engine, save_engine_checkpoint
    from repro_torch.layers.mplinear import count_weight_quant
    from repro_torch.models import registry
    from repro_torch.quant import calibrate
    from repro_torch.serving import ServingEngine
    cfg = dataclasses.replace(cfg_full, precision_policy="int4_serving")
    calls = []
    real = calibrate.calibrate_act_scales

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)
    calibrate.calibrate_act_scales = counted
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with count_weight_quant() as wq_fresh:
            eng = ServingEngine(cfg, registry.build(cfg), params,
                                config=config)
        torch.cuda.synchronize()
        fresh_s = time.perf_counter() - t0
        fresh_calls = len(calls)
        reqs = _requests(cfg, 8, 8, 64, 16, seed=21)
        _, saved_streams, _ = _serve(cfg, None, None, None, reqs, eng=eng)
        with tempfile.TemporaryDirectory() as d:
            t0 = time.perf_counter()
            step_dir = save_engine_checkpoint(eng, os.path.join(d, "ckpt"))
            save_s = time.perf_counter() - t0
            disk = sum(os.path.getsize(os.path.join(step_dir, f))
                       for f in os.listdir(step_dir))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with count_weight_quant() as wq_rebuilt:
                again = build_engine(os.path.join(d, "ckpt"))
            torch.cuda.synchronize()
            restore_s = time.perf_counter() - t0
            rebuild_calls = len(calls) - fresh_calls
            restore_parts = {}
            for verify in (True, False):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                tree, _ = restore_checkpoint(os.path.join(d, "ckpt"), 0,
                                             verify=verify)
                torch.cuda.synchronize()
                restore_parts[f"verify={verify}"] = time.perf_counter() - t0
                del tree
            if wq_rebuilt[0] or rebuild_calls or not wq_fresh[0] \
                    or fresh_calls != 1:
                raise AssertionError(
                    f"rebuild did {wq_rebuilt[0]} weight quantizations and "
                    f"{rebuild_calls} calibrations (fresh: {wq_fresh[0]}, "
                    f"{fresh_calls})")
            if again.device != eng.device or not _leaves_equal(
                    eng.params, again.params):
                raise AssertionError("restored leaves differ from the "
                                     "saved engine's, or left the card")
            if not again.fused or again.act_scales != eng.act_scales:
                raise AssertionError("the rebuilt engine lost its fused "
                                     "route or its scales")
            _, restored_streams, restored_wave = _serve(
                cfg, None, None, None, _fresh(reqs), eng=again)
            if restored_streams != saved_streams:
                raise AssertionError("the rebuilt engine serves other "
                                     "streams than the saved one")
            # one flipped byte in one leaf of a copy
            bad = os.path.join(d, "bad")
            shutil.copytree(os.path.join(d, "ckpt"), bad)
            npz = os.path.join(bad, os.path.basename(step_dir), "arrays.npz")
            with np.load(npz) as data:
                arrays = {k: data[k] for k in data.files}
            from repro_torch.checkpoint import _msgpack
            with open(os.path.join(step_dir, "manifest.msgpack"), "rb") as f:
                paths = _msgpack.unpackb(f.read())["paths"]
            leaf = next(i for i, p in enumerate(paths)
                        if p.endswith("['w_down']['w'].data"))
            flat = arrays[f"a{leaf}"].reshape(-1)
            flat[flat.size // 2] ^= np.array(0x10, flat.dtype)
            np.savez(npz, **arrays)
            try:
                restore_checkpoint(bad, 0)
            except ChecksumError as e:
                if paths[leaf] not in str(e):
                    raise AssertionError(f"ChecksumError names another "
                                         f"leaf: {e}") from None
                refused = str(e)
            else:
                raise AssertionError("a flipped byte restored silently")
    finally:
        calibrate.calibrate_act_scales = real
    return {"fresh_prepare_calibrate_s": fresh_s, "save_s": save_s,
            "restore_s": restore_s, "restore_checkpoint_s": restore_parts,
            "bytes_on_disk": disk,
            "weight_quant_fresh": wq_fresh[0],
            "weight_quant_rebuilt": wq_rebuilt[0],
            "calibrations_rebuilt": rebuild_calls,
            "restored_wave": restored_wave, "corrupt_leaf": paths[leaf],
            "refused": refused}


def phase_fleet(params, cfg_full):
    """Full-width qwen2-0.5b from the committed plan: the plan replica's
    routes and launches, a two-replica plan-aware fleet against each
    replica serving alone (static, then online correction), and an
    int4_serving engine checkpoint round trip."""
    import gc
    from repro_torch.core.policy import get_policy
    from repro_torch.kernels import ops
    from repro_torch.serving import EngineConfig, Router, build_replicas
    from repro_torch.serving.graphs import count_delta
    from repro_torch.serving.router import replica_cost
    t_phase = time.perf_counter()
    config = EngineConfig(batch_slots=8, cache_len=256, prefill_chunk=32,
                          decode_block=4, act_calibration="auto")
    plan = f"plan:{PLAN_FILE}"
    t0 = time.perf_counter()
    reps = build_replicas(cfg_full, [plan, "bf16"], params=params,
                          config=config)
    build_s = time.perf_counter() - t0
    cost_s = {}
    for rep in reps:
        rcfg = dataclasses.replace(cfg_full, precision_policy=rep.policy_name)
        t0 = time.perf_counter()
        cost = replica_cost(rcfg, get_policy(rep.policy_name))
        cost_s[rep.name] = time.perf_counter() - t0
        if any(cost[k] != rep.cost[k] for k in cost):
            raise AssertionError(f"{rep.name}: replica_cost is not "
                                 f"deterministic: {cost} / {rep.cost}")
    routes, step_launches, scales = _plan_replica(reps[0])

    # static plan-aware routing: a first wave (captures), a warm wave
    reqs = _tagged_requests(cfg_full, 16, 8, 64, 16, seed=17)
    before = ops.launch_counts()
    waves = {}
    placed, streams, *timing = _route_wave(Router(reps), reqs)
    waves["first"] = _wave_numbers(placed, reqs, *timing)
    warm_reqs = _fresh(reqs)
    placed_w, streams_w, *timing = _route_wave(Router(reps), warm_reqs)
    waves["warm"] = _wave_numbers(placed_w, warm_reqs, *timing)
    launches = count_delta(before, ops.launch_counts())
    reserved = _reserved_after()
    if streams_w != streams or placed_w != placed:
        raise AssertionError("the warm wave routed or served otherwise")
    if any(placed[r.rid] != "bf16" for r in reqs if r.tags):
        raise AssertionError(f"accuracy-tagged requests left bf16: {placed}")
    if set(launches) != {"fused_dequant_mm"}:
        raise AssertionError(f"the fleet launched {launches}")
    solo = _solo_streams(reps, reqs)
    _check_placed(placed, streams, solo, "static fleet")

    # online correction on the replicas' measured stats
    online = Router(reps, cost_correction="online")
    online_reqs = _fresh(reqs)
    placed_o, streams_o, *timing = _route_wave(online, online_reqs)
    waves["online"] = _wave_numbers(placed_o, online_reqs, *timing)
    _check_placed(placed_o, streams_o, solo, "online fleet")
    report = online.routing_report()
    graphs = {rep.name: rep.engine.metrics()["graphs"]["captures"]
              for rep in reps}
    costs = {rep.name: {k: v for k, v in rep.cost.items()
                        if k != "weight_bytes"} for rep in reps}
    weight_bytes = {rep.name: rep.cost["weight_bytes"] for rep in reps}
    del reps, online
    gc.collect()
    ckpt = _checkpoint_round_trip(params, cfg_full, dataclasses.replace(
        config, fused_executors="on"))
    log(7, plan_routes=routes, decode_step_launches=step_launches,
        plan_scales=scales, build_replicas_s=build_s,
        replica_cost=costs, replica_cost_s=cost_s, weight_bytes=weight_bytes,
        fleet=waves, fleet_launches=launches,
        reserved_two_engines=reserved, captures=graphs,
        routing_report=report, checkpoint=ckpt,
        phase_s=time.perf_counter() - t_phase)
    return launches


# ------------------------------------------------------ phases 8 and 9

def _free():
    import gc
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def _rel(a, b):
    """Relative RMS of ``a - b`` against ``b`` (any devices)."""
    a, b = a.double().cpu(), b.double().cpu()
    return float(torch.sqrt(((a - b) ** 2).mean() / (b ** 2).mean()))


def _no_tf32():
    """The f32 router and head must not run on TF32: a TF32 router
    moves expert selection."""
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise AssertionError("f32 matmuls may run on TF32")


def _step_launches(eng, want):
    """One decode step of ``eng``'s program, its launches against
    ``want``."""
    import contextlib
    from repro_torch.kernels import ops
    from repro_torch.serving.graphs import count_delta
    before = ops.launch_counts()
    eng._trace_decode(contextlib.nullcontext)
    torch.cuda.synchronize()
    step = count_delta(before, ops.launch_counts())
    if step != want:
        raise AssertionError(f"{eng.cfg.arch_id}: one decode step launched "
                             f"{step}, want {want}")
    return step


def _prepared_engine(cfg, api, config):
    """Random f32 weights from seed 0, one engine to calibrate and
    prepare them, and then only its prepared tree: the raw projection
    weights (the f32 expert stacks among them) are released. Returns
    (prepared tree, act scales, memory numbers: ``memory_allocated``
    before the init (what earlier phases still hold), with the raw
    parameters, with only the prepared tree, and its peak)."""
    from repro_torch.models import registry
    from repro_torch.serving.engine import ServingEngine
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    params = registry.init_params(cfg, seed=0)
    torch.cuda.synchronize()
    raw = torch.cuda.memory_allocated()
    eng = ServingEngine(cfg, api, params, config=config)
    if eng.weight_quant_trace_count():
        raise AssertionError("the prepared engine quantizes weights")
    prepared, scales = eng.params, eng.act_scales
    del eng, params
    _free()
    return prepared, scales, {
        "allocated_before_init": before, "allocated_raw_params": raw,
        "allocated_prepared_only": torch.cuda.memory_allocated(),
        "max_allocated_preparing": torch.cuda.max_memory_allocated()}


def _serve_both_blocks(cfg, api, prepared, scales, make_reqs, step_want,
                       results, eager_probe=None, profile=False,
                       blocks=(1, 4)):
    """The prepared model served at each of ``blocks``, each a first
    (capturing) wave, a warm wave and an eager wave; identical streams
    everywhere, the same kernel launches graphed and eager, and one
    decode step's launches equal to ``step_want`` (``profile``: and a
    profile of one decode block of the last block length, replayed and
    eager, into ``results["profile"]``). Returns the launches of every
    wave."""
    from repro_torch.kernels import ops
    from repro_torch.serving import EngineConfig
    streams = {}
    ops.reset_launch_counts()
    for blk in blocks:
        config = EngineConfig(batch_slots=8, cache_len=256, prefill_chunk=32,
                              decode_block=blk, act_calibration=scales,
                              fused_executors="on")
        eng, streams[blk] = _graphs_vs_eager(
            cfg, api, prepared, config, make_reqs, results, f"block{blk}",
            eager_probe=eager_probe if blk == 1 else None)
        if not eng.fused or eng.weight_quant_trace_count() \
                or eng.staged_trace_count():
            raise AssertionError(f"{cfg.arch_id}: not the fused path")
        results[f"block{blk}"]["step_launches"] = _step_launches(
            eng, step_want)
        if profile and blk == blocks[-1]:
            results["profile"] = _profile(eng, cfg)
        del eng
        _free()
    launches = ops.launch_counts()
    if any(streams[b] != streams[blocks[0]] for b in blocks):
        raise AssertionError(f"{cfg.arch_id}: greedy streams differ "
                             f"between decode blocks {blocks}")
    if {k for k, v in launches.items() if v} != set(step_want):
        raise AssertionError(f"{cfg.arch_id} launched {launches}")
    return launches


class _DropCount:
    """While open, counts on the card (no host sync) the (token, k)
    assignments ``layers.moe.route`` drops at capacity and all it makes,
    over every call with more than one token per group (prefill)."""

    def __enter__(self):
        from repro_torch.layers import moe
        self.moe, self.real = moe, moe.route
        self.counts = torch.zeros(2, dtype=torch.int64, device="cuda")

        def route(params, cfg, x):
            out = self.real(params, cfg, x)
            if x.shape[1] > 1:
                fits = out[4]
                self.counts[0] += (~fits).sum()
                self.counts[1] += fits.numel()
            return out
        moe.route = route
        return self

    def __exit__(self, *exc):
        self.moe.route = self.real
        self.dropped, self.assigned = (int(v) for v in self.counts.tolist())


def _moe_layer_card_vs_cpu(cfg, prepared):
    """Layer 0's MoE block alone at full width, on the card (its prepared
    experts) and on the CPU (a copy), for a 32-token chunk of two rows
    and a decode step of eight: expert ids, queue positions and ``fits``
    identical, outputs within phase 5's first-layer tolerance."""
    from repro_torch.convert import tree_to
    from repro_torch.core.policy import get_policy
    from repro_torch.layers import moe
    from repro_torch.models.lm import moe_cfg, unstack
    mcfg = moe_cfg(cfg)
    policy = get_policy(cfg.precision_policy)
    card = unstack(prepared["blocks"]["b0"]["moe"])[0]
    cpu = tree_to(card, "cpu")
    rng = np.random.default_rng(8)
    out = {}
    for what, shape in (("chunk", (2, 32, cfg.d_model)),
                        ("decode", (8, 1, cfg.d_model))):
        x = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                             ).to(torch.bfloat16)
        got = {}
        for where, tree, xx in (("card", card, x.cuda()), ("cpu", cpu, x)):
            t0 = time.perf_counter()
            with torch.no_grad():
                _, ids, _, pos, fits, cap = moe.route(tree, mcfg, xx)
                y, aux = moe.forward(tree, mcfg, xx, policy, "block/moe")
            if where == "card":
                torch.cuda.synchronize()
            got[where] = [t.cpu() for t in (ids, pos, fits, y, aux)] + [
                time.perf_counter() - t0]
        (ic, pc, fc, yc, ac, tc), (ip, pp, fp, yp, ap, tp) = (
            got["card"], got["cpu"])
        for name, a, b in (("expert ids", ic, ip), ("queue positions", pc,
                                                    pp), ("fits", fc, fp)):
            if not torch.equal(a, b):
                raise AssertionError(f"MoE {what}: {name} differ between "
                                     f"the card and the CPU")
        rel = _rel(yc, yp)
        if not bool(torch.isfinite(yc).all()) or rel > FIRST_LAYER_REL_RMS:
            raise AssertionError(f"MoE {what}: card vs CPU relative RMS "
                                 f"{rel} (tolerance {FIRST_LAYER_REL_RMS})")
        out[what] = {"shape": list(shape), "capacity": cap,
                     "dropped": int((~fp).sum()), "assignments": fp.numel(),
                     "y_rel_rms": rel,
                     "y_max_abs_diff": float((yc.double() - yp.double()
                                              ).abs().max()),
                     "aux_card": float(ac), "aux_cpu": float(ap),
                     "card_s": tc, "cpu_s": tp}
    return out


def _decode_step_ms(cfg, api, prepared, batch):
    """One decode step of ``batch`` rows (fused executors) replayed from
    a CUDA graph; for an MoE model also, timed the same way, what the
    step spends dequantizing every expert stack of every layer to bf16
    (``layers.moe.expert_weights``, as the forward does)."""
    from repro_torch.core.policy import get_policy
    from repro_torch.layers import moe
    from repro_torch.layers.mplinear import executor_variant
    from repro_torch.models import lm
    from repro_torch.models.lm import unstack
    caches = api.init_cache(batch, 256)
    tok = torch.zeros((batch, 1), dtype=torch.int32, device="cuda")
    pos = torch.full((batch,), 40, dtype=torch.int32, device="cuda")

    def step():
        with executor_variant("fused"):
            api.decode_step(prepared, {"token": tok, "pos": pos}, caches)

    with torch.no_grad():
        out = {"rows": batch, "decode_step_ms": graph_ms(step, reps=5)}
    if cfg.moe:
        spec = get_policy(cfg.precision_policy).spec_for(
            "block/moe/experts")
        stacks = prepared["blocks"]["b0"]["moe"]
        groups = cfg.n_layers // len(lm.group_kinds(cfg))

        def dequant():
            layers = {n: unstack(stacks[n]["w"])
                      for n in ("w_gate", "w_up", "w_down")}
            for i in range(groups):
                for n in ("w_gate", "w_up", "w_down"):
                    moe.expert_weights(layers[n][i], spec).to(
                        torch.bfloat16)

        with torch.no_grad():
            out["expert_dequant_ms"] = graph_ms(dequant, reps=5)
        out["expert_dequant_share"] = out["expert_dequant_ms"] / out[
            "decode_step_ms"]
    del caches
    _free()
    return out


QWEN3_MOE_LAYERS = 16


def phase_moe(smi, profile):
    """qwen3-moe-30b-a3b at full width (16 of its 48 layers) under
    int4_serving with calibrated act scales and the fused executors."""
    from repro_torch.configs import get_config
    from repro_torch.models import registry
    from repro_torch.serving import EngineConfig
    _no_tf32()
    t_phase = time.perf_counter()
    full = get_config("qwen3-moe-30b-a3b")
    cfg = dataclasses.replace(full, n_layers=QWEN3_MOE_LAYERS,
                              precision_policy="int4_serving")
    api = registry.build(cfg)
    prepared, scales, memory = _prepared_engine(
        cfg, api, EngineConfig(batch_slots=8, cache_len=256,
                               prefill_chunk=32, act_calibration="auto",
                               fused_executors="on"))
    results = {}
    torch.cuda.reset_peak_memory_stats()
    drops = _DropCount()
    launches = _serve_both_blocks(
        cfg, api, prepared, scales,
        lambda: _requests(cfg, 8, 8, 64, 8, seed=21),
        {"fused_dequant_mm": 4 * cfg.n_layers}, results, eager_probe=drops,
        profile=profile)
    memory["max_allocated_serving"] = torch.cuda.max_memory_allocated()
    memory["reserved_after"] = _reserved_after()
    layer0 = _moe_layer_card_vs_cpu(cfg, prepared)
    step = _decode_step_ms(cfg, api, prepared, 8)
    log(8, card=smi, arch=cfg.arch_id, layers=cfg.n_layers,
        reduced={"n_layers": f"{full.n_layers} -> {cfg.n_layers}: 48 "
                 f"layers of f32 parameters are about 122 GB"},
        launches=launches, runs=results, memory=memory,
        prefill_dropped={"dropped": drops.dropped,
                         "assignments": drops.assigned,
                         "wave": "block1_eager, padded positions included"},
        layer0_card_vs_cpu=layer0, decode_step=step,
        phase_s=time.perf_counter() - t_phase)
    del prepared
    _free()
    return launches


def phase_gemma2(smi, profile):
    """gemma2-9b whole (42 layers) at full width under int4_serving with
    calibrated act scales and the fused executors."""
    from repro_torch.configs import get_config
    from repro_torch.models import registry
    from repro_torch.serving import EngineConfig
    _no_tf32()
    t_phase = time.perf_counter()
    cfg = dataclasses.replace(get_config("gemma2-9b"),
                              precision_policy="int4_serving")
    api = registry.build(cfg)
    prepared, scales, memory = _prepared_engine(
        cfg, api, EngineConfig(batch_slots=8, cache_len=256,
                               prefill_chunk=32, act_calibration="auto",
                               fused_executors="on"))
    results = {}
    torch.cuda.reset_peak_memory_stats()
    launches = _serve_both_blocks(
        cfg, api, prepared, scales,
        lambda: _requests(cfg, 4, 8, 64, 8, seed=22),
        {"fused_dequant_mm": 7 * cfg.n_layers}, results, profile=profile)
    memory["max_allocated_serving"] = torch.cuda.max_memory_allocated()
    memory["reserved_after"] = _reserved_after()
    step = _decode_step_ms(cfg, api, prepared, 8)
    log(9, card=smi, arch=cfg.arch_id, layers=cfg.n_layers,
        launches=launches, runs=results, memory=memory, decode_step=step,
        phase_s=time.perf_counter() - t_phase)
    del prepared
    _free()
    return launches


# ------------------------------------------------------- phases 10-12

# families whose decode state is recurrent, not position-tagged KV caches
RECURRENT_FAMILIES = ("rwkv", "griffin")
# griffin's first (rec, rec, attn) group chained, card vs CPU: three
# blocks deep, so past the first block's amplification (see
# FIRST_LAYER_REL_RMS), held to the whole-model gate
GROUP_REL_RMS = CPU_LOGIT_REL_RMS

# per family: the phase, requests served, their seed, the decode blocks
FAMILIES = {
    "internvl2-1b": (10, 6, 23, (1, 4)),
    "rwkv6-1.6b": (11, 6, 24, (1,)),
    "recurrentgemma-9b": (12, 4, 25, (1,)),
}


def _launches_per_step(cfg):
    """``fused_dequant_mm`` launches of one decode step: one per
    projection. vlm 7 a layer as qwen2 (its projector runs only in
    prefill: 168 at full width); rwkv 8 a layer (w_r, w_k, w_v, w_g,
    w_o, c_key, c_val, c_rec: 192); griffin 6 a rec block (w_in_rnn,
    w_in_gate, w_out and the MLP's three) and 7 an attention block (26 x
    6 + 12 x 7 = 240)."""
    from repro_torch.models import griffin
    if cfg.family == "rwkv":
        return 8 * cfg.n_layers
    if cfg.family == "griffin":
        pat, n_groups, _ = griffin._pattern(cfg)
        n_attn = n_groups * pat.count("attn")
        return 6 * (cfg.n_layers - n_attn) + 7 * n_attn
    return 7 * cfg.n_layers


def _card_vs_cpu(fn, tree, state, tol=FIRST_LAYER_REL_RMS):
    """``fn(tree, state, device) -> (out, state)`` on the card (fused
    executors) and on the CPU (a copy: the plain versions), from the
    same state: relative RMS of the output and of each floating state
    leaf (updated in place on both sides), each within ``tol``."""
    from repro_torch.convert import tree_to
    from repro_torch.layers.mplinear import executor_variant
    from repro_torch.serving import graphs
    got = {}
    for where in ("card", "cpu"):
        t = tree if where == "card" else tree_to(tree, "cpu")
        st = tree_to(graphs.clone_tree(state), "cuda" if where == "card"
                     else "cpu")
        t0 = time.perf_counter()
        with torch.no_grad(), executor_variant("fused"):
            out, st = fn(t, st, "cuda" if where == "card" else "cpu")
        if where == "card":
            torch.cuda.synchronize()
        got[where] = (out, st, time.perf_counter() - t0)
    (oc, sc, tc), (op, sp, tp) = got["card"], got["cpu"]
    rel = {"out": _rel(oc, op)}
    rel.update({"/".join(map(str, p)): _rel(a, b) for (p, a), (_, b) in
                zip(graphs.leaves(sc), graphs.leaves(sp))
                if a.dtype.is_floating_point})
    bad = {k: v for k, v in rel.items() if not v <= tol}
    if bad or not bool(torch.isfinite(oc).all()):
        raise AssertionError(f"card vs CPU relative RMS {bad} (tolerance "
                             f"{tol})")
    return {"rel_rms": rel, "tolerance": tol, "card_s": tc, "cpu_s": tp}


class _Taps:
    """While open, keeps what a griffin block's projections see: the
    input and output of each ``mp_linear`` call of the RG-LRU, attention
    and MLP layers, the int8 act codes of each input under its weight's
    calibrated scale (``quantize_symmetric``, the fused executor's
    rounding), and the RG-LRU's conv output and gates ``a``, ``b``."""

    def __enter__(self):
        from repro_torch.layers import attention, mlp, rglru
        from repro_torch.quant.quantize import quantize_symmetric
        self.taps, self.mods = {}, (attention, mlp, rglru)
        self.real, self.gates = [m.mp_linear for m in self.mods], \
            rglru._gates

        def tapped(real):
            def run(params, x, spec, *a, **kw):
                y = real(params, x, spec, *a, **kw)
                path = kw["path"].split("/", 1)[1]
                self.taps[f"{path} in"] = x.detach().clone()
                sa = getattr(params["w"], "act_scale", None)
                if sa is not None:
                    self.taps[f"{path} codes"] = quantize_symmetric(
                        x, 8, scale=sa)[0]
                self.taps[f"{path} out"] = y.detach().clone()
                return y
            return run

        def gates(params, xr):
            a, b = self.gates(params, xr)
            self.taps.update({"rec/conv out": xr.detach().clone(),
                              "rec/gates a": a.detach().clone(),
                              "rec/gates b": b.detach().clone()})
            return a, b
        for m, real in zip(self.mods, self.real):
            m.mp_linear = tapped(real)
        rglru._gates = gates
        return self.taps

    def __exit__(self, *exc):
        for m, real in zip(self.mods, self.real):
            m.mp_linear = real
        self.mods[2]._gates = self.gates

    @staticmethod
    def compare(card, cpu):
        """Each tap, in the order the block made them: relative RMS and
        elements that differ; for act codes, the codes that differ, the
        mean |code| and the most that one moved."""
        out = {}
        for k, a in card.items():
            a, b = a.cpu(), cpu[k]
            n = int((a != b).sum())
            if k.endswith("codes"):
                d = (a.int() - b.int()).abs()
                out[k] = {"differ": n, "mean_abs": float(
                    b.float().abs().mean()), "max_step": int(d.max())}
            else:
                out[k] = {"rel_rms": _rel(a, b), "differ": n,
                          "of": b.numel()}
        return out


def _first_layers_card_vs_cpu(cfg, api, prepared):
    """rwkv: layer 0; griffin: each block of the first (rec, rec, attn)
    group from the same input, with what each of its projections saw
    (``_Taps``), and the group chained; one decode step of 8 rows from a
    random state, card against CPU. vlm:
    one prefill of 2 rows of 16 tokens behind 256 patches (the projector
    at 512 rows, every projection at 544), logits and caches card
    against CPU within phase 5's whole-model relative RMS, and the rows
    of every ``fused_dequant_mm`` call."""
    from repro_torch.core.policy import get_policy
    from repro_torch.kernels import ops
    from repro_torch.models import griffin, rwkv
    from repro_torch.models.lm import unstack
    from repro_torch.serving import graphs
    policy = get_policy(cfg.precision_policy)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(31)
    rnd = lambda t: (torch.randn(t.shape, generator=gen,  # noqa: E731
                                 device="cuda") * 0.5).to(t.dtype)
    x = torch.randn((8, 1, cfg.d_model), generator=gen,
                    device="cuda").to(torch.bfloat16)
    if cfg.family == "rwkv":
        state = graphs.tree_map(lambda p, t: rnd(t), api.init_cache(8, 0))
        state = type(state)(*(t[0] for t in state))
        return {"layer0": _card_vs_cpu(
            lambda t, st, dev: (rwkv._block(t, cfg, x.to(dev), st, policy,
                                            True), st),
            unstack(prepared["blocks"])[0], state)}
    if cfg.family == "griffin":
        caches = api.init_cache(8, 256)["groups"]
        pos = torch.full((8,), 40, dtype=torch.int32, device="cuda")
        pat, _, _ = griffin._pattern(cfg)
        trees, states, out = {}, {}, {}
        for i, kind in enumerate(pat):
            b, c = f"b{i}", caches[f"b{i}"]
            trees[b] = unstack(prepared["blocks"][b])[0]
            states[b] = type(c)(*(rnd(t[0]) if kind == "rec" else t[0]
                                  for t in c))
            taps = {}

            def block(t, st, dev, kind=kind):
                p = pos.to(dev)
                with _Taps() as taps[dev]:
                    y = griffin._apply_block(t, cfg, kind, x.to(dev),
                                             p[:, None], policy, "decode",
                                             st, p)
                return y, st
            out[b] = _card_vs_cpu(block, trees[b], states[b])
            out[b]["stages"] = _Taps.compare(taps["cuda"], taps["cpu"])

        def group(t, st, dev):
            p, y = pos.to(dev), x.to(dev)
            for i, kind in enumerate(pat):
                y = griffin._apply_block(t[f"b{i}"], cfg, kind, y,
                                         p[:, None], policy, "decode",
                                         st[f"b{i}"], p)
            return y, st
        return {"group0": out, "group0_chained": _card_vs_cpu(
            group, trees, states, GROUP_REL_RMS)}
    # vlm: a prefill behind 256 patches, every fused_dequant_mm call's rows
    rows, real = [], ops.fused_dequant_matmul

    def counted(x2, *a, **kw):
        if x2.is_cuda:
            rows.append((int(x2.shape[0]), int(x2.shape[1])))
        return real(x2, *a, **kw)

    tokens = torch.randint(0, cfg.vocab, (2, 16), generator=gen,
                           device="cuda", dtype=torch.int32)
    patches = torch.randn((2, cfg.n_patches, cfg.vit_dim), generator=gen,
                          device="cuda")
    batch = {"tokens": tokens, "patches": patches}
    ops.fused_dequant_matmul = counted
    try:
        out = _card_vs_cpu(
            lambda t, st, dev: (api.prefill(
                t, {k: v.to(dev) for k, v in batch.items()}, st)[0][
                    :, :cfg.vocab], st),
            prepared, api.init_cache(2, 16), CPU_LOGIT_REL_RMS)
    finally:
        ops.fused_dequant_matmul = real
    projector = [r for r in rows if r[1] == cfg.vit_dim]
    if len(rows) != 2 + 7 * cfg.n_layers or projector != [
            (2 * cfg.n_patches, cfg.vit_dim)] or min(
            r[0] for r in rows) < 2 * cfg.n_patches:
        raise AssertionError(f"vlm prefill: fused_dequant_mm calls {rows}")
    out["fused_dequant_calls"] = len(rows)
    out["rows"] = sorted({r[0] for r in rows})
    return {"prefill_with_patches": out}


def phase_family(arch, smi, profile):
    """``arch`` whole at full width under int4_serving (calibrated,
    prepared, only the prepared tree kept), served by teacher-forced
    admission through the engine's graphs."""
    from repro_torch.configs import get_config
    from repro_torch.models import registry
    from repro_torch.serving import EngineConfig
    from repro_torch.serving.engine import ServingEngine
    num, n_req, seed, blocks = FAMILIES[arch]
    _no_tf32()
    t_phase = time.perf_counter()
    cfg = dataclasses.replace(get_config(arch),
                              precision_policy="int4_serving")
    api = registry.build(cfg)
    per_step = _launches_per_step(cfg)
    prepared, scales, memory = _prepared_engine(
        cfg, api, EngineConfig(batch_slots=8, cache_len=256,
                               act_calibration="auto",
                               fused_executors="on"))
    refused = None
    if 4 not in blocks:
        try:
            ServingEngine(cfg, api, prepared, config=EngineConfig(
                batch_slots=8, cache_len=256, decode_block=4))
        except ValueError as e:
            refused = str(e)
        if not refused or "not eligible" not in refused:
            raise AssertionError(f"{arch}: decode_block=4 was not refused")
    results = {}
    torch.cuda.reset_peak_memory_stats()
    make = lambda: _requests(cfg, n_req, 8, 32, 8, seed=seed)  # noqa: E731
    forced = sum(len(r.prompt) - 1 for r in make())
    launches = _serve_both_blocks(
        cfg, api, prepared, scales, make, {"fused_dequant_mm": per_step},
        results, profile=profile, blocks=blocks)
    for wave, numbers in results.items():
        if isinstance(numbers, dict) and "teacher_forced_tokens" in numbers \
                and (numbers["teacher_forced_tokens"] != forced
                     or numbers["prefill_calls"]):
            raise AssertionError(f"{arch} {wave}: teacher-forced "
                                 f"{numbers['teacher_forced_tokens']} "
                                 f"tokens, want {forced}")
    memory["max_allocated_serving"] = torch.cuda.max_memory_allocated()
    memory["reserved_after"] = _reserved_after()
    first = _first_layers_card_vs_cpu(cfg, api, prepared)
    step = _decode_step_ms(cfg, api, prepared, 8)
    log(num, card=smi, arch=arch, family=cfg.family, layers=cfg.n_layers,
        launches=launches, fused_dequant_per_step=per_step,
        teacher_forced_per_wave=forced,
        decode_block_4_refused=refused, runs=results, memory=memory,
        card_vs_cpu=first, decode_step=step,
        phase_s=time.perf_counter() - t_phase)
    del prepared
    _free()
    return launches


# ------------------------------------------------------------- phase 13

ENCDEC = "seamless-m4t-medium"
ENCDEC_POLICIES = ("int4_serving", "int8_serving")
# 8 rows of 32-token prompts behind 128 frames (the reference's
# seq_len // 4 for 512), 16 greedy new tokens, a 64-token cache
ENCDEC_ROWS, ENCDEC_PROMPT, ENCDEC_FRAMES = 8, 32, 128
ENCDEC_NEW, ENCDEC_CACHE = 16, 64
# prefill against decode (tests/test_models_smoke.py::
# test_prefill_decode_consistency's 2e-2), held here as a relative RMS:
# at full width its pointwise atol = rtol = 2e-2 fails on the CPU too,
# where rounding alone, not the cache, sets the difference (see
# _encdec_consistency); a wrong slot, tag or mask moves the logits by
# their whole scale
CONSISTENCY_TOL = 2e-2


def _encdec_launches(cfg):
    """``fused_dequant_mm`` launches of one prefill and of one decode
    step, one per projection: the frontend, 7 an encoder layer and 11 a
    decoder layer (self-attention 4, cross-attention 4, MLP 3) in
    prefill; the decoder alone in a decode step, whose cross-attention
    projects its K and V from the encoder output again (1 + 12 x 7 + 12
    x 11 = 217 and 12 x 11 = 132 at full width)."""
    from repro_torch.models import encdec
    return 1 + 7 * encdec.n_enc_layers(cfg) + 11 * cfg.n_layers, \
        11 * cfg.n_layers


def _encdec_batch(cfg, device, seed=13):
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return {"tokens": torch.randint(0, cfg.vocab,
                                    (ENCDEC_ROWS, ENCDEC_PROMPT + 1),
                                    generator=gen, device=device,
                                    dtype=torch.int32),
            "frames": torch.randn((ENCDEC_ROWS, ENCDEC_FRAMES,
                                   cfg.frontend_dim), generator=gen,
                                  device=device)}


def _encdec_greedy(api, tree, batch, program=None, state=None):
    """Prefill the prompts, then ``ENCDEC_NEW - 1`` greedy decode steps,
    eager or through ``program`` (the port's program cache: a CUDA graph
    captured at its first call, replayed after), under the fused
    executors. ``state`` (caches, encoder-output buffer), where given,
    takes the prefill's writes, so that a program's static state stays
    the same tensors from run to run. Returns the tokens (B,
    ENCDEC_NEW), each decode step's logits (copies), the prefill's
    logits and encoder output, and the launches of the prefill and of
    each decode step."""
    from repro_torch.kernels import ops
    from repro_torch.layers.mplinear import executor_variant
    from repro_torch.serving.graphs import count_delta
    before = ops.launch_counts()
    prompt = {"tokens": batch["tokens"][:, :ENCDEC_PROMPT],
              "frames": batch["frames"]}
    caches = api.init_cache(ENCDEC_ROWS, ENCDEC_CACHE) if state is None \
        else state[0]
    with torch.no_grad(), executor_variant("fused"):
        logits, (_, enc_out) = api.prefill(tree, prompt, caches)
        if state is None:
            state = (caches, enc_out)
        else:
            state[1].copy_(enc_out)
    torch.cuda.synchronize()
    prefill_launches = count_delta(before, ops.launch_counts())
    first = logits.clone()
    tok = logits.argmax(-1).to(torch.int32)[:, None]
    pos = torch.full((ENCDEC_ROWS,), ENCDEC_PROMPT, dtype=torch.int32,
                     device="cuda")
    tokens, steps, step_launches = [tok], [], []
    for _ in range(ENCDEC_NEW - 1):
        before = ops.launch_counts()
        if program is None:
            with torch.no_grad(), executor_variant("fused"):
                logits, _ = api.decode_step(tree, {"token": tok, "pos": pos},
                                            state)
        else:
            logits, _ = program(tree, state, tok, pos)
        torch.cuda.synchronize()
        step_launches.append(count_delta(before, ops.launch_counts()))
        steps.append(logits.clone())
        tok = logits.argmax(-1).to(torch.int32)[:, None]
        tokens.append(tok)
        pos = pos + 1
    return (torch.cat(tokens, 1).cpu(), steps, first, enc_out,
            prefill_launches, step_launches)


def _decode_program(api):
    """A decode step through the port's program cache (static: the tree
    and the state ``(caches, enc_out)``; dynamic: token and position)."""
    from repro_torch.layers.mplinear import executor_variant
    from repro_torch.serving import graphs

    def step(tree, state, tok, pos):
        with torch.no_grad(), executor_variant("fused"):
            return api.decode_step(tree, {"token": tok, "pos": pos}, state)
    programs = graphs.Programs(torch.device("cuda"))
    return programs, programs.program(step, 2, "decode_step")


def _gate_logits(card, cpu, what):
    """Card against CPU within the whole-model gates: the largest
    difference within ``CPU_LOGIT_MAX_OF_RANGE`` of the CPU's range and
    the relative RMS within ``CPU_LOGIT_REL_RMS``."""
    a, b = card.double().cpu(), cpu.double().cpu()
    span = float(b.max() - b.min())
    diff = float((a - b).abs().max())
    rel = _rel(a, b)
    out = {"max_abs_diff": diff, "range": span, "rel_rms": rel,
           "max_tolerance": CPU_LOGIT_MAX_OF_RANGE * span,
           "rel_rms_tolerance": CPU_LOGIT_REL_RMS}
    if not bool(torch.isfinite(a).all()) or diff > \
            CPU_LOGIT_MAX_OF_RANGE * span or rel > CPU_LOGIT_REL_RMS:
        raise AssertionError(f"{what}: card vs CPU {out}")
    return out


def _encdec_card_vs_cpu(cfg, api, prepared, batch, logits, enc_out):
    """The first encoder block and the first decoder block (prefill into
    a fresh cache, cross-attention onto a random encoder output), each
    from the same random input on the card (fused executors) and on the
    CPU (plain versions), within ``FIRST_LAYER_REL_RMS``; then the whole
    prefill on the CPU against the card's logits and encoder output,
    within the whole-model gates."""
    from repro_torch.convert import tree_to
    from repro_torch.core.policy import get_policy
    from repro_torch.layers.attention import KVCache
    from repro_torch.layers.mplinear import executor_variant
    from repro_torch.models import encdec
    from repro_torch.models.lm import unstack
    policy = get_policy(cfg.precision_policy)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(32)
    rnd = lambda *shape: torch.randn(shape, generator=gen,  # noqa: E731
                                     device="cuda").to(torch.bfloat16)
    x_enc = rnd(ENCDEC_ROWS, ENCDEC_FRAMES, cfg.d_model)
    x_dec = rnd(ENCDEC_ROWS, ENCDEC_PROMPT, cfg.d_model)
    enc = rnd(ENCDEC_ROWS, ENCDEC_FRAMES, cfg.d_model)

    def positions(n, dev):
        return torch.arange(n, dtype=torch.int32, device=dev)[None].expand(
            ENCDEC_ROWS, n)

    out = {"enc_block0": _card_vs_cpu(
        lambda t, st, dev: (encdec.encode_block(
            t, cfg, x_enc.to(dev), positions(ENCDEC_FRAMES, dev), policy),
            st), unstack(prepared["enc_blocks"])[0], ())}
    c = api.init_cache(ENCDEC_ROWS, ENCDEC_CACHE)
    out["dec_block0"] = _card_vs_cpu(
        lambda t, st, dev: (encdec.decode_block(
            t, cfg, x_dec.to(dev), positions(ENCDEC_PROMPT, dev),
            enc.to(dev), "prefill", st, None, policy), st),
        unstack(prepared["dec_blocks"])[0],
        KVCache(c.k[0], c.v[0], c.pos[0]))
    cpu_tree = tree_to(prepared, "cpu")
    t0 = time.perf_counter()
    with torch.no_grad(), executor_variant("fused"):
        cpu_logits, (_, cpu_enc) = api.prefill(
            cpu_tree, {"tokens": batch["tokens"][:, :ENCDEC_PROMPT].cpu(),
                       "frames": batch["frames"].cpu()},
            api.init_cache(ENCDEC_ROWS, ENCDEC_CACHE, "cpu"))
    out["prefill_cpu_s"] = time.perf_counter() - t0
    real = slice(0, cfg.vocab)          # padded columns are -1e30 on both
    out["prefill_logits"] = _gate_logits(logits[:, real], cpu_logits[:, real],
                                         "prefill logits")
    out["enc_out"] = _gate_logits(enc_out, cpu_enc, "encoder output")
    out["greedy_first_token_equal"] = bool(torch.equal(
        logits[:, real].argmax(-1).cpu(), cpu_logits[:, real].argmax(-1)))
    return out


def _encdec_consistency(cfg, params, batch, device):
    """At f32 compute (bf16 policy), a decode step after a prefill of S
    tokens against the last logits of a prefill of S + 1, the reference's
    ``test_prefill_decode_consistency`` at full width: relative RMS,
    largest difference, and the excess over that test's pointwise
    criterion (``atol = rtol = 2e-2``). Prefill and decode round every
    projection's output to bf16 (``mp_linear``, as the reference's, at
    any compute dtype), and their products sum in orders that depend on
    the row count, so a bf16 rounding can fall the other way between
    them; over 24 layers of random weights that leaves a few hundredths
    in the largest logit, on the CPU as on the card."""
    from repro_torch.convert import tree_to
    from repro_torch.layers.mplinear import executor_variant
    from repro_torch.models import registry
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    api32 = registry.build(cfg32)
    s = ENCDEC_PROMPT
    tokens, frames = (batch["tokens"].to(device), batch["frames"].to(device))
    params = tree_to(params, device)
    t0 = time.perf_counter()
    with torch.no_grad(), executor_variant("fused"):
        _, state = api32.prefill(
            params, {"tokens": tokens[:, :s], "frames": frames},
            api32.init_cache(ENCDEC_ROWS, s + 1, device))
        step, _ = api32.decode_step(
            params, {"token": tokens[:, s:s + 1],
                     "pos": torch.full((ENCDEC_ROWS,), s, dtype=torch.int32,
                                       device=device)}, state)
        whole, _ = api32.prefill(
            params, {"tokens": tokens, "frames": frames},
            api32.init_cache(ENCDEC_ROWS, s + 1, device))
    real = slice(0, cfg.vocab)
    a, b = step[:, real].double().cpu(), whole[:, real].double().cpu()
    excess = float(((a - b).abs() - CONSISTENCY_TOL * (1 + b.abs())).max())
    return {"rel_rms": _rel(a, b), "tolerance": CONSISTENCY_TOL,
            "max_abs_diff": float((a - b).abs().max()),
            "logit_std": float(b.std()),
            "pointwise_excess_over_2e-2": excess,
            "seconds": time.perf_counter() - t0}


def _profile_fn(fn):
    """Device time by kernel over one call of ``fn`` (after one call
    outside the profiler), and the call's wall time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = _kernel_rows(prof)
    busy = sum(r[1] for r in rows)
    return {"wall_ms": wall * 1e3, "device_busy_ms": busy,
            "kernel_launches": sum(r[2] for r in rows),
            "device_idle_share": 1 - busy / (wall * 1e3) if rows else None,
            "top_kernels_ms": [[k, t, c] for k, t, c in rows[:15]]}


def _encdec_policy(cfg, api, prepared, batch, profile):
    """One policy's run: the launches of the eager greedy run (217 a
    prefill, 132 a decode step, no other kernel), the same run with its
    decode steps replayed from one CUDA graph (streams equal, logits
    bit-identical), card against CPU, and the times."""
    from repro_torch.kernels import ops
    from repro_torch.layers.mplinear import executor_variant
    from repro_torch.serving import graphs
    want_prefill, want_step = _encdec_launches(cfg)
    ops.reset_launch_counts()
    eager = _encdec_greedy(api, prepared, batch)
    programs, program = _decode_program(api)
    static = (api.init_cache(ENCDEC_ROWS, ENCDEC_CACHE),
              torch.empty_like(eager[3]))
    replayed = _encdec_greedy(api, prepared, batch, program, static)
    launches = ops.launch_counts()
    for what, run in (("eager", eager), ("replayed", replayed)):
        if run[4] != {"fused_dequant_mm": want_prefill} or any(
                s != {"fused_dequant_mm": want_step} for s in run[5]):
            raise AssertionError(f"{cfg.precision_policy} {what}: prefill "
                                 f"launched {run[4]}, decode steps "
                                 f"{run[5]}; want {want_prefill} and "
                                 f"{want_step} fused_dequant_mm")
    if {k for k, v in launches.items() if v} != {"fused_dequant_mm"}:
        raise AssertionError(f"encdec launched {launches}")
    stats = programs.stats()
    if stats["captures"] != 1 or stats["replays"] != ENCDEC_NEW - 2:
        raise AssertionError(f"decode program: {stats['captures']} "
                             f"captures, {stats['replays']} replays")
    if not torch.equal(eager[0], replayed[0]) or not all(
            graphs.same_bits(a, b) for a, b in zip(eager[1], replayed[1])):
        raise AssertionError(f"{cfg.precision_policy}: replayed decode "
                             f"steps differ from eager ones")
    out = {"launches": launches, "prefill_launches": eager[4],
           "step_launches": eager[5][0],
           "streams_equal_eager_replayed": True,
           "logits_bit_identical": True, "captures": stats["captures"],
           "replays": stats["replays"],
           "card_vs_cpu": _encdec_card_vs_cpu(cfg, api, prepared, batch,
                                              eager[2], eager[3])}
    # times: prefill, a decode step eager and replayed, a greedy run
    prompt = {"tokens": batch["tokens"][:, :ENCDEC_PROMPT],
              "frames": batch["frames"]}
    caches = api.init_cache(ENCDEC_ROWS, ENCDEC_CACHE)
    with torch.no_grad(), executor_variant("fused"):
        out["prefill_ms"] = median_ms(
            lambda: api.prefill(prepared, prompt, caches), reps=5, warm=1)
        _, state = api.prefill(prepared, prompt, caches)
    tok = eager[0][:, :1].cuda()
    pos = torch.full((ENCDEC_ROWS,), ENCDEC_PROMPT, dtype=torch.int32,
                     device="cuda")

    def step():
        with torch.no_grad(), executor_variant("fused"):
            api.decode_step(prepared, {"token": tok, "pos": pos}, state)
    out["decode_step_ms"] = {"eager": median_ms(step, reps=10),
                             "replayed": graph_ms(step)}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _encdec_greedy(api, prepared, batch, program, static)
    wall = time.perf_counter() - t0
    out["greedy_run"] = {"wall_s": wall, "new_tokens": ENCDEC_ROWS
                         * ENCDEC_NEW,
                         "tok_per_s": ENCDEC_ROWS * ENCDEC_NEW / wall}
    if profile:
        out["profile_replayed_step"] = _profile_fn(
            lambda: program(prepared, static, tok, pos))
    del programs, program
    return out, launches


def phase_encdec(smi, profile):
    """seamless-m4t-medium whole at full width: random f32 weights from a
    seed, the prefill/decode consistency at f32 compute (bf16 policy, on
    the card and on the CPU), then calibrated (random path, with frames)
    and prepared under int4_serving and int8_serving with only the
    prepared trees kept, and each served greedily through the fused
    executors."""
    from repro_torch.configs import get_config
    from repro_torch.core.policy import get_policy
    from repro_torch.models import registry
    from repro_torch.quant.calibrate import calibrate_act_scales
    _no_tf32()
    t_phase = time.perf_counter()
    full = get_config(ENCDEC)
    torch.cuda.reset_peak_memory_stats()
    memory = {"allocated_before_init": torch.cuda.memory_allocated()}
    params = registry.init_params(full, seed=0)
    torch.cuda.synchronize()
    memory["allocated_raw_params"] = torch.cuda.memory_allocated()
    n_params = sum(t.numel() for _, t in _encdec_leaves(params))
    batch = _encdec_batch(full, "cuda")
    consistency = {dev: _encdec_consistency(full, params, batch, dev)
                   for dev in ("cuda", "cpu")}
    if any(not c["rel_rms"] <= CONSISTENCY_TOL
           for c in consistency.values()):
        raise AssertionError(f"prefill/decode consistency: {consistency}")
    trees = {}
    for policy in ENCDEC_POLICIES:
        cfg = dataclasses.replace(full, precision_policy=policy)
        api = registry.build(cfg)
        trees[policy] = api.prepare(
            params, get_policy(policy),
            act_scales=calibrate_act_scales(cfg, api, params))
    del params
    _free()
    memory["allocated_prepared_only"] = torch.cuda.memory_allocated()
    memory["max_allocated_preparing"] = torch.cuda.max_memory_allocated()
    memory["prepared_tree_bytes"] = {
        policy: sum(t.numel() * t.element_size()
                    for _, t in _encdec_leaves(tree))
        for policy, tree in trees.items()}
    runs, launches = {}, {}
    for policy in ENCDEC_POLICIES:
        cfg = dataclasses.replace(full, precision_policy=policy)
        runs[policy], launches[policy] = _encdec_policy(
            cfg, registry.build(cfg), trees[policy], batch, profile)
    prefill_want, step_want = _encdec_launches(full)
    log(13, card=smi, arch=ENCDEC, parameters=n_params,
        encoder_layers=full.n_enc_layers, decoder_layers=full.n_layers,
        rows=ENCDEC_ROWS, prompt=ENCDEC_PROMPT, frames=ENCDEC_FRAMES,
        new_tokens=ENCDEC_NEW, cache_len=ENCDEC_CACHE,
        fused_dequant_per_prefill=prefill_want,
        fused_dequant_per_step=step_want, memory=memory,
        prefill_decode_consistency=consistency, runs=runs,
        phase_s=time.perf_counter() - t_phase)
    del trees
    _free()
    return {"fused_dequant_mm": sum(n["fused_dequant_mm"]
                                    for n in launches.values())}


def _encdec_leaves(tree):
    from repro_torch.quant.prepare import PreparedWeight
    from repro_torch.serving import graphs
    out = []
    for p, t in graphs.leaves(tree):
        if isinstance(t, PreparedWeight):
            out += [(p, x) for x in (t.data, t.scale, t.act_scale)
                    if x is not None]
        elif isinstance(t, torch.Tensor):
            out.append((p, t))
    return out


# ------------------------------------------------------------- phase 14

def phase_serving_smoke(smi, path):
    """``repro_torch.serving.smoke.main`` with the reference's defaults
    and ``--trace path``, on the card: exit 0, and a trace in which
    ``validate_chrome_trace`` finds no fault."""
    from repro_torch.kernels import ops
    from repro_torch.obs import validate_chrome_trace
    from repro_torch.serving import smoke
    t_phase = time.perf_counter()
    summary = {}
    ops.reset_launch_counts()
    rc = smoke.main(["--trace", path], summary=summary)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    with open(path) as f:
        errors = validate_chrome_trace(json.load(f))
    if rc != 0 or errors:
        raise AssertionError(f"serving smoke: exit {rc}, trace faults "
                             f"{errors[:5]}")
    if summary.get("device") != "cuda" or not launches["fused_dequant_mm"]:
        raise AssertionError(f"serving smoke ran off the card: {summary}, "
                             f"launches {launches}")
    log(14, card=smi, exit_code=rc, trace_faults=len(errors),
        launches=launches, contract=summary,
        phase_s=time.perf_counter() - t_phase)
    return launches


# ------------------------------------------------------------- phase 15

# serve_lm's three routes: the reference's command lines, at full width
SERVE_LM_ROUTES = (
    ("int4_serving", ("--policy", "int4_serving", "--calibrate",
                      "--decode-block", "4")),
    ("plan", ("--plan", PLAN_FILE)),
    ("router", ("--replicas", f"int8_serving,plan:{PLAN_FILE}")),
)


def _fig3_sweep(device):
    """Fig. 3's whole grid on ``device``, no cache: (results, seconds)."""
    from repro_torch import exp
    from repro_torch.studies import fig3_error
    t0 = time.perf_counter()
    results = fig3_error.run(verbose=False, engine=exp.EngineConfig(
        cache=None, device=device))
    return results, time.perf_counter() - t0


def _fig3_raw_accumulators():
    """For every Fig. 3 cell, the 400 raw accumulators of
    ``core.ipu.fp16_inner_product_raw`` (``hi``, ``lo`` and exponent)
    on the card equal to the CPU's, integer for integer: the rows are
    medians, which a few flipped accumulators would leave unchanged.
    Returns the cells compared."""
    from repro_torch.core.ipu import fp16_inner_product_raw
    from repro_torch.studies import fig3_error
    points = fig3_error.spec().points()
    for p in points:
        kw = p.kwargs
        a, b = fig3_error.operands(kw["dist"], kw["length"], kw["samples"],
                                   kw["seed"])
        cfg = fig3_error.ipu_config(kw["accum"], kw["w"], kw["n"])
        got = {}
        for dev in ("cuda", "cpu"):
            acc, e = fp16_inner_product_raw(torch.as_tensor(a, device=dev),
                                            torch.as_tensor(b, device=dev),
                                            cfg)
            got[dev] = [t.cpu() for t in (acc.hi, acc.lo, e)]
        if not all(torch.equal(x, y) for x, y in zip(got["cuda"],
                                                      got["cpu"])):
            raise AssertionError(f"fig3 raw accumulators on the card != "
                                 f"the CPU's at {p.label()}")
    return len(points)


def _fig3_mp_matmul():
    """For every Fig. 3 cell, the diagonal of ``mp_matmul(a, b.T)`` on
    the card bit-equal to ``core.ipu.fp16_inner_product(a, b)`` on the
    card, at the cell's IPU configuration. Returns the launches."""
    from repro_torch.core.ipu import fp16_inner_product
    from repro_torch.kernels import ops
    from repro_torch.studies import fig3_error
    points = fig3_error.spec().points()
    operands = {}
    for p in points:
        kw = p.kwargs
        key = (kw["dist"], kw["length"], kw["samples"], kw["seed"])
        if key not in operands:
            operands[key] = [torch.as_tensor(x, device="cuda")
                             for x in fig3_error.operands(*key)]
    ops.reset_launch_counts()
    for p in points:
        kw = p.kwargs
        a, b = operands[(kw["dist"], kw["length"], kw["samples"],
                         kw["seed"])]
        cfg = fig3_error.ipu_config(kw["accum"], kw["w"], kw["n"])
        diag = torch.diagonal(ops.mp_matmul(a, b.T.contiguous(), cfg))
        want = fp16_inner_product(a, b, cfg)
        if not torch.equal(_as_bits(diag.contiguous()), _as_bits(want)):
            raise AssertionError(f"mp_matmul diagonal != fp16_inner_product "
                                 f"at {p.label()}")
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    if launches["mp_matmul"] != len(points):
        raise AssertionError(f"{launches['mp_matmul']} mp_matmul launches "
                             f"for {len(points)} cells")
    return launches


def _stdout_of(fn, *args):
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(*args)
    return rc, buf.getvalue()


def _serve_lm(route, argv):
    """One serve_lm route at full width: its summary and launches."""
    from repro_torch.configs import get_config
    from repro_torch.examples import serve_lm
    from repro_torch.kernels import ops
    args = serve_lm.parse_args(list(argv) + ["--device", "cuda"])
    cfg = get_config("qwen2-0.5b")
    ops.reset_launch_counts()
    run = (serve_lm.run_router if args.replicas
           else serve_lm.run_single)(args, cfg)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    _free()
    want = {rid: args.max_new for rid in range(args.requests)}
    if run["new_tokens"] != want:
        raise AssertionError(f"serve_lm {route}: new tokens "
                             f"{run['new_tokens']} != {want}")
    # the plan and router routes run without --calibrate, as the
    # reference's command lines do: their int routes take staged
    # operands (plain products), so they may launch no kernel at all
    launched = {k: n for k, n in launches.items() if n}
    if route == "int4_serving" and (
            set(launched) != {"fused_dequant_mm"}):
        raise AssertionError(f"serve_lm int4_serving launched {launched}")
    metrics = ([run["metrics"]] if not args.replicas
               else list(run["metrics"].values()))
    ttft = {k: [m["ttft_s"].get(k) for m in metrics] for k in ("p50",
                                                              "max")}
    return {"tok_s": run["tok_s"], "wall_s": run["wall_s"],
            "ticks": run["ticks"], "ttft_p50_s": ttft["p50"],
            "ttft_max_s": ttft["max"], "launches": launched}, launches


def phase_studies(smi, trace_path):
    """The paper's studies, the sweep engine, the examples and the trace
    report on the card (see the module docstring, phase 15)."""
    from repro_torch.examples import quickstart
    from repro_torch.exp import smoke as exp_smoke
    from repro_torch.tools import trace_report
    t_phase = time.perf_counter()
    card, card_s = _fig3_sweep("cuda")
    cpu, cpu_s = _fig3_sweep("cpu")
    rows_equal = (json.dumps(card["rows"], sort_keys=True)
                  == json.dumps(cpu["rows"], sort_keys=True))
    if not rows_equal or not all(card["claims"].values()):
        raise AssertionError(f"fig3 on the card: rows equal to the CPU's "
                             f"{rows_equal}, claims {card['claims']}")
    raw_cells = _fig3_raw_accumulators()
    mp_launches = _fig3_mp_matmul()

    with tempfile.TemporaryDirectory() as d:
        rc, smoke_out = _stdout_of(exp_smoke.main,
                                   ["--cache-dir", d, "--jobs", "2"])
    if rc != 0 or "exp smoke OK" not in smoke_out:
        raise AssertionError(f"exp smoke: exit {rc}: {smoke_out[-500:]}")

    _, qs_card = _stdout_of(quickstart.main, ["--device", "cuda"])
    _, qs_cpu = _stdout_of(quickstart.main, ["--device", "cpu"])
    if qs_card != qs_cpu or not qs_card:
        raise AssertionError("quickstart prints other text on the card")

    serve, launches = {}, {}
    for route, argv in SERVE_LM_ROUTES:
        serve[route], route_launches = _serve_lm(route, argv)
        for k, n in route_launches.items():
            launches[k] = launches.get(k, 0) + n

    rc, report = _stdout_of(trace_report.main, [trace_path])
    if rc != 0 or "INVALID" in report:
        raise AssertionError(f"trace_report: exit {rc}: {report[:500]}")
    log(15, card=smi, fig3_cells=len(card["rows"]), fig3_card_s=card_s,
        fig3_cpu_s=cpu_s, fig3_rows_equal=rows_equal,
        fig3_raw_cells_equal=raw_cells,
        fig3_claims=card["claims"],
        fig3_mp_matmul_launches=mp_launches["mp_matmul"],
        exp_smoke=smoke_out.strip().splitlines()[-1],
        quickstart_lines=len(qs_card.splitlines()), serve_lm=serve,
        serve_lm_launches=launches,
        trace_report_lines=len(report.splitlines()),
        phase_s=time.perf_counter() - t_phase)
    return {"mp_matmul": mp_launches["mp_matmul"],
            "fused_dequant_mm": launches.get("fused_dequant_mm", 0)}


# ------------------------------------------------------------- phase 16

PLANNER_ARCH = "qwen2-0.5b"
# sha256 of the probe model's numpy-drawn weights and tokens (reduced
# qwen2-0.5b, seed 0): tests/test_torch_autotune.py holds the CPU
# installation to the same value
PROBE_DRAW_SHA256 = ("437f48216f191db829a5ed92b840e74e"
                     "d6284a69a72b18017c18d7b9b84958cb")
# the exact fp16_ipu widths of the default grid (w < 28) times the
# projections a probe flips: 3 + 1 + 2 + 1 a layer of the reduced
# model's 2 (the head is not routed through the policy)
PROBE_MP_MATMUL = 3 * 7 * 2


def _draw_digest(*trees):
    """sha256 over every leaf of dict ``trees`` in sorted path order: its
    path and its values as f32 bytes (``draw_digest`` of
    tests/test_torch_autotune.py)."""
    def leaves(tree, prefix):
        for k, v in tree.items():
            path = f"{prefix}/{k}" if prefix else str(k)
            if isinstance(v, dict):
                yield from leaves(v, path)
            else:
                yield path, v
    h = hashlib.sha256()
    for tree in trees:
        for path, leaf in sorted(leaves(tree, ""), key=lambda kv: kv[0]):
            h.update(path.encode())
            h.update(leaf.detach().to("cpu", torch.float32).numpy()
                     .tobytes())
    return h.hexdigest()


def _probe_draws():
    """The probe model's draw on the card (numpy seeds; must hash to
    ``PROBE_DRAW_SHA256``), and for comparison the hash of the model's
    torch-generator init on this machine's CPU."""
    from repro_torch.autotune import objectives
    from repro_torch.configs import reduced
    from repro_torch.models import registry
    cfg = reduced(PLANNER_ARCH)
    got = _draw_digest(*objectives.probe_inputs(cfg, 0, device="cuda"))
    if got != PROBE_DRAW_SHA256:
        raise AssertionError(f"the probe's draw hashes to {got}, not "
                             f"{PROBE_DRAW_SHA256}")
    return {"numpy_draw_sha256": got,
            "torch_draw_cpu_sha256": _draw_digest(
                registry.build(cfg).init(0, "cpu")),
            "torch": torch.__version__, "numpy": np.__version__}


class _RecordedMpMatmul:
    """Inside the block, every call of the ``mp_matmul`` kernel wrapper
    is recorded (operands, config, output) and counted as usual."""

    def __enter__(self):
        from repro_torch.kernels import mpmm
        self.module, self.real, self.calls = mpmm, mpmm.mp_matmul, []

        def record(a, b, cfg, **kwargs):
            out = self.real(a, b, cfg, **kwargs)
            self.calls.append((a.clone(), b.clone(), cfg, kwargs,
                               out.clone()))
            return out

        mpmm.mp_matmul = record
        return self.calls

    def __exit__(self, *exc):
        self.module.mp_matmul = self.real
        return False


def _calls_exact(calls):
    """Each recorded ``mp_matmul`` call bit-equal to the plain version on
    its own operands; returns {"M x K x N w": calls}."""
    from repro_torch.kernels import ref
    seen = {}
    for a, b, cfg, kwargs, out in calls:
        want = ref.mp_matmul_blocked_ref(a, b, cfg, **kwargs)
        what = f"{a.shape[0]}x{a.shape[1]}x{b.shape[1]} w{cfg.w}"
        if out.dtype != want.dtype or not torch.equal(_as_bits(out),
                                                      _as_bits(want)):
            raise AssertionError(f"the probe's mp_matmul {what} n={cfg.n}: "
                                 f"not bit-equal to its plain version")
        seen[what] = seen.get(what, 0) + 1
    return dict(sorted(seen.items()))


def _search(device, cache, out, jobs):
    """``python -m repro_torch.autotune search`` for qwen2-0.5b at full
    shapes, the default candidates, the probe on ``device``: (seconds,
    points executed, printed text)."""
    import re
    from repro_torch.autotune import cli
    t0 = time.perf_counter()
    rc, text = _stdout_of(cli.main, [
        "search", "--model", "qwen2_0_5b", "--shapes", "full",
        "--device", device, "--jobs", str(jobs), "--cache-dir", cache,
        "--out", out, "--quiet-progress"])
    seconds = time.perf_counter() - t0
    head = re.match(r"# total: \d+ points, \d+ cached, (\d+) executed",
                    text)
    if rc != 0 or head is None:
        raise AssertionError(f"search on {device}: exit {rc}: {text[:500]}")
    return seconds, int(head.group(1)), text


def _cached_table(device, cache):
    """The score table of a finished search, read back from its cache
    (0 points executed)."""
    from repro_torch import exp
    from repro_torch.autotune import candidates, search
    from repro_torch.configs import get_config
    engine = exp.EngineConfig(cache=exp.ResultCache(cache), device=device)
    table = search.build_scores(
        PLANNER_ARCH, candidates.groups_for(get_config(PLANNER_ARCH)),
        candidates.default_candidates(), engine, shapes="full", probe=True)
    if engine.total.n_executed:
        raise AssertionError(f"{device} table: {engine.total.summary()}")
    return table


def _tables_agree(card, cpu):
    """Cycles and efficiency rows ``==``; accuracy rows' analytic bound
    ``==`` and divergence within the probe's bound. Returns the largest
    divergence difference, absolute and relative to the CPU's."""
    from repro_torch.autotune.objectives import PROBE_KL_ATOL, PROBE_KL_RTOL
    worst_abs = worst_rel = 0.0
    for key, c in card.scores.items():
        p = cpu.scores[key]
        if {k: v for k, v in c.items() if k not in ("divergence",
                                                   "acc_proxy")} != \
                {k: v for k, v in p.items() if k not in ("divergence",
                                                        "acc_proxy")}:
            raise AssertionError(f"{key}: card row {c} != CPU row {p}")
        d = abs(c["divergence"] - p["divergence"])
        if d > PROBE_KL_RTOL * p["divergence"] + PROBE_KL_ATOL:
            raise AssertionError(f"{key}: divergence on the card "
                                 f"{c['divergence']} against the CPU's "
                                 f"{p['divergence']}")
        worst_abs = max(worst_abs, d)
        if p["divergence"]:
            worst_rel = max(worst_rel, d / p["divergence"])
    if card.scores.keys() != cpu.scores.keys():
        raise AssertionError("the card's and the CPU's tables differ in "
                             "their entries")
    return worst_abs, worst_rel


def _plan_kernels(plan, cfg, params):
    """The kernels one decode step of ``plan`` launches, derived from its
    rules over the model's projections: an int or fp storage rule one
    ``fused_dequant_mm`` a projection (the planner marks no int rule
    exact), an exact fp16_ipu rule (w < 28) one ``mp_matmul``, bf16 and
    fp16_ipu at w >= 28 none (plain torch products); the head is never
    routed through the policy."""
    from repro_torch.models import registry
    from repro_torch.quant.prepare import iter_projection_weights
    policy = plan.to_policy()
    paths = registry.projection_paths(cfg)
    want = {}
    for prefix, w in iter_projection_weights(params, paths):
        spec = policy.spec_for(paths(prefix))
        kernel = None
        if spec.mode in ("int8", "int4", "fp8", "fp4"):
            if spec.exact:
                raise AssertionError(f"an exact int rule: {spec}")
            kernel = "fused_dequant_mm"
        elif spec.mode == "fp16_ipu" and spec.exact:
            kernel = "mp_matmul"
        if kernel:
            want[kernel] = want.get(kernel, 0) + w.shape[0]
    return want


def _serve_plan(path):
    """Full-width qwen2-0.5b (weights from seed 0) served from the plan
    at ``path`` (``act_calibration="auto"``), 8 requests at decode_block
    1 and 4, graphed and eager: identical streams, each decode step's
    launches equal to the plan's rules, no other kernel."""
    from repro_torch.autotune.plan import load_plan
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import registry
    from repro_torch.serving import EngineConfig
    cfg = dataclasses.replace(get_config(PLANNER_ARCH),
                              precision_policy=f"plan:{path}")
    api = registry.build(cfg)
    params = registry.init_params(cfg, seed=0)
    step_want = _plan_kernels(load_plan(path), cfg, params)
    results, streams = {}, {}
    ops.reset_launch_counts()
    for blk in (1, 4):
        config = EngineConfig(batch_slots=8, cache_len=256, prefill_chunk=32,
                              decode_block=blk, act_calibration="auto")
        eng, streams[blk] = _graphs_vs_eager(
            cfg, api, params, config,
            lambda: _requests(cfg, 8, 8, 32, 8, seed=26), results,
            f"block{blk}")
        results[f"block{blk}"]["step_launches"] = _step_launches(eng,
                                                                 step_want)
        results[f"block{blk}"]["fused"] = eng.fused
        routes = eng.routing_report()
        del eng
        _free()
    launches = ops.launch_counts()
    del params
    _free()
    if streams[1] != streams[4]:
        raise AssertionError("the searched plan: greedy streams differ "
                             "between decode_block 1 and 4")
    if {k for k, v in launches.items() if v} != set(step_want):
        raise AssertionError(f"the searched plan launched {launches}, its "
                             f"rules imply {step_want} a step")
    return launches, step_want, routes, results


def phase_planner(smi):
    """The precision planner on the card (see the module docstring,
    phase 16)."""
    from repro_torch.autotune import cli
    from repro_torch.autotune.plan import load_plan
    from repro_torch.kernels import ops
    from repro_torch.tools import plan_report
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        card_cache, cpu_cache = (os.path.join(d, n) for n in ("card", "cpu"))
        plan_path = os.path.join(d, "card.json")
        draws = _probe_draws()
        ops.reset_launch_counts()
        with _RecordedMpMatmul() as calls:
            cold_s, cold_n, text = _search("cuda", card_cache, plan_path, 1)
            torch.cuda.synchronize()
        probe_launches = {k: n for k, n in ops.launch_counts().items() if n}
        if probe_launches != {"mp_matmul": PROBE_MP_MATMUL} or \
                len(calls) != PROBE_MP_MATMUL:
            raise AssertionError(f"the cold search launched "
                                 f"{probe_launches} ({len(calls)} calls "
                                 f"recorded), want {PROBE_MP_MATMUL} "
                                 f"mp_matmul")
        probe_calls = _calls_exact(calls)
        del calls
        with open(plan_path) as f:
            cold_json = f.read()
        warm_s, warm_n, _ = _search("cuda", card_cache, plan_path, 2)
        with open(plan_path) as f:
            warm_same = f.read() == cold_json
        if cold_n <= 0 or warm_n != 0 or not warm_same:
            raise AssertionError(f"search: cold {cold_n} executed, warm "
                                 f"{warm_n}, warm plan identical "
                                 f"{warm_same}")
        if ops.launch_counts()["mp_matmul"] != PROBE_MP_MATMUL:
            raise AssertionError("the warm search launched a kernel")
        cpu_path = os.path.join(d, "cpu.json")
        cpu_s, cpu_n, _ = _search("cpu", cpu_cache, cpu_path, 1)
        card_table = _cached_table("cuda", card_cache)
        kl_abs, kl_rel = _tables_agree(card_table,
                                       _cached_table("cpu", cpu_cache))
        plan, cpu_plan = load_plan(plan_path), load_plan(cpu_path)
        same_as_cpu = plan.to_json()["rules"] == cpu_plan.to_json()["rules"]

        rc, scored = _stdout_of(cli.main, [
            "score", "--model", "qwen2_0_5b", "--shapes", "full",
            "--cache-dir", card_cache, "--plan", plan_path,
            "--quiet-progress"])
        head, body = scored.split("\n", 1)
        if rc != 0 or " 0 executed " not in head or \
                json.loads(body)["metrics"] != plan.metrics:
            raise AssertionError(f"score --plan: exit {rc}: {scored[:500]}")
        rc, report = _stdout_of(plan_report.main, [plan_path])
        if rc != 0 or "Pareto frontier" not in report:
            raise AssertionError(f"plan_report: exit {rc}: {report[:500]}")

        launches, step_want, routes, serve = _serve_plan(plan_path)
    committed = load_plan(PLAN_FILE)
    log(16, card=smi, search_cold_s=cold_s, search_cold_executed=cold_n,
        search_warm_jobs2_s=warm_s, search_warm_executed=warm_n,
        search_cpu_s=cpu_s, search_cpu_executed=cpu_n,
        probe_launches=probe_launches, probe_calls_bit_equal=probe_calls,
        probe_draws=draws,
        divergence_card_vs_cpu={"max_abs": kl_abs, "max_rel": kl_rel},
        divergence_card={f"{g}/{k}": v["divergence"]
                         for (g, k), v in card_table.scores.items()
                         if v["divergence"]},
        selected_from=plan.meta["selected_from"],
        assignment={r.group: f"{r.mode}/w{r.w}" for r in plan.rules},
        metrics={k: v for k, v in plan.metrics.items() if k != "modes"},
        frontier=len(plan.frontier),
        selected_same_as_cpu=same_as_cpu,
        cpu_assignment=cpu_plan.assignment(),
        same_as_committed_plan=(plan.assignment()
                                == committed.assignment()),
        plan_report_lines=len(report.splitlines()),
        search_printed=text.strip().splitlines()[1:3],
        serve_routes=sorted(set(routes.values())),
        serve_step_want=step_want, serve_launches=launches, runs=serve,
        phase_s=time.perf_counter() - t_phase)
    return {"mp_matmul": probe_launches["mp_matmul"]
            + launches.get("mp_matmul", 0),
            "fused_dequant_mm": launches.get("fused_dequant_mm", 0)}


# ------------------------------------------------------------- phase 17

FABRIC_SLOTS = 8
# the longest the fleet driver waits for the subprocess worker's
# heartbeat before it calls the worker hung
SUBPROCESS_SILENCE_S = 120.0


def _wave(cfg, rid0):
    """Phase 3's workload (16 requests, 8-64-token prompts, 16 new
    tokens, seed 7), rids from ``rid0``."""
    reqs = _requests(cfg, 16, 8, 64, 16, seed=7)
    for r in reqs:
        r.rid += rid0
    return reqs


def _codec_us(stats, reps=2000):
    """Median microseconds to encode and to decode one StatsSnapshot
    (``stats``: a measured engine's snapshot) and one Heartbeat through
    the port's wire codec, on this host."""
    from repro_torch.fabric import transport as tp
    out = {}
    for name, msg in (("StatsSnapshot", tp.StatsSnapshot(
            name="worker-a", stats=stats, slots=FABRIC_SLOTS, completed=16)),
            ("Heartbeat", tp.Heartbeat(tick=123, time=45.5))):
        data = tp.encode_message(msg)
        if tp.decode_message(data) != msg:
            raise AssertionError(f"{name} does not round-trip the wire")
        for what, fn, arg in (("encode", tp.encode_message, msg),
                              ("decode", tp.decode_message, data)):
            samples = []
            for _ in range(5):
                t0 = time.perf_counter()
                for _ in range(reps):
                    fn(arg)
                samples.append((time.perf_counter() - t0) / reps * 1e6)
            out[f"{name}_{what}_us"] = statistics.median(samples)
        out[f"{name}_bytes"] = len(data)
    return out


class _FleetDriver:
    """Ticks a controller to drained under its ManualClock, one clock
    second a tick, and holds each tick until the subprocess worker
    ``sub`` (while connected and routable) has heartbeated in it: the
    subprocess steps on the wall clock, so a CUDA graph capture in it
    must not read as silence to the heartbeat timeout. Times the
    controller's own host work per tick (its tick less the in-process
    workers' ticks it drives)."""

    def __init__(self, ctrl, clock, sub):
        self.ctrl, self.clock, self.sub = ctrl, clock, sub
        self.ticks = 0
        self.tick_s = 0.0
        self.worker_s = [0.0]

    def _time_drivers(self):
        for h in self.ctrl.workers.values():
            d = h.driver
            if d is not None and not getattr(d, "_timed", False):
                inner, acc = d.tick, self.worker_s

                def tick(inner=inner, acc=acc):
                    t0 = time.perf_counter()
                    try:
                        inner()
                    finally:
                        acc[0] += time.perf_counter() - t0
                d.tick, d._timed = tick, True

    def _tick(self):
        self._time_drivers()
        t0 = time.perf_counter()
        self.ctrl.tick()
        self.tick_s += time.perf_counter() - t0
        self.ticks += 1

    def _waiting_on_sub(self):
        s = self.sub
        return (s.routable and not s.endpoint.closed
                and s.last_heartbeat < self.clock())

    def run(self, on_tick=None, max_ticks=20_000):
        t_start = time.perf_counter()
        while self.ctrl.has_pending():
            self.clock.advance(1.0)
            self._tick()
            t_wait = time.perf_counter()
            while self._waiting_on_sub():
                time.sleep(0.0005)
                self._tick()
                if time.perf_counter() - t_wait > SUBPROCESS_SILENCE_S:
                    raise AssertionError("the subprocess worker stayed "
                                         "silent for 120 s")
            if on_tick is not None:
                on_tick()
            if self.ticks > max_ticks:
                raise AssertionError(f"the fleet did not drain in "
                                     f"{max_ticks} ticks")
        return time.perf_counter() - t_start

    def host_ms_per_tick(self):
        return (self.tick_s - self.worker_s[0]) / max(self.ticks, 1) * 1e3


def _check_wave(ctrl, rid0, single, what):
    """Every request of the wave from ``rid0`` completed, each stream the
    single engine's; returns the tokens generated."""
    done = {r.rid - rid0: r for r in ctrl.completed.values()
            if 0 <= r.rid - rid0 < 100 and r.done}
    if sorted(done) != sorted(single):
        raise AssertionError(f"{what}: lost requests "
                             f"{sorted(set(single) - set(done))}")
    if {i: list(r.tokens) for i, r in done.items()} != single:
        raise AssertionError(f"{what}: fleet streams differ from the "
                             f"single engine's")
    return sum(r.new_tokens for r in done.values())


def _fabric_prepare(cfg, config, ckpt, device):
    """Prepare and calibrate once, serve phase 17's wave, save the
    serve-ready checkpoint. Returns (numbers, the saved engine's
    streams, its act scales)."""
    from repro_torch.fabric import save_engine_checkpoint
    from repro_torch.fabric.smoke import _engine_streams
    from repro_torch.layers.mplinear import count_weight_quant
    from repro_torch.models import registry
    from repro_torch.quant import calibrate
    from repro_torch.serving import ServingEngine
    calls = []
    real = calibrate.calibrate_act_scales

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)
    calibrate.calibrate_act_scales = counted
    try:
        t0 = time.perf_counter()
        api = registry.build(cfg)
        params = registry.init_params(cfg, seed=0, device=device)
        with count_weight_quant() as wq:
            eng = ServingEngine(cfg, api, params, config=config,
                                device=device)
        del params
        torch.cuda.synchronize()
        prepare_s = time.perf_counter() - t0
    finally:
        calibrate.calibrate_act_scales = real
    if not wq[0] or len(calls) != 1:
        raise AssertionError(f"the fresh engine did {wq[0]} weight "
                             f"quantizations and {len(calls)} "
                             f"calibrations")
    saved = _engine_streams(eng, _wave(cfg, 0))
    t0 = time.perf_counter()
    save_engine_checkpoint(eng, ckpt)
    save_s = time.perf_counter() - t0
    scales = dict(eng.act_scales)
    del eng
    _free()
    return ({"prepare_calibrate_s": prepare_s, "save_s": save_s,
             "weight_quant_fresh": wq[0], "calibrations_fresh": len(calls)},
            saved, scales)


def _fabric_rebuild(cfg, ckpt, saved, scales, device):
    """``build_engine`` from the checkpoint: no weight quantization, no
    calibration, the saved engine's scales and streams. Returns
    (numbers, the single engine's streams of phase 17's wave and of the
    chaos workload, its measured stats)."""
    from repro_torch.fabric import build_engine
    from repro_torch.fabric.smoke import _engine_streams, _make_requests
    from repro_torch.layers.mplinear import count_weight_quant
    from repro_torch.quant import calibrate
    calls = []
    real = calibrate.calibrate_act_scales
    calibrate.calibrate_act_scales = lambda *a, **k: calls.append(1)
    try:
        t0 = time.perf_counter()
        with count_weight_quant() as wq:
            restored = build_engine(ckpt, device=device)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
    finally:
        calibrate.calibrate_act_scales = real
    numbers = {"restore_s": restore_s, "weight_quant_restored": wq[0],
               "calibrations_restored": len(calls),
               "weight_quant_trace": restored.weight_quant_trace_count(),
               "act_quant_trace": restored.act_quant_trace_count()}
    if wq[0] or calls or numbers["weight_quant_trace"] \
            or numbers["act_quant_trace"]:
        raise AssertionError(f"restore did rework: {numbers}")
    if restored.act_scales != scales:
        raise AssertionError("the restored engine lost its act scales")
    single = _engine_streams(restored, _wave(cfg, 0))
    if single != saved:
        raise AssertionError("the restored engine serves other streams "
                             "than the saved one")
    chaos_ref = _engine_streams(restored, _make_requests(cfg, 8, 12, 0))
    stats = restored.stats.snapshot()
    del restored
    _free()
    return numbers, single, chaos_ref, stats


class _SubprocessBoot:
    """``spawn_subprocess_worker`` in a thread: the child (``--register
    --resume``) imports torch, makes its CUDA context and restores the
    checkpoint the RegisterAck names while this process rebuilds and
    builds its own engines. Nothing else touches the controller until
    ``join``."""

    def __init__(self, ctrl, device):
        import threading
        from repro_torch.fabric import spawn_subprocess_worker
        self.handle, self.error, self.seconds = None, None, None

        def run():
            t0 = time.perf_counter()
            try:
                self.handle = spawn_subprocess_worker(
                    ctrl, name="worker-proc", register=True,
                    resumable=True, listener=ctrl.listener, timeout=300.0,
                    device=device)
            except BaseException as e:       # re-raised by join
                self.error = e
            self.seconds = time.perf_counter() - t0
        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def join(self):
        self._thread.join(timeout=360.0)
        if self._thread.is_alive():
            raise AssertionError("the subprocess worker never announced")
        if self.error is not None:
            raise self.error
        return self.handle


def _attach_local(ctrl, name, engine):
    """``spawn_local_worker`` on an engine already built (with the
    controller's clock)."""
    from repro_torch.fabric import FabricWorker, LocalWorkerDriver, local_pair
    ctrl_ep, worker_ep = local_pair()
    worker = FabricWorker(name, engine, worker_ep, clock=ctrl.clock)
    worker.announce()
    return ctrl.add_worker(ctrl_ep, driver=LocalWorkerDriver(worker),
                           name=name)


def _fabric_fleet(ctrl, clock, sub, cfg, single):
    """Two in-process workers and the TCP subprocess worker behind one
    controller on a ManualClock: a first and a warm wave, then a wave in
    which an in-process worker dies silently mid-flight (heartbeat
    timeout), then one in which the subprocess is killed mid-flight."""
    from repro_torch.runtime.fault_tolerance import fail_at_step
    numbers = {}
    drive = _FleetDriver(ctrl, clock, sub)
    for wave, rid0 in (("first", 0), ("warm", 100)):
        reqs = _wave(cfg, rid0)
        for r in reqs:
            ctrl.submit(r)
        torch.cuda.synchronize()
        ticks0 = drive.ticks
        wall = drive.run()
        new = _check_wave(ctrl, rid0, single, f"fleet {wave} wave")
        numbers[wave] = {"wall_s": wall, "new_tokens": new,
                         "tok_per_s": new / wall,
                         "ticks": drive.ticks - ticks0,
                         "routed": ctrl.routing_counters()}
    if ctrl.failures or not all(ctrl.routing_counters().values()):
        raise AssertionError(f"fleet: failures {ctrl.failures}, "
                             f"routed {ctrl.routing_counters()}")
    report = ctrl.routing_report()
    if report["cost_correction"] != "online" or not all(
            r["measured"]["transported"]
            and r["measured"]["tok_per_s"] is not None
            for r in report["replicas"].values()):
        raise AssertionError(f"fleet routing did not run on transported "
                             f"stats: {report}")
    numbers["routing"] = {n: {"tok_per_s": r["measured"]["tok_per_s"],
                              "effective_cost": r["effective_cost"]}
                          for n, r in report["replicas"].items()}
    numbers["host_ms_per_tick"] = drive.host_ms_per_tick()

    def streamed(handle):
        return any(q.tokens is not None and len(q.tokens) > len(q.prompt)
                   for q in handle.replica.in_flight.values())

    # kill worker-b mid-flight: silent, its heartbeats stop
    hb, state = ctrl.workers["worker-b"], {}

    def arm_b():
        worker = hb.driver.worker
        if "armed" not in state and streamed(hb):
            worker.failure_hook = fail_at_step(worker.tick_count)
            state["armed"] = ctrl.ticks
        if "killed" not in state and hb.driver.dead:
            state["killed"] = time.perf_counter()
            state["held"] = len(hb.replica.in_flight)
    numbers["kill_in_process"] = _kill_wave(ctrl, drive, cfg, 200, single,
                                            arm_b, state, "worker-b")

    # kill the subprocess mid-flight: its socket closes
    state = {}

    def kill_proc():
        if "killed" not in state and streamed(sub):
            sub.process.kill()
            sub.process.wait()
            state["killed"] = time.perf_counter()
            state["armed"] = ctrl.ticks
            state["held"] = len(sub.replica.in_flight)
    numbers["kill_subprocess"] = _kill_wave(ctrl, drive, cfg, 300, single,
                                            kill_proc, state, "worker-proc")
    numbers["kill_subprocess"]["exit_code"] = sub.process.returncode
    alive = [h.name for h in ctrl.workers.values() if h.alive]
    if alive != ["worker-a"] or ctrl.failures != ["worker-b",
                                                  "worker-proc"]:
        raise AssertionError(f"after the kills: alive {alive}, failures "
                             f"{ctrl.failures}")
    numbers["report"] = {k: ctrl.report()[k] for k in (
        "ticks", "failures", "suspects", "resumed", "requeued",
        "completed")}
    return numbers


def _kill_wave(ctrl, drive, cfg, rid0, single, on_tick, state, name):
    requeued0 = ctrl.scheduler.requeued
    reqs = _wave(cfg, rid0)
    for r in reqs:
        ctrl.submit(r)
    ticks0 = drive.ticks
    wall = drive.run(on_tick=on_tick)
    t_end = time.perf_counter()
    _check_wave(ctrl, rid0, single, f"kill {name}")
    requeued = ctrl.scheduler.requeued - requeued0
    if "killed" not in state or requeued <= 0 or name not in ctrl.failures:
        raise AssertionError(f"kill {name}: {state}, requeued {requeued}, "
                             f"failures {ctrl.failures}")
    return {"wall_s": wall, "ticks": drive.ticks - ticks0,
            "killed_at_tick": state["armed"], "requeued": requeued,
            "lost": 0, "held_at_kill": state["held"],
            "kill_to_last_completion_s": t_end - state["killed"]}


def phase_fabric(smi, cfg_full, device="cuda"):
    """The serving fabric at full width (see the module docstring,
    phase 17)."""
    from repro_torch.fabric import Controller, ManualClock, build_engine
    from repro_torch.fabric import chaos_smoke
    from repro_torch.fabric.smoke import _make_requests
    from repro_torch.kernels import ops
    from repro_torch.serving import EngineConfig
    t_phase = time.perf_counter()
    cfg = dataclasses.replace(cfg_full, precision_policy="int4_serving")
    config = EngineConfig(batch_slots=FABRIC_SLOTS, cache_len=256,
                          prefill_chunk=32, decode_block=4,
                          act_calibration="auto", cost_correction="online",
                          fused_executors="on")
    step_want = {"fused_dequant_mm": 7 * cfg.n_layers}
    parts = {}
    ops.reset_launch_counts()
    with tempfile.TemporaryDirectory() as d:
        ckpt = os.path.join(d, "ckpt")
        restore, saved, scales = _fabric_prepare(cfg, config, ckpt, device)
        parts["prepare_save_s"] = time.perf_counter() - t_phase
        clock = ManualClock()
        ctrl = Controller(heartbeat_timeout=4.0, clock=clock,
                          checkpoint_dir=ckpt)
        ctrl.listen("127.0.0.1", 0)
        try:
            t0 = time.perf_counter()
            boot = _SubprocessBoot(ctrl, device)
            rebuilt, single, chaos_ref, stats = _fabric_rebuild(
                cfg, ckpt, saved, scales, device)
            restore.update(rebuilt)
            parts["rebuild_s"] = time.perf_counter() - t0
            codec = _codec_us(stats)
            t1 = time.perf_counter()
            engines = [build_engine(ckpt, clock=clock, device=device)
                       for _ in range(2)]
            local_s = time.perf_counter() - t1
            sub = boot.join()
            parts["workers_up_s"] = time.perf_counter() - t0
            for name, eng in zip(("worker-a", "worker-b"), engines):
                _attach_local(ctrl, name, eng)
            t0 = time.perf_counter()
            fleet = _fabric_fleet(ctrl, clock, sub, cfg, single)
            fleet["subprocess_up_s"] = boot.seconds
            fleet["local_engines_s"] = local_s
            parts["fleet_and_kills_s"] = time.perf_counter() - t0
            step = _step_launches(engines[0], step_want)
        finally:
            ctrl.shutdown()
        del engines
        _free()
        t0 = time.perf_counter()
        chaos = chaos_smoke.check_contract(
            ckpt, lambda: _make_requests(cfg, 8, 12, 0), chaos_ref, 0, 3,
            device)
        parts["chaos_s"] = time.perf_counter() - t0
    _free()
    launches = {k: v for k, v in ops.launch_counts().items() if v}
    if set(launches) != {"fused_dequant_mm"}:
        raise AssertionError(f"the fabric launched {launches}")
    warm3 = REPORT["phases"].get("3", {}).get("runs", {}).get(
        "int4_block4_warm", {}).get("tok_per_s")
    log(17, card=smi, parts_s=parts, restore=restore, codec=codec,
        fleet=fleet, fleet_warm_tok_per_s=fleet["warm"]["tok_per_s"],
        phase3_warm_tok_per_s=warm3,
        fleet_vs_phase3_warm=(fleet["warm"]["tok_per_s"] / warm3
                              if warm3 else None),
        worker_decode_step_launches=step, chaos=chaos,
        launches=launches, phase_s=time.perf_counter() - t_phase)
    return launches


# ------------------------------------------------------------- phase 18

TRAIN_ARCH = "qwen2-0.5b"
TRAIN_STEPS = 30
# (e) steps a run, and pairs of runs without and with the trainer's
# numerics
TRAIN_DET_STEPS = 5
TRAIN_DET_PAIRS = 5
TRAIN_BATCH = 8
TRAIN_SEQ = 128
# ten times the trainer CLI's default: 30 steps sit inside the default
# 100-step warmup, and at 3e-4 the loss moves 0.017 nats over them (an
# H100 at 700 W), inside the batch-to-batch spread of +-0.05; at 3e-3
# it falls 0.23
TRAIN_LR = 3e-3
# card against CPU, one step of each reduced family under the trainer's
# numerics: (loss relative, the worst gradient leaf's relative L2, the
# parameter tree after the step, relative L2), each a few times the
# reading beside it (an H100 at 700 W). qwen2 and seamless multiply
# only in f32 (``_dot_f32``) and agree to f32 summation order; the
# others also multiply bf16 by bf16 (rwkv's token-shift mixing,
# griffin's recurrence gates, the experts' einsums, the vision
# projector), where the card and the CPU round differently. The same
# table is in tests/test_torch_cuda.py.
TRAIN_CARD_VS_CPU = {
    "qwen2-0.5b": (1e-6, 1e-5, 1e-7),            # 7.3e-8 1.5e-7 5.0e-9
    "rwkv6-1.6b": (1e-6, 2e-2, 1e-3),            # 0      2.1e-3 3.2e-5
    "recurrentgemma-9b": (1e-6, 2e-2, 1e-3),     # 0      5.4e-3 9.6e-5
    "mixtral-8x7b": (1e-6, 2e-2, 1e-3),          # 6.8e-8 4.3e-3 1.8e-4
    "internvl2-1b": (1e-6, 2e-2, 1e-3),          # 7.4e-8 3.4e-3 1.1e-4
    "seamless-m4t-medium": (1e-6, 1e-5, 1e-7),   # 6.7e-8 1.2e-7 3.4e-10
}


def _timed_steps(seconds, profiled):
    """A ``wrap_step`` for ``launch.train.run``: each step's wall time,
    the card synchronized before and after, into ``seconds``; the last
    step also under ``torch.profiler``, its device time by kernel into
    ``profiled``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def wrap(step):
        def timed(state, batch):
            last = len(seconds) == TRAIN_STEPS - 1
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if last:
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    out = step(state, batch)
                    torch.cuda.synchronize()
            else:
                out = step(state, batch)
                torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
            if last:
                kernels = [e for e in prof.key_averages()
                           if e.device_type == DeviceType.CUDA]
                kernels.sort(key=lambda e: -e.self_device_time_total)
                profiled["busy_ms"] = sum(
                    e.self_device_time_total for e in kernels) / 1e3
                profiled["kernels"] = len(kernels)
                profiled["top_ms"] = {
                    e.key[:70]: e.self_device_time_total / 1e3
                    for e in kernels[:8]}
            return out
        return timed
    return wrap


def _train_full_width(tmp):
    """(a) qwen2-0.5b at full width through the trainer CLI's code path
    (``launch.train.run``: FaultTolerantLoop, a checkpoint at the end)."""
    from repro_torch.launch import train
    seconds, profiled = [], {}
    _free()
    torch.cuda.reset_peak_memory_stats()
    args = train.parse_args([
        "--arch", TRAIN_ARCH, "--steps", str(TRAIN_STEPS),
        "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ),
        "--policy", "bf16", "--lr", str(TRAIN_LR),
        "--ckpt-every", str(TRAIN_STEPS),
        "--ckpt-dir", os.path.join(tmp, "full"), "--device", "cuda"])
    t0 = time.perf_counter()
    r = train.run(args, wrap_step=_timed_steps(seconds, profiled))
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    losses = r.losses
    finite = [h["finite"] for h in r.history]
    if r.step != TRAIN_STEPS or len(losses) != TRAIN_STEPS:
        raise AssertionError(f"trained {r.step} steps, {len(losses)} losses")
    if not all(np.isfinite(losses)) or set(finite) != {1.0}:
        raise AssertionError(f"losses {losses}, finite {finite}")
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    if not last < first:
        raise AssertionError(f"the loss did not fall: first 5 {first}, "
                             f"last 5 {last}")
    # steps 2-29: the first builds, the last runs under the profiler
    step_ms = statistics.median(seconds[1:-1]) * 1e3
    profiled["idle_share"] = 1 - profiled["busy_ms"] / step_ms
    grad_norms = [h["grad_norm"] for h in r.history]
    del r
    _free()
    return {"step_ms": step_ms,
            "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / (step_ms / 1e3),
            "first_step_s": seconds[0], "profiled_step_s": seconds[-1],
            "last_step_profile": profiled, "steps_s": sum(seconds),
            "run_s": wall, "checkpoint_and_loop_s": wall - sum(seconds),
            "max_memory_allocated": peak, "losses": losses,
            "first5_mean": first, "last5_mean": last,
            "log_vocab": float(np.log(151936)),
            "markov_entropy": float(np.log(16)),
            "grad_norms": grad_norms}


def _train_example(tmp):
    """(b) ``repro_torch.examples.train_lm`` at its defaults on the card
    (it asserts that the last loss is below the first)."""
    import contextlib
    import io
    from repro_torch.examples import train_lm
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        losses = train_lm.main(["--device", "cuda", "--ckpt-dir",
                                os.path.join(tmp, "example")])
    return {"s": time.perf_counter() - t0, "first": losses[0],
            "last": losses[-1], "steps": len(losses),
            "reached_0.8_of_first": losses[-1] < 0.8 * losses[0],
            "stdout": out.getvalue().strip().splitlines()}


def _rel_l2(a, b):
    a, b = a.double().cpu(), b.double().cpu()
    return float(torch.linalg.vector_norm(a - b)
                 / max(float(torch.linalg.vector_norm(b)), 1e-30))


def _train_card_vs_cpu():
    """(c) one step of each reduced family (numpy-drawn weights, a numpy
    batch) on the card and on the CPU under the trainer's numerics: loss,
    every gradient leaf and the parameters after the step."""
    from repro_torch.configs import InputShape, reduced
    from repro_torch.convert import tree_to
    from repro_torch.launch import train
    from repro_torch.models import registry
    from repro_torch.optim.tree import tree_leaves
    out = {}
    for arch, bounds in TRAIN_CARD_VS_CPU.items():
        cfg = reduced(arch)
        api = registry.build(cfg)
        tc = train.TrainConfig(adamw=train.AdamWConfig(lr=1e-3), warmup=1)
        batch = registry.materialize_batch(
            cfg, InputShape("train", 16, 2, "train"), seed=3, device="cpu")
        params = api.init(0, "cpu", draws="numpy")
        got = {}
        for dev in ("cuda", "cpu"):
            st = train.init_state(api, tree_to(params, dev))
            st = st._replace(step=st.step + 1)       # lr past warmup
            b = {k: v.to(dev) for k, v in batch.items()}
            with train.train_numerics():
                grads, loss, metrics = train.grad_step(api, tc, st, b)
                new, m = train.apply_updates(api, tc, st, grads, loss,
                                             metrics)
            got[dev] = (float(loss), tree_leaves(grads),
                        torch.cat([t.double().cpu().ravel()
                                   for t in tree_leaves(new.params)]))
        (lc, gc, pc), (lp, gp, pp) = got["cuda"], got["cpu"]
        rel = {"loss": abs(lc - lp) / abs(lp),
               "grad_worst": max(_rel_l2(a, b) for a, b in zip(gc, gp)),
               "params": _rel_l2(pc, pp)}
        if not all(r <= b for r, b in zip(rel.values(), bounds)):
            raise AssertionError(f"{arch}: card vs CPU {rel}, bounds "
                                 f"{bounds}")
        out[arch] = rel
    return out


def _train_kill_resume(tmp):
    """(d) the trainer CLI on the card (reduced qwen2-0.5b) killed by
    ``fail_at_step`` and resumed: losses and final state bit-equal to an
    uninterrupted run."""
    from repro_torch.launch import train
    from repro_torch.optim.tree import tree_leaves
    from repro_torch.runtime.fault_tolerance import (WorkerFailure,
                                                     fail_at_step)

    def args(name):
        return train.parse_args(["--arch", TRAIN_ARCH, "--reduced",
                                 "--steps", "8", "--ckpt-every", "3",
                                 "--ckpt-dir", os.path.join(tmp, name),
                                 "--device", "cuda"])

    whole = train.run(args("whole"))
    try:
        train.run(args("killed"), failure_hook=fail_at_step(5))
        raise AssertionError("fail_at_step(5) did not kill the run")
    except WorkerFailure:
        pass
    resumed = train.run(args("killed"))
    equal = (resumed.losses == whole.losses[3:] and all(
        torch.equal(a, b) for a, b in zip(tree_leaves(resumed.state),
                                          tree_leaves(whole.state))))
    if not equal or resumed.step != 8:
        raise AssertionError(f"resumed {resumed.losses} against "
                             f"{whole.losses[3:]}")
    return {"bit_equal": equal,
            "resumed_from_step": resumed.history[0]["step"],
            "losses": whole.losses}


@contextlib.contextmanager
def _deterministic_mode():
    """torch's deterministic algorithms, without the mode's NaN fill of
    every new empty tensor (a guard against reading unwritten memory,
    not a question of summation order), and ``CUBLAS_WORKSPACE_CONFIG``
    set for the mode's cuBLAS check; all as they were after."""
    import torch.utils.deterministic as det
    prev = (torch.are_deterministic_algorithms_enabled(),
            det.fill_uninitialized_memory,
            os.environ.get("CUBLAS_WORKSPACE_CONFIG"))
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    det.fill_uninitialized_memory = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev[0])
        det.fill_uninitialized_memory = prev[1]
        if prev[2] is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)


def _train_determinism():
    """(e) Whether the trainer repeats a run bit for bit without torch's
    deterministic algorithms, and what they would cost at full width:
    qwen2-0.5b, ``bf16``, batch 8, seq 128, ``TRAIN_DET_STEPS`` + 1
    steps from one state under the trainer's numerics, without the mode
    and with it (``_deterministic_mode``), in ``TRAIN_DET_PAIRS`` pairs
    whose order alternates. Per run the median step ms (its first step
    left out); per mode the median and quartiles over its runs, and the
    pairs in which the mode was the faster; whether every run of a mode,
    and the first runs of the two modes, give bit-equal losses and final
    states. The trainer's runs must repeat, and give the mode's bits."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLMDataset
    from repro_torch.launch import train
    from repro_torch.models import registry
    from repro_torch.optim.tree import tree_leaves
    cfg = dataclasses.replace(get_config(TRAIN_ARCH),
                              precision_policy="bf16")
    api = registry.build(cfg)
    tc = train.TrainConfig(adamw=train.AdamWConfig(lr=TRAIN_LR),
                           total_steps=TRAIN_STEPS)
    ds = SyntheticLMDataset(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                                       global_batch=TRAIN_BATCH),
                            device="cuda")
    batches = [ds.batch(i) for i in range(TRAIN_DET_STEPS + 1)]
    state0 = train.init_state(api, device="cuda")
    ms, first = {False: [], True: []}, {}
    equal = {"off_vs_itself": True, "on_vs_itself": True}
    order = [(False, True) if i % 2 == 0 else (True, False)
             for i in range(TRAIN_DET_PAIRS)]
    for pair in order:
        for det in pair:
            mode = _deterministic_mode() if det else contextlib.nullcontext()
            st, secs, losses = state0, [], []
            with train.train_numerics(), mode:
                for b in batches:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    grads, loss, metrics = train.grad_step(api, tc, st, b)
                    st, m = train.apply_updates(api, tc, st, grads, loss,
                                                metrics)
                    torch.cuda.synchronize()
                    secs.append(time.perf_counter() - t0)
                    losses.append(float(m["loss"]))
                    del grads, loss, metrics, m
            ms[det].append(statistics.median(secs[1:]) * 1e3)
            run = (losses, tree_leaves(st))
            if det not in first:
                first[det] = run
            else:
                key = f"{'on' if det else 'off'}_vs_itself"
                equal[key] = equal[key] and run[0] == first[det][0] and all(
                    torch.equal(a, b) for a, b in zip(run[1],
                                                      first[det][1]))
            del st, run
            _free()
    equal["on_vs_off"] = (first[True][0] == first[False][0] and all(
        torch.equal(a, b) for a, b in zip(first[True][1],
                                          first[False][1])))
    if not (equal["off_vs_itself"] and equal["on_vs_off"]):
        raise AssertionError(f"the trainer did not repeat its bits, or "
                             f"not the deterministic mode's: {equal}")

    def spread(xs):
        q = statistics.quantiles(xs, n=4)
        return {"median": statistics.median(xs), "q1": q[0], "q3": q[2]}

    out = {"pairs": TRAIN_DET_PAIRS, "step_ms_off": ms[False],
           "step_ms_on": ms[True], "off": spread(ms[False]),
           "on": spread(ms[True]),
           "cost": statistics.median(ms[True])
           / statistics.median(ms[False]) - 1,
           "on_faster_pairs": sum(a < b for a, b in zip(ms[True],
                                                        ms[False])),
           "bit_equal": equal, "losses": first[True][0]}
    del first, state0
    _free()
    return out


def phase_train(smi):
    """Training on the card (see the module docstring, phase 18)."""
    from repro_torch.kernels import ops
    t_phase = time.perf_counter()
    _no_tf32()
    ops.reset_launch_counts()
    parts = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        full = _train_full_width(tmp)
        parts["full_width_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        example = _train_example(tmp)
        parts["example_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        card_cpu = _train_card_vs_cpu()
        parts["card_vs_cpu_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        resume = _train_kill_resume(tmp)
        parts["kill_resume_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    determinism = _train_determinism()
    parts["determinism_s"] = time.perf_counter() - t0
    _no_tf32()
    launches = {k: v for k, v in ops.launch_counts().items() if v}
    if launches:
        raise AssertionError(f"training launched {launches}")
    log(18, card=smi, full_width=full, example=example,
        card_vs_cpu=card_cpu, kill_resume=resume, determinism=determinism,
        parts_s=parts,
        launches=launches, phase_s=time.perf_counter() - t_phase)


# ------------------------------------------------ phase 19: meshes

MESH_TRAIN_STEPS = 3
MESH_SERVE_PROMPT = 32
MESH_SERVE_NEW = 16
MESH_SERVE_POLICIES = {"fidelity_fp16_ipu": ("mp_matmul",),
                       "fidelity_int8": ("qmm", "fused_qmm")}
# (c) runs full widths at this depth: its checkpoints hold the f32 state
# (parameters and both moments), about 2 GB at 2 layers
MESH_RESTORE_LAYERS = 2
MESH_RESTORE_STEPS = 4


def _dtensor_faults(tree):
    """Paths of the leaves of ``tree`` that are not DTensors."""
    from torch.distributed.tensor import DTensor
    from repro_torch.parallel import sharding as shd
    bad = []
    shd.tree_map_with_path(
        lambda path, x: None if isinstance(x, DTensor) else bad.append(path),
        tree)
    return bad


def _mesh_train(mesh):
    """(a) full-width qwen2-0.5b, bf16, phase 18's state at step 0 (seed
    0) and its first batches: ``MESH_TRAIN_STEPS`` sharded steps on the
    one-card mesh beside as many plain ones (``mesh=None``): losses
    equal, parameters and moments within ``MESH_TRAIN_PARAM_BOUND``;
    each step's ms, and each run's peak memory above what was allocated
    when it started (the plain run's final state is held meanwhile)."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLMDataset
    from repro_torch.launch import train
    from repro_torch.models import registry
    from repro_torch.optim.tree import tree_leaves
    from repro_torch.parallel import sharding as shd
    cfg = dataclasses.replace(get_config(TRAIN_ARCH),
                              precision_policy="bf16")
    api = registry.build(cfg)
    tc = train.TrainConfig(adamw=train.AdamWConfig(lr=TRAIN_LR),
                           total_steps=TRAIN_STEPS)
    ds = SyntheticLMDataset(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                                       global_batch=TRAIN_BATCH),
                            device="cuda")
    batches = [ds.batch(i) for i in range(MESH_TRAIN_STEPS)]
    out = {}
    finals = {}
    for name, mesh_or_none in (("plain", None), ("mesh", mesh),
                               ("plain_again", None), ("mesh_again", mesh)):
        _free()
        state = train.init_state(api, device="cuda")
        if mesh_or_none is not None:
            state = train.shard_state(state, mesh_or_none)
            bad = _dtensor_faults(state)
            if bad:
                raise AssertionError(f"state leaves not DTensors: {bad[:5]}")
        step = train.make_train_step(api, tc, mesh_or_none)
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.memory_allocated()
        secs, losses = [], []
        for b in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, b)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            losses.append(float(m["loss"]))
        if mesh_or_none is not None:
            bad = _dtensor_faults(state)
            if bad:
                raise AssertionError(f"stepped leaves not DTensors: "
                                     f"{bad[:5]}")
        out[name] = {"step_s": secs, "losses": losses,
                     "peak_above_start": torch.cuda.max_memory_allocated()
                     - start}
        if name in ("plain", "mesh"):
            finals[name] = [t.detach() for t in tree_leaves(
                shd.undistribute((state.params, state.opt)))]
        del state, step
    p_err = max(float((a.float() - b.float()).abs().max())
                for a, b in zip(finals["mesh"], finals["plain"]))
    bit_equal = all(torch.equal(a, b) for a, b in zip(finals["mesh"],
                                                      finals["plain"]))
    del finals
    _free()
    if out["mesh"]["losses"] != out["plain"]["losses"] \
            or p_err > MESH_TRAIN_PARAM_BOUND:
        raise AssertionError(f"sharded steps {out['mesh']['losses']} vs "
                             f"plain {out['plain']['losses']}, state max "
                             f"abs err {p_err}")
    ms = {k: statistics.median(v["step_s"][1:]) * 1e3
          for k, v in out.items()}
    return {"runs": out, "state_max_abs_err": p_err,
            "state_bit_equal": bit_equal,
            "step_ms_after_first": ms,
            "phase18_step_ms": REPORT["phases"].get("18", {}).get(
                "full_width", {}).get("step_ms"),
            "dtensor_overhead_ms": (ms["mesh"] + ms["mesh_again"]
                                    - ms["plain"] - ms["plain_again"]) / 2}


# the sharded steps against the plain ones: one device runs no
# collective and every op sees the plain step's local tensors, so the
# reading is 0 (bit-equal); a difference would be a fault
MESH_TRAIN_PARAM_BOUND = 0.0


def _mesh_greedy(prefill, decode, params, prompts, caches, n):
    """Greedy streams (n tokens: prefill's, then n - 1 decode steps) and
    the decode steps' seconds."""
    logits, st = prefill(params, {"tokens": prompts}, caches)
    full = lambda t: t.full_tensor() if hasattr(t, "full_tensor") else t  # noqa
    tok = torch.argmax(full(logits), -1).to(torch.int32)
    toks = [tok]
    pos = torch.full((prompts.shape[0],), prompts.shape[1],
                     dtype=torch.int32, device=prompts.device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n - 1):
        logits, st = decode(params, {"token": tok[:, None], "pos": pos}, st)
        tok = torch.argmax(full(logits), -1).to(torch.int32)
        toks.append(tok)
        pos = pos + 1
    torch.cuda.synchronize()
    return torch.stack(toks, 1).cpu(), time.perf_counter() - t0


def _mesh_serve(mesh):
    """(b) ``make_serve_fns`` on the one-card mesh for full-width
    qwen2-0.5b (weights from seed 0, raw: every projection quantizes or
    converts its weight per call) under ``MESH_SERVE_POLICIES``: 8
    prompts of ``MESH_SERVE_PROMPT`` tokens prefilled, then greedy
    decode to ``MESH_SERVE_NEW`` tokens, beside the plain
    ``api.prefill``/``api.decode_step`` loop: equal streams, and the
    policy's kernel launched once per projection per forward on local
    shards."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import registry
    from repro_torch.parallel import sharding as shd
    from repro_torch.serving.engine import make_serve_fns
    out, launches = {}, {}
    for policy, names in MESH_SERVE_POLICIES.items():
        cfg = dataclasses.replace(get_config(TRAIN_ARCH),
                                  precision_policy=policy)
        api = registry.build(cfg)
        params = api.init(0, "cuda")
        prompts = torch.from_numpy(np.random.default_rng(19).integers(
            0, 1000, (8, MESH_SERVE_PROMPT), dtype=np.int32)).cuda()
        cache_len = MESH_SERVE_PROMPT + MESH_SERVE_NEW
        prefill, decode, _, p_sh = make_serve_fns(
            api, mesh, {"tokens": registry.Spec(tuple(prompts.shape),
                                                torch.int32)},
            cache_len, 8)
        placed = shd.distribute(params, p_sh)
        forwards = MESH_SERVE_NEW            # one prefill, n - 1 decodes
        projections = 7 * cfg.n_layers
        ops.reset_launch_counts()
        toks, dec_s = _mesh_greedy(prefill, decode, placed, prompts,
                                   api.init_cache(8, cache_len, "cuda"),
                                   MESH_SERVE_NEW)
        got = {k: v for k, v in ops.launch_counts().items() if v}
        ops.reset_launch_counts()
        with torch.no_grad():
            ref, ref_s = _mesh_greedy(api.prefill, api.decode_step, params,
                                      prompts, api.init_cache(
                                          8, cache_len, "cuda"),
                                      MESH_SERVE_NEW)
        ref_launches = {k: v for k, v in ops.launch_counts().items() if v}
        ops.reset_launch_counts()
        n = sum(got.get(k, 0) for k in names)
        if n != projections * forwards or got != ref_launches:
            raise AssertionError(
                f"{policy}: the mesh run launched {got} (want "
                f"{projections * forwards} of {names}), the plain run "
                f"{ref_launches}")
        if not torch.equal(toks, ref):
            raise AssertionError(f"{policy}: mesh streams {toks.tolist()} "
                                 f"vs plain {ref.tolist()}")
        for k in names:
            launches[k] = launches.get(k, 0) + got.get(k, 0)
        out[policy] = {
            "launches": got, "plain_launches": ref_launches,
            "streams_equal": True,
            "decode_tok_s": 8 * (MESH_SERVE_NEW - 1) / dec_s,
            "plain_decode_tok_s": 8 * (MESH_SERVE_NEW - 1) / ref_s}
        del params, placed, api, prefill, decode
        _free()
    return out, launches


def _mesh_restore(mesh, tmp):
    """(c) a checkpoint saved from the plain state (full widths,
    ``MESH_RESTORE_LAYERS`` layers) restored onto the mesh by
    ``FaultTolerantLoop.run(shardings=)``; ``MESH_RESTORE_STEPS`` sharded
    steps with checkpoints every 2, then the same run killed at step 3
    (no restarts left) and resumed by a new loop from the step-2
    checkpoint: the resumed losses and final state equal the
    uninterrupted run's."""
    import shutil
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLMDataset
    from repro_torch.launch import train
    from repro_torch.models import registry
    from repro_torch.optim.tree import tree_leaves
    from repro_torch.parallel import sharding as shd
    from repro_torch.runtime.fault_tolerance import (FTConfig,
                                                     FaultTolerantLoop,
                                                     WorkerFailure,
                                                     fail_at_step)
    cfg = dataclasses.replace(get_config(TRAIN_ARCH),
                              precision_policy="bf16",
                              n_layers=MESH_RESTORE_LAYERS)
    api = registry.build(cfg)
    tc = train.TrainConfig(adamw=train.AdamWConfig(lr=TRAIN_LR),
                           total_steps=MESH_RESTORE_STEPS)
    ds = SyntheticLMDataset(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                                       global_batch=TRAIN_BATCH),
                            device="cuda")
    plain = train.init_state(api, seed=1, device="cuda")
    shardings = train.state_shardings(plain, mesh)
    whole_dir, killed_dir = (os.path.join(tmp, n) for n in ("whole",
                                                            "killed"))
    t0 = time.perf_counter()
    CheckpointManager(whole_dir).save(0, plain)
    save_s = time.perf_counter() - t0
    shutil.copytree(os.path.join(whole_dir, f"step_{0:09d}"),
                    os.path.join(killed_dir, f"step_{0:09d}"))
    step_fn = train.make_train_step(api, tc, mesh)
    # the loops start from a state they replace by the checkpoint: zeros
    # on the mesh, so a missed restore shows
    blank = shd.distribute(train.TrainState(
        *(shd.zip_map(lambda x, _: torch.zeros_like(x), part, part)
          for part in plain)), shardings)

    def loop(path, **kw):
        return FaultTolerantLoop(step_fn, ds.batch, path,
                                 FTConfig(checkpoint_every=2,
                                          max_restarts=0), **kw)

    t0 = time.perf_counter()
    whole = loop(whole_dir)
    st_whole, n_whole = whole.run(blank, 0, MESH_RESTORE_STEPS,
                                  shardings=shardings)
    whole_s = time.perf_counter() - t0
    killed = loop(killed_dir, failure_hook=fail_at_step(3))
    try:
        killed.run(blank, 0, MESH_RESTORE_STEPS, shardings=shardings)
        raise AssertionError("fail_at_step(3) did not kill the run")
    except WorkerFailure:
        pass
    resumed = loop(killed_dir)
    st_res, n_res = resumed.run(blank, 0, MESH_RESTORE_STEPS,
                                shardings=shardings)
    bad = _dtensor_faults(st_res) + _dtensor_faults(st_whole)
    l_whole = [h["loss"] for h in whole.history]
    l_killed = [h["loss"] for h in killed.history]
    l_res = [h["loss"] for h in resumed.history]
    equal = (n_res == n_whole == MESH_RESTORE_STEPS and not bad
             and [h["step"] for h in resumed.history] == [2, 3]
             and l_killed[:2] + l_res == l_whole
             and all(torch.equal(a, b) for a, b in zip(
                 tree_leaves(shd.undistribute(st_res)),
                 tree_leaves(shd.undistribute(st_whole)))))
    if not equal:
        raise AssertionError(f"resumed {l_res} (steps {n_res}, non-DTensor "
                             f"leaves {bad[:5]}) vs whole {l_whole}")
    del plain, blank, st_whole, st_res
    _free()
    return {"bit_equal": equal, "losses": l_whole,
            "killed_losses": l_killed, "resumed_losses": l_res,
            "plain_save_s": save_s, "whole_run_s": whole_s,
            "layers": MESH_RESTORE_LAYERS}


def phase_mesh(smi):
    """Sharding on a one-card mesh (see the module docstring, phase 19)."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_single_device_mesh
    t_phase = time.perf_counter()
    _no_tf32()
    parts = {}
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(
            "nccl", init_method="file://" + os.path.join(tmp, "rendezvous"),
            rank=0, world_size=1)
        try:
            torch.cuda.set_device(0)
            mesh = make_single_device_mesh("cuda")
            t0 = time.perf_counter()
            train_out = _mesh_train(mesh)
            parts["train_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            serve_out, launches = _mesh_serve(mesh)
            parts["serve_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            restore_out = _mesh_restore(mesh, tmp)
            parts["restore_s"] = time.perf_counter() - t0
        finally:
            dist.destroy_process_group()
    _no_tf32()
    log(19, card=smi, mesh=[[1, 1], ["data", "model"]], train=train_out,
        serve=serve_out, restore=restore_out, launches=launches,
        parts_s=parts, phase_s=time.perf_counter() - t_phase)
    return launches


# ------------------------------------ phase 20: exchange and dry-run

CODEC_WIDTHS = (8, 4)
EXCHANGE_METHODS = ("f32", "int8", "blockfp8")
# the dry-run's per-device estimate against the measured step peak
DRYRUN_MEMORY_RATIO = (0.67, 1.5)
# (d): the production cell traced on a fake world of 256
DRYRUN_CELL = ("qwen2-0.5b", "train_4k")


def _exchange_state():
    """Full-width qwen2-0.5b under ``bf16``, phase 18's state at step 0
    (seed 0) and its first batch of 8 x 128 tokens, on the card."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLMDataset
    from repro_torch.launch import train
    from repro_torch.models import registry
    cfg = dataclasses.replace(get_config(TRAIN_ARCH),
                              precision_policy="bf16")
    api = registry.build(cfg)
    ds = SyntheticLMDataset(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                                       global_batch=TRAIN_BATCH),
                            device="cuda")
    return cfg, api, train.init_state(api, device="cuda"), ds.batch(0)


def _paths(tree):
    """{keystr path: leaf} of a tree."""
    from repro_torch.parallel import sharding as shd
    out = {}
    shd.tree_map_with_path(lambda p, x: out.__setitem__(p, x), tree)
    return out


def _codec(leaves, w):
    """{path: (mant, exp, dequantized)} of every leaf at width ``w``, on
    the leaves' device."""
    from repro_torch.parallel import blockfp
    res = {}
    for k, g in leaves.items():
        m, e, n = blockfp.blockfp_quantize(g, w)
        res[k] = (m, e, blockfp.blockfp_dequantize(
            m.to(torch.int32), e, n, w, g.shape))
    return res


def _codec_on_card(grads):
    """(a), on the card: ``blockfp_quantize``/``blockfp_dequantize`` of
    every gradient leaf at each width, the results copied to the host,
    and the milliseconds of the whole tree against its byte bound."""
    leaves = _paths(grads)
    n_values = sum(g.numel() for g in leaves.values())
    out, results = {"leaves": len(leaves), "values": n_values}, {}
    for w in CODEC_WIDTHS:
        results[w] = {k: tuple(t.cpu() for t in v)
                      for k, v in _codec(leaves, w).items()}
        ms = median_ms(lambda: _codec(leaves, w), reps=5, warm=1)
        # quantize reads 4 B a value and writes 1 (and 1 exponent byte a
        # block); dequantize reads those and writes 4
        n_bytes = n_values * (4 + 1 + 1 + 4) + 2 * n_values / 256
        out[f"w{w}"] = {"ms": ms, "bytes": n_bytes,
                        "bound_ms": n_bytes / REPORT["rates"]["bytes_per_s"]
                        * 1e3}
    return out, results


def _codec_vs_cpu(grads_cpu, results, out):
    """(a), on the CPU: the card's results bit-equal to the CPU's."""
    leaves = _paths(grads_cpu)
    for w in CODEC_WIDTHS:
        cpu = _codec(leaves, w)
        bad = [k for k in leaves
               if not all(torch.equal(a, b)
                          for a, b in zip(results[w][k], cpu[k]))]
        if bad:
            raise AssertionError(f"blockfp w={w}: card and CPU differ on "
                                 f"{bad[:5]}")
        out[f"w{w}"]["bit_equal"] = True


def _exchange_on_card(grads):
    """(b), on the card: ``make_pod_exchange`` on a (1, 1, 1) ("pod",
    "data", "model") mesh over the one-rank NCCL group, each method over
    the gradients stacked on a pod axis of 1: every output's shape and
    placements, the recorder seeing the all-gathers (0 wire bytes at
    group size 1), ms per exchange; the outputs' local tensors copied
    to the host."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.roofline import CollectiveRecorder
    from repro_torch.optim.tree import tree_map
    from repro_torch.parallel import blockfp
    from repro_torch.parallel import sharding as shd
    mesh = make_mesh((1, 1, 1), ("pod", "data", "model"), "cuda")
    stacked = tree_map(lambda g: g[None], grads)
    out, results = {}, {}
    for method in EXCHANGE_METHODS:
        fn, in_sh, out_sh = blockfp.make_pod_exchange(mesh, stacked, method)
        placed = shd.distribute(stacked, in_sh)
        with CollectiveRecorder() as rec:
            got = fn(placed)
        torch.cuda.synchronize()
        want, want_sh, got_p = _paths(stacked), _paths(out_sh), _paths(got)
        bad = [(k, tuple(x.shape), x.placements) for k, x in got_p.items()
               if tuple(x.shape) != tuple(want[k].shape)
               or tuple(x.placements) != want_sh[k].placements]
        if bad:
            raise AssertionError(f"exchange {method}: outputs at {bad[:5]}")
        if "all-gather" not in rec.stats.by_op or \
                rec.stats.total_bytes != 0.0:
            raise AssertionError(f"exchange {method}: recorded "
                                 f"{rec.stats.by_op} at group size 1")
        results[method] = {k: x.to_local().cpu() for k, x in got_p.items()}
        del got
        ms = median_ms(lambda: fn(placed), reps=5, warm=1)
        out[method] = {"ms": ms, "recorded": dict(rec.stats.by_op),
                       "collectives": rec.stats.count}
        del placed
    return out, results


def _exchange_vs_cpu(grads_cpu, results, out):
    """(b), on the CPU: the card's outputs bit-equal to the same
    functions over the one-rank gloo group that is the default group."""
    from repro_torch.parallel import blockfp
    cpu_fn = {"f32": lambda g: blockfp._all_gather(g, None).sum(0),
              "int8": lambda g: blockfp.int8_psum(g, None),
              "blockfp8": lambda g: blockfp.compressed_psum(g, None, 8)}
    for method in EXCHANGE_METHODS:
        bad = [k for k, g in _paths(grads_cpu).items()
               if not torch.equal(results[method][k], cpu_fn[method](
                   g[None].to(torch.float32)))]
        if bad:
            raise AssertionError(f"exchange {method}: card and CPU differ "
                                 f"on {bad[:5]}")
        out[method]["bit_equal"] = True


def _compression_on_meshes(api, state, batch):
    """(c) ``TrainConfig(compression="blockfp8")`` refuses a (1, 1, 1)
    pod mesh and, on a (1, 1) mesh, gives the ``"none"`` step's loss and
    state bit for bit."""
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim.tree import tree_leaves
    from repro_torch.parallel import sharding as shd
    tc = train.TrainConfig(adamw=train.AdamWConfig(lr=TRAIN_LR),
                           total_steps=TRAIN_STEPS, compression="blockfp8")
    pod = make_mesh((1, 1, 1), ("pod", "data", "model"), "cuda")
    try:
        train.make_train_step(api, tc, pod)
    except NotImplementedError as e:
        refused = str(e)
    else:
        raise AssertionError("compression on a pod mesh did not raise")
    mesh = make_mesh((1, 1), ("data", "model"), "cuda")
    runs = {}
    for name, cfg_tc in (("blockfp8", tc), ("none", dataclasses.replace(
            tc, compression="none"))):
        new, m = train.make_train_step(api, cfg_tc, mesh)(
            train.shard_state(state, mesh), batch)
        runs[name] = (float(m["loss"]), [t.detach() for t in tree_leaves(
            shd.undistribute((new.params, new.opt)))])
        del new, m
    same = runs["blockfp8"][0] == runs["none"][0] and all(
        torch.equal(a, b) for a, b in zip(runs["blockfp8"][1],
                                          runs["none"][1]))
    if not same:
        raise AssertionError(f"compression on a (1, 1) mesh changed the "
                             f"step: {runs['blockfp8'][0]} vs "
                             f"{runs['none'][0]}")
    loss = runs["none"][0]
    del runs
    return {"refused_on_pod_mesh": refused, "loss": loss,
            "bit_equal_to_none": True}


def _nbytes(tensors):
    """Bytes of the storages under ``tensors``, each counted once."""
    storages = {t.untyped_storage().data_ptr(): t.untyped_storage().nbytes()
                for t in tensors}
    return sum(storages.values())


def _dryrun_vs_card(cfg, api, state, batch):
    """(d) the dry-run's per-device estimate of the 8 x 128 step (a fake
    world of 1, a (1, 1) mesh) against one real plain step: its
    Parameter and Optstate bytes equal to the state's on the card; the
    whole estimate against the step's measured peak above what was
    resident before it (``max_memory_allocated`` with the peak reset;
    earlier phases' leftovers drop out), plus the state and batch bytes;
    and the rest of the estimate (activations and temporaries) against
    that measured increment."""
    from repro_torch.configs import InputShape
    from repro_torch.launch import dryrun, train
    from repro_torch.optim.tree import tree_leaves
    rec = dryrun.run_cell(cfg.arch_id, "phase20", False, cfg=cfg,
                          shape=InputShape("phase20", TRAIN_SEQ, TRAIN_BATCH,
                                           "train"), mesh_shape=(1, 1))
    if rec["status"] != "ok":
        raise AssertionError(f"the dry-run failed: {rec}")
    held = {"Parameter": _nbytes(tree_leaves(state.params)),
            "Optstate": _nbytes(tree_leaves(
                (state.opt, state.loss_scale, state.step))),
            "Other": _nbytes(tree_leaves(batch))}
    est_mem = rec["memory"]
    if any(est_mem[k] != held[k] for k in ("Parameter", "Optstate")):
        raise AssertionError(f"the dry-run's state bytes {est_mem} against "
                             f"the state's on the card {held}")
    step = train.make_train_step(api, train.TrainConfig(
        adamw=train.AdamWConfig(lr=TRAIN_LR), total_steps=TRAIN_STEPS))
    _free()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    new, m = step(state, batch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    del new, m
    est = rec["per_device_bytes"]
    held_bytes = sum(held.values())
    measured = peak - resident + held_bytes
    ratio = est / measured
    step_ratio = (est - held_bytes) / (peak - resident)
    lo, hi = DRYRUN_MEMORY_RATIO
    if not (lo <= ratio <= hi and lo <= step_ratio <= hi):
        raise AssertionError(f"dry-run estimate {est} against the measured "
                             f"{measured}: ratio {ratio}; above the state "
                             f"{step_ratio}")
    return {"estimate_bytes": est, "memory": est_mem, "state_bytes": held,
            "measured_bytes": measured, "measured_peak_bytes": peak,
            "resident_before_bytes": resident, "ratio": ratio,
            "step_ratio": step_ratio, "bounds": DRYRUN_MEMORY_RATIO,
            "flops": rec["cost"]["flops"],
            "collectives": rec["collectives"]}


def _start_production_cell(tmp):
    """The production cell's dry-run CLI in a process of its own (a fake
    world of 256 is process-wide)."""
    arch, shape = DRYRUN_CELL
    env = dict(os.environ)
    src = os.path.join(HERE, "src")
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (src, env.get("PYTHONPATH")) if p)
    out = os.path.join(tmp, "dryrun")
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", shape, "--mesh", "single", "--out", out],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, out, time.perf_counter()


def _finish_production_cell(proc, out, t0):
    text, _ = proc.communicate(timeout=600)
    wall = time.perf_counter() - t0
    arch, shape = DRYRUN_CELL
    path = os.path.join(out, f"{arch}__{shape}__single.json")
    if proc.returncode != 0 or not os.path.exists(path):
        raise AssertionError(f"the dry-run CLI failed ({proc.returncode}): "
                             f"{text[-2000:]}")
    with open(path) as f:
        rec = json.load(f)
    if rec["status"] != "ok":
        raise AssertionError(f"the production cell did not trace: "
                             f"{rec.get('traceback', rec)}")
    return {"cell": f"{arch} {shape} {rec['mesh']}", "since_start_s": wall,
            "trace_s": rec["compile_s"], "chips": rec["chips"],
            "per_device_bytes": rec["per_device_bytes"],
            "fits_card": rec["fits_card"], "card_bytes": rec["card_bytes"],
            "roofline": rec["roofline"], "collectives": rec["collectives"]}


@contextlib.contextmanager
def _production_cell(tmp):
    """Starts the production cell on entry and yields the call that waits
    for it and reads its record; while it runs, this process's torch
    keeps to all but one of the host's cores, and the cell's process is
    killed on the way out if it still runs."""
    proc, out, t0 = _start_production_cell(tmp)
    threads = torch.get_num_threads()
    torch.set_num_threads(max(1, (os.cpu_count() or 2) - 1))
    try:
        yield lambda: _finish_production_cell(proc, out, t0)
    finally:
        torch.set_num_threads(threads)
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def phase_exchange(smi):
    """The block-FP exchange and the dry-run (see the module docstring,
    phase 20). The timed parts of (a) and (b) run first, alone; the
    production cell then traces beside the rest, which times nothing."""
    import torch.distributed as dist
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.launch.dryrun import fake_world
    from repro_torch.optim.tree import tree_map
    t_phase = time.perf_counter()
    _no_tf32()
    ops.reset_launch_counts()
    parts = {}
    with tempfile.TemporaryDirectory() as tmp, \
            contextlib.ExitStack() as stack:
        cfg, api, state, batch = _exchange_state()
        with train.train_numerics():
            grads, _, _ = train.grad_step(api, train.TrainConfig(),
                                          state, batch)
        grads_cpu = tree_map(lambda g: g.cpu(), grads)
        dist.init_process_group(
            "nccl", init_method="file://" + os.path.join(tmp, "rdv"),
            rank=0, world_size=1)
        try:
            torch.cuda.set_device(0)
            t0 = time.perf_counter()
            codec, codec_card = _codec_on_card(grads)
            parts["codec_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            exchange, exchange_card = _exchange_on_card(grads)
            parts["exchange_s"] = time.perf_counter() - t0
            del grads
            _free()
            finish_cell = stack.enter_context(_production_cell(tmp))
            t_beside = time.perf_counter()
            compression = _compression_on_meshes(api, state, batch)
        finally:
            dist.destroy_process_group()
        _free()
        with fake_world(1):
            memory = _dryrun_vs_card(cfg, api, state, batch)
        del state, batch
        _free()
        dist.init_process_group(
            "gloo", init_method="file://" + os.path.join(tmp, "gloo"),
            rank=0, world_size=1)
        try:
            _codec_vs_cpu(grads_cpu, codec_card, codec)
            _exchange_vs_cpu(grads_cpu, exchange_card, exchange)
        finally:
            dist.destroy_process_group()
        parts["beside_cell_s"] = time.perf_counter() - t_beside
        t0 = time.perf_counter()
        production = finish_cell()
        parts["cell_wait_s"] = time.perf_counter() - t0
    _no_tf32()
    launches = {k: v for k, v in ops.launch_counts().items() if v}
    if launches:
        raise AssertionError(f"phase 20 launched {launches}")
    log(20, card=smi, codec=codec, exchange=exchange,
        compression=compression, dryrun_vs_card=memory,
        production_cell=dict(production, beside="phase 20's (c), (d) "
                             "and CPU checks"),
        parts_s=parts, phase_s=time.perf_counter() - t_phase)


# ---------------------------------------------------------------- main

KERNELS = {
    "fused_dequant_mm": ("src/repro_torch/kernels/csrc/fused_dequant.cu",
                         "src/repro/kernels/fused.py:108"),
    "fused_qmm": ("src/repro_torch/kernels/csrc/qmm.cu",
                  "src/repro/kernels/fused.py:85"),
    "qmm": ("src/repro_torch/kernels/csrc/qmm.cu",
            "src/repro/kernels/qmm.py:25"),
    "qmm_packed": ("src/repro_torch/kernels/csrc/qmm.cu",
                   "src/repro/kernels/qmm.py:38"),
    "mp_matmul": ("src/repro_torch/kernels/csrc/mpmm.cu",
                  "src/repro/kernels/mpmm.py:42"),
}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--report", help="also write every number to this "
                    "JSON file")
    ap.add_argument("--profile", action="store_true",
                    help="profile one decode block, replayed from its "
                    "graph and run eagerly, in phases 3, 4, 6 and 8-12, "
                    "and one replayed decode step in phase 13")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke test needs one",
              file=sys.stderr)
        return 1
    src = os.path.join(HERE, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print(f"chip_smoke: no port package under {src}", file=sys.stderr)
        return 1
    sys.path.insert(0, src)
    if args.report:
        REPORT_PATH.append(args.report)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.configs import get_config
    from repro_torch.models import registry

    name, smi = phase_build()
    rates_key, rates = card_rates(name)
    clock_hz = float(REPORT["clocks_max_sm"].split()[0]) * 1e6
    rates = dict(rates, int32=rates["sms"] * INT32_LANES_PER_SM * clock_hz)
    REPORT["rates"] = {"card": rates_key, **rates}
    err, timing = phase_kernels(rates)
    cfg = get_config("qwen2-0.5b")
    params = registry.init_params(cfg, seed=0)
    launches3, scales8 = phase_serving(name, smi, params, cfg, args.profile)
    launches4 = phase_exact(params, cfg, args.profile)
    phase_card_vs_cpu(params, cfg, scales8)
    launches6 = phase_fidelity(params, cfg, args.profile)
    launches7 = phase_fleet(params, cfg)
    del params
    _free()
    launches8 = phase_moe(smi, args.profile)
    launches9 = phase_gemma2(smi, args.profile)
    launches_families = [phase_family(arch, smi, args.profile)
                         for arch in FAMILIES]
    launches13 = phase_encdec(smi, args.profile)
    with tempfile.TemporaryDirectory() as tmp:
        trace = os.path.join(tmp, "serving_smoke_trace.json")
        launches14 = phase_serving_smoke(smi, trace)
        launches15 = phase_studies(smi, trace)
    launches16 = phase_planner(smi)
    launches17 = phase_fabric(smi, get_config("qwen2-0.5b"))
    phase_train(smi)
    launches19 = phase_mesh(smi)
    phase_exchange(smi)

    main_launches = {
        "fused_dequant_mm": launches3["fused_dequant_mm"]
        + launches7["fused_dequant_mm"] + launches8["fused_dequant_mm"]
        + launches9["fused_dequant_mm"]
        + sum(n["fused_dequant_mm"] for n in launches_families)
        + launches13["fused_dequant_mm"] + launches14["fused_dequant_mm"]
        + launches15["fused_dequant_mm"] + launches16["fused_dequant_mm"]
        + launches17["fused_dequant_mm"],
        "fused_qmm": launches4["fidelity_int8"]["fused_qmm"]
        + launches4["int4_exact"]["fused_qmm"] + launches14["fused_qmm"]
        + launches19.get("fused_qmm", 0),
        "qmm": launches4["fidelity_int8"]["qmm"] + launches14["qmm"]
        + launches19.get("qmm", 0),
        "qmm_packed": launches4["int4_exact"]["qmm_packed"],
        "mp_matmul": launches6["mp_matmul"] + launches15["mp_matmul"]
        + launches16["mp_matmul"] + launches19["mp_matmul"],
    }
    kernels = []
    for kname, (source, replaces) in KERNELS.items():
        t = timing[kname]
        kernels.append({
            "name": kname, "route": "cuda", "source": source,
            "replaces": replaces, "launches": main_launches[kname],
            "max_abs_err": err[kname], "ms": t["ms"],
            "graph_ms": t["graph_ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
    REPORT["kernels"] = kernels
    REPORT["card"] = smi
    REPORT["total_s"] = time.perf_counter() - T_START
    write_report()
    print(f"total {REPORT['total_s']:.1f} s on {smi}", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
