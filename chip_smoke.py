#!/usr/bin/env python3
"""Build and drive the PyTorch/CUDA port of Squeeze on one NVIDIA GPU.

    python3 chip_smoke.py

Run from a checkout of the repository (it imports ``src/repro_torch``, never
jax or the reference package). Phases, each printing one JSON line:

  1. device  -- the card's name and power limit (nvidia-smi), torch/CUDA;
  2. build   -- the kernels built from ``src/repro_torch/kernels/csrc`` by
                nvcc for sm_90a;
  3. kernels against their plain PyTorch versions on the card: v1 and v2
     (one simulation and B=3), v2's strip gather (every direction, and the
     workload's ``halo_needs``), v3, v4 (k in {1, 2, rho}) and v5 (k in {1,
     2}, two packings, B=3) on LIFE, HIGHLIFE, HEAT and GRAY_SCOTT over
     sierpinski (m=2), carpet and vicsek (m=1: rho = 3, runs that are not
     16-byte aligned) at about 10^6 compact cells or more, <= 8 steps each;
     CA bit-exact, floats to rtol=1e-5 and atol=1e-5 * min(1, max|plain|),
     so a field that has decayed is still compared at its own scale, v1,
     v2, the gather, v3 (one simulation and B=3) and v4 bit for bit for
     every rule; then v4 at
     every body ``fused_plan`` picks (``FUSED_CHECK``: windows of W = 16 and
     32 lanes at rho = 8, 9 and 27, and the CTA body ``[wide]`` at rho = 27,
     k = 3 and 27), one simulation and B=3, bit for bit, with the launches
     by body; then v1 and v2 at every body ``step_plan`` picks and v3 at
     every body ``fused_plan`` picks at k = 1 (the warp body at W = 16 and
     32 on ``FUSED_CHECK``'s layouts, and the CTA body, ``[wide]``, for two
     workloads whose ring weights are not their rule's own), 2 steps, bit
     for bit, with the launches by body (every class reached by each); then
     nu and lambda, bit-exact, on all five registry fractals at r in {0, 1,
     2, 3, 2L + 1 (nu's top group short, and lambda's), the largest r whose
     coordinates fit int32}, 10^6 + 1 coordinates each (nu's past both
     edges of the grid, lambda's negative and past the compact edges);
  4. the main path at the paper's size (sierpinski r=16, 3^16 cells), each
     timed run after one untimed warm-up run: ``BatchedRunner.run`` with
     cuda-mxu (LIFE, B=4, 64 steps) and (HEAT, B=2, 64 steps),
     ``make_engine('cuda-fused').run`` with LIFE and GRAY_SCOTT for 63 steps
     (the v3 remainder runs), ``make_engine('cuda')`` (= cuda-strips, v4
     plus one v2 remainder) with LIFE for 63 steps, cuda-strips,
     cuda-blocks and cuda-fused with fusion_k=1 (every step v2, and its
     gather, v1 or v3; no ``[wide]`` launch) with LIFE and HEAT for 16
     steps, each held against the plain ``block`` engine on the
     card; and the ``cell`` engine (index tensors from one lambda and 8 nu
     launches) with LIFE for 4 steps, held against cuda-fused through the
     expanded grid; with the kernel launch counts of the whole phase;
  5. the paper's comparison (Fig. 12's trio): the expanded bounding-box
     engine on the 65536^2 grid against the lambda engine, the cell engine,
     cuda-mxu and cuda-fused for LIFE (the same states, checked equal),
     time per step with the index build outside the timed window, speedup,
     memory;
  6. each kernel at the main path's shapes, with its plain version's time
     and, for v2, the step alone and the strip gather (the kernel and its
     plain version), each with its design's bound (``bound_design_ms``: v1
     nine whole blocks a window from device memory, v2 the gather's bytes
     and the step's) and the registers of each instance of its warp body,
     CTA body and gather (v3: its instances compiled at k = 1); for the
     maps over all 3^16 compact cells, also the float32 product form
     (``*_map_matmul``, Fig. 14's tensor-core form against the scalar
     kernels), nu and lambda each with its plan (groups of L levels), the
     operations of its design (``nu_ops``, ``lambda_ops``) and the
     registers of each of its instances; then
     a ``kernels`` line:
     each kernel's launches on the main path, largest error against its
     plain version, time, plain time and bound; v5's row (and kernel 7's,
     phase 13) also with the operation bound of its padded TF32 products
     (``bound_ops_design_ms``) and the registers and spills of each
     instance of its kernel (``registers``), v4's (and kernel 6's) with the
     registers and spills of its warp body's instances by W and of its
     CTA body (``registers``). v4 and kernel 6 hold a window column a lane,
     its rows in registers, 32 / W windows a warp, and stage a group's
     blocks into fixed slots of a warp-private buffer (the centers as one
     run, a lane a neighbor block, only the rows a window reads; kernel 6
     its five piece runs); v5 computes each window slot's
     Moore aggregate as sum_t (R_t X) C_t^T on the tensor cores
     (``mma.sync`` m16n8k8 TF32: one pass for the uint8 CA states, exact
     after rintf; 3xTF32 for float32), a warp per pair of slots in a
     persistent grid; windows wider than 8 cells take its wide instance,
     counted as ``<name>[wide]``;
  7. the 3D kernels (cuda-3d's fused kernel, cuda-3d-mxu's z-slab banded
     kernel) against their plain versions on the Menger sponge (r=5 at m=1
     and m=2) and the Sierpinski tetrahedron (r=10, m=2): LIFE3D, HEAT3D
     and the 2D rule LIFE, k in {1, 2, 3, rho}, two packings of the mxu
     kernel for k <= 2 where its plan runs the CTA body (the tensor-core
     body takes no packing), one simulation and B=3, <= 8 steps (at least one),
     at phase 3's bar, the fused kernel bit for bit; each run through the
     body its plan names (``fused3_plan``: the column body, a thread a
     window column with its cells in registers, at W = 8 and 16, or the CTA
     body for w > 16, counted as ``<name>[wide]``; ``mxu3_plan``: the
     tensor-core body, a warp a window plane with the banded products on
     ``mma.sync`` TF32, or the CTA body), its launches counted under that
     body's name, every body (``CLASSES3D``) reached; then the windows over
     one CTA's shared memory, on the Menger sponge r=5 m=3 (rho=27):
     HEAT3D at k=2 and 3 and LIFE3D at k=27 through cuda-3d and
     cuda-3d-mxu, B=1 and 3, each one launch of the CTA body's device-
     workspace variant (counted under ``<name>[global]``), with a launch's
     time;
  8. the 3D main path at full size, the Menger sponge r=6, m=2 (160,000
     blocks of 9^3, 64,000,000 cells), each timed run after a warm-up:
     ``make_engine('cuda-3d')`` with LIFE3D and HEAT3D for 31 steps,
     ``make_engine('cuda-3d-mxu')`` with both for 16 steps,
     ``BatchedRunner.run('cuda-3d')`` with LIFE3D, B=2, 16 steps, each held
     against the plain ``block3d`` engine on the card (cuda-3d bit for
     bit, floats too), and ``cell3d`` with
     LIFE3D for 2 steps, held against cuda-3d through the expanded volume;
     with the phase's launch counts, asserted to floor(steps/k) + steps % k
     under the plain names (the column and tensor-core bodies: 28 fused
     and 12 mxu launches) and none under ``[wide]`` or ``[global]``;
  9. Fig. 12 in 3D: ``bb3d`` on the 729^3 volume against cell3d, cuda-3d
     and cuda-3d-mxu for LIFE3D from the same state (checked equal), time
     per step, speedup and memory;
 10. both 3D kernels at the main path's shapes (LIFE3D and HEAT3D), with
     their plain versions' times and bounds, each line with its plan;
     their rows join the ``kernels`` line with LIFE3D's numbers, HEAT3D's
     beside them (``heat3d``), the registers and spills of each instance
     (``registers``) and row 9's design bound (``bound_ops_design_ms``:
     the tensor-core body's TF32 products as it runs them);
 11. the shard-local kernels (kernels 6 and 7: v4 and v5 over one shard's
     blocks from halo pieces and an existence table) against their plain
     versions on the card, on every call the distributed engine makes:
     phase 3's shapes sharded over 1, 3 and 8 shards (all on cuda:0), both
     exchanges, k in {1, 2, rho}, B=1 and 3, two packings for v5, LIFE,
     HIGHLIFE, HEAT and GRAY_SCOTT (kernel 6 bit for bit); each run's
     result also against the single-device cuda-fused (bit for bit) or
     cuda-mxu engine; then kernel 6 at every body ``fused_plan`` picks, as
     v4 in phase 3, from random halo pieces and existence rows;
 12. the distributed main path at the paper's size, sierpinski r=16 (4
     shards, all on cuda:0 on one card), each timed run after a warm-up:
     ``make_engine('dist-fused')`` LIFE and GRAY_SCOTT with the p2p
     exchange and LIFE with the gather exchange for 63 steps,
     ``BatchedRunner.run`` with
     dist-mxu LIFE (B=4, 64 steps) and dist-block LIFE for 4 steps, each
     against the single-device run of its kind (cuda-fused, cuda-mxu or
     plain block) on the same state, with ms per step beside that run's,
     the launch counts (two per shard for a p2p launch, one for a gather
     launch), the exchange accounting against the byte model, the kernels'
     share of a launch on CUDA events, the decomposition's build seconds
     and the wire bytes per device for 2, 4 and 8 shards;
 13. kernels 6 and 7 at phase 12's per-shard shapes (LIFE, k=2, B=4 for
     v5), with their plain versions' times and bounds, and kernel 6's
     registers by instance; their rows join the ``kernels`` line;
 14. the flash-attention and SSD chunk kernels against their plain
     versions: the reference tests' attention shapes (one block, several,
     Sq < Sk, windows 128 and 256, softcap 50, decode Sq=1), non-causal,
     causal Sq > Sk (queries that see no key get the mean of v), a window
     that hides every key, D in {36, 64, 128, 256}, decode with a ragged
     Sk and with four rows under a window, each in float32 (bar 2e-5) and
     bfloat16 (the reference's 2e-2, and within one bf16 rounding of the
     plain version in float32: |got - want| <= ulp_bf16(|want|) + 1e-5),
     each through the body ``attention.plan`` names (tensor cores, split,
     FP32), counted under that body's name; the SSD kernel at the
     reference test's shapes, a ragged S at mamba2-780m's widths, chunks
     of 256 (S whole and ragged) and 512 (2e-5), with the whole scan
     against the chunked oracle ``models.ssm._ssd_chunked``;
 15. their path at full width, each run after a warm-up and held against
     the plain version: ``flash_attention`` at gemma2-2b (bf16, 8 heads of
     D=256, softcap 50) for a global layer (causal, S=8192), a local layer
     (window 4096) and decode (B=8, Sq=1, Sk=8192, bq=1), and
     ``ssd_chunk_scan`` at mamba2-780m (f32, B=4, S=2048, 48 heads of P=64,
     N=128, chunk 128), with the kernel's share of the scan on CUDA events
     and the launch counts by body (global and local on the tensor cores,
     decode split); each bf16 run also within one bf16 rounding of the
     float32 plain version; then the three attention runs again in float32
     at 2e-5 (FP32 body for prefill, split for decode, counted), each row
     with its output's rms beside its bar;
 16. both kernels timed (attention also at the global layer with the
     softcap off, beside ``scaled_dot_product_attention`` on the same
     inputs, the yardstick the port never calls, and its plain version),
     with the bound of the function (4 D operations a visible pair) and of
     the split-P design (6 D); the SSD kernel with its bytes, its
     operations in FP32 and as its design runs them (3xTF32), the
     registers of its two kernels, and its time at chunks of 256 and 512
     at the same S; their rows join the ``kernels`` line (thirteen rows;
     attention's launches summed over its three bodies);
 17. the fault-tolerant simulation service on the main path's layout
     (sierpinski r=16 m=2, the ``shared_layout`` phases 4 and 12 built:
     no new layout is built), with telemetry on: six requests
     (``SERVE_REQUESTS``: four cuda-fused LIFE with snapshots every 8
     steps, the last submitted once the bucket runs so it joins the batch
     of four; one cuda-mxu HEAT; one dist-fused LIFE over 4 shards on
     cuda:0 with sharded checkpoints) through ``FractalService`` and a
     ``BatchedRunner`` on the card, every final state and snapshot held
     against an uninterrupted ``runner.run`` of its seed (CA bit for bit,
     HEAT at rtol = atol = 1e-5); the same requests again under a
     ``FaultInjector`` (a corrupt checkpoint, an exception at the next
     segment, whose restore falls back past the damaged step, and a stall
     past the hang threshold), one bucket at a time, equal to the same
     references, with ``serve.retries``, ``serve.restarts``,
     ``serve.recoveries``, ``checkpoint.fallbacks`` and
     ``watchdog.hangs`` exactly what was injected; a checkpoint of one
     LIFE state saved and restored, timed; ``ElasticDistributedRunner``
     over 4 shards losing a device at launch 2, resharded to 2 and equal to
     cuda-fused bit for bit; the service's time a step beside the runner's
     for a batch of four; and the phase's kernel launches (v3/v4, v5 and
     kernel 6 must have run);
 18. the autotuner (``repro_torch.tuning``) on the same layout (no new
     layout is built): the card's copy bandwidth (``measured_bandwidth_gbs``,
     1 GiB, past the L2), then ``tune_spec`` sweeps of cuda-fused LIFE (k =
     1..4), cuda-mxu LIFE (k x P) and dist-fused LIFE over 4 shards on
     cuda:0 (k x {p2p, gather}), each candidate held bit for bit against
     the heuristic engine before it is timed (any difference fails the
     phase), each with its timing matrix, winner, heuristic baseline,
     speedup, roofline and ``suspect`` flag; the three winners saved as a
     table under ``build/`` and made the active one
     (``SQUEEZE_TUNING_TABLE``): ``make_engine`` of each spec with k left
     unset hits it exactly once, takes its k, P and exchange, and runs 16
     steps bit for bit with the heuristic engine; the phase's launches and
     seconds;
 19. the language-model serving path (``models/``, ``launch/serve.py``;
     no hand-written kernel is on it, as the reference's models call no
     Pallas kernel, and the phase fails if one launches): (a) every
     architecture at its smoke config (float32), the port's own seeded
     weights on the card and a copy on the CPU, prefill and 4 decode
     steps within rtol = atol = 2e-4 and greedy tokens equal (up to a
     near tie of the CPU's two largest logits within 2e-4), the largest
     error of each; (b) smollm-135m at full width in float32, forward and
     prefill logits at B=4, S=32, card against CPU within 1e-3; (c)
     smollm-135m (B=4, prompt 32, 16 new), gemma2-2b (prompts 24 / 17 /
     31 / 8, 12 new) and mamba2-780m (B=4, 32, 16) at full width in their
     bf16 through ``BatchServer``, twice, the greedy tokens equal and
     inside the logits, with prefill ms, ms a decoded token, tokens/s,
     ``max_memory_allocated``, the decode step's byte bound (its stored
     parameters over 3.35 TB/s) and the device's busy share of a decode
     loop (the device events of ``torch.profiler``, each kernel once); (d) one gemma2-2b forward at
     B=1, S=4096, every attention layer through ``_sdpa_chunked``, finite,
     timed; (e) every ``examples/torch`` script's ``main`` on the card at
     its defaults (``fractal_large.py``'s is r = 14), with its launches;
 20. the language-model training path (``launch/train.py``,
     ``launch/specs.py::make_train_step``, ``train_loss`` with autograd,
     ``optim/adamw.py``; no hand-written kernel is on it, as no reference
     model calls a Pallas kernel and the reference differentiates plain
     XLA, and the phase fails if one launches): (a) one ``make_train_step``
     step of every architecture's smoke config on the card against the
     same step on the CPU, from the same weights, seeded non-zero moments
     and batch, and smollm-135m and mixtral-8x22b again at ``accum_steps``
     = 4: loss, grad norm, every parameter and moment within the
     reference's step bar (rtol 5e-4, atol 5e-6); (b) smollm-135m at full
     width through the CLI's ``main`` (``--steps 50`` at its defaults B=8,
     S=256, lr 3e-4, warm-up 20; then B=16, S=1024 for 10 steps), the loss
     falling (the CLI's own check), with the median ms a step after three
     warm-up steps, tokens/s, the peak memory the run added and the share
     6 N tokens / (step time x 989 TFLOP/s); the device's busy share of
     one profiled step and its kernel count; (c) the smoke smollm-135m
     trained 12 steps with a checkpoint every 4, killed after step 6 and
     resumed, bit for bit with the uninterrupted run (deterministic
     algorithms on for this part); (d) gemma2-2b and mamba2-780m at full
     width, 3 steps at B=2, S=1024: finite losses, ms a step, peak memory;
 21. the language-model path sharded over a local mesh in one process
     (``mesh=`` on the entry points, ``runtime/spmd.py``; every position
     on cuda:0; no hand-written kernel is on it, and the phase fails if
     one launches): (a) the reference's sharded-equality cases
     (smollm-135m, smollm-135m with ``seq_shard``, mixtral-8x22b with
     ``dispatch_groups`` = 4) as one step on a (data=4, model=2) mesh from
     seeded weights and non-zero moments against the unsharded step on the
     card (loss and grad norm within 1e-5 relative, every parameter within
     1e-5, every moment within 1e-5 of its leaf's largest entry), and the
     seven attention-family architectures served on (4, 2) and (2, 4)
     meshes through ``BatchServer(mesh=)`` on ragged prompts, the tokens
     equal to the unsharded server's and the logits of prefill and every
     decode step within 1e-5; (b) tinyllama-1.1b at full width on a (2, 4)
     mesh: four ragged bf16 requests (prompts 64-256, 32 new tokens)
     served sharded and unsharded, the tokens equal up to a near tie (a
     request may part only where the unsharded top-2 logits lie within
     twice the bf16 logit bar), prefill ms, ms a token on the host's clock
     and the card's (a profiler trace of the card alone), peak memory and
     the collectives' elements a token; ``train(mesh=)`` in float32, 3
     steps at B=8, S=512 from the seed of an unsharded run, the first
     step's loss and grad norm within 1e-5, every loss within 1e-4 and
     grad norm within 2e-3, every parameter leaf within 5e-2 of its
     largest entry,
     each position's parameter and moment bytes equal to
     ``launch/dryrun.py``'s plan, ms a step (host and device), peak
     memory and elements a step; (c) the host's card count, and where
     there are two or more, the bf16 serve again over a mesh of them;
 22. the ``rec``, ``ssm`` and ``encdec`` families sharded over a local
     mesh (recurrentgemma-9b: RG-LRU units and a tail, mamba2-780m: SSD
     units, whisper-small: an encoder, learned positions and
     cross-attention; every position on cuda:0; no hand-written kernel is
     on it, and the phase fails if one launches): (a) their smoke configs
     as one ``make_train_step`` step on (4, 2) and (2, 4) meshes (and on
     (4, 2) with ``seq_shard`` for recurrentgemma and mamba2) and served
     through ``BatchServer(mesh=)`` on phase 21's ragged prompts, against
     the unsharded card run at phase 21's bars; (b) each at full width on
     a (2, 4) mesh beside its unsharded run: greedy bf16 ``generate`` of
     four requests (whisper's with seeded stub frames), the tokens equal
     up to a near tie as in phase 21, the bar on the logits the larger of
     phase 21's and twice the unsharded bf16 logits' distance from a
     float32 run of the same (bf16-valued) weights, prefill ms and ms a
     token on the
     host's clock and the card's, elements moved a token, peak memory,
     each position's parameter and cache bytes equal to the dry run's
     plan; mamba2-780m and whisper-small also in float32 training (3
     ``make_train_step`` steps from the same weights and seeded non-zero
     moments, the last under a card-only profiler trace) within
     ``LM_SHARD_TRAIN_TOL``, ms a step (host and card), elements a step,
     peak memory, parameter and moment bytes equal to the plan.

It ends with the card's name and power limit, the ``kernels`` line and
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero;
without a CUDA device it exits 2 and prints no result.
"""
from __future__ import annotations

import contextlib
import json
import re
import subprocess
import sys
import time
from pathlib import Path

SRC = Path(__file__).resolve().parent / "src"
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
# H100 SXM float32 outside the tensor cores. NVIDIA's data sheet gives no
# scalar integer rate; the integer units are no faster, so the map kernels'
# integer operations are counted against this rate too, which keeps their
# bound a lower bound.
F32_FLOPS = 67e12
FLOAT_TOL = dict(rtol=1e-5, atol=1e-5)
_STENCIL = "src/repro_torch/kernels/csrc/squeeze_stencil.cu"
_MAPS = "src/repro_torch/kernels/csrc/squeeze_maps.cu"
_STENCIL3D = "src/repro_torch/kernels/csrc/squeeze_stencil3d.cu"
_TPU = "src/repro/kernels/"
#: kernel -> (its source, the TPU kernel's entry it replaces)
KERNELS = {
    "stencil_step_blocks": (_STENCIL, _TPU + "squeeze_stencil.py:110"),
    "stencil_step_strips": (_STENCIL, _TPU + "squeeze_stencil.py:229"),
    "stencil_step_fused": (_STENCIL, _TPU + "squeeze_stencil.py:294"),
    "stencil_step_fused_k": (_STENCIL, _TPU + "squeeze_stencil.py:451"),
    "stencil_step_mxu_batched": (_STENCIL,
                                 _TPU + "squeeze_stencil.py:620"),
    "nu_map_tc": (_MAPS, _TPU + "nu_map.py:73"),
    "lambda_map_tc": (_MAPS, _TPU + "lambda_map.py:53"),
    "stencil3d_step_fused_k": (_STENCIL3D,
                               _TPU + "squeeze_stencil3d.py:136"),
    "stencil3d_step_mxu_k": (_STENCIL3D, _TPU + "squeeze_stencil3d.py:298"),
    "stencil_step_fused_k_local": (_STENCIL,
                                   _TPU + "squeeze_stencil.py:744"),
    "stencil_step_mxu_k_local": (_STENCIL, _TPU + "squeeze_stencil.py:780"),
}
#: H100 SXM bf16 on the tensor cores (dense), the rate bf16 attention's
#: bar (2e-2) allows
BF16_FLOPS = 989e12
#: H100 SXM TF32 on the tensor cores (dense): v5's and kernel 7's products
TF32_FLOPS = 495e12
_ATTN = "src/repro_torch/kernels/csrc/attention.cu"
_SSD = "src/repro_torch/kernels/csrc/ssd_chunk.cu"
KERNELS.update({
    "flash_attention": (_ATTN, _TPU + "attention.py:75"),
    "ssd_chunk_scan": (_SSD, _TPU + "ssd_chunk.py:70"),
})
#: attention's bars (tests/test_kernels_attention.py:19), (rtol, atol); a
#: bf16 result is also held within one bf16 rounding of the float32 plain
#: version (``Checker.check_bf16_rounding``)
ATTN_TOL = {"torch.float32": (2e-5, 2e-5), "torch.bfloat16": (2e-2, 2e-2)}
#: the absolute term of the bf16 rounding bar
BF16_ROUNDING_ATOL = 1e-5
#: attention's three bodies, each counted under its own name
#: (``attention.FP32``, ``TC``, ``SPLIT``)
ATTN_BODIES = ("flash_attention", "flash_attention[tc]",
               "flash_attention[split]")
#: the SSD kernel's bar (tests/test_kernels_ssd.py)
SSD_TOL = (2e-5, 2e-5)
#: chunk lengths phase 16 also times at mamba2-780m's S
SSD_CHUNKS = (256, 512)
#: phase 14's attention cases: the reference test's shapes, then non-causal,
#: causal Sq > Sk (queries that see no key), a window that hides every key
#: and D in {64, 256}, and D = 36 (bf16 rows the 16-byte loads cannot
#: take); (label, (B, H, Sq, Sk, D), keyword arguments)
ATTN_CASES = [
    ("1blk", (1, 2, 128, 128, 128), {}),
    ("multi", (2, 3, 256, 256, 128), {}),
    ("prefill-chunk", (1, 2, 128, 384, 128), {}),
    ("window128", (1, 2, 384, 384, 128), {"window": 128}),
    ("window256", (1, 2, 384, 384, 128), {"window": 256}),
    ("softcap", (1, 2, 256, 256, 128), {"softcap": 50.0}),
    ("decode", (2, 2, 1, 512, 128), {"bq": 1}),
    ("block-sizes", (1, 1, 256, 256, 128), {"bq": 64, "bk": 256}),
    ("noncausal", (1, 2, 256, 384, 128), {"causal": False}),
    ("empty-rows", (1, 2, 384, 128, 128), {}),
    ("window-hides-all", (1, 2, 128, 256, 64), {"window": 0}),
    ("d64", (2, 4, 512, 512, 64), {"window": 200, "softcap": 30.0}),
    ("d256", (1, 4, 512, 1024, 256), {"softcap": 50.0}),
    ("d36", (1, 2, 128, 256, 36), {"causal": False}),
    ("decode-ragged", (1, 4, 1, 1000, 128), {"bq": 1, "bk": 8}),
    ("decode-rows-window", (2, 2, 4, 1000, 64), {"bq": 4, "bk": 8,
                                                  "window": 250}),
]
#: phase 14's SSD cases: the reference test's shapes and a ragged S at the
#: mamba2-780m head and state widths; (B, S, H, P, N, chunk)
SSD_CASES = [(1, 16, 2, 8, 8, 8), (2, 64, 4, 16, 16, 16),
             (1, 40, 3, 8, 16, 16), (2, 300, 8, 64, 128, 128),
             (1, 512, 4, 64, 128, 256), (2, 600, 8, 64, 128, 256),
             (1, 1024, 2, 64, 128, 512)]
#: gemma2-2b's attention (configs/gemma2_2b.py): 8 heads of D = 256, local
#: window 4096, logit softcap 50; S = 8192 at B = 1, decode at B = 8
GEMMA2 = dict(h=8, d=256, s=8192, window=4096, softcap=50.0, decode_b=8)
#: mamba2-780m's SSD (configs/mamba2_780m.py): d_inner 3072 = 48 heads of
#: P = 64, N = 128, chunk 128; B = 4, S = 2048
MAMBA2 = dict(b=4, s=2048, h=48, p=64, n=128, chunk=128)
#: the 3D shapes over one CTA's shared memory: the Menger sponge r=5 m=3
#: (400 blocks of 27^3); (workload, k) at HEAT3D k = 2, 3, LIFE3D k = rho
GLOBAL3D = ("menger", 5, 3)

#: the shard-local kernels (6 and 7), each checked against its plain version
LOCAL = ("stencil_step_fused_k_local", "stencil_step_mxu_k_local")
#: (fractal, r, m, ks) of the v4 and kernel 6 checks at every body
#: ``fused_plan`` picks beyond phase 3's shapes (w = rho + 2k <= 8 and 16):
#: rho = 8 at w = 10 and 24, rho = 9 at 17 and 27, rho = 27 at 29 and 31
#: (W = 32, one window a warp) and 33 and 81 (the CTA body, [wide]); about
#: 10^6 compact cells or more each
FUSED_CHECK = [("sierpinski", 13, 3, (1, 8)), ("vicsek", 9, 2, (4, 9)),
               ("carpet", 7, 3, (1, 2, 3, 27))]
#: (fractal, r, m) of the shard-local kernel checks (phase 3's shapes)
DIST_CHECK = [("sierpinski", 13, 2), ("carpet", 7, 1), ("vicsek", 9, 1)]
#: the distributed main path: sierpinski r=16 m=2 over 4 shards (round the
#: visible cards: all on cuda:0 on one card)
DIST_MAIN = ("sierpinski", 16, 2)
DIST_SHARDS = 4
#: phase 17, the simulation service on the main path's layout: requests
#: (kind, workload, seed, steps, snapshot_every), served by one
#: ``FractalService``; the last is submitted once the first bucket runs, so
#: it joins that batch
SERVE_MAIN = ("sierpinski", 16, 2)
SERVE_REQUESTS = [("cuda-fused", "life", 0, 48, 8),
                  ("cuda-fused", "life", 1, 24, 8),
                  ("cuda-fused", "life", 2, 32, 8),
                  ("cuda-mxu", "heat", 4, 16, 0),
                  ("dist-fused", "life", 5, 24, 8),
                  ("cuda-fused", "life", 3, 24, 8)]
#: the chaos run's hang threshold and injected stall (seconds): a segment
#: of the main path takes milliseconds, so only the stall trips it
SERVE_HANG_S = 2.0
SERVE_STALL_S = 3.0
#: the elastic run: seed, steps, checkpoint cadence, the launch that loses
#: a device (4 -> 2 shards)
ELASTIC = dict(seed=9, steps=16, ckpt_every=4, lost_at=2)
#: phase 18, the autotuner: its layout (the main path's, phases 4, 12 and
#: 17), the dist sweep's shards, the steps of a timed run, the rounds, and
#: the steps of the table-hit check
TUNE_MAIN = ("sierpinski", 16, 2)
TUNE_SHARDS = 4
TUNE_STEPS = 8
TUNE_ROUNDS = 3
TUNE_HIT_STEPS = 16

#: phase 19, the language-model serving path: (a) every arch at its smoke
#: config, card against CPU (batch, prompt, decode steps fed, greedy new
#: tokens, cache length) at the reference's MoE bar
LM_SMOKE = dict(batch=2, prompt=12, decode=4, new=6, max_len=20)
LM_TOL = (2e-4, 2e-4)
#: (b) a full-width float32 prefill, card against CPU: arch, B, S, bar
LM_FULL_F32 = ("smollm-135m", 4, 32, 1e-3)
#: (c) full-width serving in the config's bf16: arch, prompts, new tokens
LM_SERVE = [("smollm-135m", (32, 32, 32, 32), 16),
            ("gemma2-2b", (24, 17, 31, 8), 12),
            ("mamba2-780m", (32, 32, 32, 32), 16)]
#: decode steps under ``torch.profiler`` for the busy share (few: the
#: profiler's trace of a step's ~3,000 launches is slow to gather)
LM_PROFILE_STEPS = 4
#: (d) one long forward through the chunked attention: arch, B, S
LM_LONG = ("gemma2-2b", 1, 4096)
#: phase 20, the language-model training path: (a) every arch's smoke step
#: card against CPU (batch, sequence) at the reference's step bar, and the
#: archs taken again at ``accum_steps`` = 4
LM_STEP = dict(batch=4, seq=16)
LM_STEP_TOL = (5e-4, 5e-6)
LM_STEP_ACCUM = ("smollm-135m", "mixtral-8x22b")
#: (b) smollm-135m at full width through the CLI: its arguments, and the
#: steps left out of the median
LM_TRAIN_CLI = [["--steps", "50"],
                ["--steps", "10", "--batch", "16", "--seq", "1024"]]
LM_TRAIN_WARMUP = 3
#: (c) the restart: steps, checkpoint interval, the step after which the
#: first attempt dies
LM_RESTART = dict(steps=12, ckpt_every=4, fail_at=6)
#: (d) full width: arch, B, S, steps
LM_TRAIN_FULL = [("gemma2-2b", 2, 1024, 3), ("mamba2-780m", 2, 1024, 3)]
#: one H100's dense bf16 peak, for the FLOP share of a training step
PEAK_BF16_FLOPS = 989e12
#: phase 21, the language-model path sharded over a local mesh (every
#: position on cuda:0 on one card): (a) the reference's sharded-equality
#: cases (arch, seq_shard) as one step on a (data=4, model=2) mesh, and
#: the attention family served on (4, 2) and (2, 4), each against the
#: unsharded card run at the bars of tests/test_torch_lm_sharded.py
LM_SHARD_STEPS = [("smollm-135m", False), ("smollm-135m", True),
                  ("mixtral-8x22b", False)]
LM_SHARD_ARCHS = ("smollm-135m", "tinyllama-1.1b", "qwen1.5-110b",
                  "mixtral-8x22b", "arctic-480b", "gemma2-2b",
                  "llava-next-34b")
LM_SHARD_MESHES = ((4, 2), (2, 4))
LM_SHARD_TOL = dict(loss=1e-5, params=1e-5, moments=1e-5, logits=1e-5)
LM_SHARD_SMOKE = dict(prompts=(24, 17, 31, 8), new=8, max_len=64)
#: (b) tinyllama-1.1b at full width on a (2, 4) mesh: bf16 serving of four
#: ragged requests (32 new tokens each; a timed decode loop of
#: ``decode_timed`` steps), float32 training (B, S, steps; 3 since phase
#: 22 came: 5 before)
LM_SHARD_FULL = dict(arch="tinyllama-1.1b", mesh=(2, 4),
                     prompts=(64, 256, 160, 100), new=32, max_len=512,
                     decode_timed=4, batch=8, seq=512, steps=3)
#: bf16 serving: the sharded logits within this of the unsharded ones on
#: the unsharded greedy trajectory (one forward of the prompts and the
#: generated tokens), and a request's tokens may part from
#: the unsharded ones only at a step whose two largest unsharded logits
#: lie within twice it (a near tie: bf16 products and sums rounded in
#: another order; the rule phase 19 applies to card against CPU)
LM_SHARD_BF16_LOGITS = 0.1
#: float32 training at full width, relative: the first step's loss and
#: grad norm (the same weights and batch), every loss, every grad norm,
#: and each parameter leaf against its largest entry (the reference
#: check's bar). From zero moments Adam's first steps move each parameter
#: by lr times the sign of its gradient, so the gradients that differ in
#: sign at float32 rounding move apart and later steps drift (an H100
#: read grad norms 4.2e-4 apart at step 3, 2.7e-7 at the first)
LM_SHARD_TRAIN_TOL = dict(first=1e-5, loss=1e-4, grad_norm=2e-3,
                          params=5e-2)
#: phase 22, the rec, ssm and encdec families sharded over a local mesh:
#: (a) their smoke configs, one step on each of ``LM_SHARD_MESHES`` (and
#: with ``seq_shard`` on (4, 2) for the two recurrent ones) and greedy
#: serving of ``LM_SHARD_SMOKE``'s prompts, against the unsharded card run
LM_FAMILIES = ("recurrentgemma-9b", "mamba2-780m", "whisper-small")
LM_FAMILIES_SEQ = ("recurrentgemma-9b", "mamba2-780m")
#: (b) each at full width on a (2, 4) mesh beside its unsharded run:
#: greedy bf16 ``generate`` of four requests (prompts, new tokens; whisper
#: with seeded stub frames), and float32 ``make_train_step`` steps
#: (B, S, steps) where the card holds the state (recurrentgemma-9b's
#: float32 parameters, gradients and moments take 153 GB: serving only)
LM_FAMILIES_FULL = {
    "recurrentgemma-9b": dict(prompts=(64, 48, 32, 16), new=8),
    "mamba2-780m": dict(prompts=(16, 16, 16, 16), new=8,
                        train=(2, 1024, 3)),
    "whisper-small": dict(prompts=(8, 8, 8, 8), new=16, train=(8, 256, 3)),
}
LM_FAMILIES_MESH = (2, 4)
LM_FAMILIES_DECODE_TIMED = 4
#: the 3D main path: the Menger sponge F^{20,3} at r=6, m=2 (rho=9, 20^4 =
#: 160,000 blocks, 64,000,000 cells in a 729^3 volume)
MAIN3D = ("menger", 6, 2)
#: (fractal, r, m) of the 3D kernel checks
CHECK3D = [("menger", 5, 1), ("menger", 5, 2), ("sierpinski3d", 10, 2)]
#: the bodies phase 7 reaches: (wrapper, launch-name suffix, W) of the
#: column body at W = 8 and 16, the tensor-core body and both CTA bodies
#: (their workspace variant in ``phase_3d_global_windows``)
CLASSES3D = {("stencil3d_step_fused_k", "", 8),
             ("stencil3d_step_fused_k", "", 16),
             ("stencil3d_step_fused_k", "[wide]", 0),
             ("stencil3d_step_mxu_k", "", 16),
             ("stencil3d_step_mxu_k", "[wide]", 0)}


def ptxas_summary(log: str) -> list:
    """[{"entry", "ptxas"}] from nvcc's -Xptxas=-v log: each kernel
    instance (its mangled name after the source's prefix) with its
    registers, shared memory and spill lines."""
    out = []
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            out.append({"entry": re.sub(r"^.*?_cu_[0-9a-f]+", "",
                                        m.group(1))[:64], "ptxas": []})
        elif out and ("registers" in ln or "spill" in ln):
            out[-1]["ptxas"].append(ln.strip())
    return out


def mxu_registers(log: str) -> dict:
    """{"in-kernel" | "pieces": {"<rule>/<body>": "registers/spill
    bytes"}}: the v5 kernel's instances (kInKernel for row 5, kPieces for
    row 7; the one-tile body and the wide one) from nvcc's log."""
    out = {"in-kernel": {}, "pieces": {}}
    for e in ptxas_summary(log):
        m = re.search(r"mxu_kernelINS_\d+(\w+?)ELi(\d)ELi(\d)E", e["entry"])
        if not m:
            continue
        text = " ".join(e["ptxas"])
        regs = re.search(r"Used (\d+) registers", text)
        spill = re.search(r"(\d+) bytes spill stores", text)
        halo = "pieces" if m.group(2) == "3" else "in-kernel"
        body = "one-tile" if m.group(3) == "1" else "wide"
        out[halo][f"{m.group(1)}/{body}"] = (
            f"{regs.group(1) if regs else '?'}/"
            f"{spill.group(1) if spill else 0}")
    return out


#: the warp and CTA bodies' staging (``Halo`` in the source) -> the key of
#: its instances in ``fused_registers``
_HALO_KEYS = {"0": "in-kernel", "1": "blocks", "2": "strips", "3": "pieces"}


def fused_registers(log: str) -> dict:
    """{"in-kernel" | "in-kernel-k1" | "blocks" | "strips" | "pieces":
    {"<rule>/<body>": "registers/spill bytes"}, "gather": {...}}: the warp
    body's instances of v4 (row 4; "in-kernel-k1" its instance compiled at
    k = 1, v3's, row 3), v1 (row 1), v2 (row 2) and kernel 6 (row 6) by W
    (8, 16, 32), the CTA body (``step_kernel``, their [wide] instance, which
    v3 shares for kInKernel), and v2's strip gather (``gather_kernel``:
    'u8/R4' the whole-block body, 'u8/R0' the general one) from nvcc's
    log."""
    out = {key: {} for key in _HALO_KEYS.values()}
    out["in-kernel-k1"] = {}
    out["gather"] = {}
    for e in ptxas_summary(log):
        m = re.search(r"warp_kernelINS_\d+(\w+?)ELi(\d)ELi(\d+)ELi(\d)E",
                      e["entry"])
        c = re.search(r"step_kernelINS_\d+(\w+?)ELi([0-3])EE", e["entry"])
        g = re.search(r"gather_kernelI([hj])Li(\d+)E", e["entry"])
        if not (m or c or g):
            continue
        text = " ".join(e["ptxas"])
        regs = re.search(r"Used (\d+) registers", text)
        spill = re.search(r"(\d+) bytes spill stores", text)
        val = (f"{regs.group(1) if regs else '?'}/"
               f"{spill.group(1) if spill else 0}")
        if g:
            out["gather"][f"{'u8' if g.group(1) == 'h' else 'u32'}/"
                          f"R{g.group(2)}"] = val
            continue
        rule, halo = (m or c).group(1), (m or c).group(2)
        body = f"W{m.group(3)}" if m else "wide"
        key = _HALO_KEYS[halo]
        if m and halo == "0" and m.group(4) == "1":
            key += "-k1"
        out[key][f"{rule}/{body}"] = val
    return out


def nu_ops(plan, count: int) -> int:
    """Integer operations of the nu kernel's design for ``count``
    coordinates (``nu_map.nu_plan``'s groups): 9 a coordinate for the
    bounds, the clip and the valid byte; 6 a group (the lookup, the hole
    bits, two field extractions, two multiply-adds); 5 a lower group's
    digits (two remainders, two quotients, the index) and 2 the top
    group's index."""
    g = plan.groups
    return count * (9 + 6 * g + 5 * max(g - 1, 0) + 2 * (g > 0))


def lambda_ops(plan, count: int) -> int:
    """Integer operations of the lambda kernel's design for ``count``
    coordinates (``lambda_map.lambda_plan``'s groups): 23 a group (two
    floor divmods by k^(L/2) of 8 each: the sign, two flips, a
    multiply-high quotient, the remainder; the index, the lookup, two
    field extractions, two multiply-adds) and one a lower group (the next
    weight)."""
    g = plan.groups
    return count * (23 * g + max(g - 1, 0))


def instance_registers(log: str, kernel: str) -> dict:
    """{"<template arguments>": "registers/spill bytes"}: each instance of
    ``kernel`` (the map kernels' ``S/K/L/G`` or ``S/L/G``, '-1' the
    runtime path; the SSD kernels by name) from nvcc's log."""
    out = {}
    for e in ptxas_summary(log):
        m = re.search(kernel + r"(?:I((?:Li-?n?\d+E)+))?", e["entry"])
        if not m:
            continue
        args = re.findall(r"Li(n?\d+)E", m.group(1) or "")
        text = " ".join(e["ptxas"])
        regs = re.search(r"Used (\d+) registers", text)
        spill = re.search(r"(\d+) bytes spill stores", text)
        key = "/".join(a.replace("n", "-") for a in args) or kernel
        out[key] = (f"{regs.group(1) if regs else '?'}/"
                    f"{spill.group(1) if spill else 0}")
    return out


def stencil3d_registers(log: str) -> dict:
    """{"fused" | "mxu": {"<rule>/<body>": "registers/spill bytes"}}: the
    3D kernels' instances from nvcc's log: the column body by W
    (``column_kernel``, row 8), the tensor-core body (``tc_kernel``, row
    9, as '<rule>/tc'), and the CTA body of each
    (``step3_kernel``: '[wide]' in shared memory, '[global]' in its
    workspace)."""
    out = {"fused": {}, "mxu": {}}
    for e in ptxas_summary(log):
        # (the entry's prefix strip takes column_kernel's leading 'c')
        col = re.search(r"olumn_kernelINS_\d+(\w+?)ELi(\d+)E", e["entry"])
        tc = re.search(r"tc_kernelINS_\d+(\w+?)EE", e["entry"])
        cta = re.search(r"step3_kernelINS_\d+(\w+?)ELb([01])ELb([01])E",
                        e["entry"])
        if not (col or tc or cta):
            continue
        text = " ".join(e["ptxas"])
        regs = re.search(r"Used (\d+) registers", text)
        spill = re.search(r"(\d+) bytes spill stores", text)
        val = (f"{regs.group(1) if regs else '?'}/"
               f"{spill.group(1) if spill else 0}")
        if col:
            out["fused"][f"{col.group(1)}/W{col.group(2)}"] = val
        elif tc:
            out["mxu"][f"{tc.group(1)}/tc"] = val
        else:
            kernel = "mxu" if cta.group(2) == "1" else "fused"
            body = "[global]" if cta.group(3) == "1" else "[wide]"
            out[kernel][f"{cta.group(1)}/{body}"] = val
    return out


def tc_products(torch, k3, workload, w: int) -> int:
    """16x8x8 TF32 products row 9's tensor-core body runs for one live
    plane of a w-wide window: per operator group (the dz = -1 and +1 terms
    one, each dz = 0 term one) R X and Y C^T, each in two n-tiles of two
    k-steps, times its passes: one for uint8 states; for float32 three
    (3xTF32), less the product of the operator's lo part where the
    operator (R, C) is exact in TF32, as the body finds on the card
    (HEAT3D's merged identity group: two)."""
    import numpy as np
    rm, cm, dzs = k3.mxu3_operators(workload, w)
    terms = range(len(dzs) - 1)
    if workload.dtype != torch.float32:
        return 8 * len(terms)

    def exact(op):
        bits = op.view(np.uint32).astype(np.uint64)
        return bool(np.all(((bits + 0x1000) & 0xFFFFE000) == bits))
    return 4 * sum(6 - exact(rm[t]) - exact(cm[t]) for t in terms)


def mxu3_design_ms(batch: int, n_blocks: int, k: int, w: int,
                   products: int) -> float:
    """The operation bound of row 9's tensor-core products as the body
    runs them: per window the live planes of each substep (w - 2j at
    substep j), ``products`` 16x8x8 TF32 products a plane
    (``tc_products``), at the tensor cores' TF32 rate."""
    planes = sum(w - 2 * j for j in range(1, k + 1))
    return 1e3 * batch * n_blocks * planes * products * 2048 / TF32_FLOPS


def mxu_design_ms(batch: int, n_blocks: int, k: int, passes: int) -> float:
    """The operation bound of v5's padded products: per slot and substep
    two 16x8x8 TF32 products' worth (2 x 1024 multiply-adds), times the
    TF32 passes, at the tensor cores' TF32 rate."""
    return 1e3 * batch * n_blocks * k * 2 * 1024 * 2 * passes / TF32_FLOPS


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


class Checker:
    """Compares a result with its plain version and keeps the largest
    difference seen per kernel."""

    def __init__(self, torch):
        self.torch = torch
        self.max_err = {}

    def check(self, what, kernel, got, want, exact, tol=None):
        """``tol`` (rtol, atol), when given, replaces the float bar."""
        t = self.torch
        if got.shape != want.shape or got.dtype != want.dtype:
            raise AssertionError(f"{what}: {got.shape}/{got.dtype} vs "
                                 f"{want.shape}/{want.dtype}")
        diff = (got.double() - want.double()).abs()
        err = float(diff.max())
        if not bool(t.isfinite(got).all()):
            raise AssertionError(f"{what}: non-finite values")
        # atol shrinks with a decayed field (HEAT on sierpinski falls to
        # ~1e-10 in 64 steps), so zeros or a wrong rule cannot pass.
        scale = min(1.0, float(want.double().abs().max()))
        bound = 0.0 if exact else (FLOAT_TOL["atol"] * scale
                                   + FLOAT_TOL["rtol"] * want.double().abs())
        if tol is not None:
            bound = tol[1] + tol[0] * want.double().abs()
        if bool((diff > bound).any()):
            raise AssertionError(f"{what}: max |kernel - plain| = {err}")
        if kernel:
            self.max_err[kernel] = max(self.max_err.get(kernel, 0.0), err)
        return err

    def check_bf16_rounding(self, what, got, want32):
        """A bf16 result within one bf16 rounding of the float32 plain
        version: |got - want32| <= ulp_bf16(|want32|) + 1e-5 elementwise,
        ulp_bf16(x) = 2^(floor(log2 x) - 7). Returns the largest |got -
        want32| and the largest |got - want32| - ulp_bf16(|want32|) (at
        most 1e-5 where it holds)."""
        t = self.torch
        a = want32.double().abs()
        _, e = t.frexp(a)   # a = f 2^e, 0.5 <= f < 1: floor(log2 a) = e - 1
        ulp = t.where(a > 0, t.ldexp(t.ones_like(a), e - 8),
                      t.zeros_like(a))
        diff = (got.double() - want32.double()).abs()
        excess = float((diff - ulp).max())
        if excess > BF16_ROUNDING_ATOL:
            raise AssertionError(f"{what}: |kernel - plain f32| exceeds one "
                                 f"bf16 rounding by {excess}")
        return float(diff.max()), excess


def cuda_ms(torch, fn, n: int) -> float:
    """Mean ms of ``fn()`` over n calls after one warm-up, CUDA events."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def phase_kernels_vs_plain(torch, chk, F, R, BlockLayout, sk, halo_needs):
    cases = [(F.SIERPINSKI, 13, 2), (F.CARPET, 7, 1), (F.VICSEK, 9, 1)]
    for frac, r, m in cases:
        lay = BlockLayout(frac, r, m)
        for wl in (R.LIFE, R.HIGHLIFE, R.HEAT, R.GRAY_SCOTT):
            t0 = time.perf_counter()
            exact = wl.dtype == torch.uint8
            g = torch.Generator(device="cuda")
            g.manual_seed(11)
            shape = (lay.n_blocks, lay.rho, lay.rho)
            x = torch.stack([wl.init(g, shape, "cuda") for _ in range(3)])
            mask = lay.device_table("micro_mask", "cuda")
            x = (x * mask.to(x.dtype)).contiguous()
            errs = {}

            def run(name, fn, plain, state, n, bit=exact):
                got, want = state, state
                for _ in range(n):
                    got, want = fn(got), plain(want)
                errs[name] = chk.check(f"{frac.name}/{wl.name}/{name}",
                                       fn.kernel, got, want, bit)

            def tag(fn, kernel):
                fn.kernel = kernel
                return fn
            sk.reset_launches()
            for v, fn, plain in (
                    ("v1", sk.stencil_step_blocks,
                     sk.stencil_step_blocks_plain),
                    ("v2", sk.stencil_step_strips,
                     sk.stencil_step_strips_plain)):
                for label, state in ((v, x[0]), (f"{v}_b3", x)):
                    run(label, tag(lambda s, fn=fn: fn(lay, s, wl),
                                   fn.__name__),
                        lambda s, plain=plain: plain(lay, s, wl), state, 8,
                        bit=True)
            x5 = x if wl.n_channels > 1 else x[:, None]
            for label, needs in (("gather", None),
                                 ("gather_needs", halo_needs(wl.weights2d))):
                errs[label] = chk.check(
                    f"{frac.name}/{wl.name}/{label}", "gather_halo_strips",
                    sk._gather_halo_strips(lay, x5, needs),
                    sk.gather_halo_strips_plain(lay, x5, needs), True)
            single = {n: v for n, v in sk.LAUNCHES.items() if v}
            for label, state in (("v3", x[0]), ("v3_b3", x)):   # bit for bit
                run(label, tag(lambda s: sk.stencil_step_fused(lay, s, wl),
                               "stencil_step_fused"),
                    lambda s: sk.stencil_step_fused_plain(lay, s, wl), state,
                    8, bit=True)
            for k in sorted({1, 2, lay.rho}):   # bit for bit
                run(f"v4_k{k}",
                    tag(lambda s, k=k: sk.stencil_step_fused_k(
                        lay, s, wl, k=k), "stencil_step_fused_k"),
                    lambda s, k=k: sk.stencil_step_fused_k_plain(
                        lay, s, wl, k=k), x[0], 8 // k, bit=True)
            for k in (1, 2):
                for p in (None, 7):
                    run(f"v5_k{k}_p{lay.macro_tiles(k, p)[0]}",
                        tag(lambda s, k=k, p=p: sk.stencil_step_mxu_batched(
                            lay, s, wl, k=k, p=p),
                            "stencil_step_mxu_batched"),
                        lambda s, k=k: sk.stencil_step_mxu_batched_plain(
                            lay, s, wl, k=k), x, 8 // k)
            torch.cuda.synchronize()
            emit("kernel_vs_plain", fractal=frac.name, r=r, m=m,
                 compact_cells=frac.volume(r), workload=wl.name,
                 tolerance="exact" if exact else FLOAT_TOL,
                 tolerance_v1_v4_gather="exact", max_err=errs,
                 single_step_plans={v: sk.step_plan(
                     wl.dtype, wl.n_channels, lay.rho, v == "v2").W
                     for v in ("v1", "v2")},
                 single_step_launches=single,
                 seconds=time.perf_counter() - t0)


def phase_fused_bodies_vs_plain(torch, chk, F, R, BlockLayout, sk, local):
    """v4 (``local=False``) or kernel 6 (``local=True``: random pieces and
    existence rows) at the shapes of ``FUSED_CHECK``, all four rules, one
    simulation and B=3, bit for bit against the plain version; v4 steps
    max(1, 8 // k) times. Emits the launches by body."""
    kname = "stencil_step_fused_k_local" if local else "stencil_step_fused_k"
    fn, plain = getattr(sk, kname), getattr(sk, kname + "_plain")
    for name, r, m, ks in FUSED_CHECK:
        lay = BlockLayout(F.REGISTRY[name], r, m)
        for wl in (R.LIFE, R.HIGHLIFE, R.HEAT, R.GRAY_SCOTT):
            t0 = time.perf_counter()
            g = torch.Generator(device="cuda")
            g.manual_seed(13)
            nc, rho = wl.n_channels, lay.rho
            x = torch.stack([wl.init(g, (lay.n_blocks, rho, rho), "cuda")
                             for _ in range(3)])
            x = (x * lay.device_table("micro_mask", "cuda").to(x.dtype))
            if local:
                x = x if nc > 1 else x[:, None]
            x = x.contiguous()

            def rand(shape):
                """Random halo pieces: CA states, or floats in [0, 0.25)
                (Gray-Scott stays finite over k = rho substeps)."""
                if wl.dtype == torch.uint8:
                    return torch.randint(0, 2, shape, generator=g,
                                         device="cuda", dtype=torch.uint8)
                return 0.25 * torch.rand(shape, generator=g, device="cuda")
            errs, bodies = {}, {}
            sk.reset_launches()
            for k in ks:
                w = rho + 2 * k
                bodies[k] = sk.fused_plan(wl.dtype, nc, rho, k, local).body
                for label, s in (("b1", x[0]), ("b3", x)):
                    what = f"fused/{name}/{wl.name}/k{k}/{label}"
                    if local:
                        halo = tuple(rand(s.shape[:-2] + tail) for tail in
                                     ((k, w), (k, w), (rho, k), (rho, k)))
                        ex = torch.randint(0, 2, (lay.n_blocks, 8),
                                           generator=g, device="cuda",
                                           dtype=torch.int32)
                        got = fn(lay, s, halo, ex, wl, k=k)
                        want = plain(lay, s, halo, ex, wl, k=k)
                    else:
                        got, want = s, s
                        for _ in range(max(1, 8 // k)):
                            got = fn(lay, got, wl, k=k)
                            want = plain(lay, want, wl, k=k)
                    errs[f"k{k}/{label}"] = chk.check(what, kname, got, want,
                                                      True)
                    del got, want
            torch.cuda.synchronize()
            emit("fused_bodies_vs_plain", kernel=kname, fractal=name, r=r,
                 m=m, rho=rho, workload=wl.name, tolerance="exact",
                 bodies=bodies, max_err=errs, launches={
                     n: v for n, v in sk.LAUNCHES.items() if v},
                 seconds=time.perf_counter() - t0)


def _other_weights(R):
    """Two workloads whose ring weights are not their rule's own (the CTA
    body's [wide] instance): Life over the 4 orthogonal neighbors (0, 1)
    and heat over all 8 (1, 1)."""
    import dataclasses

    @dataclasses.dataclass(frozen=True)
    class OrthLife(R.TotalisticCA):
        name: str = "orth-life"

        def weight(self, offset):
            return 1 if sum(abs(d) for d in offset) == 1 else 0

    @dataclasses.dataclass(frozen=True)
    class MooreHeat(R.HeatDiffusion):
        name: str = "moore-heat"
        degree: int = 8

        def weight(self, offset):
            return 1
    return OrthLife(), MooreHeat()


def phase_single_bodies_vs_plain(torch, chk, F, R, BlockLayout, sk):
    """v1 and v2 at the bodies ``step_plan`` picks, and v3 at those
    ``fused_plan`` picks at k = 1, beyond phase 3's W = 8 (``FUSED_CHECK``'s
    layouts: W = 16 at rho = 8 and 9, W = 32 at rho = 27), all four rules,
    and at the CTA body ([wide]) with two workloads of other ring weights
    on sierpinski r=13 m=2; one simulation and B=3, 2 steps, bit for bit
    against the plain version. Emits the launches by body; every class (W
    = 8, 16, 32 and [wide]) is reached by each."""
    singles = (("v1", sk.stencil_step_blocks, sk.stencil_step_blocks_plain),
               ("v2", sk.stencil_step_strips, sk.stencil_step_strips_plain),
               ("v3", sk.stencil_step_fused, sk.stencil_step_fused_plain))
    # phase 3's layouts (rho = 3 and 4) reach W = 8
    seen = {v: {8} for v, _, _ in singles}
    cases = [(name, r, m, (R.LIFE, R.HIGHLIFE, R.HEAT, R.GRAY_SCOTT))
             for name, r, m, _ in FUSED_CHECK]
    cases.append(("sierpinski", 13, 2, _other_weights(R)))
    for name, r, m, wls in cases:
        lay = BlockLayout(F.REGISTRY[name], r, m)
        for wl in wls:
            t0 = time.perf_counter()
            g = torch.Generator(device="cuda")
            g.manual_seed(14)
            rho = lay.rho
            x = torch.stack([wl.init(g, (lay.n_blocks, rho, rho), "cuda")
                             for _ in range(3)])
            x = (x * lay.device_table("micro_mask", "cuda").to(x.dtype)
                 ).contiguous()
            errs, bodies = {}, {}
            sk.reset_launches()
            for v, fn, plain in singles:
                plan = sk._fused_plan_for(lay, x, wl, 1, False) \
                    if v == "v3" else sk._step_plan_for(lay, x, wl, v == "v2")
                bodies[v] = plan.body or f"W{plan.W}"
                seen[v].add(plan.W)
                for label, s in (("b1", x[0]), ("b3", x)):
                    got, want = s, s
                    for _ in range(2):
                        got, want = fn(lay, got, wl), plain(lay, want, wl)
                    errs[f"{v}/{label}"] = chk.check(
                        f"single/{name}/{wl.name}/{v}/{label}",
                        fn.__name__, got, want, True)
                    del got, want
            torch.cuda.synchronize()
            emit("single_bodies_vs_plain", fractal=name, r=r, m=m, rho=rho,
                 workload=wl.name, tolerance="exact", bodies=bodies,
                 max_err=errs, launches={
                     n: v for n, v in sk.LAUNCHES.items() if v},
                 seconds=time.perf_counter() - t0)
    for v, ws in seen.items():
        if ws != {0, 8, 16, 32}:
            raise AssertionError(f"{v} reached W {sorted(ws)}, not every "
                                 "plan class")


def phase_maps_vs_plain(torch, chk, F, nm, lm, n=1_000_001):
    """nu and lambda against their plain (int64) versions, bit-exact: r in
    {0, 1, 2, 3, an r whose top nu group is short and one whose top lambda
    group is, the largest r}, n = 4 * 250000 + 1 coordinates (the kernels'
    scalar tails)."""
    g = torch.Generator(device="cuda")
    g.manual_seed(12)

    def uniform(lo, hi):
        lo, hi = max(lo, -2 ** 31), min(hi, 2 ** 31)
        return torch.randint(lo, hi, (n,), generator=g, device="cuda",
                             dtype=torch.int64).to(torch.int32)
    for frac in F.REGISTRY.values():
        top = nm.max_int32_level(frac)
        short = {2 * nm.group_levels(frac.s) + 1,
                 min(top, 2 * lm.lambda_plan(frac, 0).levels + 1)}
        for r in sorted({0, 1, 2, 3, top} | short):
            t0 = time.perf_counter()
            side = frac.side(r)
            rows, cols = frac.compact_dims(r)
            spill = side // 8 + 2
            ex, ey = (uniform(-spill, side + spill) for _ in range(2))
            cx, cy = uniform(-cols, 2 * cols), uniform(-rows, 2 * rows)
            for what, got, want in zip(
                    ("cx", "cy", "valid"), nm.nu_map_tc(frac, r, ex, ey),
                    nm.nu_map_tc_plain(frac, r, ex, ey)):
                chk.check(f"maps/{frac.name}/r{r}/nu/{what}", "nu_map_tc",
                          got.to(torch.int64), want.to(torch.int64), True)
            for what, got, want in zip(
                    ("ex", "ey"), lm.lambda_map_tc(frac, r, cx, cy),
                    lm.lambda_map_tc_plain(frac, r, cx, cy)):
                chk.check(f"maps/{frac.name}/r{r}/lambda/{what}",
                          "lambda_map_tc", got, want, True)
            torch.cuda.synchronize()
            emit("map_vs_plain", fractal=frac.name, r=r, coordinates=n,
                 nu_range=[-spill, side + spill],
                 lambda_range_x=[-cols, 2 * cols], tolerance="exact",
                 max_err={"nu_map_tc": chk.max_err["nu_map_tc"],
                          "lambda_map_tc": chk.max_err["lambda_map_tc"]},
                 seconds=time.perf_counter() - t0)


def _init3d(torch, lay, wl, batch, seed):
    """``batch`` states of the workload's distribution, holes zeroed."""
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    shape = (lay.n_blocks,) + (lay.rho,) * 3
    x = torch.stack([wl.init(g, shape, "cuda") for _ in range(batch)])
    return (x * lay.device_table("micro_mask", "cuda").to(x.dtype)) \
        .contiguous()


def phase_3d_kernels_vs_plain(torch, chk, F3, R, BlockLayout3D, k3):
    """Both 3D kernels against their plain versions at every body their
    plans pick (``CLASSES3D``); each run's launches counted under the name
    of the body its plan names."""
    seen = set()
    for name, r, m in CHECK3D:
        frac = F3.REGISTRY3D[name]
        lay = BlockLayout3D(frac, r, m)
        for wl in (R.LIFE3D, R.HEAT3D, R.LIFE):
            t0 = time.perf_counter()
            exact = wl.dtype == torch.uint8
            x = _init3d(torch, lay, wl, 3, 13)
            errs, bodies = {}, {}
            for k in sorted({1, 2, 3, lay.rho}):
                runs = [("fused", k3.stencil3d_step_fused_k,
                         k3.stencil3d_step_fused_k_plain, {},
                         k3.fused3_plan_for(lay, wl, k))]
                runs += [(f"mxu_p{lay.macro_tiles(k, p)[0]}",
                          k3.stencil3d_step_mxu_k,
                          k3.stencil3d_step_mxu_k_plain, {"p": p},
                          k3.mxu3_plan_for(lay, wl, k, p))
                         for p in ((None, 2) if k <= 2 and k3.mxu3_plan_for(
                             lay, wl, k).W == 0 else (None,))]
                for label, fn, plain, kw, plan in runs:
                    seen.add((fn.__name__, plan.body, plan.W))
                    k3.reset_launches()
                    for tag, state in (("", x[0]), ("_b3", x)):
                        got, want = state, state
                        for _ in range(max(1, 8 // k)):
                            got = fn(lay, got, wl, k=k, **kw)
                            want = plain(lay, want, wl, k=k)
                        what = f"{label}_k{k}{tag}"
                        # the fused kernel bit for bit, floats too
                        errs[what] = chk.check(
                            f"3d/{name}/{wl.name}/{what}", fn.__name__, got,
                            want, exact or label == "fused")
                    launched = {n: v for n, v in k3.LAUNCHES.items() if v}
                    want_launches = {fn.__name__ + plan.body:
                                     2 * max(1, 8 // k)}
                    if launched != want_launches:
                        raise AssertionError(
                            f"3d/{name}/{wl.name}/{label}_k{k}: launches "
                            f"{launched}, expected {want_launches}")
                    bodies[f"{label}_k{k}"] = f"{plan.body or 'new'}/W" \
                                              f"{plan.W}"
            torch.cuda.synchronize()
            emit("kernel3d_vs_plain", fractal=name, r=r, m=m,
                 n_blocks=lay.n_blocks, compact_cells=frac.volume(r),
                 workload=wl.name,
                 tolerance="exact" if exact else FLOAT_TOL, max_err=errs,
                 bodies=bodies, seconds=time.perf_counter() - t0)
    if not CLASSES3D <= seen:
        raise AssertionError(f"3D plan classes not reached: "
                             f"{sorted(CLASSES3D - seen)}")


def phase_3d_main(torch, chk, F3, R, make_engine, default_fusion_k,
                  shared_layout3d, BatchedRunner, k3, c3):
    """The 3D main path; returns its launch counts."""
    name, r, m = MAIN3D
    frac = F3.REGISTRY3D[name]
    t0 = time.perf_counter()
    lay = shared_layout3d(frac, r, m)
    k = default_fusion_k(lay.rho)
    _ = lay.neighbor_table, lay.window_mask(k), lay.window_mask(1)
    host_seconds = time.perf_counter() - t0
    t0 = time.perf_counter()
    lay.device_table("halo_mask", "cuda", k)   # read by block3d only
    emit("layout3d", fractal=name, r=r, m=m, rho=lay.rho,
         n_blocks=lay.n_blocks, compact_cells=frac.volume(r),
         expanded_cells=frac.side(r) ** 3, host_seconds=host_seconds,
         halo_mask_seconds=time.perf_counter() - t0,
         halo_mask_bytes=lay.n_blocks * (lay.rho + 2 * k) ** 3)
    wls = (R.LIFE3D, R.HEAT3D)
    engines = {(kind, wl.name): make_engine(kind, frac, r, m, workload=wl)
               for kind in ("cuda-3d", "cuda-3d-mxu") for wl in wls}
    init = {wl.name: _init3d(torch, lay, wl, 1, 31 + i)[0]
            for i, wl in enumerate(wls)}
    runner = BatchedRunner()
    batch = _init3d(torch, lay, R.LIFE3D, 2, 33)
    cell = make_engine("cell3d", frac, r, workload=R.LIFE3D)
    cell_init = c3.expanded_to_compact3(frac, r,
                                        lay.to_expanded(init["life3d"]))
    for table, kk in (("neighbor_table", None), ("micro_mask", None),
                      ("window_mask", 1), ("window_mask", k)):
        lay.device_table(table, "cuda", *(() if kk is None else (kk,)))
    steps = {"cuda-3d": 31, "cuda-3d-mxu": 16}
    timed = [(f"{kind} {n}", lambda e=e, n=n, t=steps[kind]: e.run(init[n], t),
              steps[kind], 1) for (kind, n), e in engines.items()]
    timed.append(("runner cuda-3d life3d", lambda: runner.run(
        "cuda-3d", frac, r, batch, 16, m=m, workload=R.LIFE3D), 16, 2))
    for _, fn, _, _ in timed:   # warm-up: buffers, caches, index tensors
        fn()
    t = time.perf_counter()
    _ = cell._gathers
    torch.cuda.synchronize()
    cell_index_seconds = time.perf_counter() - t
    cell.run(cell_init, 1)
    torch.cuda.synchronize()

    k3.reset_launches()
    runs = []

    def drive(label, fn, n, b):
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        sec = time.perf_counter() - t
        runs.append(dict(run=label, steps=n, batch=b, seconds=sec,
                         ms_per_step=1e3 * sec / n,
                         cells_per_s=b * frac.volume(r) * n / sec))
        return out
    outs = {label: drive(label, fn, n, b) for label, fn, n, b in timed}
    out_cell = drive("cell3d life3d", lambda: cell.run(cell_init, 2), 2, 1)
    launches = dict(k3.LAUNCHES)

    def per_run(n):
        return n // k + n % k
    expect = dict.fromkeys(launches, 0)
    expect["stencil3d_step_fused_k"] = 2 * per_run(31) + per_run(16)
    expect["stencil3d_step_mxu_k"] = 2 * per_run(16)
    if launches != expect:
        raise AssertionError(f"3D launches {launches}, expected {expect}")

    checks, max_abs_plain = {}, {}
    for (kind, n), e in engines.items():
        wl = e.workload
        plain = make_engine("block3d", frac, r, m, workload=wl, fusion_k=k)
        want = plain.run(init[n], steps[kind])
        label = f"{kind} {n}"
        kernel = "stencil3d_step_mxu_k" if kind.endswith("mxu") \
            else "stencil3d_step_fused_k"
        checks[label] = chk.check(f"main3d/{label}", kernel, outs[label],
                                  want, wl.dtype == torch.uint8 or
                                  kernel.endswith("fused_k"))
        if wl.dtype != torch.uint8:
            max_abs_plain[label] = float(want.abs().max())
    plain = make_engine("block3d", frac, r, m, workload=R.LIFE3D, fusion_k=k)
    checks["runner cuda-3d life3d"] = chk.check(
        "main3d/runner", "stencil3d_step_fused_k",
        outs["runner cuda-3d life3d"],
        torch.stack([plain.run(s, 16) for s in batch]), True)
    alive = int(outs["cuda-3d life3d"].sum())
    want = c3.expanded_to_compact3(frac, r, lay.to_expanded(
        engines[("cuda-3d", "life3d")].run(init["life3d"], 2)))
    checks["cell3d life3d"] = chk.check("main3d/cell3d", None, out_cell,
                                        want, True)
    if alive == 0:
        raise AssertionError("LIFE3D died out on the 3D main path")
    emit("main_path_3d", fractal=name, r=r, m=m, fusion_k=k, runs=runs,
         launches={n: v for n, v in launches.items() if "3d" in n},
         expected_launches={n: v for n, v in expect.items() if "3d" in n},
         max_err_vs_plain=checks, max_abs_plain=max_abs_plain,
         cell_index_seconds=cell_index_seconds,
         live_cells_after_31_steps=alive,
         state_bytes={"life3d": init["life3d"].numel(),
                      "heat3d": 4 * init["heat3d"].numel()})
    return launches, lay, engines


def phase_3d_bb(torch, chk, F3, R, make_engine, lay, engines, c3):
    """Fig. 12 in 3D: bb3d against cell3d, cuda-3d and cuda-3d-mxu."""
    name, r, m = MAIN3D
    frac = F3.REGISTRY3D[name]
    bb = make_engine("bb3d", frac, r, workload=R.LIFE3D)
    cell = make_engine("cell3d", frac, r, workload=R.LIFE3D)
    fu = engines[("cuda-3d", "life3d")]
    mx = engines[("cuda-3d-mxu", "life3d")]
    e0 = bb.init_random(41)
    s0 = lay.from_expanded(e0)
    c0 = c3.expanded_to_compact3(frac, r, e0)
    n_eq = 4
    e1 = bb.run(e0, n_eq)
    want = lay.from_expanded(e1)
    chk.check("bb3d/fused", None, fu.run(s0, n_eq), want, True)
    chk.check("bb3d/mxu", None, mx.run(s0, n_eq), want, True)
    chk.check("bb3d/cell3d", None, cell.run(c0, n_eq),
              c3.expanded_to_compact3(frac, r, e1), True)
    alive = int(e1.sum())
    del e1, want
    torch.cuda.empty_cache()
    bb_ms = cuda_ms(torch, lambda: bb.run(e0, 3), 2) / 3
    cell_ms = cuda_ms(torch, lambda: cell.run(c0, 3), 2) / 3
    fu_ms = cuda_ms(torch, lambda: fu.run(s0, 30), 3) / 30
    mx_ms = cuda_ms(torch, lambda: mx.run(s0, 30), 3) / 30
    bb_bytes, sq_bytes = bb.memory_bytes(), lay.memory_bytes()
    emit("bb3d_vs_squeeze", workload="life3d", expanded_side=frac.side(r),
         bb3d_ms_per_step=bb_ms, cell3d_ms_per_step=cell_ms,
         cuda_3d_ms_per_step=fu_ms, cuda_3d_mxu_ms_per_step=mx_ms,
         speedup_cell3d=bb_ms / cell_ms, speedup_cuda_3d=bb_ms / fu_ms,
         speedup_cuda_3d_mxu=bb_ms / mx_ms, bb3d_bytes=bb_bytes,
         squeeze_block_bytes=sq_bytes, fractal_cells=frac.volume(r),
         cell3d_bytes=cell.memory_bytes(), mrf=bb_bytes / frac.volume(r),
         block_mrf=bb_bytes / sq_bytes, equal_after_steps=n_eq,
         live_cells_after_4_steps=alive)


def phase_3d_timing(torch, chk, R, lay, k, launches, k3, regs3):
    """Both 3D kernels at the main path's shapes, LIFE3D and HEAT3D;
    returns their rows (LIFE3D's numbers, HEAT3D's beside them, the
    registers and spills of each instance, row 9's design bound). Bounds:
    the state read and written once and the neighbor table read once;
    about 10 operations a cell and substep (the separable 26-cell sum: 6
    adds and the center, then the rule)."""
    rows = []
    for kname, fn, plain in (
            ("stencil3d_step_fused_k", k3.stencil3d_step_fused_k,
             k3.stencil3d_step_fused_k_plain),
            ("stencil3d_step_mxu_k", k3.stencil3d_step_mxu_k,
             k3.stencil3d_step_mxu_k_plain)):
        per_wl = {}
        for wl in (R.LIFE3D, R.HEAT3D):
            s1 = _init3d(torch, lay, wl, 1, 51)[0]
            o1 = torch.empty_like(s1)
            chk.check(f"timing3d/{kname}/{wl.name}", kname,
                      fn(lay, s1, wl, k=k), plain(lay, s1, wl, k=k),
                      wl.dtype == torch.uint8 or "fused" in kname)
            state_bytes = s1.numel() * s1.element_size()
            nbytes = 2 * state_bytes + lay.n_blocks * 26 * 4
            ops = 10 * k * s1.numel()
            ms = cuda_ms(torch, lambda: fn(lay, s1, wl, k=k, out=o1), 20)
            plain_ms = cuda_ms(torch, lambda: plain(lay, s1, wl, k=k), 3)
            bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
            ops_ms = 1e3 * ops / F32_FLOPS
            per_wl[wl.name] = dict(ms=ms, plain_ms=plain_ms,
                                   bound_ms=max(bytes_ms, ops_ms),
                                   bound_by="bytes" if bytes_ms >= ops_ms
                                   else "operations")
            if "mxu" in kname:
                plan = k3.mxu3_plan_for(lay, wl, k)
                per_wl[wl.name]["bound_ops_design_ms"] = mxu3_design_ms(
                    1, lay.n_blocks, k, lay.rho + 2 * k, tc_products(
                        torch, k3, wl, lay.rho + 2 * k))
            else:
                plan = k3.fused3_plan_for(lay, wl, k)
            emit("kernel_timing", name=kname, shape=list(s1.shape),
                 workload=wl.name, k=k, plan=plan._asdict(), ms=ms,
                 plain_ms=plain_ms, bytes=nbytes, bytes_ms=bytes_ms,
                 ops=ops, ops_ms=ops_ms)
            del s1, o1
        source, replaces = KERNELS[kname]
        row = per_wl["life3d"]
        rows.append(dict(
            name=kname, route="cuda", source=source, replaces=replaces,
            launches=launches[kname] + launches[kname + "[wide]"] +
            launches[kname + "[global]"], max_abs_err=chk.max_err[kname],
            ms=row["ms"], plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
            bound_by=row["bound_by"], library_ms=None,
            heat3d=per_wl["heat3d"],
            registers=regs3["mxu" if "mxu" in kname else "fused"]))
        if "mxu" in kname:
            rows[-1]["bound_ops_design_ms"] = row["bound_ops_design_ms"]
    return rows


@contextlib.contextmanager
def checked_local_kernels(chk, sk, what, errs):
    """Every call of kernels 6 and 7 inside the block is held against its
    plain version on the same inputs; the largest error per kernel goes to
    ``errs``."""
    orig = {name: getattr(sk, name) for name in LOCAL}

    def wrap(name):
        fn, plain = orig[name], getattr(sk, name + "_plain")

        def call(layout, s, halo, existence, wl, **kw):
            want = plain(layout, s, halo, existence, wl, k=kw["k"])
            got = fn(layout, s, halo, existence, wl, **kw)
            # kernel 6 bit for bit, kernel 7 exact for the CA states
            err = chk.check(f"{what}/{name}", name, got, want,
                            name == LOCAL[0] or
                            str(wl.dtype) == "torch.uint8")
            errs[name] = max(errs.get(name, 0.0), err)
            return got
        return call
    for name in LOCAL:
        setattr(sk, name, wrap(name))
    try:
        yield
    finally:
        for name, fn in orig.items():
            setattr(sk, name, fn)


def phase_dist_kernels_vs_plain(torch, chk, F, R, BlockLayout, sk,
                                make_engine, make_distributed_engine):
    """Kernels 6 and 7 on every call of the distributed engine, at phase
    3's shapes sharded 1, 3 and 8 ways on cuda:0."""
    for name, r, m in DIST_CHECK:
        frac = F.REGISTRY[name]
        lay = BlockLayout(frac, r, m)
        for wl in (R.LIFE, R.HIGHLIFE, R.HEAT, R.GRAY_SCOTT):
            t0 = time.perf_counter()
            exact = wl.dtype == torch.uint8
            errs, runs = {}, []
            single = {kind: make_engine(kind, frac, r, m, workload=wl)
                      for kind in ("cuda-fused", "cuda-mxu")}
            x1 = single["cuda-fused"].init_random(21)
            x3 = torch.stack([single["cuda-fused"].init_random(22 + i)
                              for i in range(3)])
            for ns in (1, 3, 8):
                # ns=3 runs k=rho then one k=1 launch, the others k=2 and
                # one k=1; ns=8 steps a batch of 3
                k = lay.rho if ns == 3 else 2
                x = x3 if ns == 8 else x1
                for exchange in ("p2p", "gather"):
                    for compute in ("fused", "mxu"):
                        p = 7 if compute == "mxu" and exchange == "gather" \
                            else None
                        eng = make_distributed_engine(
                            lay, n_shards=ns, device="cuda:0", workload=wl,
                            compute=compute, fusion_k=k, exchange=exchange,
                            macro_p=p)
                        label = f"ns{ns}/{exchange}/{compute}/k{k}/" \
                            f"b{3 if ns == 8 else 1}/p{p}"
                        with checked_local_kernels(
                                chk, sk, f"dist/{frac.name}/{wl.name}/"
                                f"{label}", errs):
                            got = eng.to_dense(eng.run(eng.from_dense(x),
                                                       k + 1))
                        want = single[f"cuda-{compute}"].run(x, k + 1)
                        runs.append(label)
                        chk.check(f"dist/{frac.name}/{wl.name}/{label}/"
                                  "engine", None, got, want,
                                  exact or compute == "fused")
            torch.cuda.synchronize()
            emit("dist_kernel_vs_plain", fractal=frac.name, r=r, m=m,
                 compact_cells=frac.volume(r), workload=wl.name,
                 tolerance="exact" if exact else FLOAT_TOL, runs=len(runs),
                 max_err=errs, seconds=time.perf_counter() - t0)


def _cuda_events_around(torch, sk, spans):
    """Wrap kernels 6 and 7 so each call records a CUDA event pair into
    ``spans``; returns the restore function."""
    orig = {name: getattr(sk, name) for name in LOCAL}

    def wrap(fn):
        def call(*a, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*a, **kw)
            end.record()
            spans.append((start, end))
            return out
        return call
    for name, fn in orig.items():
        setattr(sk, name, wrap(fn))

    def restore():
        for name, fn in orig.items():
            setattr(sk, name, fn)
    return restore


def phase_dist_main(torch, chk, F, R, sk, make_engine, shared_layout,
                    default_fusion_k, BatchedRunner, EngineSpec,
                    make_distributed_engine):
    """The distributed main path at r=16 over 4 shards (all on cuda:0 on
    one card); returns its launch counts, the layout and the engines (for
    phase 13)."""
    name, r, m = DIST_MAIN
    frac, ns = F.REGISTRY[name], DIST_SHARDS
    lay = shared_layout(frac, r, m)
    k = default_fusion_k(lay.rho)
    t0 = time.perf_counter()
    decomp = lay.strip_decomposition(ns)
    decomp_seconds = time.perf_counter() - t0
    wire = {}
    for n in (2, 4, 8):
        t = time.perf_counter()
        lay.strip_decomposition(n)
        wire[n] = {ex: make_distributed_engine(
            lay, n_shards=n, device="cuda:0", compute="fused",
            exchange=ex).wire_bytes_per_device(k)
            for ex in ("p2p", "gather")}
        wire[n]["decomposition_seconds"] = time.perf_counter() - t
    emit("dist_layout", fractal=frac.name, r=r, m=m, n_blocks=lay.n_blocks,
         n_shards=ns, decomposition_seconds=decomp_seconds,
         nb_local=decomp.nb_local, ms_prev=decomp.ms_prev,
         ms_next=decomp.ms_next, n_boundary=decomp.n_boundary.tolist(),
         wire_bytes_per_device_life_k2=wire)

    def dist(kind, wl, exchange="auto"):
        return make_engine(kind, frac, r, m, workload=wl, n_shards=ns,
                           exchange=exchange)
    engines = {
        "dist-fused life p2p": dist("dist-fused", R.LIFE, "p2p"),
        "dist-fused gray-scott p2p": dist("dist-fused", R.GRAY_SCOTT, "p2p"),
        "dist-fused life gather": dist("dist-fused", R.LIFE, "gather"),
        "dist-block life": dist("dist-block", R.LIFE),
    }
    singles = {
        "dist-fused life p2p": make_engine("cuda-fused", frac, r, m,
                                           workload=R.LIFE),
        "dist-fused gray-scott p2p": make_engine(
            "cuda-fused", frac, r, m, workload=R.GRAY_SCOTT),
        "dist-block life": make_engine("block", frac, r, m, workload=R.LIFE,
                                       fusion_k=k),
    }
    singles["dist-fused life gather"] = singles["dist-fused life p2p"]
    steps = {"dist-fused life p2p": 63, "dist-fused gray-scott p2p": 63,
             "dist-fused life gather": 63, "dist-block life": 4}
    dense0 = {label: singles[label].init_random(60 + i)
              for i, label in enumerate(engines)}
    init = {label: e.from_dense(dense0[label]) for label, e in
            engines.items()}
    runner = BatchedRunner()
    mxu_spec = EngineSpec.from_args("dist-mxu", frac, r, m, R.LIFE,
                                    n_shards=ns)
    mxu_states = runner.init_batch(mxu_spec, [64, 65, 66, 67])
    mxu_eng = runner.engine_for(mxu_spec)
    timed = [(label, lambda e=e, label=label: e.run(init[label],
                                                    steps[label]),
              steps[label], 1) for label, e in engines.items()]
    timed.append(("runner dist-mxu life", lambda: runner.run(
        mxu_spec, mxu_states, 64), 64, 4))
    t = time.perf_counter()
    for _, fn, _, _ in timed:   # warm-up: tables, buffers, the build
        fn()
    torch.cuda.synchronize()
    warmup_seconds = time.perf_counter() - t
    for e in list(engines.values()) + [mxu_eng]:
        e.reset_exchange_stats()

    sk.reset_launches()
    runs, outs = [], {}
    for label, fn, n, b in timed:
        t = time.perf_counter()
        outs[label] = fn()
        torch.cuda.synchronize()
        sec = time.perf_counter() - t
        runs.append(dict(run=label, steps=n, batch=b, seconds=sec,
                         ms_per_step=1e3 * sec / n,
                         cells_per_s=b * frac.volume(r) * n / sec))
    launches = dict(sk.LAUNCHES)
    per_run = 63 // k + (63 % k > 0)
    expect = dict.fromkeys(launches, 0)
    expect["stencil_step_fused_k_local"] = ns * (2 * per_run * 2
                                                 + per_run)
    expect["stencil_step_mxu_k_local"] = ns * 2 * (64 // k)
    if launches != expect:
        raise AssertionError(f"dist launches {launches}, expected {expect}")

    # exchange accounting against the byte model of the decomposition
    stats = {}
    for label, e in list(engines.items()) + [("runner dist-mxu life",
                                              mxu_eng)]:
        st, n = e.exchange_stats(), steps.get(label, 64)
        b = 4 if e is mxu_eng else 1
        depths = [k] * (n // k) + ([n % k] if n % k else [])
        item = 4 if e.workload.dtype == torch.float32 else 1
        lanes = b * e.workload.n_channels
        if e.exchange_mode == "p2p":
            d = e.decomp
            want = dict(bytes_permuted=sum(
                lanes * (d.ms_prev + d.ms_next) * (ns - 1) * 4 * dd
                * lay.rho * item for dd in depths), bytes_gathered=0,
                neighbor_sends=2 * (ns - 1) * len(depths))
            want_t = dict(all_gather=0, permute=2 * len(depths),
                          send=2 * (ns - 1) * len(depths))
        else:
            want = dict(bytes_gathered=sum(
                lanes * e.nb_padded * 4 * dd * lay.rho * item
                for dd in depths), bytes_permuted=0, neighbor_sends=0)
            want_t = dict(all_gather=len(depths), permute=0, send=0)
        got = {key: getattr(st, key) for key in want}
        if got != want or st.collectives != len(depths) or \
                st.steps != n or e.transfer_counts() != want_t:
            raise AssertionError(f"{label}: exchange {st} "
                                 f"{e.transfer_counts()}, expected {want} "
                                 f"{want_t}")
        stats[label] = dict(**got, collectives=st.collectives,
                            transfers=e.transfer_counts())

    # results against the single-device runs (each timed after an untimed
    # run), dead cells zero
    checks, ms_single = {}, {}

    def single_run(label, fn, n):
        want = fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ms_single[label] = 1e3 * (time.perf_counter() - t) / n
        return want
    for label, e in engines.items():
        n = steps[label]
        want = single_run(label, lambda: singles[label].run(dense0[label],
                                                            n), n)
        kernel = None if label.startswith("dist-block") \
            else "stencil_step_fused_k_local"
        # dist-fused equals cuda-fused bit for bit
        checks[label] = chk.check(f"dist_main/{label}", kernel,
                                  e.to_dense(outs[label]), want,
                                  e.workload.dtype == torch.uint8 or
                                  kernel is not None)
    dense4 = mxu_eng.to_dense(mxu_states)
    want = single_run("runner dist-mxu life", lambda: runner.run(
        "cuda-mxu", frac, r, dense4, 64, m=m, workload=R.LIFE), 64)
    checks["runner dist-mxu life"] = chk.check(
        "dist_main/runner", "stencil_step_mxu_k_local",
        mxu_eng.to_dense(outs["runner dist-mxu life"]), want, True)
    alive = int(mxu_eng.to_dense(outs["runner dist-mxu life"]).sum())
    if alive == 0:
        raise AssertionError("LIFE died out on the distributed main path")
    for label, out in outs.items():
        e = engines.get(label, mxu_eng)
        dead = torch.from_numpy(e.dead_mask()).cuda()
        native = torch.cat([o.to(dead.device) for o in out], dim=-3)
        if float((native.double() * dead).abs().sum()):
            raise AssertionError(f"{label}: a dead cell is nonzero")

    # the kernels' share of a launch, CUDA events around each kernel call
    # (with every shard on one card: events time one device's stream)
    share = {}
    one_card = len(set(mxu_eng.devices)) == 1
    for label, fn in () if not one_card else (
            ("dist-fused life p2p", lambda: engines[
                "dist-fused life p2p"].run(init["dist-fused life p2p"], 16)),
            ("dist-fused life gather", lambda: engines[
                "dist-fused life gather"].run(
                init["dist-fused life gather"], 16)),
            ("runner dist-mxu life", lambda: runner.run(
                mxu_spec, mxu_states, 16))):
        spans = []
        restore = _cuda_events_around(torch, sk, spans)
        try:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
        finally:
            restore()
        total = start.elapsed_time(end)
        kern = sum(a.elapsed_time(b) for a, b in spans)
        share[label] = dict(ms_per_step=total / 16,
                            kernel_ms_per_step=kern / 16,
                            exchange_and_assembly_share=1 - kern / total,
                            kernel_launches=len(spans))
    for row in runs:
        row["single_device_ms_per_step"] = ms_single[row["run"]]
    emit("dist_main_path", fractal=frac.name, r=r, m=m, n_shards=ns,
         devices=[str(d) for d in mxu_eng.devices], fusion_k=k, runs=runs,
         warmup_seconds=warmup_seconds, launches={
             n: v for n, v in launches.items() if n in LOCAL},
         expected_launches={n: v for n, v in expect.items() if n in LOCAL},
         max_err_vs_single_device=checks, exchange=stats,
         kernel_share=share, live_cells_after_64_steps=alive,
         state_bytes={"life": lay.memory_bytes(1),
                      "gray_scott": 2 * lay.memory_bytes(4)})
    return launches, lay, engines["dist-fused life p2p"], mxu_eng, \
        init["dist-fused life p2p"], mxu_states


def phase_dist_timing(torch, chk, R, sk, lay, k, launches, fused_eng,
                      mxu_eng, state1, states4, mxu_regs, fused_regs):
    """Kernels 6 and 7 at the per-shard shapes of the main path: shard 0's
    whole-domain pass (interior-view table), LIFE, k=2; B=4 for v5.
    Bounds: the state read and written once, the four pieces read once
    and the existence table; about 12 operations a cell and substep."""
    rows = []
    for kname, eng, state in (
            ("stencil_step_fused_k_local", fused_eng, state1),
            ("stencil_step_mxu_k_local", mxu_eng, states4)):
        s5, halo, ex = eng.local_inputs(state, k)
        fn, plain = getattr(sk, kname), getattr(sk, kname + "_plain")
        o = torch.empty_like(s5)
        chk.check(f"timing/{kname}", kname, fn(lay, s5, halo, ex, R.LIFE,
                                               k=k),
                  plain(lay, s5, halo, ex, R.LIFE, k=k), True)
        nbytes = 2 * s5.numel() * s5.element_size() + sum(
            h.numel() * h.element_size() for h in halo) + ex.numel() * 4
        ops_n = 12 * k * s5.numel()
        ms = cuda_ms(torch, lambda: fn(lay, s5, halo, ex, R.LIFE, k=k,
                                       out=o), 20)
        plain_ms = cuda_ms(torch, lambda: plain(lay, s5, halo, ex, R.LIFE,
                                                k=k), 3)
        bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
        ops_ms = 1e3 * ops_n / F32_FLOPS
        p = lay.macro_tiles_for(s5.shape[2], k)[0] if "mxu" in kname \
            else None
        emit("kernel_timing", name=kname, shape=list(s5.shape),
             workload="life", k=k, p=p, ms=ms, plain_ms=plain_ms,
             bytes=nbytes, bytes_ms=bytes_ms, ops=ops_n, ops_ms=ops_ms)
        source, replaces = KERNELS[kname]
        rows.append(dict(
            name=kname, route="cuda", source=source, replaces=replaces,
            launches=launches[kname] + launches.get(kname + "[wide]", 0),
            max_abs_err=chk.max_err[kname], ms=ms,
            plain_ms=plain_ms, bound_ms=max(bytes_ms, ops_ms),
            bound_by="bytes" if bytes_ms >= ops_ms else "operations",
            library_ms=None))
        if "mxu" in kname:
            rows[-1].update(
                bound_ops_design_ms=mxu_design_ms(s5.shape[0], s5.shape[2],
                                                  k, 1),
                registers=mxu_regs["pieces"])
        else:
            rows[-1].update(registers=fused_regs["pieces"])
        del halo, o
    return rows


def phase_3d_global_windows(torch, chk, F3, R, make_engine, c3, k3):
    """The 3D windows over one CTA's shared memory (phase 7's repaired
    shapes): the Menger sponge r=5, m=3 (rho = 27), HEAT3D at k = 2 and 3
    and LIFE3D at k = rho, one simulation and B = 3, each ``run(k)`` one
    launch of the workspace variant through cuda-3d and cuda-3d-mxu, held
    against the kernel's plain version at phase 3's bar; then one launch's
    time (CUDA events, after the checked runs)."""
    name, r, m = GLOBAL3D
    frac = F3.REGISTRY3D[name]
    lay = c3.shared_layout3d(frac, r, m)
    rows = []
    for wl, k in ((R.HEAT3D, 2), (R.HEAT3D, 3), (R.LIFE3D, lay.rho)):
        exact = wl.dtype == torch.uint8
        x = _init3d(torch, lay, wl, 3, 61 + k)
        for kind, kernel in (("cuda-3d", "fused"), ("cuda-3d-mxu", "mxu")):
            t0 = time.perf_counter()
            if k3.window_variant(lay, wl, k, kernel) != "global":
                raise AssertionError(f"{kind} {wl.name} k={k}: the window "
                                     "fits shared memory")
            eng = make_engine(kind, frac, r, m, workload=wl, fusion_k=k)
            kname = f"stencil3d_step_{kernel}_k"
            k3.reset_launches()
            got1 = eng.run(x[0], k)
            got3 = eng.run(x, k)
            torch.cuda.synchronize()
            launches = {n: v for n, v in k3.LAUNCHES.items() if v}
            if launches != {kname + "[global]": 2}:
                raise AssertionError(f"{kind} {wl.name} k={k}: launches "
                                     f"{launches}")
            plain = getattr(k3, kname + "_plain")
            want = plain(lay, x, wl, k=k)
            what = f"3d-global/{kind}/{wl.name}/k{k}"
            errs = [chk.check(what + "/b1", kname, got1, want[0], exact),
                    chk.check(what + "/b3", kname, got3, want, exact)]
            del want, got1, got3
            fn = getattr(k3, kname)
            out = torch.empty_like(x[0])
            ms = cuda_ms(torch, lambda: fn(lay, x[0], wl, k=k, out=out), 2)
            rows.append(dict(kind=kind, workload=wl.name, k=k,
                             window=lay.rho + 2 * k, launches=launches,
                             max_err=max(errs), ms_per_launch=ms,
                             seconds=time.perf_counter() - t0))
            del eng, out
        del x
        torch.cuda.empty_cache()
    emit("kernel3d_global_window", fractal=name, r=r, m=m, rho=lay.rho,
         n_blocks=lay.n_blocks,
         tolerance={"life3d": "exact", "heat3d": FLOAT_TOL}, runs=rows)


def _qkv(torch, shape, dtype, seed):
    b, h, sq, sk, d = shape
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    return (torch.randn((b, h, sq, d), generator=g, device="cuda")
            .to(dtype),
            torch.randn((b, h, sk, d), generator=g, device="cuda").to(dtype),
            torch.randn((b, h, sk, d), generator=g, device="cuda").to(dtype))


def _ssd_inputs(torch, b, s, h, p, n, seed):
    """x, dt (softplus), a (negative), B and C as the reference test draws
    them, on the card."""
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda")
    x = randn(b, s, h, p)
    dt = torch.nn.functional.softplus(randn(b, s, h) - 1.0)
    a = -torch.exp(randn(h) * 0.3)
    return x, dt, a, randn(b, s, n) * 0.5, randn(b, s, n) * 0.5


def phase_attention_ssd_vs_plain(torch, chk, ta, ts, tssm, build):
    """Phase 14: both new kernels against their plain versions."""
    t0 = time.perf_counter()
    errs = {}
    rounding, bodies = {}, {}
    for i, (label, shape, kw) in enumerate(ATTN_CASES):
        plain_kw = {n: v for n, v in kw.items() if n not in ("bq", "bk")}
        b, h, sq, sk, d = shape
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = _qkv(torch, shape, dtype, 70 + i)
            what = f"{label}/{str(dtype)[6:]}"
            body = ta.plan(dtype, b * h, sq, sk, d, True,
                           plain_kw.get("causal", True),
                           plain_kw.get("window")).body
            before = {n: build.LAUNCHES[n] for n in ATTN_BODIES}
            got = ta.flash_attention(q, k, v, **kw)
            ran = {n: build.LAUNCHES[n] - before[n] for n in ATTN_BODIES}
            if ran != {n: int(n == body) for n in ATTN_BODIES}:
                raise AssertionError(f"attention/{what}: launches {ran}, "
                                     f"expected one of {body}")
            bodies[what] = body
            want = ta.attention_plain(q, k, v, **plain_kw)
            errs[what] = chk.check(f"attention/{what}", "flash_attention",
                                   got, want, False, ATTN_TOL[str(dtype)])
            if dtype == torch.bfloat16:
                rounding[what] = chk.check_bf16_rounding(
                    f"attention/{what}", got, ta.attention_plain(
                        q.float(), k.float(), v.float(), **plain_kw))
    emit("attention_vs_plain", cases=len(errs), tolerance=ATTN_TOL,
         max_err=errs, bodies=bodies,
         bf16_rounding={"bar": f"ulp_bf16(|want|) + {BF16_ROUNDING_ATOL}",
                        "max_err_vs_f32_and_excess_over_ulp": rounding},
         seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    errs = {}
    for b, s, h, p, n, chunk in SSD_CASES:
        x, dt, a, bm, cm = _ssd_inputs(torch, b, s, h, p, n, s)
        xc, dtc, bc, cc = ts.to_chunks(x, dt, bm, cm, chunk)
        label = f"b{b}_s{s}_h{h}_p{p}_n{n}_l{chunk}"
        for part, got, want in zip(
                ("y_diag", "states"), ts.ssd_chunk(xc, dtc, a, bc, cc),
                ts.ssd_chunk_plain(xc, dtc, a, bc, cc)):
            errs[f"{label}/{part}"] = chk.check(
                f"ssd/{label}/{part}", "ssd_chunk_scan", got, want, False,
                SSD_TOL)
        errs[f"{label}/scan"] = chk.check(
            f"ssd/{label}/scan", None,
            ts.ssd_chunk_scan(x, dt, a, bm, cm, chunk=chunk),
            tssm._ssd_chunked(x, dt, a, bm[:, :, None], cm[:, :, None],
                              chunk), False, SSD_TOL)
    emit("ssd_vs_plain", cases=len(SSD_CASES), tolerance=SSD_TOL,
         max_err=errs, seconds=time.perf_counter() - t0)


def _gemma2_inputs(torch, seed):
    """(global/local q, k, v) and the decode triple at gemma2-2b's widths,
    bfloat16."""
    g2 = GEMMA2
    full = _qkv(torch, (1, g2["h"], g2["s"], g2["s"], g2["d"]),
                torch.bfloat16, seed)
    dec = _qkv(torch, (g2["decode_b"], g2["h"], 1, g2["s"], g2["d"]),
               torch.bfloat16, seed + 1)
    return full, dec


def phase_attention_ssd_main(torch, chk, ta, ts, tssm, build):
    """Phase 15: the slice's path at full width; returns its launches."""
    g2, mb = GEMMA2, MAMBA2
    full, dec = _gemma2_inputs(torch, 81)
    ssd = _ssd_inputs(torch, mb["b"], mb["s"], mb["h"], mb["p"], mb["n"], 83)
    att_kw = {
        "gemma2 global": dict(causal=True, softcap=g2["softcap"]),
        "gemma2 local": dict(causal=True, window=g2["window"],
                             softcap=g2["softcap"]),
        "gemma2 decode": dict(causal=True, softcap=g2["softcap"]),
    }
    att_in = {"gemma2 global": full, "gemma2 local": full,
              "gemma2 decode": dec}
    runs = [(label, lambda label=label: ta.flash_attention(
                 *att_in[label], bq=1 if label == "gemma2 decode" else 128,
                 **att_kw[label]))
            for label in att_kw]
    runs.append(("mamba2 ssd", lambda: ts.ssd_chunk_scan(
        *ssd, chunk=mb["chunk"])))
    for _, fn in runs:   # warm-up: builds, allocations
        fn()
    torch.cuda.synchronize()
    build.reset_launches()
    outs, results = {}, []
    for label, fn in runs:
        t = time.perf_counter()
        outs[label] = fn()
        torch.cuda.synchronize()
        results.append(dict(run=label, ms=1e3 * (time.perf_counter() - t)))
    launches = dict(build.LAUNCHES)
    expect = dict.fromkeys(launches, 0)
    expect.update({"flash_attention[tc]": 2, "flash_attention[split]": 1,
                   "ssd_chunk_scan": 1})
    if launches != expect:
        raise AssertionError(f"launches {launches}, expected {expect}")
    row = results[-1]
    got = outs.pop("mamba2 ssd")
    row["max_err"] = chk.check("main/mamba2 ssd", "ssd_chunk_scan", got,
                               tssm._ssd_chunked(
                                   ssd[0], ssd[1], ssd[2], ssd[3][:, :, None],
                                   ssd[4][:, :, None], mb["chunk"]),
                               False, SSD_TOL)
    row.update(shape=list(got.shape), tolerance=SSD_TOL)
    del got
    # each bf16 run against the plain version (the reference's 2e-2) and
    # within one bf16 rounding of the plain version in float32; then the
    # same calls in float32 at 2e-5 against that float32 result, through
    # the FP32 body (prefill) and the split body (decode)
    f32 = {id(t): tuple(x.float() for x in t) for t in (full, dec)}
    build.reset_launches()
    for row, label in zip(results[:len(att_kw)], att_kw):
        qkv, kw = att_in[label], att_kw[label]
        got = outs.pop(label)
        row["max_err"] = chk.check(f"main/{label}", "flash_attention", got,
                                   ta.attention_plain(*qkv, **kw), False,
                                   ATTN_TOL[str(got.dtype)])
        want32 = ta.attention_plain(*f32[id(qkv)], **kw)
        row["max_err_vs_f32"], row["excess_over_bf16_ulp"] = \
            chk.check_bf16_rounding(f"main/{label}", got, want32)
        row.update(shape=list(got.shape), tolerance=ATTN_TOL[str(got.dtype)],
                   rms=float(got.double().square().mean().sqrt()))
        del got
        got = ta.flash_attention(*f32[id(qkv)], bq=1 if qkv is dec else 128,
                                 **kw)
        tol = ATTN_TOL[str(got.dtype)]
        results.append(dict(
            run=f"{label} f32", max_err=chk.check(
                f"main/{label} f32", "flash_attention", got, want32, False,
                tol),
            shape=list(got.shape), tolerance=tol,
            rms=float(got.double().square().mean().sqrt())))
        del got, want32
        torch.cuda.empty_cache()
    f32_launches = {n: build.LAUNCHES[n] for n in ATTN_BODIES}
    if f32_launches != {"flash_attention": 2, "flash_attention[tc]": 0,
                        "flash_attention[split]": 1}:
        raise AssertionError(f"float32 runs' launches {f32_launches}")
    del f32, full, dec
    torch.cuda.empty_cache()
    # the SSD kernel's share of a scan, on CUDA events
    xc, dtc, bc, cc = ts.to_chunks(ssd[0], ssd[1], ssd[3], ssd[4],
                                   mb["chunk"])
    kernel_ms = cuda_ms(torch, lambda: ts.ssd_chunk(xc, dtc, ssd[2], bc, cc),
                        10)
    scan_ms = cuda_ms(torch, lambda: ts.ssd_chunk_scan(
        *ssd, chunk=mb["chunk"]), 10)
    emit("attention_ssd_main_path", gemma2=g2, mamba2=mb, runs=results,
         launches={n: launches[n] for n in ATTN_BODIES + ("ssd_chunk_scan",)},
         f32_launches=f32_launches,
         bf16_rounding_bar=f"ulp_bf16(|want|) + {BF16_ROUNDING_ATOL}",
         ssd_kernel_ms=kernel_ms, ssd_scan_ms=scan_ms,
         ssd_kernel_share=kernel_ms / scan_ms)
    return launches


def phase_attention_ssd_timing(torch, chk, ta, ts, launches, ssd_regs):
    """Phase 16: rows 12 and 13. Attention at gemma2-2b's global layer
    with the softcap off, where SDPA computes the same function (timed
    here only as the yardstick); the other main-path shapes beside it.
    Bounds count visible (query, key) pairs, 4 D operations each, at the
    bf16 tensor rate, and Q, K, V and O once; the tensor-core body's
    split-P design does 6 D a pair (its own bound beside). The SSD
    kernel at mamba2-780m: x, dt, B, C in and y_diag and the states out
    once; C B^T once a chunk on its lower triangle, the y triangle and the
    state per head, at the FP32 rate and, as the design runs them (three
    TF32 products each), at the TF32 tensor rate; the bound is the larger
    of the bytes and the products at the tensor rate. Then the kernel at
    chunks of 256 and 512 at the same S."""
    F = torch.nn.functional
    g2, mb = GEMMA2, MAMBA2
    full, dec = _gemma2_inputs(torch, 91)
    h, s, d = g2["h"], g2["s"], g2["d"]
    qkv_bytes = 4 * h * s * d * 2   # Q, K, V and O, bf16
    shapes = {
        "global": (full, dict(causal=True), h * s * (s + 1) // 2),
        "global softcap": (full, dict(causal=True, softcap=g2["softcap"]),
                           h * s * (s + 1) // 2),
        "local softcap": (full, dict(causal=True, window=g2["window"],
                                     softcap=g2["softcap"]),
                          h * (g2["window"] * (g2["window"] + 1) // 2
                               + (s - g2["window"]) * g2["window"])),
        "decode softcap": (dec, dict(causal=True, softcap=g2["softcap"],
                                     bq=1), g2["decode_b"] * h * s),
    }
    att = {}
    for label, (qkv, kw, pairs) in shapes.items():
        plain_kw = {n: v for n, v in kw.items() if n != "bq"}
        nbytes = qkv_bytes if qkv is full else \
            2 * qkv[1].numel() * 2 + 2 * qkv[0].numel() * 2
        ms = cuda_ms(torch, lambda: ta.flash_attention(*qkv, **kw), 5)
        plain_ms = cuda_ms(torch, lambda: ta.attention_plain(*qkv,
                                                             **plain_kw), 2)
        ops_ms = 1e3 * 4 * d * pairs / BF16_FLOPS
        bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
        att[label] = dict(ms=ms, plain_ms=plain_ms, pairs=pairs,
                          bound_ms=max(ops_ms, bytes_ms),
                          bound_split_p_ms=max(1.5 * ops_ms, bytes_ms),
                          bound_by="bytes" if bytes_ms >= ops_ms
                          else "operations")
        emit("kernel_timing", name="flash_attention", run=label,
             body=ta.plan(torch.bfloat16, qkv[0].shape[0] * h,
                          qkv[0].shape[2], qkv[1].shape[2], d, True,
                          kw["causal"], kw.get("window")).body,
             shape=list(qkv[0].shape), sk=qkv[1].shape[2], ms=ms,
             plain_ms=plain_ms, pairs=pairs, ops_ms=ops_ms,
             ops_split_p_ms=1.5 * ops_ms, bytes=nbytes, bytes_ms=bytes_ms)
    got = ta.flash_attention(*full, causal=True)
    lib = F.scaled_dot_product_attention(*full, is_causal=True)
    sdpa_err = chk.check("timing/sdpa", None, got, lib, False,
                         ATTN_TOL["torch.bfloat16"])
    del got, lib
    library_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
        *full, is_causal=True), 5)
    emit("library_timing", name="scaled_dot_product_attention",
         run="global", ms=library_ms, max_err_vs_kernel=sdpa_err,
         kernel_ms=att["global"]["ms"],
         kernel_over_library=att["global"]["ms"] / library_ms)
    del full, dec
    torch.cuda.empty_cache()

    x, dt, a, bm, cm = _ssd_inputs(torch, mb["b"], mb["s"], mb["h"],
                                   mb["p"], mb["n"], 93)
    xc, dtc, bc, cc = ts.to_chunks(x, dt, bm, cm, mb["chunk"])
    for got, want in zip(ts.ssd_chunk(xc, dtc, a, bc, cc),
                         ts.ssd_chunk_plain(xc, dtc, a, bc, cc)):
        chk.check("timing/ssd", "ssd_chunk_scan", got, want, False, SSD_TOL)
    n_chunks, ll = xc.shape[0], mb["chunk"]
    hh, p, n = mb["h"], mb["p"], mb["n"]
    # C B^T on its lower triangle, the y triangle and the state; the exps
    # and scalings are left out, which keeps the bound a lower bound
    tri = ll * (ll + 1) // 2
    ops = 2 * n_chunks * (tri * n + hh * (tri * p + ll * p * n))
    nbytes = 4 * (2 * xc.numel() + dtc.numel() + bc.numel() + cc.numel()
                  + n_chunks * hh * p * n)
    ms = cuda_ms(torch, lambda: ts.ssd_chunk(xc, dtc, a, bc, cc), 10)
    plain_ms = cuda_ms(torch, lambda: ts.ssd_chunk_plain(xc, dtc, a, bc,
                                                         cc), 3)
    ops_ms, bytes_ms = 1e3 * ops / F32_FLOPS, 1e3 * nbytes / HBM_BYTES_PER_S
    tf32_ms = 1e3 * 3 * ops / TF32_FLOPS
    by_chunk = {}
    for chunk in SSD_CHUNKS:   # the same S, longer chunks
        xl, dtl, bl, cl = ts.to_chunks(x, dt, bm, cm, chunk)
        for got, want in zip(ts.ssd_chunk(xl, dtl, a, bl, cl),
                             ts.ssd_chunk_plain(xl, dtl, a, bl, cl)):
            chk.check(f"timing/ssd/chunk{chunk}", "ssd_chunk_scan", got,
                      want, False, SSD_TOL)
        by_chunk[chunk] = cuda_ms(torch, lambda: ts.ssd_chunk(
            xl, dtl, a, bl, cl), 10)
        del xl, dtl, bl, cl
    plan = ts.ssd_plan(n_chunks, ll, hh, p)
    emit("kernel_timing", name="ssd_chunk_scan", shape=list(xc.shape),
         n=n, ms=ms, plain_ms=plain_ms, ops=ops, ops_ms=ops_ms,
         ops_3xtf32_ms=tf32_ms, bytes=nbytes, bytes_ms=bytes_ms,
         ms_by_chunk=by_chunk, plan=plan._asdict(), registers=ssd_regs)
    row_att = att["global"]
    rows = [dict(
        name="flash_attention", route="cuda", source=KERNELS[
            "flash_attention"][0], replaces=KERNELS["flash_attention"][1],
        launches=sum(launches[n] for n in ATTN_BODIES),
        launches_by_body={n: launches[n] for n in ATTN_BODIES},
        max_abs_err=chk.max_err["flash_attention"], ms=row_att["ms"],
        plain_ms=row_att["plain_ms"], bound_ms=row_att["bound_ms"],
        bound_split_p_ms=row_att["bound_split_p_ms"],
        bound_by=row_att["bound_by"], library_ms=library_ms), dict(
        name="ssd_chunk_scan", route="cuda",
        source=KERNELS["ssd_chunk_scan"][0],
        replaces=KERNELS["ssd_chunk_scan"][1],
        launches=launches["ssd_chunk_scan"],
        max_abs_err=chk.max_err["ssd_chunk_scan"], ms=ms, plain_ms=plain_ms,
        bound_ms=max(tf32_ms, bytes_ms),
        bound_by="bytes" if bytes_ms >= tf32_ms else "operations",
        bound_bytes_ms=bytes_ms, bound_ops_fp32_ms=ops_ms,
        bound_ops_3xtf32_ms=tf32_ms, ms_by_chunk=by_chunk,
        registers=ssd_regs, library_ms=None)]
    return rows


def phase_serving(torch, F, R, shared_layout, build):
    """Phase 17: the fault-tolerant simulation service and the elastic
    runner on the main path's layout (module docstring, item 17)."""
    import asyncio
    import tempfile
    import threading

    import numpy as np

    from repro_torch import obs
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.core.device import synchronize
    from repro_torch.core.elastic import ElasticDistributedRunner
    from repro_torch.core.stencil import make_engine
    from repro_torch.runtime.fault import Fault, FaultInjector
    from repro_torch.serving import FractalService, ServiceConfig, SimRequest
    from repro_torch.workloads import BatchedRunner

    name, r, m = SERVE_MAIN
    frac = F.REGISTRY[name]
    misses = shared_layout.cache_info().misses
    lay = shared_layout(frac, r, m)
    launches0 = dict(build.LAUNCHES)
    was_enabled = obs.enabled()
    obs.enable(True)
    obs.reset()
    reg = obs.default_registry()
    runner = BatchedRunner()

    def requests(prefix):
        return [SimRequest(
            frac=frac, r=r, m=m, kind=kind, workload=R.get_workload(wl),
            seed=seed, steps=steps, snapshot_every=snap,
            n_shards=DIST_SHARDS if kind.startswith("dist-") else None,
            rid=f"{prefix}-{seed}")
            for kind, wl, seed, steps, snap in SERVE_REQUESTS]

    def serve(svc, reqs):
        """Serve ``reqs``; the last is submitted once a segment of its
        bucket has started, so it joins the running batch."""
        async def go():
            await svc.start()
            try:
                futs = [asyncio.ensure_future(svc.submit(q))
                        for q in reqs[:-1]]
                t0 = time.perf_counter()
                while not reg.value("serve.segments", kind=reqs[-1].kind):
                    if time.perf_counter() - t0 > 600:
                        raise AssertionError("serving: no segment in 600 s")
                    await asyncio.sleep(0.002)
                futs.append(asyncio.ensure_future(svc.submit(reqs[-1])))
                return await asyncio.gather(*futs)
            finally:
                await svc.stop()
        t = time.perf_counter()
        res = asyncio.run(go())
        # join the worker threads (an abandoned stall among them), so no
        # leftover launch overlaps what is timed next
        for th in threading.enumerate():
            if th.name.startswith("serve_"):
                th.join(timeout=60)
        return res, time.perf_counter() - t

    def host(q, eng, state):
        dist = q.kind.startswith("dist-")
        return (eng.to_dense(state) if dist else state[0]).cpu().numpy()

    def uninterrupted(q):
        """{step: host state} of one ``runner.run`` of q's seed in legs of
        ``snapshot_every`` steps (one leg without snapshots)."""
        eng = runner.engine_for(q.bucket, frac=frac, workload=q.workload)
        state = eng.init_random(q.seed)
        if not q.kind.startswith("dist-"):
            state = state[None]
        legs, done = {}, 0
        while done < q.steps:
            n = min(q.snapshot_every or q.steps, q.steps - done)
            state = runner.run(q.bucket, states=state, steps=n, frac=frac,
                               workload=q.workload)
            done += n
            legs[done] = host(q, eng, state)
        return legs

    def max_err(got, want, exact, what):
        """Largest |served - run|: 0 for CA (bit for bit), within
        rtol = atol = 1e-5 for floats."""
        if got.shape != want.shape or got.dtype != want.dtype:
            raise AssertionError(f"{what}: {got.shape}/{got.dtype} vs "
                                 f"{want.shape}/{want.dtype}")
        if exact:
            if not np.array_equal(got, want):
                raise AssertionError(f"{what}: {int((got != want).sum())} "
                                     "cells differ")
            return 0.0
        diff = np.abs(got - want)
        if not (np.isfinite(got).all() and (diff <= FLOAT_TOL["atol"] + (
                FLOAT_TOL["rtol"] * np.abs(want))).all()):
            raise AssertionError(f"{what}: max |served - run| = "
                                 f"{float(diff.max())}")
        return float(diff.max())

    def check_results(res, reqs, refs, what):
        errs = {}
        for q, out in zip(reqs, res):
            if out.status != "ok" or out.steps_done != q.steps:
                raise AssertionError(f"{what}/{q.rid}: {out.status} at "
                                     f"{out.steps_done}: {out.error}")
            want = refs[q.seed]
            snaps = dict(out.snapshots)
            if sorted(snaps) != sorted(want)[:-1]:
                raise AssertionError(f"{what}/{q.rid}: snapshots at "
                                     f"{sorted(snaps)}")
            exact = q.workload.dtype != torch.float32
            errs[q.rid] = max(
                [max_err(out.state, want[q.steps], exact, what)]
                + [max_err(v, want[step], exact, f"{what}@{step}")
                   for step, v in snaps.items()])
        return errs

    def counts(*names):
        return {n: sum(mm.value for mm in reg.metrics() if mm.name == n)
                for n in names}

    with tempfile.TemporaryDirectory(prefix="squeeze-serving-") as tmp:
        # -- the six requests, served clean
        base = dict(max_batch=4, backoff_base_s=0.01, backoff_cap_s=0.05)
        svc = FractalService(ServiceConfig(
            ckpt_dir=f"{tmp}/clean", hang_threshold_s=10 * SERVE_HANG_S,
            **base), runner)
        clean_reqs = requests("clean")
        clean, clean_s = serve(svc, clean_reqs)
        batches = counts("serve.batches", "serve.joins")
        max_batch = reg.get("serve.batch_size", kind="cuda-fused").max
        recovery = counts("serve.retries", "serve.restarts",
                          "serve.recoveries")
        if any(recovery.values()) or max_batch != 4:
            raise AssertionError(f"serving/clean: recovery {recovery}, "
                                 f"largest cuda-fused batch {max_batch}")
        refs = {q.seed: uninterrupted(q) for q in clean_reqs}
        clean_errs = check_results(clean, clean_reqs, refs, "serving/clean")
        save_h = reg.get("checkpoint.save_seconds")
        emit("serving", fractal=frac.name, r=r, m=m,
             state_bytes=int(refs[0][48].nbytes), seconds=clean_s,
             latency_s={q.rid: o.latency_s for q, o in zip(clean_reqs,
                                                          clean)},
             queue_wait_s={q.rid: o.queue_wait_s
                           for q, o in zip(clean_reqs, clean)},
             snapshots={q.rid: len(o.snapshots)
                        for q, o in zip(clean_reqs, clean)},
             max_abs_err=clean_errs, largest_cuda_fused_batch=max_batch,
             checkpoint_saves=save_h.count,
             checkpoint_save_seconds_mean=save_h.mean, **batches)

        # -- the same requests under chaos, one bucket at a time so the
        #    segment indices of the faults are the cuda-fused bucket's; the
        #    runner is warm (kernels built, engines cached), so a batch
        #    size's first segment gets no more time than any other
        obs.reset()
        inj = FaultInjector([
            Fault("corrupt", at_segment=1, target_rid="chaos-0"),
            Fault("exception", at_segment=2),
            Fault("stall", at_segment=5, stall_s=SERVE_STALL_S)])
        svc = FractalService(ServiceConfig(
            ckpt_dir=f"{tmp}/chaos", hang_threshold_s=SERVE_HANG_S,
            compile_grace_s=SERVE_HANG_S, max_inflight=1, **base), runner,
            injector=inj)
        chaos_reqs = requests("chaos")
        chaos, chaos_s = serve(svc, chaos_reqs)
        if not inj.all_fired():
            raise AssertionError(f"serving/chaos: faults not fired "
                                 f"{inj.pending()}")
        chaos_errs = check_results(chaos, chaos_reqs, refs, "serving/chaos")
        got = counts("serve.retries", "serve.restarts", "serve.recoveries",
                     "checkpoint.fallbacks", "checkpoint.corrupt",
                     "watchdog.hangs")
        want = {"serve.retries": 1, "serve.restarts": 1,
                "serve.recoveries": 2, "checkpoint.fallbacks": 1,
                "checkpoint.corrupt": 1, "watchdog.hangs": 1}
        if got != want:
            raise AssertionError(f"serving/chaos: counts {got}, injected "
                                 f"{want}")
        rec = reg.get("serve.recovery_seconds", kind="cuda-fused")
        recovery_s = rec.mean
        emit("serving_chaos", seconds=chaos_s, injected=inj.log, **got,
             recovery_seconds_mean=recovery_s, recovery_seconds_max=rec.max,
             hang_threshold_s=SERVE_HANG_S, stall_s=SERVE_STALL_S,
             max_abs_err=chaos_errs,
             latency_s={q.rid: o.latency_s
                        for q, o in zip(chaos_reqs, chaos)})

        # -- a checkpoint of one LIFE state, saved and restored
        state = clean[0].state
        mgr = CheckpointManager(f"{tmp}/one")
        t = time.perf_counter()
        mgr.save(1, {"state": state})
        save_s = time.perf_counter() - t
        t = time.perf_counter()
        back = mgr.restore({"state": state})["state"]
        restore_s = time.perf_counter() - t
        if not np.array_equal(back, state):
            raise AssertionError("serving: checkpoint round trip differs")

        # -- elastic: 4 shards, a device lost at a launch, 2 shards on
        e = ELASTIC
        ref_eng = make_engine("cuda-fused", frac, r, m, workload=R.LIFE)
        want_el = ref_eng.run(ref_eng.init_random(e["seed"]), e["steps"])
        inj = FaultInjector([Fault("device_loss", at_segment=e["lost_at"],
                                   shard=1)])
        with ElasticDistributedRunner(
                lay, n_shards=DIST_SHARDS, workload=R.LIFE,
                compute="fused", ckpt_dir=f"{tmp}/elastic",
                ckpt_every=e["ckpt_every"],
                launch_timeout_s=10 * SERVE_HANG_S, backoff_base_s=0.01,
                backoff_cap_s=0.05, injector=inj) as el:
            t = time.perf_counter()
            out = el.run(e["steps"], seed=e["seed"])
            synchronize(out)
            elastic_s = time.perf_counter() - t
            got_el = el.engine.to_dense(out)
            st = el.stats
            if el.n_shards != DIST_SHARDS // 2 or st.reshards != 1 or \
                    not torch.equal(got_el, want_el):
                raise AssertionError(
                    f"serving/elastic: {el.n_shards} shards, {st}, equal "
                    f"{torch.equal(got_el, want_el)}")
        emit("serving_elastic", shards_before=DIST_SHARDS,
             shards_after=el.n_shards, steps=e["steps"],
             seconds=elastic_s, reshard_recovery_seconds=st.recovery_seconds,
             launches=st.launches, restores=st.restores,
             checkpoints=st.checkpoints, max_abs_err=float(
                 (got_el.double() - want_el.double()).abs().max()))

        # -- the service's time a step beside the runner's, one bucket:
        #    four LIFE requests of 64 steps, no snapshots or checkpoints
        steps = 64
        timing = [SimRequest(frac=frac, r=r, m=m, kind="cuda-fused",
                             seed=s, steps=steps, rid=f"time-{s}")
                  for s in range(4)]
        svc = FractalService(ServiceConfig(
            hang_threshold_s=10 * SERVE_HANG_S, **base), runner)
        svc.serve(timing)            # warm: the batch of four
        obs.reset()
        t = time.perf_counter()
        res = svc.serve(timing)
        serve_s = time.perf_counter() - t
        if not all(o.ok for o in res):
            raise AssertionError("serving/timing: a request failed")
        seg = reg.get("watchdog.step_seconds", watchdog="serve")
        bucket = timing[0].bucket
        eng = runner.engine_for(bucket, frac=frac, workload=R.LIFE)
        states = torch.stack([eng.init_random(q.seed) for q in timing])
        runner.run(bucket, states=states, steps=steps, frac=frac)
        synchronize(states)
        t = time.perf_counter()
        ran = runner.run(bucket, states=states, steps=steps, frac=frac)
        synchronize(ran)
        run_s = time.perf_counter() - t
        for q, o in zip(timing, res):
            if not np.array_equal(o.state, ran[q.seed].cpu().numpy()):
                raise AssertionError(f"serving/timing: {q.rid} differs")

    deltas = {k: v - launches0.get(k, 0) for k, v in build.LAUNCHES.items()
              if v != launches0.get(k, 0)}
    grew = {"v3 or v4": deltas.get("stencil_step_fused", 0)
            + deltas.get("stencil_step_fused_k", 0),
            "v5": deltas.get("stencil_step_mxu_batched", 0),
            "kernel 6": deltas.get("stencil_step_fused_k_local", 0)}
    if not all(grew.values()):
        raise AssertionError(f"serving: kernels not launched {grew}")
    if shared_layout.cache_info().misses != misses:
        raise AssertionError("serving: a new r=16 layout was built")
    emit("serving_numbers", card=nvidia_smi(), launches=deltas,
         kernels_grew=grew, batch=4, steps=steps,
         service_seconds=serve_s, service_ms_per_step=1e3 * serve_s / steps,
         service_segment_ms_per_step=1e3 * seg.sum / steps,
         runner_ms_per_step=1e3 * run_s / steps,
         checkpoint_save_seconds=save_s,
         checkpoint_restore_seconds=restore_s,
         checkpoint_state_bytes=int(state.nbytes),
         recovery_seconds_mean=recovery_s,
         reshard_recovery_seconds=st.recovery_seconds[0])
    obs.enable(was_enabled)
    del runner, svc, ref_eng, want_el, got_el, out, el, eng, states, ran
    torch.cuda.empty_cache()


def phase_tuning(torch, F, shared_layout, build):
    """Phase 18: the autotuner at the main path's full width (module
    docstring, item 18)."""
    import os

    from repro_torch import obs
    from repro_torch.tuning import (EngineSpec, TuningTable,
                                    reset_default_table_cache, tune_spec)
    from repro_torch.tuning.measure import measured_bandwidth_gbs
    from repro_torch.core.stencil import make_engine

    t_phase = time.perf_counter()
    name, r, m = TUNE_MAIN
    misses = shared_layout.cache_info().misses
    lay = shared_layout(F.REGISTRY[name], r, m)
    launches0 = dict(build.LAUNCHES)
    gbs = measured_bandwidth_gbs()
    emit("tuning_bandwidth", card=nvidia_smi(), bandwidth_gbs=gbs,
         copy_bytes=1 << 30, share_of_3350=gbs / (HBM_BYTES_PER_S / 1e9))

    specs = [EngineSpec("cuda-fused", 2, name, r, m, "life"),
             EngineSpec("cuda-mxu", 2, name, r, m, "life"),
             EngineSpec("dist-fused", 2, name, r, m, "life",
                        mesh_shape=(TUNE_SHARDS,))]
    table = TuningTable(meta={"generator": "chip_smoke.py phase 18",
                              "card": nvidia_smi()})
    for spec in specs:
        t0 = time.perf_counter()
        res = tune_spec(spec, steps=TUNE_STEPS, rounds=TUNE_ROUNDS, seed=0)
        if res.parity_failures:
            raise AssertionError(f"tuning/{spec.kind}: candidates "
                                 f"{res.parity_failures} differ from the "
                                 "heuristic engine")
        table.put(res.spec, res.entry())
        emit("tuning_sweep", kind=spec.kind, rho=lay.rho,
             n_blocks=lay.n_blocks, steps=TUNE_STEPS, rounds=TUNE_ROUNDS,
             ms_per_step={k: 1e3 * v for k, v in res.times.items()},
             best=res.best.label, baseline=res.baseline.label,
             speedup=res.speedup, roofline_ms=1e3 * res.roofline_s,
             suspect=res.suspect, candidates=len(res.times),
             seconds=time.perf_counter() - t0)
        del res
        torch.cuda.empty_cache()

    # the winners as the active table: make_engine with k left None hits it
    path = build.BUILD_DIR.parent / "tuning" / "phase18.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    table.save(str(path))
    prev_env = os.environ.get("SQUEEZE_TUNING_TABLE")
    was_enabled = obs.enabled()
    os.environ["SQUEEZE_TUNING_TABLE"] = str(path)
    reset_default_table_cache()
    obs.enable(True)
    obs.reset()
    hits = {}
    try:
        for spec in specs:
            entry = table.get(spec)
            eng = make_engine(spec)
            hits[spec.kind] = obs.default_registry().value(
                "engine.tune.hit", kind=spec.kind)
            if hits[spec.kind] != 1:
                raise AssertionError(f"tuning/{spec.kind}: "
                                     f"{hits[spec.kind]} table hits")
            got = (eng.fusion_k, getattr(eng, "macro_p", None),
                   getattr(eng, "exchange", "auto"))
            want = (entry.fusion_k, lay.macro_tiles(
                entry.fusion_k, p=entry.macro_p)[0] if spec.is_mxu else None,
                entry.exchange)
            if got != want:
                raise AssertionError(f"tuning/{spec.kind}: engine knobs "
                                     f"{got}, table {want}")
            base = make_engine(spec, table=None)
            out = eng.run(eng.init_random(7), TUNE_HIT_STEPS)
            ref = base.run(base.init_random(7), TUNE_HIT_STEPS)
            if spec.is_dist:
                out, ref = eng.to_dense(out), base.to_dense(ref)
            if not torch.equal(out, ref):
                raise AssertionError(f"tuning/{spec.kind}: the table's "
                                     "engine differs from the heuristic's")
            emit("tuning_hit", kind=spec.kind, table=entry.to_json(),
                 engine={"fusion_k": got[0], "macro_p": got[1],
                         "exchange": got[2]},
                 heuristic={"fusion_k": base.fusion_k,
                            "macro_p": getattr(base, "macro_p", None),
                            "exchange": getattr(base, "exchange", "auto")},
                 steps=TUNE_HIT_STEPS, bit_for_bit=True)
            del eng, base, out, ref
    finally:
        if prev_env is None:
            os.environ.pop("SQUEEZE_TUNING_TABLE", None)
        else:
            os.environ["SQUEEZE_TUNING_TABLE"] = prev_env
        reset_default_table_cache()
        obs.enable(was_enabled)

    deltas = {k: v - launches0.get(k, 0) for k, v in build.LAUNCHES.items()
              if v != launches0.get(k, 0)}
    grew = {"v3 or v4": deltas.get("stencil_step_fused", 0)
            + deltas.get("stencil_step_fused_k", 0),
            "v5": sum(v for k, v in deltas.items()
                      if k.startswith("stencil_step_mxu_batched")),
            "kernel 6": deltas.get("stencil_step_fused_k_local", 0)}
    if not all(grew.values()):
        raise AssertionError(f"tuning: kernels not launched {grew}")
    if shared_layout.cache_info().misses != misses:
        raise AssertionError("tuning: a new r=16 layout was built")
    emit("tuning_numbers", card=nvidia_smi(), hits=hits, launches=deltas,
         kernels_grew=grew, table=table.to_json()["entries"],
         seconds=time.perf_counter() - t_phase)
    del lay
    torch.cuda.empty_cache()


def _lm_within(torch, what, got, want, rtol, atol) -> float:
    """max |got - want|, raising where |got - want| > atol + rtol |want|
    or ``got`` is not finite."""
    got, want = got.double().cpu(), want.double().cpu()
    if got.shape != want.shape or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{what}: shape {tuple(got.shape)} against "
                             f"{tuple(want.shape)}, or non-finite values")
    diff = (got - want).abs()
    if bool((diff > atol + rtol * want.abs()).any()):
        raise AssertionError(f"{what}: max |card - cpu| = {float(diff.max())}")
    return float(diff.max())


def _lm_replay(torch, lm, model, cfg, batch, toks, start, max_len, device,
               mesh=None):
    """Prefill, then one decode step a column of ``toks`` (B, n): the
    logits before each fed token and after the last, (B, n + 1, V);
    ``mesh``: the model split over it."""
    cache = lm.init_cache(cfg, toks.shape[0], max_len, device, mesh=mesh)
    last, cache, extras = lm.prefill(model, batch, cfg, cache, mesh=mesh)
    out = [last]
    for i in range(toks.shape[1]):
        last, cache = lm.decode_step(model, toks[:, i:i + 1].to(device),
                                     start + i, cfg, cache, extras=extras,
                                     mesh=mesh)
        out.append(last)
    return torch.stack(out, dim=1)


def decode_param_bytes(model, cfg, batch: int) -> int:
    """Bytes of the parameters one decode step reads, as stored: every
    decoder parameter once, B rows of an untied token table or of a
    learned position table, no encoder parameter."""
    total = 0
    for name, p in model.named_parameters():
        if name.startswith("enc_"):
            continue
        if name == "embed.pos_embed" or (name == "embed.tok_embed"
                                         and not cfg.tie_embeddings):
            total += batch * p.shape[1] * p.element_size()
        else:
            total += p.numel() * p.element_size()
    return total


def device_event_us(events) -> float:
    """Microseconds of work on the card among ``torch.profiler`` events:
    the events that ran there (kernels, copies, memsets), each once. The
    host op that launched a kernel carries that kernel's time as its own
    device time too, so summing every event counts each kernel twice;
    user annotations on the device span kernels as well."""
    from torch.autograd import DeviceType
    return float(sum(ev.self_device_time_total for ev in events
                     if ev.device_type == DeviceType.CUDA
                     and not ev.is_user_annotation))


def _device_busy_ms(torch, fn):
    """(wall ms of ``fn()`` ending in a synchronize, ms of device work in
    it) from ``torch.profiler``; device time None where the profiler
    shows none."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    busy_us = device_event_us(prof.events())
    return wall, (busy_us / 1e3 if busy_us > 0 else None)


def _kernel_ms(torch, fn):
    """ms of work on the card in ``fn()`` (ending in a synchronize), from
    a ``torch.profiler`` trace of the card alone: a host trace of the
    sharded path's ~10^5 operations a step takes longer to read than the
    step takes to run. None where the profiler shows no device time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    busy_us = device_event_us(prof.events())
    return busy_us / 1e3 if busy_us > 0 else None


def phase_lm_serve(torch, build):
    """Phase 19: the language-model serving path (module docstring, item
    19). No hand-written kernel is on it: the reference's models call no
    Pallas kernel, and the phase asserts that the port's launch none."""
    import dataclasses
    import importlib.util

    import numpy as np

    from repro_torch import configs
    from repro_torch.launch.serve import BatchServer, Request
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import model as lm

    t_phase = time.perf_counter()
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    rtol, atol = LM_TOL
    card = nvidia_smi()
    build.reset_launches()

    def on_cpu(model, cfg):
        twin = lm.build_model(cfg, cpu, None)
        twin.load_state_dict(model.state_dict())
        return twin

    def to(batch, dev):
        return {k: v.to(dev) for k, v in batch.items()}

    # (a) every arch at its smoke config: card against CPU -------------------
    sm = LM_SMOKE
    smoke = {}
    with torch.no_grad():
        for i, arch in enumerate(configs.ARCHS):
            t0 = time.perf_counter()
            cfg = configs.get_smoke_config(arch)
            model = lm.init_params(100 + i, cfg, device=cuda)
            twin = on_cpu(model, cfg)
            rng = np.random.default_rng(i)
            toks = torch.from_numpy(rng.integers(
                0, cfg.vocab, (sm["batch"], sm["prompt"] + sm["decode"])
            ).astype(np.int32))
            batch = {"tokens": toks[:, :sm["prompt"]]}
            if cfg.family == "encdec":
                batch["frames"] = torch.from_numpy(rng.standard_normal(
                    (sm["batch"], cfg.enc_seq, cfg.d_model)
                ).astype(np.float32))
            fed = toks[:, sm["prompt"]:]
            got = _lm_replay(torch, lm, model, cfg, to(batch, cuda), fed,
                             sm["prompt"], sm["max_len"], cuda)
            want = _lm_replay(torch, lm, twin, cfg, batch, fed, sm["prompt"],
                              sm["max_len"], cpu)
            err = _lm_within(torch, f"lm {arch} prefill + decode", got, want,
                             rtol, atol)
            run = dict(max_new=sm["new"], max_len=sm["max_len"])
            g_card = lm.generate(model, to(batch, cuda), cfg, **run).cpu()
            g_cpu = lm.generate(twin, batch, cfg, **run)
            # a near tie in the CPU's own greedy trajectory (two largest
            # logits within the bar) excuses that step's token and later
            traj = _lm_replay(torch, lm, twin, cfg, batch, g_cpu,
                              sm["prompt"], sm["max_len"], cpu)[:, :-1]
            top2 = traj.topk(2, dim=-1).values
            tied = ((top2[..., 0] - top2[..., 1]) <= atol).any(dim=0)
            upto = int(tied.nonzero()[0, 0]) if bool(tied.any()) \
                else sm["new"]
            if not torch.equal(g_card[:, :upto], g_cpu[:, :upto]):
                raise AssertionError(f"lm {arch}: greedy tokens differ, card "
                                     f"{g_card.tolist()} cpu "
                                     f"{g_cpu.tolist()}")
            smoke[arch] = dict(max_abs_err=err, greedy_steps_equal=upto,
                               greedy_all_equal=bool(torch.equal(g_card,
                                                                 g_cpu)),
                               seconds=time.perf_counter() - t0)
            emit("lm_smoke", arch=arch, **smoke[arch])
            del model, twin

    # (b) full width, float32: card against CPU ---------------------------
    t_full = time.perf_counter()
    arch, b, s, bar = LM_FULL_F32
    cfg = dataclasses.replace(configs.get_config(arch), dtype="float32")
    with torch.no_grad():
        model = lm.init_params(7, cfg, device=cuda)
        twin = on_cpu(model, cfg)
        toks = torch.from_numpy(np.random.default_rng(7).integers(
            0, cfg.vocab, (b, s)).astype(np.int32))
        full = _lm_within(torch, f"lm {arch} f32 forward",
                          lm.forward(model, {"tokens": toks.to(cuda)}, cfg)[0],
                          lm.forward(twin, {"tokens": toks}, cfg)[0], 0.0, bar)
        last = [lm.prefill(m, {"tokens": toks.to(dev)}, cfg,
                           lm.init_cache(cfg, b, s, dev))[0]
                for m, dev in ((model, cuda), (twin, cpu))]
        pre = _lm_within(torch, f"lm {arch} f32 prefill", *last, 0.0, bar)
    full_f32 = dict(arch=arch, batch=b, seq=s, forward_max_abs_err=full,
                    prefill_max_abs_err=pre, bar=bar,
                    params=sum(p.numel() for p in model.parameters()),
                    seconds=time.perf_counter() - t_full)
    emit("lm_full_f32", **full_f32)
    del model, twin
    torch.cuda.empty_cache()

    # (c) full width, the config's bf16: served through BatchServer -------
    served = {}
    for arch, prompts, new in LM_SERVE:
        t_model = time.perf_counter()
        cfg = configs.get_config(arch)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        held_before = torch.cuda.memory_allocated()
        model = lm.init_params(0, cfg, device=cuda)
        rng = np.random.default_rng(0)
        prompt_np = [rng.integers(0, cfg.vocab, size=n).astype(np.int32)
                     for n in prompts]
        server = BatchServer(cfg, model)
        outs, serve_s = [], []
        for _ in range(2):
            reqs = [Request(prompt=p, max_new=new) for p in prompt_np]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            server.serve(reqs)
            serve_s.append(time.perf_counter() - t0)
            outs.append(np.stack([r.out for r in reqs]))
        if not np.array_equal(outs[0], outs[1]):
            raise AssertionError(f"lm {arch}: two greedy runs differ")
        if not ((outs[0] >= 0) & (outs[0] < cfg.vocab_padded)).all():
            raise AssertionError(f"lm {arch}: a token outside the logits")
        # prefill and decode timed apart, as the server runs them
        b, s_max = len(prompts), max(prompts)
        toks = np.zeros((b, s_max), np.int32)
        for j, p in enumerate(prompt_np):
            toks[j, s_max - len(p):] = p
        batch = {"tokens": torch.from_numpy(toks).to(cuda)}
        state = {}

        def prefill():
            state["cache"] = lm.init_cache(cfg, b, s_max + new, cuda)
            state["last"], state["cache"], _ = lm.prefill(
                model, batch, cfg, state["cache"])

        def decode(steps=new):
            last, cache = state["last"], state["cache"]
            for i in range(steps):
                tok = torch.argmax(last, dim=-1).to(torch.int32)[:, None]
                last, cache = lm.decode_step(model, tok, s_max + i, cfg,
                                             cache)

        pre_ms, dec_ms = [], []
        with torch.no_grad():
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                prefill()
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                decode()
                torch.cuda.synchronize()
                pre_ms.append(1e3 * (t1 - t0))
                dec_ms.append(1e3 * (time.perf_counter() - t1) / new)
            prefill()
            wall, busy = _device_busy_ms(
                torch, lambda: decode(LM_PROFILE_STEPS))
        read = decode_param_bytes(model, cfg, b)
        served[arch] = dict(
            batch=b, prompts=list(prompts), new=new, dtype=cfg.dtype,
            params=sum(p.numel() for p in model.parameters()),
            prefill_ms=sorted(pre_ms)[1], prefill_ms_runs=pre_ms,
            decode_ms_per_token=sorted(dec_ms)[1], decode_ms_runs=dec_ms,
            serve_s=serve_s, tokens_per_s=b * new / serve_s[1],
            decode_tokens_per_s=1e3 * b / sorted(dec_ms)[1],
            # the phases before leave tensors on the card (layouts): the
            # peak less what was allocated before the model is the
            # model's own
            max_memory_allocated=torch.cuda.max_memory_allocated(),
            allocated_before=held_before,
            peak_bytes=torch.cuda.max_memory_allocated() - held_before,
            decode_param_bytes=read,
            decode_bound_ms=1e3 * read / HBM_BYTES_PER_S,
            profiled_steps=LM_PROFILE_STEPS, profiled_decode_wall_ms=wall,
            decode_kernel_ms_per_token=None if busy is None
            else busy / LM_PROFILE_STEPS,
            # kernel time (profiled) over the unprofiled decode time: the
            # profiler's own host cost would inflate the wall time
            device_busy_share=None if busy is None
            else busy / LM_PROFILE_STEPS / sorted(dec_ms)[1],
            tokens_at_or_past_vocab=int((outs[0] >= cfg.vocab).sum()),
            first_tokens=outs[0][:, :8].tolist(), card=card,
            seconds=time.perf_counter() - t_model)
        emit("lm_serve_model", arch=arch, **served[arch])
        del model, server, state, batch
        torch.cuda.empty_cache()

    # (d) one long forward through the chunked attention ------------------
    arch, b, s = LM_LONG
    cfg = configs.get_config(arch)
    if s * s <= attn_mod._CHUNK_THRESHOLD:
        raise AssertionError("the long forward would not take the chunked "
                             "attention")
    calls = []
    plain_chunked = attn_mod._sdpa_chunked

    def counted(*args, **kw):
        calls.append(1)
        return plain_chunked(*args, **kw)

    with torch.no_grad():
        model = lm.init_params(0, cfg, device=cuda)
        toks = torch.from_numpy(np.random.default_rng(4).integers(
            0, cfg.vocab, (b, s)).astype(np.int32)).to(cuda)
        attn_mod._sdpa_chunked = counted
        try:
            times = []
            for _ in range(2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                logits = lm.forward(model, {"tokens": toks}, cfg)[0]
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
        finally:
            attn_mod._sdpa_chunked = plain_chunked
        finite = bool(torch.isfinite(logits).all())
    if not finite or len(calls) != 2 * cfg.n_layers:
        raise AssertionError(f"lm {arch} S={s}: finite {finite}, chunked "
                             f"attention calls {len(calls)}")
    long = dict(arch=arch, batch=b, seq=s, seconds=times,
                chunked_calls=len(calls) // 2, logits=list(logits.shape),
                card=card)
    emit("lm_long_forward", **long)
    del model, logits
    torch.cuda.empty_cache()
    lm_launches = sum(build.LAUNCHES.values())
    if lm_launches:
        raise AssertionError(f"the LM path launched hand-written kernels: "
                             f"{build.LAUNCHES}")

    # (e) the examples, on the card ---------------------------------------
    examples = {}
    root = Path(__file__).resolve().parent / "examples" / "torch"
    for path in sorted(root.glob("*.py")):
        build.reset_launches()
        spec = importlib.util.spec_from_file_location(
            f"example_{path.stem}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        t0 = time.perf_counter()
        mod.main([])
        torch.cuda.synchronize()
        examples[path.stem] = dict(
            seconds=time.perf_counter() - t0,
            launches={k: v for k, v in build.LAUNCHES.items() if v})
        emit("lm_example", name=path.stem, **examples[path.stem])
        torch.cuda.empty_cache()
    if len(examples) != 8:
        raise AssertionError(f"examples run: {sorted(examples)}")
    emit("lm_serve", card=card, smoke=smoke, full_f32=full_f32,
         served=served, long_forward=long, lm_kernel_launches=lm_launches,
         examples=examples, seconds=time.perf_counter() - t_phase)


def _seeded_moments(torch, state, named, seed):
    """Non-zero float32 moments from a CPU generator (a step from zero
    moments moves every parameter by +-lr, whatever its gradient's size,
    so it would compare the signs of gradients that are rounding noise)."""
    gen = torch.Generator().manual_seed(seed)
    for n, p in named.items():
        state["m"][n].copy_(1e-3 * torch.randn(p.shape, generator=gen))
        state["v"][n].copy_(1e-6 * torch.rand(p.shape, generator=gen) + 1e-8)
    return state


def _train_batch(torch, np, cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal(
            (b, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    if cfg.n_patches:
        batch["prefix_embeds"] = rng.standard_normal(
            (b, cfg.n_patches, cfg.d_model)).astype(np.float32)
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _train_run_figures(torch, res, cfg, b, s, held_before, card):
    """Median ms a step past the warm-up, tokens/s, the FLOP share and the
    peak memory the run added, from a ``TrainResult``."""
    times = sorted(res.step_seconds[LM_TRAIN_WARMUP:] or res.step_seconds)
    med = times[len(times) // 2]
    n = cfg.param_count()
    return dict(batch=b, seq=s, steps=res.step, step_ms=1e3 * med,
                step_ms_runs=[1e3 * t for t in res.step_seconds],
                tokens_per_s=b * s / med, params=n,
                step_flops=6.0 * n * b * s,
                flop_share=6.0 * n * b * s / (med * PEAK_BF16_FLOPS),
                loss_first5=sum(res.losses[:5]) / len(res.losses[:5]),
                loss_last5=sum(res.losses[-5:]) / len(res.losses[-5:]),
                losses=res.losses,
                max_memory_allocated=torch.cuda.max_memory_allocated(),
                allocated_before=held_before,
                peak_bytes=torch.cuda.max_memory_allocated() - held_before,
                card=card)


def phase_lm_train(torch, build):
    """Phase 20: the language-model training path (module docstring, item
    20). No hand-written kernel is on it, and the phase asserts that none
    launches."""
    import os
    import tempfile

    import numpy as np

    from repro_torch import configs
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.data.pipeline import SyntheticMarkov
    from repro_torch.launch import specs
    from repro_torch.launch import train as train_mod
    from repro_torch.models import model as lm
    from repro_torch.optim import adamw
    from repro_torch.runtime.fault import run_with_restarts

    t_phase = time.perf_counter()
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    card = nvidia_smi()
    build.reset_launches()

    # (a) every arch's smoke step, card against CPU -----------------------
    rtol, atol = LM_STEP_TOL
    ocfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=0, total_steps=10)
    cases = [(a, 1) for a in configs.ARCHS] + [(a, 4) for a in LM_STEP_ACCUM]
    steps = {}
    for i, (arch, accum) in enumerate(cases):
        t0 = time.perf_counter()
        cfg = configs.get_smoke_config(arch)
        on_card = lm.init_params(300 + i, cfg, device=cuda)
        on_cpu = lm.build_model(cfg, cpu, None)
        on_cpu.load_state_dict(on_card.state_dict())
        step = specs.make_train_step(cfg, ocfg, accum_steps=accum)
        batch = _train_batch(torch, np, cfg, LM_STEP["batch"],
                             LM_STEP["seq"], i)
        out = []
        for model, dev in ((on_card, cuda), (on_cpu, cpu)):
            named = dict(model.named_parameters())
            state = _seeded_moments(torch, adamw.init(ocfg, named), named, i)
            _, state, metrics = step(model, state,
                                     {k: v.to(dev) for k, v in batch.items()})
            out.append((model, state, metrics))
        (_, s_card, m_card), (_, s_cpu, m_cpu) = out
        errs = {k: _lm_within(torch, f"lm train {arch} x{accum} {k}",
                              m_card[k], m_cpu[k], rtol, atol)
                for k in ("loss", "grad_norm", "lr")}
        worst = {"params": 0.0, "m": 0.0, "v": 0.0}
        for n, p in on_cpu.named_parameters():
            got = on_card.get_parameter(n).detach()
            worst["params"] = max(worst["params"], _lm_within(
                torch, f"lm train {arch} x{accum} {n}", got, p.detach(),
                rtol, atol))
            for key in ("m", "v"):
                worst[key] = max(worst[key], _lm_within(
                    torch, f"lm train {arch} x{accum} {key} {n}",
                    s_card[key][n], s_cpu[key][n], rtol, atol))
        steps[f"{arch} x{accum}"] = dict(
            max_abs_err={**errs, **worst}, loss=float(m_card["loss"]),
            seconds=time.perf_counter() - t0)
        emit("lm_train_step", arch=arch, accum_steps=accum,
             **steps[f"{arch} x{accum}"])
        del on_card, on_cpu, out, s_card, s_cpu
    torch.cuda.empty_cache()

    # (b) smollm-135m at full width through the CLI -----------------------
    cli = []
    for argv in LM_TRAIN_CLI:
        t0 = time.perf_counter()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        res = train_mod.main(["--arch", "smollm-135m"] + argv)
        torch.cuda.synchronize()
        args = dict(zip(argv[::2], argv[1::2]))
        b, s = int(args.get("--batch", 8)), int(args.get("--seq", 256))
        row = _train_run_figures(torch, res, configs.get_config(
            "smollm-135m"), b, s, held, card)
        row.update(argv=argv, seconds=time.perf_counter() - t0)
        cli.append(row)
        emit("lm_train_cli", **row)
    # one step of the CLI's defaults under the profiler: the device's busy
    # share (each kernel once) over the unprofiled step time
    cfg = configs.get_config("smollm-135m")
    model = lm.init_params(0, cfg, device=cuda)
    named = dict(model.named_parameters())
    state = {"s": adamw.init(ocfg, named)}
    step = specs.make_train_step(cfg, adamw.AdamWConfig(warmup_steps=20,
                                                        total_steps=50))
    data = SyntheticMarkov(vocab=cfg.vocab, seq_len=256, global_batch=8)
    batches = [{k: torch.from_numpy(v).to(cuda)
                for k, v in data.batch(j).items()} for j in range(6)]

    def one(j):
        _, state["s"], metrics = step(model, state["s"], batches[j])
        return float(metrics["loss"])

    walls = []
    for j in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one(j)
        walls.append(1e3 * (time.perf_counter() - t0))
    step_ms = sorted(walls[2:])[1]
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        one(5)
        torch.cuda.synchronize()
    from torch.autograd import DeviceType
    events = prof.events()
    busy_ms = device_event_us(events) / 1e3
    kernels = sum(1 for ev in events if ev.device_type == DeviceType.CUDA
                  and not ev.is_user_annotation)
    profiled = dict(step_ms=step_ms, step_ms_runs=walls,
                    kernel_ms=busy_ms or None,
                    device_busy_share=busy_ms / step_ms if busy_ms else None,
                    device_events=kernels, card=card)
    emit("lm_train_profile", **profiled)
    del model, named, state, batches
    torch.cuda.empty_cache()

    # (c) kill, restart, resume: bit for bit ------------------------------
    t0 = time.perf_counter()
    cfg = configs.get_smoke_config("smollm-135m")
    rs = LM_RESTART
    rcfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=2,
                             total_steps=rs["steps"], weight_decay=0.0)
    data = SyntheticMarkov(vocab=cfg.vocab, seq_len=16, global_batch=2,
                           seed=3)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    calls = []
    try:
        with tempfile.TemporaryDirectory() as tmp:
            clean, broken = f"{tmp}/clean", f"{tmp}/broken"
            full = train_mod.train(cfg, rcfg, data, steps=rs["steps"],
                                   ckpt_dir=clean,
                                   ckpt_every=rs["ckpt_every"], log_every=0)

            def run():
                calls.append(1)
                return train_mod.train(
                    cfg, rcfg, data, steps=rs["steps"], ckpt_dir=broken,
                    ckpt_every=rs["ckpt_every"], log_every=0,
                    fail_at=rs["fail_at"] if len(calls) == 1 else None)

            resumed = run_with_restarts(lambda: run().step, max_restarts=2)
            named = dict(lm.build_model(cfg, cpu, None).named_parameters())
            like = {"params": named, "opt": adamw.init(rcfg, named)}
            want = CheckpointManager(clean).restore(like)["params"]
            got = CheckpointManager(broken).restore(like)["params"]
            differ = sorted(n for n in named
                            if not np.array_equal(got[n], want[n]))
            resumed_from = CheckpointManager(broken).all_steps()
    finally:
        torch.use_deterministic_algorithms(was)
    if resumed != rs["steps"] or len(calls) != 2 or differ:
        raise AssertionError(f"lm restart: final step {resumed}, attempts "
                             f"{len(calls)}, parameters that differ {differ}")
    restart = dict(steps=rs["steps"], ckpt_every=rs["ckpt_every"],
                   failed_after=rs["fail_at"], attempts=len(calls),
                   bit_exact=True, params=len(named),
                   checkpoints_kept=resumed_from, losses=full.losses,
                   seconds=time.perf_counter() - t0)
    emit("lm_train_restart", **restart)

    # (d) gemma2-2b and mamba2-780m at full width -------------------------
    wide = {}
    for arch, b, s, n_steps in LM_TRAIN_FULL:
        t0 = time.perf_counter()
        cfg = configs.get_config(arch)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        data = SyntheticMarkov(vocab=cfg.vocab, seq_len=s, global_batch=b)
        res = train_mod.train(cfg, adamw.AdamWConfig(warmup_steps=1,
                                                     total_steps=n_steps),
                              data, steps=n_steps, log_every=0)
        torch.cuda.synchronize()
        if not all(np.isfinite(res.losses)):
            raise AssertionError(f"lm train {arch}: losses {res.losses}")
        wide[arch] = dict(
            batch=b, seq=s, steps=n_steps, losses=res.losses,
            step_ms_runs=[1e3 * t for t in res.step_seconds],
            step_ms=1e3 * sorted(res.step_seconds)[len(res.step_seconds)
                                                    // 2],
            params=cfg.param_count(),
            flop_share=6.0 * cfg.param_count() * b * s / (
                sorted(res.step_seconds)[len(res.step_seconds) // 2]
                * PEAK_BF16_FLOPS),
            max_memory_allocated=torch.cuda.max_memory_allocated(),
            allocated_before=held,
            peak_bytes=torch.cuda.max_memory_allocated() - held,
            card=card, seconds=time.perf_counter() - t0)
        emit("lm_train_full", arch=arch, **wide[arch])
        torch.cuda.empty_cache()

    launches = sum(build.LAUNCHES.values())
    if launches:
        raise AssertionError(f"the LM training path launched hand-written "
                             f"kernels: {build.LAUNCHES}")
    emit("lm_train", card=card, steps=steps, cli=cli, profile=profiled,
         restart=restart, full_width=wide, lm_kernel_launches=launches,
         seconds=time.perf_counter() - t_phase)


def _padded(np, prompts, vocab, seed):
    """Ragged prompts from a seed, and the left-padded (B, S) batch
    ``BatchServer`` makes of them."""
    rng = np.random.default_rng(seed)
    rows = [rng.integers(0, vocab, size=n).astype(np.int32)
            for n in prompts]
    batch = np.zeros((len(rows), max(prompts)), np.int32)
    for i, r in enumerate(rows):
        batch[i, batch.shape[1] - len(r):] = r
    return rows, batch


def _sharded_bytes(spmd, tree, n):
    """Each of the n positions' resident bytes of a tree of ``Sharded``."""
    return [spmd.resident_bytes(tree, p) for p in range(n)]


def _tensor_bytes(tree) -> int:
    """Bytes of the tensors of nested dicts and lists."""
    if isinstance(tree, dict):
        return sum(_tensor_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_tensor_bytes(v) for v in tree)
    return 0 if tree is None else tree.numel() * tree.element_size()


def _parted(np, want, have, gaps, bar):
    """The requests whose sharded tokens part from the unsharded ones, each
    where its unsharded top-2 logits lie within twice ``bar`` (a near
    tie), else raise."""
    parted = []
    for r in range(want.shape[0]):
        diff = np.nonzero(want[r] != have[r])[0]
        if diff.size:
            at = int(diff[0])
            gap = float(gaps[r, at])
            if gap > 2 * bar:
                raise AssertionError(f"request {r} parts at token {at}, "
                                     f"top-2 gap {gap}")
            parted.append(dict(request=r, token=at, top2_gap=gap))
    return parted


def _mesh_of(shape):
    """A local (data, model) mesh of ``shape`` on the card."""
    from repro_torch.launch.mesh import make_local_mesh
    return make_local_mesh(shape[1], shape[0])


def _within(what, got, want, bar, scale=1.0) -> float:
    """max |got - want|, raising where it passes ``bar`` x ``scale``."""
    err = float((got.detach().double() - want.double()).abs().max())
    if not err <= bar * scale:
        raise AssertionError(f"{what}: {err} > {bar} x {scale}")
    return err


def _smoke_step(torch, cfg, shape, model_seed: int, seed: int,
                what: str) -> dict:
    """One ``make_train_step`` step of a smoke config on the card, split
    over a (data, model) mesh of ``shape`` and unsplit, from the same
    seeded weights, non-zero moments and (8, 32) batch: the loss and grad
    norm within ``LM_SHARD_TOL`` relative, every parameter absolute, every
    moment against its leaf's largest entry (else raise) -> the errors,
    the loss, the collectives' elements and the seconds."""
    import numpy as np

    from repro_torch.launch import specs
    from repro_torch.models import model as lm
    from repro_torch.optim import adamw
    from repro_torch.runtime import spmd

    t0 = time.perf_counter()
    tol = LM_SHARD_TOL
    ocfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=0, total_steps=4,
                             weight_decay=0.0)
    cuda = torch.device("cuda")
    mesh = _mesh_of(shape)
    model = lm.init_params(model_seed, cfg, device=cuda)
    named = dict(model.named_parameters())
    state = _seeded_moments(torch, adamw.init(ocfg, named), named, seed)
    sharded = lm.shard_model(model, mesh)
    s_state = specs.place_opt_state(state, sharded.specs, mesh)
    batch = {k: v.to(cuda) for k, v in _train_batch(
        torch, np, cfg, 8, 32, seed).items()}
    _, state, m_u = specs.make_train_step(cfg, ocfg)(model, state, batch)
    spmd.reset_counts()
    sharded, s_state, m_s = specs.make_train_step(cfg, ocfg, mesh=mesh)(
        sharded, s_state, batch)
    moved = spmd.counts()
    errs = {k: _within(f"{what} {k}", m_s[k], m_u[k], tol["loss"],
                       abs(float(m_u[k])))
            for k in ("loss", "grad_norm")}
    worst = {"params": 0.0, "m": 0.0, "v": 0.0}
    for n, p in sharded.named_parameters():
        worst["params"] = max(worst["params"], _within(
            f"{what} {n}", p.full(), named[n].detach(), tol["params"]))
        for key in ("m", "v"):
            want = state[key][n]
            worst[key] = max(worst[key], _within(
                f"{what} {key} {n}", s_state[key][n].full(), want,
                tol["moments"], float(want.abs().max())))
    return dict(max_abs_err={**errs, **worst}, loss=float(m_s["loss"]),
                elements_moved=moved, seconds=time.perf_counter() - t0)


def _smoke_serve(torch, cfg, model_seed: int, seed: int, what: str) -> dict:
    """A smoke config served through ``BatchServer`` on the card on
    ``LM_SHARD_SMOKE``'s ragged prompts, unsplit and split over each of
    ``LM_SHARD_MESHES``: the tokens equal, and the logits of prefill and of
    each decode step fed the unsplit tokens within ``LM_SHARD_TOL``'s
    (else raise) -> the errors by mesh and the seconds."""
    import numpy as np

    from repro_torch.launch.serve import BatchServer, Request
    from repro_torch.models import model as lm

    t0 = time.perf_counter()
    sm = LM_SHARD_SMOKE
    cuda = torch.device("cuda")
    with torch.no_grad():
        model = lm.init_params(model_seed, cfg, device=cuda)
        rows, padded = _padded(np, sm["prompts"], cfg.vocab, seed)
        batch = {"tokens": torch.from_numpy(padded).to(cuda)}
        start = padded.shape[1]
        if cfg.n_patches:
            batch["prefix_embeds"] = torch.randn(
                (len(rows), cfg.n_patches, cfg.d_model),
                generator=torch.Generator().manual_seed(seed)).to(cuda)
            start += cfg.n_patches
        if cfg.family == "encdec":   # the frames BatchServer sends
            batch["frames"] = torch.zeros(
                (len(rows), cfg.enc_seq, cfg.d_model), device=cuda)

        def requests():
            return [Request(prompt=r, max_new=sm["new"]) for r in rows]

        want = np.stack([r.out for r in BatchServer(
            cfg, model, max_len=sm["max_len"]).serve(requests())])
        fed = torch.from_numpy(want)
        ref = _lm_replay(torch, lm, model, cfg, batch, fed, start,
                         sm["max_len"], cuda)
        row = {}
        for shape in LM_SHARD_MESHES:
            m = _mesh_of(shape)
            split = lm.shard_model(model, m)
            got = np.stack([r.out for r in BatchServer(
                cfg, split, max_len=sm["max_len"], mesh=m).serve(
                    requests())])
            if not np.array_equal(got, want):
                raise AssertionError(f"{what} {shape}: tokens {got} "
                                     f"against {want}")
            row["x".join(map(str, shape))] = _within(
                f"{what} {shape} logits", _lm_replay(
                    torch, lm, split, cfg, batch, fed, start,
                    sm["max_len"], cuda, mesh=m), ref,
                LM_SHARD_TOL["logits"])
    return dict(max_abs_err=row, tokens_equal=True,
                seconds=time.perf_counter() - t0)


def phase_lm_sharded(torch, build):
    """Phase 21: the language-model path sharded over a local mesh in one
    process (module docstring, item 21). No hand-written kernel is on it,
    and the phase asserts that none launches."""
    import dataclasses

    import numpy as np

    from repro_torch import configs
    from repro_torch.data.pipeline import SyntheticMarkov
    from repro_torch.launch import dryrun, specs
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.serve import BatchServer, Request
    from repro_torch.models import model as lm
    from repro_torch.optim import adamw
    from repro_torch.runtime import spmd

    t_phase = time.perf_counter()
    cuda = torch.device("cuda")
    card = nvidia_smi()
    build.reset_launches()

    def pinned(cfg):
        if cfg.moe is None:
            return cfg
        return dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, dispatch_groups=4))

    # (a) the sharded-equality cases on the card ----------------------------
    steps = {}
    for i, (arch, seq_shard) in enumerate(LM_SHARD_STEPS):
        cfg = dataclasses.replace(pinned(configs.get_smoke_config(arch)),
                                  seq_shard=seq_shard)
        name = f"{arch}{' seq_shard' if seq_shard else ''}"
        steps[name] = dict(mesh="4x2", **_smoke_step(
            torch, cfg, (4, 2), 400 + i, i, f"lm sharded {arch}"))
        emit("lm_sharded_step", arch=arch, seq_shard=seq_shard,
             **steps[name])

    served = {}
    for j, arch in enumerate(LM_SHARD_ARCHS):
        cfg = pinned(configs.get_smoke_config(arch))
        served[arch] = _smoke_serve(torch, cfg, 500 + j, j,
                                    f"lm sharded {arch}")
        emit("lm_sharded_serve_smoke", arch=arch, **served[arch])
    torch.cuda.empty_cache()

    # (b) tinyllama-1.1b at full width on a (2, 4) mesh ----------------------
    fw = LM_SHARD_FULL
    arch, mesh = fw["arch"], _mesh_of(fw["mesh"])
    plan = dryrun.run_cell(arch, "train_4k", mesh)
    scfg = specs.serve_config(configs.get_config(arch))
    rows, padded = _padded(np, fw["prompts"], scfg.vocab, 21)
    batch = {"tokens": torch.from_numpy(padded).to(cuda)}
    start = padded.shape[1]

    def requests():
        return [Request(prompt=r, max_new=fw["new"]) for r in rows]

    def decode_figures(params, m):
        """Prefill ms, then a timed decode loop and the same loop under the
        profiler: ms a token on the host's clock and on the card's."""
        n = fw["decode_timed"]
        with torch.no_grad():
            cache = lm.init_cache(scfg, len(rows), fw["max_len"], cuda,
                                  mesh=m)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            last, cache, _ = lm.prefill(params, batch, scfg, cache, mesh=m)
            torch.cuda.synchronize()
            prefill_ms = 1e3 * (time.perf_counter() - t0)
            box = {"last": last, "cache": cache, "at": start}

            def loop():
                for _ in range(n):
                    tok = torch.argmax(box["last"], dim=-1).to(
                        torch.int32)[:, None]
                    box["last"], box["cache"] = lm.decode_step(
                        params, tok, box["at"], scfg, box["cache"], mesh=m)
                    box["at"] += 1

            spmd.reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loop()
            torch.cuda.synchronize()
            token_ms = 1e3 * (time.perf_counter() - t0) / n
            moved = {k: v / n for k, v in spmd.counts().items()}
            busy = _kernel_ms(torch, loop)
        device_ms = busy / n if busy else None
        return dict(prefill_ms=prefill_ms, ms_per_token=token_ms,
                    device_ms_per_token=device_ms,
                    host_ms_per_token=(token_ms - device_ms
                                       if device_ms else None),
                    elements_moved_per_token=moved)

    t0 = time.perf_counter()
    model = lm.init_params(21, scfg, device=cuda)
    runs = {}
    for label, m in (("unsharded", None), ("sharded", mesh)):
        params = model if m is None else lm.shard_model(model, m)
        server = BatchServer(scfg, params, max_len=fw["max_len"], mesh=m)
        if m is None:   # warms the card's kernels for both runs
            server.serve(requests())
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        t1 = time.perf_counter()
        out = np.stack([r.out for r in server.serve(requests())])
        serve_s = time.perf_counter() - t1
        runs[label] = dict(tokens=out, serve_seconds=serve_s,
                           tokens_per_s=out.size / serve_s,
                           peak_bytes=torch.cuda.max_memory_allocated()
                           - held, **decode_figures(params, m))
        if m is not None:
            runs[label]["resident_param_bytes"] = _sharded_bytes(
                spmd, dict(params.named_parameters()), m.size)
        runs[label]["params"] = params
    # the prompts and the unsharded tokens in one forward: the logits
    # that picked each generated token
    seq = {"tokens": torch.cat([batch["tokens"], torch.from_numpy(
        runs["unsharded"]["tokens"]).to(cuda)], dim=1)}
    with torch.no_grad():
        ref = lm.forward(model, seq, scfg)[0][:, start - 1:-1]
        got = lm.forward(runs["sharded"]["params"], seq, scfg,
                         mesh=mesh)[0][:, start - 1:-1]
    logit_err = _within("lm sharded serve logits", got, ref,
                       LM_SHARD_BF16_LOGITS)
    top2 = ref.float().topk(2, dim=-1).values
    gaps = top2[..., 0] - top2[..., 1]
    parted = _parted(np, runs["unsharded"]["tokens"],
                     runs["sharded"]["tokens"], gaps, LM_SHARD_BF16_LOGITS)
    for label in runs:
        runs[label].pop("params")
        runs[label]["tokens"] = runs[label]["tokens"].tolist()
    serve = dict(arch=arch, mesh="2x4", dtype=scfg.dtype,
                 prompts=list(fw["prompts"]), new=fw["new"],
                 tokens_equal=not parted, parted=parted,
                 max_logit_err=logit_err,
                 min_top2_gap=float(gaps.min()), runs=runs, card=card,
                 seconds=time.perf_counter() - t0)
    emit("lm_sharded_serve", **serve)
    del model, ref, got
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    tcfg = dataclasses.replace(configs.get_config(arch), dtype="float32")
    tocfg = adamw.AdamWConfig(lr=3e-4, warmup_steps=2,
                              total_steps=fw["steps"])
    data = SyntheticMarkov(vocab=tcfg.vocab, seq_len=fw["seq"],
                           global_batch=fw["batch"])
    trains = {}
    for label, m in (("unsharded", None), ("sharded", mesh)):
        norms = []
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        spmd.reset_counts()
        res = train_mod.train(
            tcfg, tocfg, data, steps=fw["steps"], log_every=0, mesh=m,
            on_step=lambda _s, met: norms.append(float(met["grad_norm"])))
        torch.cuda.synchronize()
        times = sorted(res.step_seconds[2:])
        trains[label] = dict(
            losses=res.losses, grad_norms=norms,
            step_ms=1e3 * times[len(times) // 2],
            step_ms_runs=[1e3 * t for t in res.step_seconds],
            peak_bytes=torch.cuda.max_memory_allocated() - held,
            elements_moved_per_step={k: v / fw["steps"]
                                     for k, v in spmd.counts().items()},
            result=res)
    u, s_ = trains["unsharded"]["result"], trains["sharded"]["result"]
    tt = LM_SHARD_TRAIN_TOL
    fails = []
    for key, got, want in (("loss", s_.losses, u.losses),
                           ("grad_norm", trains["sharded"]["grad_norms"],
                            trains["unsharded"]["grad_norms"])):
        rel = [abs(a - b) / abs(b) for a, b in zip(got, want)]
        trains[f"{key}_rel_err"] = rel
        if not (rel[0] <= tt["first"] and max(rel) <= tt[key]):
            fails.append(f"{key}: {got} against {want}")
    worst, loose = 0.0, 0
    with torch.no_grad():
        for n, p in s_.model.named_parameters():
            want = u.model.get_parameter(n)
            diff = (p.full() - want).abs()
            worst = max(worst, float(diff.max() / want.abs().max()))
            loose += int((diff > 1e-5).sum())
    if not worst <= tt["params"]:
        fails.append(f"a parameter leaf {worst} of its largest entry apart")
    n_pos = mesh.size
    resident = dict(
        params=_sharded_bytes(spmd, dict(s_.model.named_parameters()),
                              n_pos),
        opt=_sharded_bytes(spmd, s_.opt_state, n_pos))
    planned = dict(params=plan["params_bytes"], opt=plan["opt_bytes"])
    if any(b != planned[k] for k, v in resident.items() for b in v):
        fails.append(f"resident bytes {resident} against the dry run's "
                     f"{planned}")
    # one more step of each under the profiler: its device time, and the
    # host's the rest of the unprofiled step
    batch_t = {k: torch.from_numpy(v).to(cuda)
               for k, v in data.batch(fw["steps"]).items()}
    for label, res, m in (("unsharded", u, None), ("sharded", s_, mesh)):
        step = specs.make_train_step(tcfg, tocfg, mesh=m)
        state = {"s": res.opt_state}

        def one():
            _, state["s"], met = step(res.model, state["s"], batch_t)
            float(met["loss"])

        busy = _kernel_ms(torch, one)
        trains[label].update(
            device_ms_per_step=busy,
            host_ms_per_step=(trains[label]["step_ms"] - busy
                              if busy else None))
        trains[label].pop("result")
    del u, s_, res, state
    train_row = dict(arch=arch, mesh="2x4", dtype=tcfg.dtype,
                     batch=fw["batch"], seq=fw["seq"], steps=fw["steps"],
                     params_max_rel_err=worst, params_over_1e5=loose,
                     resident_bytes=resident, planned_bytes=planned,
                     runs=trains, card=card,
                     seconds=time.perf_counter() - t0)
    emit("lm_sharded_train", **train_row)
    if fails:
        raise AssertionError(f"lm sharded train: {fails}")
    torch.cuda.empty_cache()

    # (c) the cards of this host -----------------------------------------
    cards = torch.cuda.device_count()
    multi = dict(device_count=cards)
    if cards >= 2:
        t0 = time.perf_counter()
        model_axis = cards if scfg.n_kv_heads % cards == 0 else 1
        m = make_local_mesh(model_axis)
        model = lm.init_params(21, scfg, device=cuda)
        want = np.stack([r.out for r in BatchServer(
            scfg, model, max_len=fw["max_len"]).serve(requests())])
        got = np.stack([r.out for r in BatchServer(
            scfg, model, max_len=fw["max_len"], mesh=m).serve(requests())])
        multi.update(mesh="x".join(map(str, m.sizes)),
                     tokens_equal=bool(np.array_equal(got, want)),
                     seconds=time.perf_counter() - t0)
        del model
    else:
        multi.update(skipped="one card: the positions of a local mesh all "
                             "share it")
    emit("lm_sharded_cards", **multi)

    launches = sum(build.LAUNCHES.values())
    if launches:
        raise AssertionError(f"the sharded LM path launched hand-written "
                             f"kernels: {build.LAUNCHES}")
    emit("lm_sharded", card=card, steps=steps, serve_smoke=served,
         serve=serve, train=train_row, cards=multi,
         lm_kernel_launches=launches, seconds=time.perf_counter() - t_phase)


def phase_lm_sharded_families(torch, build):
    """Phase 22: the rec, ssm and encdec families sharded over a local
    mesh in one process (module docstring, item 22). No hand-written
    kernel is on it, and the phase asserts that none launches."""
    import dataclasses

    import numpy as np

    from repro_torch import configs
    from repro_torch.launch import dryrun, specs
    from repro_torch.models import model as lm
    from repro_torch.optim import adamw
    from repro_torch.runtime import spmd

    t_phase = time.perf_counter()
    cuda = torch.device("cuda")
    card = nvidia_smi()
    build.reset_launches()

    def frames_of(cfg, rows, seed):
        return torch.randn((rows, cfg.enc_seq, cfg.d_model),
                           generator=torch.Generator().manual_seed(seed))

    # (a) the smoke configs against the unsharded card run -----------------
    cases = [(a, shape, False) for a in LM_FAMILIES
             for shape in LM_SHARD_MESHES]
    cases += [(a, (4, 2), True) for a in LM_FAMILIES_SEQ]
    steps = {}
    for i, (arch, shape, seq_shard) in enumerate(cases):
        cfg = dataclasses.replace(configs.get_smoke_config(arch),
                                  seq_shard=seq_shard)
        label = "x".join(map(str, shape))
        name = f"{arch} {label}{' seq_shard' if seq_shard else ''}"
        steps[name] = _smoke_step(torch, cfg, shape, 600 + i, i,
                                  f"lm families {arch}")
        emit("lm_families_step", arch=arch, mesh=label, seq_shard=seq_shard,
             **steps[name])

    served = {}
    for j, arch in enumerate(LM_FAMILIES):
        served[arch] = _smoke_serve(torch, configs.get_smoke_config(arch),
                                    700 + j, 20 + j, f"lm families {arch}")
        emit("lm_families_serve_smoke", arch=arch, **served[arch])
    torch.cuda.empty_cache()

    # (b) full width on a (2, 4) mesh beside the unsharded run --------------
    mesh = _mesh_of(LM_FAMILIES_MESH)
    n_pos = mesh.size
    full = {}
    for k, (arch, fw) in enumerate(LM_FAMILIES_FULL.items()):
        t_arch = time.perf_counter()
        scfg = specs.serve_config(configs.get_config(arch))
        rows, padded = _padded(np, fw["prompts"], scfg.vocab, 22 + k)
        batch = {"tokens": torch.from_numpy(padded).to(cuda)}
        if scfg.family == "encdec":
            batch["frames"] = frames_of(scfg, len(rows), 22 + k).to(
                cuda, getattr(torch, scfg.dtype))
        start = padded.shape[1]
        max_len = start + fw["new"]

        def figures(params, m):
            """Prefill ms, then a timed greedy decode loop and the same
            loop under a card-only profiler trace: ms a token on the host's
            clock and on the card's; the collectives' elements a token;
            each position's cache bytes."""
            n = LM_FAMILIES_DECODE_TIMED
            with torch.no_grad():
                cache = lm.init_cache(scfg, len(rows), max_len, cuda,
                                      mesh=m)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                last, cache, extras = lm.prefill(params, batch, scfg, cache,
                                                 mesh=m)
                torch.cuda.synchronize()
                prefill_ms = 1e3 * (time.perf_counter() - t0)
                box = {"last": last, "cache": cache, "at": start}

                def loop(count):
                    for _ in range(count):
                        tok = torch.argmax(box["last"], dim=-1).to(
                            torch.int32)[:, None]
                        box["last"], box["cache"] = lm.decode_step(
                            params, tok, box["at"], scfg, box["cache"],
                            extras=extras, mesh=m)
                        box["at"] += 1

                spmd.reset_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                loop(n)
                torch.cuda.synchronize()
                token_ms = 1e3 * (time.perf_counter() - t0) / n
                moved = {key: v / n for key, v in spmd.counts().items()}
                # one token under the trace: a sharded token launches
                # ~10^4 kernels, and reading their events costs seconds
                busy = _kernel_ms(torch, lambda: loop(1))
            out = dict(prefill_ms=prefill_ms, ms_per_token=token_ms,
                       device_ms_per_token=busy,
                       host_ms_per_token=token_ms - busy if busy else None,
                       elements_moved_per_token=moved)
            if m is not None:
                out["cache_bytes"] = [_tensor_bytes(c)
                                      for c in box["cache"].positions]
                mem = extras.get("memory_kv")
                if mem is not None:
                    out["memory_kv_bytes"] = [_tensor_bytes(c)
                                              for c in mem.positions]
            return out

        def serve(params, m):
            with torch.no_grad():
                return lm.generate(params, batch, scfg, max_new=fw["new"],
                                   max_len=max_len, mesh=m).cpu().numpy()

        t0 = time.perf_counter()
        model = lm.init_params(22 + k, scfg, device=cuda)
        runs = {}
        for label, m in (("unsharded", None), ("sharded", mesh)):
            if m is not None:
                # the unsharded model's logits on its own greedy
                # trajectory, then its place on the card to the split
                seq = {"tokens": torch.cat([batch["tokens"], torch.from_numpy(
                    runs["unsharded"]["tokens"]).to(cuda)], dim=1)}
                if "frames" in batch:
                    seq["frames"] = batch["frames"]
                with torch.no_grad():
                    ref = lm.forward(model, seq, scfg)[0][:, start - 1:-1]
                params = lm.shard_model(model, m)
                del model
            else:
                params = model
                serve(params, m)   # warms the card's kernels for both runs
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
            t1 = time.perf_counter()
            out = serve(params, m)
            serve_s = time.perf_counter() - t1
            runs[label] = dict(tokens=out, serve_seconds=serve_s,
                               tokens_per_s=out.size / serve_s,
                               peak_bytes=torch.cuda.max_memory_allocated()
                               - held, **figures(params, m))
            if m is not None:
                runs[label]["resident_param_bytes"] = _sharded_bytes(
                    spmd, dict(params.named_parameters()), n_pos)
        with torch.no_grad():
            got = lm.forward(params, seq, scfg, mesh=mesh)[0][:, start - 1:-1]
        del params
        torch.cuda.empty_cache()
        # the same weights (their bf16 values) computing in float32: how
        # far each bf16 run's rounding takes its logits; the two bf16 runs
        # round in different places, so they may lie twice the unsharded
        # run's own distance apart
        fcfg = dataclasses.replace(scfg, param_dtype="float32",
                                   dtype="float32")
        exact = lm.init_params(22 + k, fcfg, device=cuda)
        with torch.no_grad():
            for p in exact.parameters():
                p.copy_(p.to(torch.bfloat16))
            f32 = lm.forward(exact, seq, fcfg)[0][:, start - 1:-1]
        del exact
        torch.cuda.empty_cache()
        rounding = dict(unsharded=float((ref - f32).abs().max()),
                        sharded=float((got - f32).abs().max()))
        bar = max(LM_SHARD_BF16_LOGITS, 2 * rounding["unsharded"])
        logit_err = _within(f"lm families {arch} serve logits", got, ref,
                            bar)
        top2 = ref.float().topk(2, dim=-1).values
        gaps = top2[..., 0] - top2[..., 1]
        parted = _parted(np, runs["unsharded"]["tokens"],
                         runs["sharded"]["tokens"], gaps, bar)
        # each position's bytes against the dry run's plan
        plan = dryrun.run_cell(arch, "decode_32k", mesh)
        meta = lm.init_cache(scfg, len(rows), max_len, lm.META)
        planned = dict(params=plan["params_bytes"],
                       cache=dryrun.planned_bytes(
                           meta, specs.cache_shardings(meta, scfg, mesh),
                           mesh))
        resident = dict(params=runs["sharded"].pop("resident_param_bytes"),
                        cache=runs["sharded"].pop("cache_bytes"))
        if scfg.family == "encdec":
            shape = (len(rows), scfg.enc_seq, scfg.n_kv_heads,
                     scfg.head_dim_)
            meta_kv = {"memory_kv": [
                {key: torch.empty(shape, dtype=getattr(torch, scfg.dtype),
                                  device=lm.META) for key in ("k", "v")}
                for _ in range(scfg.n_units)]}
            planned["memory_kv"] = dryrun.planned_bytes(
                meta_kv, specs.cache_shardings(meta_kv, scfg, mesh), mesh)
            resident["memory_kv"] = runs["sharded"].pop("memory_kv_bytes")
        if any(b != planned[key] for key, v in resident.items() for b in v):
            raise AssertionError(f"lm families {arch}: resident bytes "
                                 f"{resident} against the plan {planned}")
        for label in runs:
            runs[label]["tokens"] = runs[label]["tokens"].tolist()
        row = dict(arch=arch, mesh="x".join(map(str, LM_FAMILIES_MESH)),
                   dtype=scfg.dtype, prompts=list(fw["prompts"]),
                   new=fw["new"], tokens_equal=not parted, parted=parted,
                   max_logit_err=logit_err, logit_bar=bar,
                   bf16_rounding=rounding,
                   min_top2_gap=float(gaps.min()), runs=runs,
                   resident_bytes=resident, planned_bytes=planned,
                   card=card, seconds=time.perf_counter() - t0)
        emit("lm_families_serve", **row)
        full[arch] = {"serve": row}
        del ref, got, seq, f32
        torch.cuda.empty_cache()

        if "train" not in fw:
            full[arch]["seconds"] = time.perf_counter() - t_arch
            continue
        t0 = time.perf_counter()
        b, s, n_steps = fw["train"]
        tcfg = dataclasses.replace(configs.get_config(arch),
                                   dtype="float32")
        tocfg = adamw.AdamWConfig(lr=3e-4, warmup_steps=2,
                                  total_steps=n_steps)
        model = lm.init_params(32 + k, tcfg, device=cuda)
        named = dict(model.named_parameters())
        # seeded non-zero moments, as in (a): from zero moments Adam's
        # first steps move each parameter by lr times the sign of its
        # gradient, and an entry whose gradient is rounding noise moves
        # apart by 2 lr (mamba2's out_proj entries are ~lr in size)
        state = adamw.init(tocfg, named)
        gen = torch.Generator(device=cuda).manual_seed(50 + k)
        for n in named:
            state["m"][n].normal_(0.0, 1e-3, generator=gen)
            state["v"][n].uniform_(1e-8, 1e-6 + 1e-8, generator=gen)
        split = lm.shard_model(model, mesh)
        s_state = specs.place_opt_state(state, split.specs, mesh)
        batches = [{key: v.to(cuda) for key, v in _train_batch(
            torch, np, tcfg, b, s, 40 + k + i).items()}
            for i in range(n_steps)]
        trains = {}
        for label, m, params, st in (("unsharded", None, model, state),
                                     ("sharded", mesh, split, s_state)):
            step = specs.make_train_step(tcfg, tocfg, mesh=m)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
            spmd.reset_counts()
            box = {"state": st, "losses": [], "norms": []}

            def one(i):
                _, box["state"], met = step(params, box["state"], batches[i])
                box["losses"].append(float(met["loss"]))
                box["norms"].append(float(met["grad_norm"]))

            secs = []
            for i in range(n_steps - 1):
                t1 = time.perf_counter()
                one(i)
                secs.append(time.perf_counter() - t1)
            # the last step under a card-only trace: its device time
            busy = _kernel_ms(torch, lambda: one(n_steps - 1))
            moved = {key: v / n_steps for key, v in spmd.counts().items()}
            peak = torch.cuda.max_memory_allocated() - held
            times = sorted(secs[1:] or secs)   # past the first step
            step_ms = 1e3 * times[len(times) // 2]
            trains[label] = dict(
                losses=box["losses"], grad_norms=box["norms"],
                step_ms=step_ms, step_ms_runs=[1e3 * t for t in secs],
                device_ms_per_step=busy,
                host_ms_per_step=step_ms - busy if busy else None,
                peak_bytes=peak, elements_moved_per_step=moved)
            if m is not None:
                trains[label]["bytes"] = dict(
                    params=_sharded_bytes(
                        spmd, dict(params.named_parameters()), n_pos),
                    opt=_sharded_bytes(spmd, box["state"], n_pos))
            box.clear()
        del state, s_state, st
        tt = LM_SHARD_TRAIN_TOL
        fails = []
        u, sh = trains["unsharded"], trains["sharded"]
        for key in ("losses", "grad_norms"):
            rel = [abs(x - y) / abs(y) for x, y in zip(sh[key], u[key])]
            trains[f"{key}_rel_err"] = rel
            bar = tt["loss" if key == "losses" else "grad_norm"]
            if not (rel[0] <= tt["first"] and max(rel) <= bar):
                fails.append(f"{key}: {sh[key]} against {u[key]}")
        worst, worst_leaf = 0.0, None
        with torch.no_grad():
            for n, p in split.named_parameters():
                want = model.get_parameter(n)
                err = float((p.full() - want).abs().max()
                            / want.abs().max().clamp_min(1e-30))
                if err > worst:
                    worst, worst_leaf = err, n
        if not worst <= tt["params"]:
            fails.append(f"parameter leaf {worst_leaf} {worst} of its "
                         f"largest entry apart")
        plan = dryrun.run_cell(arch, "train_4k", mesh)
        planned = dict(params=plan["params_bytes"], opt=plan["opt_bytes"])
        resident = sh.pop("bytes")
        if any(v != planned[key] for key, vs in resident.items()
               for v in vs):
            fails.append(f"resident bytes {resident} against the dry run's "
                         f"{planned}")
        train_row = dict(arch=arch, mesh="x".join(map(str, LM_FAMILIES_MESH)),
                         dtype=tcfg.dtype, batch=b, seq=s, steps=n_steps,
                         params_max_rel_err=worst, params_worst=worst_leaf,
                         resident_bytes=resident,
                         planned_bytes=planned, runs=trains, card=card,
                         seconds=time.perf_counter() - t0)
        emit("lm_families_train", **train_row)
        if fails:
            raise AssertionError(f"lm families {arch} train: {fails}")
        full[arch]["train"] = train_row
        full[arch]["seconds"] = time.perf_counter() - t_arch
        del model, split, batches
        torch.cuda.empty_cache()

    launches = sum(build.LAUNCHES.values())
    if launches:
        raise AssertionError(f"the sharded LM families launched hand-written "
                             f"kernels: {build.LAUNCHES}")
    emit("lm_families", card=card, steps=steps, serve_smoke=served,
         full={a: {"seconds": v["seconds"]} for a, v in full.items()},
         lm_kernel_launches=launches, seconds=time.perf_counter() - t_phase)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: no port package under {SRC}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.core import fractals as F
    from repro_torch.core import maps as M
    from repro_torch.core import fractals3d as F3
    from repro_torch.core import compact3d as c3
    from repro_torch.core.compact import (BlockLayout, compact_meshgrid,
                                          expanded_to_compact, shared_layout)
    from repro_torch.core.distributed import make_distributed_engine
    from repro_torch.core.stencil import default_fusion_k, make_engine
    from repro_torch.kernels import build
    from repro_torch.kernels import lambda_map as lm
    from repro_torch.kernels import nu_map as nm
    from repro_torch.kernels import squeeze_stencil as sk
    from repro_torch.kernels import squeeze_stencil3d as k3
    from repro_torch.kernels import attention as ta
    from repro_torch.kernels import ssd_chunk as ts
    from repro_torch.models import ssm as tssm
    from repro_torch.workloads.base import halo_needs
    from repro_torch.workloads import BatchedRunner
    from repro_torch.workloads import rules as R
    from repro_torch.tuning.spec import EngineSpec

    if sys.argv[1:]:
        print(f"chip_smoke: unknown arguments {sys.argv[1:]}",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    # the plain versions' float32 products in full float32, not TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = nvidia_smi()
    name = torch.cuda.get_device_name(0)
    print(card, flush=True)
    emit("device", nvidia_smi=card, name=name,
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)

    # 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    built = build.build_all()
    emit("build", seconds=time.perf_counter() - t0,
         sources={n: {"path": v["path"], "nvcc_seconds": v["seconds"],
                      "ptxas": ptxas_summary(v["log"])}
                  for n, v in built.items()})
    mxu_regs = mxu_registers(built["squeeze_stencil"]["log"])
    fused_regs = fused_registers(built["squeeze_stencil"]["log"])
    nu_regs = instance_registers(built["squeeze_maps"]["log"], "nu_kernel")
    lambda_regs = instance_registers(built["squeeze_maps"]["log"],
                                     "lambda_kernel")
    ssd_regs = {name: instance_registers(built["ssd_chunk"]["log"], name)
                for name in ("lower_cb_kernel", "ssd_kernel")}
    regs3 = stencil3d_registers(built["squeeze_stencil3d"]["log"])

    chk = Checker(torch)

    # 3. kernels against plain ------------------------------------------
    phase_kernels_vs_plain(torch, chk, F, R, BlockLayout, sk, halo_needs)
    phase_fused_bodies_vs_plain(torch, chk, F, R, BlockLayout, sk, False)
    phase_single_bodies_vs_plain(torch, chk, F, R, BlockLayout, sk)
    phase_maps_vs_plain(torch, chk, F, nm, lm)

    # 4. the main path at the paper's size --------------------------------
    frac, r, m = F.SIERPINSKI, 16, 2
    t0 = time.perf_counter()
    lay = shared_layout(frac, r, m)
    k = default_fusion_k(lay.rho)
    _ = lay.neighbor_table, lay.window_mask(k), lay.window_mask(1)
    emit("layout", fractal=frac.name, r=r, m=m, n_blocks=lay.n_blocks,
         compact_cells=frac.volume(r), host_seconds=time.perf_counter() - t0)
    runner = BatchedRunner()
    life_states = runner.init_batch("cuda-mxu", frac, r, [0, 1, 2, 3], m=m,
                                    workload=R.LIFE)
    heat_states = runner.init_batch("cuda-mxu", frac, r, [4, 5], m=m,
                                    workload=R.HEAT)
    fused = {wl.name: make_engine("cuda-fused", frac, r, m, workload=wl)
             for wl in (R.LIFE, R.GRAY_SCOTT)}
    fused_init = {n: e.init_random(6) for n, e in fused.items()}
    cuda_eng = make_engine("cuda", frac, r, m, workload=R.LIFE)
    cuda_init = cuda_eng.init_random(7)
    singles = {(kind, wl.name): make_engine(kind, frac, r, m, workload=wl,
                                            fusion_k=1)
               for kind in ("cuda-strips", "cuda-blocks", "cuda-fused")
               for wl in (R.LIFE, R.HEAT)}
    single_init = {n: singles[("cuda-strips", n)].init_random(8)
                   for n in ("life", "heat")}
    cell = make_engine("cell", frac, r, workload=R.LIFE)
    cell_init = expanded_to_compact(frac, r, lay.to_expanded(
        fused_init["life"]))
    # upload the tables now, so the timed runs below cover stepping only
    lay.device_table("neighbor_table", "cuda")
    lay.device_table("micro_mask", "cuda")
    for kk in (1, k):
        lay.device_table("window_mask", "cuda", kk)

    timed = [
        ("runner cuda-mxu life", lambda: runner.run(
            "cuda-mxu", frac, r, life_states, 64, m=m, workload=R.LIFE),
         64, 4),
        ("runner cuda-mxu heat", lambda: runner.run(
            "cuda-mxu", frac, r, heat_states, 64, m=m, workload=R.HEAT),
         64, 2)]
    timed += [(f"cuda-fused {n}", lambda n=n: fused[n].run(
        fused_init[n], 63), 63, 1) for n in fused]
    timed.append(("cuda life", lambda: cuda_eng.run(cuda_init, 63), 63, 1))
    timed += [(f"{kind} k1 {n}", lambda e=e, n=n: e.run(single_init[n], 16),
               16, 1) for (kind, n), e in singles.items()]
    # one untimed warm-up run each: the engine's ping-pong buffers and
    # the runner's batch come from the caching allocator in the timed run
    for _, fn, _, _ in timed:
        fn()
    torch.cuda.synchronize()

    sk.reset_launches()
    runs = []

    def drive(label, fn, steps, batch):
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        sec = time.perf_counter() - t
        runs.append(dict(run=label, steps=steps, batch=batch, seconds=sec,
                         ms_per_step=1e3 * sec / steps,
                         cells_per_s=batch * frac.volume(r) * steps / sec))
        return out
    outs = {label: drive(label, fn, steps, batch)
            for label, fn, steps, batch in timed}
    t = time.perf_counter()
    _ = cell._gathers   # one lambda and 8 nu launches
    torch.cuda.synchronize()
    cell_index_seconds = time.perf_counter() - t
    out_cell = drive("cell life", lambda: cell.run(cell_init, 4), 4, 1)
    launches = dict(sk.LAUNCHES)
    expect = dict.fromkeys(launches, 0)   # every other kernel: none
    expect.update({"stencil_step_mxu_batched": 64 // k * 2,
                   "stencil_step_fused_k": 63 // k * 3,
                   "stencil_step_fused": 63 % k * 2 + 16 * 2,
                   "stencil_step_strips": 63 % k + 16 * 2,
                   "gather_halo_strips": 63 % k + 16 * 2,
                   "stencil_step_blocks": 16 * 2,
                   "lambda_map_tc": 1, "nu_map_tc": 8})
    if launches != expect:
        raise AssertionError(f"launches {launches}, expected {expect}")

    def plain_run(wl, state, steps):
        eng = make_engine("block", frac, r, m, workload=wl, fusion_k=k)
        return eng.run(state, steps)
    checks = {}
    max_abs_plain = {}

    def check(label, kernel, want, exact):
        checks[label] = chk.check(f"main/{label}", kernel, outs[label],
                                  want, exact)
        if not exact:
            max_abs_plain[label] = float(want.abs().max())
    check("runner cuda-mxu life", "stencil_step_mxu_batched", torch.stack(
        [plain_run(R.LIFE, s, 64) for s in life_states]), True)
    alive = int(outs["runner cuda-mxu life"].sum())
    check("runner cuda-mxu heat", "stencil_step_mxu_batched", torch.stack(
        [plain_run(R.HEAT, s, 64) for s in heat_states]), False)
    for n, wl in (("life", R.LIFE), ("gray-scott", R.GRAY_SCOTT)):
        # v4 and v3 bit for bit
        check(f"cuda-fused {n}", "stencil_step_fused_k",
              plain_run(wl, fused_init[n], 63), True)
    check("cuda life", "stencil_step_fused_k",
          plain_run(R.LIFE, cuda_init, 63), True)
    for (kind, n), e in singles.items():
        wl = e.workload
        check(f"{kind} k1 {n}", f"stencil_step_{e.variant}",
              plain_run(wl, single_init[n], 16), wl.dtype == torch.uint8)
    # the cell engine against cuda-fused, through the expanded grid
    want = expanded_to_compact(frac, r, lay.to_expanded(
        fused["life"].run(fused_init["life"], 4)))
    checks["cell life"] = chk.check("main/cell", None, out_cell, want, True)
    if alive == 0:
        raise AssertionError("LIFE died out on the main path")
    emit("main_path", fusion_k=k, runs=runs, launches=launches,
         expected_launches=expect, max_err_vs_plain=checks,
         max_abs_plain=max_abs_plain, cell_index_seconds=cell_index_seconds,
         live_cells_after_64_steps=alive,
         state_bytes_life_b4=life_states.numel())
    del outs, out_cell, life_states, heat_states, fused_init, cuda_init
    del single_init, cell_init, want, timed
    torch.cuda.empty_cache()

    # 5. the paper's comparison: BB, lambda and Squeeze --------------------
    bb = make_engine("bb", frac, r, workload=R.LIFE)
    lam = make_engine("lambda", frac, r, workload=R.LIFE)
    mxu = make_engine("cuda-mxu", frac, r, m, workload=R.LIFE)
    fu = fused["life"]
    t = time.perf_counter()
    _ = lam._coords     # the index build (one lambda launch), untimed below
    torch.cuda.synchronize()
    lambda_index_seconds = time.perf_counter() - t
    e0 = bb.init_random(9)
    s0 = lay.from_expanded(e0)
    c0 = expanded_to_compact(frac, r, e0)
    n_bb = 4
    t = time.perf_counter()
    e1 = bb.run(e0, n_bb)
    torch.cuda.synchronize()
    bb_ms = 1e3 * (time.perf_counter() - t) / n_bb
    want = lay.from_expanded(e1)
    chk.check("bb/lambda", None, lay.from_expanded(lam.run(e0, n_bb)), want,
              True)
    chk.check("bb/cell", None, cell.run(c0, n_bb),
              expanded_to_compact(frac, r, e1), True)
    chk.check("bb/mxu", None, mxu.run(s0, n_bb), want, True)
    chk.check("bb/fused", None, fu.run(s0, n_bb), want, True)
    del e1, want
    torch.cuda.empty_cache()
    lam_ms = cuda_ms(torch, lambda: lam.run(e0, 2), 2) / 2
    del e0
    torch.cuda.empty_cache()
    n_sq = 32
    cell_ms = cuda_ms(torch, lambda: cell.run(c0, 8), 2) / 8
    mxu_ms = cuda_ms(torch, lambda: mxu.run(s0, n_sq), 3) / n_sq
    fu_ms = cuda_ms(torch, lambda: fu.run(s0, n_sq), 3) / n_sq
    emit("bb_vs_squeeze", workload="life", expanded_side=frac.side(r),
         bb_ms_per_step=bb_ms, lambda_ms_per_step=lam_ms,
         cell_ms_per_step=cell_ms, cuda_mxu_ms_per_step=mxu_ms,
         cuda_fused_ms_per_step=fu_ms, speedup_lambda=bb_ms / lam_ms,
         speedup_cell=bb_ms / cell_ms, speedup_mxu=bb_ms / mxu_ms,
         speedup_fused=bb_ms / fu_ms,
         lambda_index_seconds=lambda_index_seconds,
         bb_bytes=bb.memory_bytes(), lambda_bytes=lam.memory_bytes(),
         cell_bytes=cell.memory_bytes(), squeeze_bytes=lay.memory_bytes(),
         mrf=bb.memory_bytes() / lay.memory_bytes(), paper_mrf=56.1,
         equal_after_steps=n_bb)
    del lam, c0, cell
    torch.cuda.empty_cache()

    # 6. kernels at the main path's shapes --------------------------------
    # Bounds count the work the function needs, whatever the algorithm:
    # each input read and each output written once. A stencil step does
    # about 12 operations (Moore aggregate and rule) per cell and substep;
    # v5's halo ring, padding slots and zero band entries are not counted.
    # The maps take a lookup a group of levels (``nu_ops``,
    # ``lambda_ops``).
    s1 = mxu.init_random(3)
    sb = torch.stack([mxu.init_random(i) for i in range(4)])
    o1, ob = torch.empty_like(s1), torch.empty_like(sb)
    table_bytes = lay.n_blocks * 8 * 4
    state_bytes = s1.numel() * s1.element_size()
    step_bytes = 2 * state_bytes + table_bytes
    p = lay.macro_tiles(k)[0]
    needs = halo_needs(R.LIFE.weights2d)
    strips = sk._gather_halo_strips(lay, s1[None, None], needs)
    strips_bytes = strips.numel() * strips.element_size()
    cxm, cym = (c.contiguous() for c in compact_meshgrid(frac, r, "cuda"))
    ex16, ey16 = lm.lambda_map_tc(frac, r, cxm, cym)
    n16 = cxm.numel()
    specs = {
        "stencil_step_blocks": dict(
            fn=lambda: sk.stencil_step_blocks(lay, s1, R.LIFE, out=o1),
            plain=lambda: sk.stencil_step_blocks_plain(lay, s1, R.LIFE),
            shape=s1.shape, k=1, bytes=step_bytes, ops=12 * s1.numel(),
            # the design's: nine whole blocks a window, none reused in L2
            design_bytes=9 * state_bytes + table_bytes + state_bytes),
        "stencil_step_strips": dict(
            fn=lambda: sk.stencil_step_strips(lay, s1, R.LIFE, out=o1),
            plain=lambda: sk.stencil_step_strips_plain(lay, s1, R.LIFE),
            shape=s1.shape, k=1, bytes=step_bytes, ops=12 * s1.numel(),
            extra=dict(
                kernel_alone=lambda: sk._launch_step(
                    "stencil_step_strips", lay, s1, R.LIFE, 1, o1,
                    strips=strips),
                gather=lambda: sk._gather_halo_strips(
                    lay, s1[None, None], needs),
                gather_plain=lambda: sk.gather_halo_strips_plain(
                    lay, s1[None, None], needs)),
            kernel_alone_bytes=2 * state_bytes + strips_bytes,
            # the design's: the gather (the state, the table, the strips
            # written) and the step (the state and strips read, the state
            # written)
            design_bytes=(state_bytes + table_bytes + strips_bytes)
            + (2 * state_bytes + strips_bytes)),
        "stencil_step_fused": dict(
            fn=lambda: sk.stencil_step_fused(lay, s1, R.LIFE, out=o1),
            plain=lambda: sk.stencil_step_fused_plain(lay, s1, R.LIFE),
            shape=s1.shape, k=1, bytes=step_bytes, ops=12 * s1.numel()),
        "stencil_step_fused_k": dict(
            fn=lambda: sk.stencil_step_fused_k(lay, s1, R.LIFE, k=k,
                                               out=o1),
            plain=lambda: sk.stencil_step_fused_k_plain(lay, s1, R.LIFE,
                                                        k=k),
            shape=s1.shape, k=k, bytes=step_bytes,
            ops=12 * k * s1.numel()),
        "stencil_step_mxu_batched": dict(
            fn=lambda: sk.stencil_step_mxu_batched(lay, sb, R.LIFE, k=k,
                                                   out=ob),
            plain=lambda: sk.stencil_step_mxu_batched_plain(lay, sb, R.LIFE,
                                                            k=k),
            shape=sb.shape, k=k, p=p, bytes=2 * 4 * state_bytes
            + table_bytes, ops=12 * k * sb.numel()),
        "nu_map_tc": dict(
            fn=lambda: nm.nu_map_tc(frac, r, ex16, ey16),
            plain=lambda: nm.nu_map_tc_plain(frac, r, ex16, ey16),
            shape=ex16.shape, r=r, bytes=17 * n16,
            ops=nu_ops(nm.nu_plan(frac, r), n16),
            extra=dict(matmul=lambda: M.nu_map_matmul(frac, r, ex16,
                                                      ey16))),
        "lambda_map_tc": dict(
            fn=lambda: lm.lambda_map_tc(frac, r, cxm, cym),
            plain=lambda: lm.lambda_map_tc_plain(frac, r, cxm, cym),
            shape=cxm.shape, r=r, bytes=16 * n16,
            ops=lambda_ops(lm.lambda_plan(frac, r), n16),
            extra=dict(matmul=lambda: M.lambda_map_matmul(frac, r, cxm,
                                                          cym))),
    }

    def parts(x):
        """A result as a tuple of numeric tensors (bool as int64)."""
        xs = x if isinstance(x, tuple) else (x,)
        return tuple(t.to(torch.int64) if t.dtype == torch.bool else t
                     for t in xs)
    # lambda then nu returns every compact cell, all members
    bx, by, valid = nm.nu_map_tc(frac, r, ex16, ey16)
    for what, got, want in (("cx", bx, cxm), ("cy", by, cym),
                            ("valid", parts(valid)[0],
                             torch.ones_like(bx, dtype=torch.int64))):
        chk.check(f"roundtrip/{what}", None, got, want, True)
    del bx, by, valid
    rows = []
    for kname, spec in specs.items():
        want = parts(spec["plain"]())
        for i, (g, w) in enumerate(zip(parts(spec["fn"]()), want)):
            chk.check(f"timing/{kname}/{i}", kname, g, w, True)
        extra_ms = {}
        for what, fn in spec.get("extra", {}).items():
            if what == "matmul":   # the float32 form: exact below 2^24
                for i, g in enumerate(parts(fn())):
                    chk.check(f"timing/{kname}/matmul/{i}", None, g,
                              want[i], True)
            extra_ms[f"{what}_ms"] = cuda_ms(
                torch, fn, 3 if what in ("matmul", "gather_plain") else 20)
        del want
        ms = cuda_ms(torch, spec["fn"], 20)
        plain_ms = cuda_ms(torch, spec["plain"], 3)
        bytes_ms = 1e3 * spec["bytes"] / HBM_BYTES_PER_S
        ops_ms = 1e3 * spec["ops"] / F32_FLOPS
        source, replaces = KERNELS[kname]
        rows.append(dict(
            name=kname, route="cuda", source=source, replaces=replaces,
            launches=launches[kname] + launches.get(kname + "[wide]", 0),
            max_abs_err=chk.max_err[kname], ms=ms,
            plain_ms=plain_ms, bound_ms=max(bytes_ms, ops_ms),
            bound_by="bytes" if bytes_ms >= ops_ms else "operations",
            library_ms=None))
        if kname == "stencil_step_mxu_batched":
            rows[-1].update(
                bound_ops_design_ms=mxu_design_ms(*sb.shape[:2], k, 1),
                registers=mxu_regs["in-kernel"])
        if kname == "stencil_step_fused_k":
            rows[-1].update(registers=fused_regs["in-kernel"])
        if kname == "stencil_step_fused":   # the k = 1 instance, CTA body
            rows[-1].update(registers=dict(
                fused_regs["in-kernel-k1"], **{
                    n: v for n, v in fused_regs["in-kernel"].items()
                    if n.endswith("/wide")}))
        if kname == "nu_map_tc":
            rows[-1].update(registers=nu_regs,
                            plan=nm.nu_plan(frac, r)._asdict())
        if kname == "lambda_map_tc":
            rows[-1].update(registers=lambda_regs,
                            plan=lm.lambda_plan(frac, r)._asdict())
        if "design_bytes" in spec:   # rows 1 and 2
            rows[-1].update(
                bound_design_ms=1e3 * spec["design_bytes"] / HBM_BYTES_PER_S,
                registers=fused_regs["blocks" if kname.endswith("blocks")
                                     else "strips"])
        if kname == "stencil_step_strips":   # its time includes the gather
            rows[-1].update(
                kernel_alone_ms=extra_ms["kernel_alone_ms"],
                gather_ms=extra_ms["gather_ms"],
                gather_plain_ms=extra_ms["gather_plain_ms"],
                gather_launches=launches["gather_halo_strips"],
                gather_max_abs_err=chk.max_err["gather_halo_strips"],
                gather_registers=fused_regs["gather"])
        if "kernel_alone_bytes" in spec:
            extra_ms["kernel_alone_bytes_ms"] = \
                1e3 * spec["kernel_alone_bytes"] / HBM_BYTES_PER_S
        emit("kernel_timing", name=kname, shape=list(spec["shape"]),
             workload="life" if "stencil" in kname else None,
             k=spec.get("k"), p=spec.get("p"), r=spec.get("r"), ms=ms,
             plain_ms=plain_ms, bytes=spec["bytes"], bytes_ms=bytes_ms,
             ops=spec["ops"], ops_ms=ops_ms, **extra_ms)
    del specs, s1, sb, o1, ob, strips, cxm, cym, ex16, ey16, mxu, fu
    del fused, runner, lay, bb, s0
    torch.cuda.empty_cache()

    # 7-10. the 3D slice --------------------------------------------------
    phase_3d_kernels_vs_plain(torch, chk, F3, R, c3.BlockLayout3D, k3)
    phase_3d_global_windows(torch, chk, F3, R, make_engine, c3, k3)
    torch.cuda.empty_cache()
    launches3, lay3, engines3 = phase_3d_main(
        torch, chk, F3, R, make_engine, default_fusion_k, c3.shared_layout3d,
        BatchedRunner, k3, c3)
    torch.cuda.empty_cache()
    phase_3d_bb(torch, chk, F3, R, make_engine, lay3, engines3, c3)
    torch.cuda.empty_cache()
    rows += phase_3d_timing(torch, chk, R, lay3, default_fusion_k(lay3.rho),
                            launches3, k3, regs3)
    del lay3, engines3
    torch.cuda.empty_cache()

    # 11-13. the distributed slice -----------------------------------------
    phase_dist_kernels_vs_plain(torch, chk, F, R, BlockLayout, sk,
                                make_engine, make_distributed_engine)
    phase_fused_bodies_vs_plain(torch, chk, F, R, BlockLayout, sk, True)
    torch.cuda.empty_cache()
    launches_d, lay_d, fused_d, mxu_d, state1, states4 = phase_dist_main(
        torch, chk, F, R, sk, make_engine, shared_layout, default_fusion_k,
        BatchedRunner, EngineSpec, make_distributed_engine)
    torch.cuda.empty_cache()
    rows += phase_dist_timing(torch, chk, R, sk, lay_d,
                              default_fusion_k(lay_d.rho), launches_d,
                              fused_d, mxu_d, state1, states4, mxu_regs,
                              fused_regs)
    del lay_d, fused_d, mxu_d, state1, states4
    torch.cuda.empty_cache()

    # 14-16. attention and the SSD chunk scan ------------------------------
    phase_attention_ssd_vs_plain(torch, chk, ta, ts, tssm, build)
    torch.cuda.empty_cache()
    launches_a = phase_attention_ssd_main(torch, chk, ta, ts, tssm, build)
    torch.cuda.empty_cache()
    rows += phase_attention_ssd_timing(torch, chk, ta, ts, launches_a,
                                       ssd_regs)
    torch.cuda.empty_cache()

    # 17. the simulation service on the main path's layout ----------------
    phase_serving(torch, F, R, shared_layout, build)

    # 18. the autotuner at the main path's full width ---------------------
    phase_tuning(torch, F, shared_layout, build)
    torch.cuda.empty_cache()

    # 19. the language-model serving path and the examples -----------------
    phase_lm_serve(torch, build)
    torch.cuda.empty_cache()

    # 20. the language-model training path ---------------------------------
    phase_lm_train(torch, build)
    torch.cuda.empty_cache()

    # 21. the language-model path sharded over a local mesh -----------------
    phase_lm_sharded(torch, build)
    torch.cuda.empty_cache()

    # 22. the rec, ssm and encdec families sharded over a local mesh --------
    phase_lm_sharded_families(torch, build)
    emit("done", seconds=time.perf_counter() - t_start)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
