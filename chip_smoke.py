#!/usr/bin/env python3
"""Run the PyTorch/CUDA port on one NVIDIA card and check it: its DWN
training (each minibatch step a CUDA graph replay) and serving path
(tuned, CUDA-graph steps, artifacts, the continuous-batching loop under
open-loop load), the paper's hardware model at
MNIST and JSC width (cost report, RTL co-simulation against the served
kernel's counts), the encoding design-space sweep over the paper's grid
(cost, accuracy, K2 time, served samples/s, cache, worker processes,
autodesign), its staged packed and float datapaths, its
flash-attention kernel, qwen3-8b serving at full width with a DWN head
on its backbone, the LM zoo's ten archs served at full width (dense,
MoE, VLM, SSM, hybrid and encoder-decoder; mixtral's depth cut to the
card), qwen3-8b training, the DWN behind the model zoo's interface
(``models.dwn_arch``: prefill variants against K2, the whole
dwn_serve_1m shape, train steps, data-parallel serving at one rank), and
the dry-run's roofline terms held against steps timed on the card, and
the transformer over a one-rank ``DeviceMesh`` (tensor parallelism, FSDP,
expert parallelism, sharded restore), and the shapes its kernels once
refused for their size (wide encoders and layers, deep stacks, fan-in to
16, any head dim to 256).

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device  — the card's name, the device count, nvidia-smi's name and
   power limit, and its largest SM clock (the operation bounds use it);
2. build   — compiles every CUDA kernel source with nvcc (all at once),
   prints the assembler's register, shared-memory and spill lines and
   the tile kernels' (K1, K2, K6 and its combine, K4, K8, K3, K5, and the
   rows kernels kept beside K6, K4, K3 and K5) registers and shared
   memory, and fails if one of them spills;
3. kernels — at dwn-jsc-lg width (F=16, T=200, m=2400, n=6, 5 classes,
   operands from a numpy seed) holds K2 (packed) and K1 (batch-major)
   against their plain PyTorch versions on the card, bit for bit, at
   B = 4096, 4097, 1000, 33, 31 and 1 and block_b = the default, 7, 256
   and 4096, for a 2-layer stack (120, 50), a fan-in-8 stack (256, 60) whose
   tables are read word by word, a PEN (1, 8) grid and models larger than
   a block's shared memory (2050 LUTs of fan-in 10 and 70 of fan-in 15,
   whose last layer is split over blocks; 40 of fan-in 16 and a
   (40, 70) fan-in-16 stack, read from global memory), each launch's
   layout held to that; then times both in CUDA graphs at the served
   buckets B = 1, 64, 1024 and 4096 and sweeps block_b at B=4096; last
   the zero kernel of a split launch on its own against ``Tensor.zero_``;
4. staged  — the staged packed datapath at the same width: the three
   stage kernels (packed encode, LUT layer, masked popcount + classify)
   each held against its plain version bit for bit (B = 4096, 4097, 1000,
   33, 31, 1, the (120, 50) stack, PEN, a ragged F*T = 21, fan-in 1, 10
   and 16; the LUT layer also on 7264-word input rows, the widest it
   takes, and 454-word ones, the widest a tile of 32 samples takes, and
   in a CUDA graph replay; each of its launches held to the path it must
   take, the layer staged per block or the rows kernel; the encode also
   on NaN and denormal features, thresholds too large for one block, 500
   features (its rows kernel) and in a graph replay, each launch's path
   held likewise; the classify on random, strided and all-zero-word
   masks, MNIST-lg's 10 classes, the widest rows and the most classes a
   tile takes, rows one word wider and 33 classes (its rows kernel),
   all-zero words and in a graph replay, each launch's path held
   likewise); then
   ``encode_packed`` ->
   ``evaluate_packed`` per layer -> ``classify_packed`` at B=4096, equal to
   the fused packed kernel and to the float oracle ``apply_hard``, with
   the launch counters showing one encode, one LUT launch per layer and one
   classify per pass; then each stage kernel, the staged total and the
   fused kernel timed in the same run, in CUDA graphs (the card's time)
   and as a loop of wrapper calls (which includes the host's), the
   encode, the LUT layer and the classify also at the served buckets
   beside their first designs (the kept rows kernels), and the launch
   floor: one launch of the zero kernel on one element in a CUDA graph;
5. float   — the float datapath at the same width: the float encode, the
   float LUT layer (multilinear table evaluation), the group popcount +
   classify and the float fused kernel, each held against its plain
   version (B = 4096, 4097, 1000, 33, 31, 1, the (120, 50) stack, PEN, a
   ragged F*T = 21, m = 2402 LUTs of which two count for no class, fan-in
   1 to 8; the fused kernel also at several block_b and block_m; the LUT
   layer also on 3632-bit rows (the widest a tile takes), 3633-bit and
   58,112-bit ones (its rows kernel; the widest it takes) and in a graph
   replay, each launch's path held to the tiles or the rows kernel) bit for
   bit, and within a stated tolerance on soft bits and float tables (the
   fused kernel bitwise the same in two calls and in a CUDA graph replay;
   its combine kernel alone equal to its plain version); then
   ``encode`` -> ``evaluate`` per layer -> ``classify`` at B=4096, equal
   to the float fused ``forward``, the staged packed path, the packed
   fused kernel and ``apply_hard``, with the launch counters showing one
   encode, one LUT launch per layer and one classify per pass and one
   fused launch per ``forward``; then each float kernel, the float and
   packed staged totals and the three fused kernels timed in the same
   run, the float fused kernel and the float LUT layer also at the served
   buckets beside their first designs, and the fused kernel over its
   block_b (samples a tile) and block_m (most LUTs a slice);
6. flash   — the flash-attention kernel against its plain version at the
   qwen3-8b head shape (32 query heads over 8 KV heads, head_dim 128, bf16
   from a numpy seed) for (B, S) in (1, 1), (2, 33), (1, 129), (2, 255),
   (4, 512), (4, 2048), causal and not, for a flat and a peaked softmax,
   within 2e-2 elementwise and within 1e-2 of each query row's largest
   value; the same at the LM zoo's head shapes (qwen2-7b's 28 over 4,
   qwen3-14b's 40 over 8 and llava-next-34b's 56 over 8 at hd 128,
   phi3-mini's 32 over 32 at hd 96, granite-moe's 24 over 8 at hd 64, all
   on the Hopper design) for (B, S) in ZOO_FLASH_SIZES (S on either side
   of its query blocks and key tiles), llava's at its served 2 x 3904
   (a ragged last query block; FLASH_SERVED_SIZES, also timed), and
   qwen3-8b's at 8 x 2048 and granite-moe's at 10 x 2048,
   where K and V pass 40 MB but, with several query heads a KV head, the
   blocks keep the order by query block (FLASH_GQA_PAST_L2_SIZES); then
   each head shape timed at B=4, S=2048 in a CUDA graph
   beside its plain version and one ``scaled_dot_product_attention`` call
   (a yardstick the port never calls), hd 64 and 96 also beside their
   kept first designs (mma.sync, ``flash_attn_mma_launch``, uncounted),
   with its TFLOP/s, the bound counted from shapes and the share of it
   reached, and the registers, shared memory and spills from ptxas of the
   Hopper design's hd-64, hd-96 and hd-128 instances and of the first
   designs (it fails if one spills or ptxas serialised a Hopper
   instance's wgmmas);
7. lm      — ``ServingEngine(qwen3-8b with attn_impl="pallas",
   prompt_len=2048, gen=16, device="cuda")`` at full width (36 layers,
   weights from a seed): serves 2 requests of 4 prompts with the launch
   counters showing 36 flash-attention launches per prefill and none in
   decode, then holds the same params with ``attn_impl="masked"`` to the
   kernel's prefill logits and 16 teacher-forced decode steps within
   0.05 of the largest logit; prefill and decode times beside their
   bounds and a profiler split of a prefill and a decode step (it fails
   if the prefill's profile finds no time in K10 while its launches were
   counted);
8. lm_zoo  — the LM zoo's ten archs at full width through
   ``ServingEngine``, weights from a seed, each freed before the next
   (ZOO): qwen2-7b (q/k/v biases), qwen3-14b, phi3-mini-3.8b (hd 96) and
   granite-moe-3b-a800m (hd 64, 40 experts top-8, tied embeddings) under
   ``attn_impl="pallas"``, 2 requests of 4 x 2048-token prompts, 16 greedy
   tokens each, every prefill launching K10 once a layer; mixtral-8x7b
   (8 experts top-2, a 4096-token sliding window, so the masked path and
   no K10) cut to the layers whose bf16 weights leave 20 GB of the card
   free, 2 requests of 2 x 6144 tokens (the ring wraps unaligned);
   llava-next-34b (VLM, all 60 layers, 14 GB left) under pallas, 2
   requests of 2 x (2880 patch embeddings + 1024 tokens), 8 tokens each,
   K10 at 56 query heads over 8; mamba2-1.3b (SSD prefill, recurrent
   decode) 2 x 4 x 2048; recurrentgemma-2b (RG-LRU and a 2048-token local
   window) 2 x 4 x 3000, the ring wrapped unaligned; whisper-large-v3
   (1500 frame embeddings, 432 + 16 text tokens) 2 x 4; each arch's
   parameter count held to the count from its shapes, its prefill's last
   logits held to the masked path's (pallas archs; llava at B = 1), a
   prefill of S tokens and one decode step held to ``forward`` on S + 1
   (B = 1, S = the prompt, mixtral 5000; MoE at capacity factor 8),
   qwen2-7b's ``tri`` prefill of 8192 tokens held to ``masked``, all
   within 0.05 of the largest logit; prefill and decode times beside
   their bounds, a profiler split of a prefill, peak memory and, for the
   MoE archs, the share of (token, k) slots a prefill drops at capacity
   factor 1.25;
9. lm_head — the DWN head on the LM backbone: an ``lm-head`` split (1024
   / 512 sequences through the reduced backbone) made on the card,
   ``dwn-lm-head`` trained one epoch there, frozen and packed, then
   ``ServingEngine(qwen3-8b with attn_impl="pallas", dwn_head=art)`` at
   full width (36 layers, weights from a seed), whose startup gate holds
   the head's K2 counts to ``apply_hard``, serving 2 LM requests (4 x
   2048 tokens, 16 generated) and 2 classify requests (8 x 2048 tokens) in
   one drain: 36 K10 launches a forward, K2 once a classify request (a
   replay of the captured step), every returned count equal to
   ``apply_hard`` on the returned features; a classify request's time
   split into the backbone forward, the pooling and K2; the 16-column
   unembedding's features against the full one's; then ``python -m
   repro_torch.launch.serve --arch qwen3-8b --dwn-head dwn-lm-head``;
10. lm_train — LM training: four steps of the reduced qwen3-8b on the card
   equal to the CPU's from one init (loss within 1e-3, grad norm within
   5e-3, params within 3 * lr * steps); then qwen3-8b at full width with
   its layers cut to what the card holds beside float32 weights,
   gradients and two Adam moments, 11 steps of 8 x 128 and 11 of 2 x 2048
   ``TokenStream`` tokens (the loss must fall and stay finite), each
   step's ms by CUDA events beside its bound, a profiler split of one
   step of each (attention, cross-entropy, Adam, the clip, the other
   products, the rest) and the peak memory; the train CLI with
   ``--ckpt-dir`` crashed once and resumed on the card, equal to an
   uninterrupted run; ``python -m repro_torch.launch.train --arch
   qwen3-8b --reduced --steps 20``;
11. train  — DWN training at dwn-jsc-lg width (one layer of 2400 LUT6 over
   3200 thermometer bits, 5 classes) on ``load_jsc(20000, 5000)``, the
   paper protocol (batch 128, Adam lr 1e-3, StepLR(30, 0.1), clamp
   (-1, 1)), with the library's float32 product settings: 4 steps on the
   card (replays of the captured step) and on the CPU (the port's plain
   path) from one numpy init, per-step losses within 1e-5, scores within
   1e-4, table signs and wiring flips counted and named; the replayed
   steps equal to the eager ones and two card runs equal, bit for bit;
   one epoch and eval through ``ScanTrainer``, with epoch seconds,
   steps/s, the step's ms replayed and eager beside its bound from
   shapes (``train_bytes_and_ops``) and a ``torch.profiler`` split of a
   step (softmax-STE elementwise work, the gb product, Adam, gathers,
   the rest; idle shares); then ``DWNArtifact.train`` (one epoch) frozen,
   packed and served through ``ServingEngine``, whose startup oracle
   check must pass, every served count equal to ``apply_hard``'s;
12. serve  — ``ServingEngine("dwn-jsc-lg", device="cuda")`` at full width,
   whose startup checks every backend against the float oracle and whose
   fused steps replay one CUDA graph per (bucket, tuned config); serves 16
   requests of 4096 rows on the packed kernel, the same stream on the
   batch-major kernel and a ragged stream, asserting from the launch
   counters (a replay adds the launches its graph captured) that each
   kernel carried its pass and that the zero kernel ran before the split
   launches, holding every request to the oracle, and times the
   host-to-device copy, the step and the device-to-host copy of a
   4096-row step, replayed and as an eager call, for both kernels; then
   ``backend="auto"``: the tuner races K1 against K2 per bucket into a
   fresh cache file (``REPRO_AUTOTUNE_CACHE`` under ``build/``), the
   selector calibrates every bucket, and the 4096-row and ragged streams
   are served with each bucket's choice, its timings and the steps built
   per bucket (at most one) printed and every request held to the
   oracle; last the served artifact is saved, loaded back and served
   bit-exact;
13. load   — dwn-jsc-lg through the continuous-batching loop
   (``serve()`` / ``submit_async``), pinned to K2 and with
   ``backend="auto"``: a ragged stream of 40 requests of 1-4096 rows,
   three of them 3 × 4096 + 17 rows (served in chunks), every result
   ``ok`` and equal to the sync drain of the same payloads, which is held
   to ``apply_hard``; every bucket's graph captured before the loop
   starts and ``compile_counts()`` unchanged until it stops; the launch
   counters, set to 0 once the loop runs, equal to what the session's
   steps replay (K2 a step pinned, K1 or K2 under auto, the zero kernel
   on split tiles).  Then the open-loop curve with ``launch.loadgen``:
   ``SLOConfig(max_queue_samples=16 * 4096, submit_timeout_s=0)``,
   Poisson arrivals of 256-4096 rows with 5 ms deadlines, seed 0, at 0.5,
   1.0 and 1.3 of the closed-loop capacity (``measure_capacity``), 2 s
   each, continuous and sync; then 1 s each, continuous only: a burst
   level (0.5, 4× for 0.1 s every 0.5 s), the 1.0 level with Python's
   garbage collector off (a diagnostic of its pauses), and dwn-jsc-lg
   with dwn-mnist-lg at 0.5, each its own engine and loop thread at
   once, weighted by capacity; every level's step estimates seeded anew
   from the calibration; each level printing offered
   and served samples/s, p50/p99/p999, the shed rate, rejections, the
   producer's lag, steps and samples a step, the loop's busy share, the
   step estimates and straggler events, and holding served + shed +
   rejected = offered, every ok result on time and each engine's shed
   count equal to its non-ok results; last one second at 1.0 under
   ``torch.profiler``: the card's busy time (kernels, copies in, copies
   out) and idle share beside the loop's busy share.  No speed is gated;
14. hw     — ``dwn-mnist-lg`` (F = 196 pooled pixels, T = 16: 3136 encoder
   bits, 98 words a sample; one layer of 2000 LUT6, 10 classes) trained
   one epoch on ``load_mnist(20000, 5000)`` on the card, frozen, packed
   and served through ``ServingEngine``: 16 requests of 4096 rows pinned
   to K2, the same pinned to K1, a ragged stream and ``backend="auto"``
   (tuned at its own cache keys), then K2 again, every step a CUDA graph
   replay and every served row equal to ``apply_hard``, with a 4096-row
   step split into its copies and its replay; K1 and K2 at its shape held
   to their plain versions and timed in CUDA graphs beside their bounds
   (B = 4096 and the served buckets), and at the md and sm tiers' shapes
   held to their plain versions (split over blocks at B = 1 and 33, one
   slice at 4096);
   its cost report, TEN and PEN at 9 bits on the same params, LUTs and
   FFs per component with the encoder's share; ``verify_rtl`` (Python
   evaluator, oracle on the card) on 256 test rows, the evaluator's
   per-class counts equal to the counts K2 served for those rows; the
   artifact saved, loaded and served again bit-exact; then the paper's
   ``dwn-jsc-lg`` at PEN 9 bits from a warm start on the card: its cost
   report and the same RTL check;
15. sweep  — the encoding design-space sweep: ``run_grid("paper",
   SweepSettings(device="cuda", kernel=True, serve=True))`` at the
   reference's defaults (n_train 4000, n_test 2000; the four presets, TEN
   and PEN at Table I's fine-tuned widths, lg-2400 at full width) into a
   fresh cache: each point's cost report, packed hard accuracy, K2 timed
   on 256 rows (best of 3 eager calls, each ending in a synchronize) and
   2 requests of 64 rows served through the engine's CUDA graphs; the
   Table I TEN check must pass, each point's timed calls must launch K2
   once a call (plus the zero kernel where the launch split) and its
   served steps K2 and never K1; the same grid on the CPU equal point for
   point on every hardware field and the accuracy; lg-2400's two points
   served again under ``serve_backend="auto"`` (K1 against K2 tuned per
   bucket, each step one of them); the rerun all cache
   hits; the ``tiny`` grid through ``run_grid_parallel`` with two worker
   processes sharing the card equal to the serial run; ``choose_design``
   at an accuracy floor between the grid's lowest and highest and
   ``emit_verified`` on 256 vectors (oracle on the card);
16. cli    — ``python -m repro_torch.launch.serve --arch dwn-jsc-lg`` with
   four requests, the same with ``--backend auto``, ``--arch <arch>
   --batch 2 --prompt-len 32 --gen 4`` for qwen3-8b, llava-next-34b
   (with its 2880 patches, masked), mamba2-1.3b, recurrentgemma-2b and
   whisper-large-v3 at full width, ``python -m
   repro_torch.launch.train --arch dwn-jsc-lg --workload jsc --epochs
   1``, and four commands in their own processes that must exit 0:
   ``python -m repro_torch.dwn.smoke --workload mnist --preset mnist-lg
   --variant TEN --bits 16 --epochs 1`` (the lifecycle, bit-exact
   roundtrip), ``python -m repro_torch.hw.cosim --presets
   dwn-jsc-lg,dwn-mnist-lg --n 256``, ``python -m
   repro_torch.launch.serve --arch dwn-jsc-lg --continuous --deadline-ms
   50`` (every request served or shed) and ``python -m
   repro_torch.launch.loadgen --preset dwn-jsc-lg --max-bucket 4096
   --levels 0.5 --duration 1 --mode both`` (every arrival accounted
   for); then ``python -m repro_torch.launch.sweep --grid paper --fresh``
   (exit 0: Table I within tolerance) and the same with ``--workers 2
   --no-kernel --no-serve``, equal on every hardware field and accuracy;
17. dwn_arch — ``api.make_prefill`` of every registered DWN arch whose
   datapath ``models.dwn_arch`` runs (dwn-jsc-lg2400 corner/contig,
   -opt1 gather, -opt2 gather/strided, -opt3 gather/strided/fused, -opt4
   at 170 bits, md360-pruned at 78, sm50-pruned at 14; params from a
   seed) on 4096 samples, one card's share of dwn_serve_1m on the
   256-card mesh: its counts equal, bit for bit, K2's for the same params
   frozen by ``dwn_arch.artifact`` (first argmax wiring, tables > 0, the
   thresholds, strided groups reordered) and served through the spec's
   fused-packed CUDA graph, and the corner and gather datapaths agree;
   each variant's ms beside its bound (what these inputs need: reads,
   compares, bit selects, table reads; the reference's dense one-hot
   product's own bound printed beside it); then -opt3 at the whole
   dwn_serve_1m shape (1,048,576 samples made on the card, 16 blocks of
   65,536), its ms, samples/s and peak memory beside its bound, its
   counts equal K2's; then ``api.make_train_step(num_micro=4)`` on
   dwn-jsc-lg2400, 3 steps of 4 x 1024 samples whose losses are within
   1e-5 of the same steps on the CPU, and 3 of 4 x 16,384 with each
   step's ms and the peak memory; last ``ServingEngine("dwn-jsc-lg")``
   under a one-rank NCCL process group, which by the reference's rule is
   not data parallel (``devices`` 1), serving 4 x 4096 rows through K2,
   each equal to ``apply_hard``;
18. dryrun — ``repro_torch.launch.dryrun`` on the meta device (no card
   work): ``run_cell`` of qwen3-8b at its four shapes on the (16, 16) and
   (2, 16, 16) production meshes and of dwn-jsc-lg2400 at dwn_serve_1m,
   each record's compute, memory and collective terms, bound and seconds
   printed (a record holding an error fails the phase; long_500k is a
   documented skip); then, priced on a (1, 1) mesh, the steps the lm and
   dwn_arch phases timed: qwen3-8b's prefill of 4 x 2048 tokens (bf16
   weights, K10 counted at its plain version's products), its decode step
   at the cache's 2064 positions (timed in a CUDA graph) and
   dwn-jsc-lg2400-opt3 at 1,048,576 samples, each measured ms beside the
   three terms, measured over the lower bound, the phase's own
   hand-counted bound and ``max_memory_allocated`` beside the argument
   bytes; it fails unless each measured time reaches the compute term and
   the argument bytes over HBM's 3.35 TB/s;
19. mesh   — the model over a ``DeviceMesh`` at world size 1: under a
   one-rank NCCL process group, ``ServingEngine(qwen3-8b with
   attn_impl="pallas", model_parallel=1)`` at full width (36 layers)
   takes the mesh path (params as DTensors on the (1, 1) ("data",
   "model") mesh) and serves 2 requests of 4 x 2048 tokens, 16
   generated: tokens equal to the meshless engine's on the same seeded
   params and prompts (served first, before the group), the prefill's
   logits within 0.05 of its, K10 once a layer a prefill; granite-moe at
   full width with ``moe_ep`` (40 experts padded to 48) on the mesh
   against ``ep=False`` on the same live experts, within 0.05, K10 at hd
   64; 3 training steps of qwen3-8b at the lm_train phase's depth (8 x
   128 tokens) through the mesh against the meshless steps (losses within
   1e-3 relative); the reduced qwen3-8b's state trained on the mesh,
   saved and restored onto it by ``shardings=``, every leaf equal; the
   mesh path's prefill and decode times beside the meshless path's, its
   peak memory and the phase's seconds;
20. limits — the shapes the kernels once refused for their size alone
   (LIMITS: jsc-lg at a 4096-threshold encoder, two hidden layers of
   32,000 LUTs, 784 features, twelve layers, fan-in 10 and 16): K2, K1,
   the staged path (K3, K4 a layer, K5), the float path (K7, K8 a layer,
   K9) and, for one layer, K6 at B = 4096, 1000, 33 and 1 (the float
   path at 256, 33 and 1; 33 and 1 at fan-in 16), every kernel bit-exact
   to its plain version and every path's counts equal to apply_hard,
   each launch on the path its plan names; the 4096-threshold model
   served through ServingEngine pinned to K2 and with backend="auto" and
   the 784-feature one pinned, every request equal to apply_hard; K4 on
   rows of 8192 words (the block rows kernel, timed beside the kept
   global kernel in the same call) and of 58,113 words (the global
   kernel); K10 at hd 8, 16, 32, 80 and 256 (2 x 1000, 8 over 2 heads),
   at hd 16, 32 and 256 at full size and at B x H = 65,600 (equal to its
   two halves launched apart) against its plain version, per row to
   flash_row_bar,
   SDPA's and flash_rounded's errors read beside each check and a
   dropped key tile failing the bar; each new path timed once beside its
   bound; the new kernels held to no spill.

Then it prints each phase's seconds, the kernels' summary line (K1's and
K2's launches on each served path, the load phase's sessions, the
sweep's paper grid and the DWN head among them, K10's on every LM path,
its hd-64 and hd-96 instances as entries of their own with their first
designs' times, K2's launches in the dwn_arch phase's one-rank engine
and, apart, in its cross-check replays, K10's on the mesh phase's paths,
their times at the mnist-lg shape
beside their bounds, and the limits phase's paths as entries of their
own: their launches over its drives, read from each launch's record, K10
counted for each head dim apart, each timed at one shape),
nvidia-smi's line and, last,
``{"ok": true, "device": {...}}``.  Any failure raises and exits non-zero;
so does a machine without a CUDA card, or a directory without the port.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# published H100 SXM peak of device memory (NVIDIA data sheet)
PEAK_BYTES_PER_S = 3.35e12
# the DWN kernels' scalar operations, each one instruction, at the CUDA C
# Programming Guide's per-instruction throughputs for compute capability
# 9.0, in lanes per clock per SM: 32-bit integer, logic, shift and compare
# ("int": compares, bit selects, table reads, gathers), float32 add,
# multiply and FMA ("fp32": float sums and lerps), population count
LANES_PER_CLOCK = {"int": 64, "fp32": 128, "popc": 16}
# the classes run on separate pipes at once, but each of an SM's 4
# schedulers dispatches at most one warp instruction a clock: 128 lanes
DISPATCH_LANES_PER_CLOCK = 128
SMS = 132
#: the SM clock the bounds count with: nvidia-smi's clocks.max.sm, read
#: by main() (Hz)
SM_CLOCK_HZ = None
# dense bf16 on the tensor cores (NVIDIA data sheet, H100 SXM)
PEAK_BF16_OPS_PER_S = 989e12

LG = dict(F=16, T=200, m=2400, n=6, C=5)
#: samples per CUDA block (a tile) swept at B=4096 for K1 and K2
BLOCK_B_SWEEP = (32, 64, 128, 256)
#: block_b values K1 and K2 are checked at beside the default: below a
#: warp and not a multiple of 32, eight warps, and more than a block's
#: shared memory holds beside the lg-2400 model (cut to what fits)
BLOCK_B_CHECKED = (7, 256, 4096)
#: the serving engine's batch buckets K1 and K2 are timed at
SERVED_BUCKETS = (1, 64, 1024, 4096)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def max_sm_clock_hz() -> float:
    """The card's largest SM clock (nvidia-smi clocks.max.sm), in Hz."""
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True)
    return float(out.stdout.strip()) * 1e6


def time_ms(fn, iters: int, warmup: int) -> float:
    """Mean milliseconds per call on the card (CUDA events)."""
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
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_ms(fn, iters: int = 200, warmup: int = 10) -> float:
    """Mean milliseconds of host time per call: the Python loop's wall
    time before the card is waited for (fewer calls than the launch queue
    holds, so the loop never waits for the card)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e3 / iters


def graph_ms(fn, iters: int = 100, replays: int = 5) -> float:
    """Mean milliseconds per call on the card with no Python between the
    launches: ``iters`` calls captured in one CUDA graph, replayed
    ``replays`` times between CUDA events.  Where the wrapper's host work
    takes longer than its kernel, :func:`time_ms` measures the host; this
    measures the card."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * replays)


def replayed(fn):
    """``fn()``'s outputs from one replay of a CUDA graph that captured
    it (after a warm-up on a side stream, as :func:`graph_ms` does)."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    graph.replay()
    torch.cuda.synchronize()
    return out


def rows_kernel(library, signatures, fn, *args):
    """A call that launches a kept rows kernel (a kernel's first design,
    which its wrapper takes for shapes its tile kernel does not) through
    its C entry point ``fn(*args, stream)`` on the current stream, for a
    same-call comparison with the tile kernel at shapes the wrappers send
    to the tiles.  These launches are not counted: they are not the main
    path's."""
    import torch
    from repro_torch.kernels._launch import bind
    lib = bind(library, signatures)

    def call():
        err = getattr(lib, fn)(*args,
                               torch.cuda.current_stream().cuda_stream)
        if err:
            raise SystemExit(f"{fn} failed: CUDA error {err}")
    return call


def make_model(rng, F, T, counts, n, pen_frac=None):
    """Random thresholds (ascending per feature), wires and {0,1} tables."""
    from repro_torch.core.thermometer import quantize_fixed_point
    th = np.sort(rng.uniform(-1, 1, (F, T)).astype(np.float32), axis=1)
    if pen_frac is not None:
        th = np.asarray(quantize_fixed_point(th, pen_frac), np.float32)
    maps, tabs, cand = [], [], F * T
    for m in counts:
        maps.append(rng.integers(0, cand, (m, n)).astype(np.int32))
        tabs.append(rng.integers(0, 2, (m, 2 ** n)).astype(np.int32))
        cand = m
    return th, maps, tabs


def model_bytes_and_ops(variant, B, F, T, counts, n, C):
    """Bytes the function must move (inputs read once, outputs written
    once) and the scalar operations it does for one launch, by class of
    :data:`LANES_PER_CLOCK`.

    ``variant`` is a fused kernel ("packed", "batch-major") or a stage
    kernel of the staged path: "thermometer" (F*T compares per sample),
    "lut_eval" (the first layer of ``counts``: m*n bit selects and m table
    reads per sample) or "popcount" (the last layer's C*W masked word
    popcounts per sample); or a kernel of the float datapath (float32 bits
    and tables, first layer of ``counts``): "float_thermometer" (F*T
    compares, F*T floats written per sample), "float_lut_eval" (per row
    and LUT n gathers and the 2^n - 1 lerps of its table, an FMA each and
    a subtraction each above the lowest level; the lowest level's 2^(n-1)
    subtractions take table entries alone, so they count once per LUT),
    "float_popcount" (one float add per LUT output) or "float_fused" (per
    LUT n wired compares, one table read and one float class add).
    """
    words = [(m + 31) // 32 for m in counts]
    w_in = (F * T + 31) // 32
    m0, A = counts[0], 2 ** n
    if variant == "float_thermometer":
        return (B * F * 4 + F * T * 4 + B * F * T * 4,
                {"int": B * F * T})
    if variant == "float_lut_eval":
        nbytes = B * F * T * 4 + m0 * n * 4 + m0 * A * 4 + B * m0 * 4
        lerps = B * m0 * ((A - 1) + (A // 2 - 1)) + m0 * (A // 2)
        return nbytes, {"int": B * m0 * n, "fp32": lerps}
    if variant == "float_popcount":
        return (B * counts[-1] * 4 + B * C * 4 + B * 4,
                {"fp32": B * counts[-1]})
    if variant == "float_fused":
        nbytes = (B * F * 4 + F * T * 4 + m0 * n * 4 + m0 * A * 4
                  + B * C * 4 + B * 4)
        return nbytes, {"int": B * m0 * (n + 1), "fp32": B * m0}
    if variant == "float_combine":
        chunks = C * -(-(m0 // C) // 32)
        return (B * chunks * 4 + B * C * 4 + B * 4,
                {"fp32": B * chunks, "int": B * C})
    if variant == "thermometer":
        return (B * F * 4 + F * T * 4 + B * w_in * 4, {"int": B * F * T})
    if variant == "lut_eval":
        m = counts[0]
        nbytes = (B * w_in * 4 + m * n * 4 * 2 + m * ((2 ** n + 31) // 32)
                  * 4 + B * words[0] * 4)
        return nbytes, {"int": B * m * n + B * m}
    if variant == "popcount":
        return (B * words[-1] * 4 + C * words[-1] * 4 + B * C * 4 + B * 4,
                {"popc": B * C * words[-1]})
    tw = (2 ** n + 31) // 32
    table_bytes = sum(m * tw * 4 for m in counts)
    wire_bytes = sum(m * n * 4 for m in counts)       # one int32 per wire
    io = B * F * 4 + B * C * 4 + B * 4 + C * words[-1] * 4
    reads = B * sum(counts)                           # one table read / LUT
    popc = B * C * words[-1]
    if variant == "packed":
        nbytes = io + F * T * 4 + wire_bytes + table_bytes
        ints = B * F * T + B * sum(m * n for m in counts) + reads
    else:
        # wire_f int16 + wire_th float32 for the first layer
        nbytes = (io + wire_bytes - counts[0] * n * 4 + counts[0] * n * 6
                  + table_bytes)
        ints = (B * counts[0] * n                     # direct-wire compares
                + B * sum(m * n for m in counts[1:]) + reads)
    return nbytes, {"int": ints, "popc": popc}


def ops_seconds(ops: dict) -> float:
    """Least time the card's SMs take for ``ops`` (class -> count): the
    classes' pipes run at once, so the slowest class at its
    per-instruction rate, or all of them at the dispatch rate
    (:data:`DISPATCH_LANES_PER_CLOCK`), whichever is longer."""
    clocks = SMS * SM_CLOCK_HZ
    slowest = max(k / (LANES_PER_CLOCK[c] * clocks) for c, k in ops.items())
    return max(slowest,
               sum(ops.values()) / (DISPATCH_LANES_PER_CLOCK * clocks))


#: the assembler's lines worth printing: resources, spills and the
#: warnings that it serialised wgmma instructions
PTXAS_KEEP = ("registers", "spill", "smem", "Compiling entry",
              "Performance Loss")


#: the tile kernels: (library, symbol in ptxas's entry names, name)
TILE_SYMBOLS = (
    ("fused_dwn", "fused_tiles_kernelILb0ELb1ELb0E", "fused_dwn_packed"),
    ("fused_dwn", "fused_tiles_kernelILb0ELb0ELb0E",
     "fused_dwn_packed, model in global"),
    ("fused_dwn", "fused_tiles_kernelILb1ELb1ELb0E", "fused_dwn_batch_major"),
    ("fused_dwn", "fused_tiles_kernelILb1ELb0ELb0E",
     "fused_dwn_batch_major, model in global"),
    ("fused_dwn", "zero_kernel", "fused_dwn_zero"),
    *(("fused_dwn", f"fused_dwn_kernelILi{n}E", f"fused_dwn, fan-in {n}")
      for n in range(1, 9)),
    ("fused_dwn", "fused_dwn_combine_kernel", "fused_dwn_combine"),
    ("fused_dwn", "fused_dwn_rows_kernel", "fused_dwn, rows"),
    ("lut_eval", "lut_eval_packed_kernel", "lut_eval_packed"),
    ("lut_eval", "lut_eval_packed_rows_kernelILb1E",
     "lut_eval_packed, rows"),
    *(("lut_eval", f"lut_eval_tiles_kernelILi{n}E", f"lut_eval, fan-in {n}")
      for n in range(1, 9)),
    ("thermometer", "thermometer_encode_packed_kernel",
     "thermometer_encode_packed"),
    ("thermometer", "thermometer_encode_packed_rows_kernel",
     "thermometer_encode_packed, rows"),
    ("popcount", "popcount_classify_packed_kernel",
     "popcount_classify_packed"),
    ("popcount", "popcount_classify_packed_rows_kernel",
     "popcount_classify_packed, rows"))


def phase_build():
    """Every kernel library built at once; returns name -> its ptxas
    lines.  The tile kernels' (K1, K2, K6, K4, K8, K3, K5 and their
    helpers) registers, static shared memory and spills are printed (their
    dynamic shared memory is in the later phases, as each launch reports
    it); a spill fails the run.  The float LUT layer's kept first design
    (``lut_eval_rows_kernel``) is not held to that: at fan-in 7 and 8 it
    spilled before it was kept; its lines are in the libraries' own."""
    from repro_torch.kernels import _build
    res = _build.build_all()
    libs = {name: {"seconds": r["seconds"], "cached": r["cached"],
                   "ptxas": [line for line in r["ptxas"]
                             if any(k in line for k in PTXAS_KEEP)]}
            for name, r in res.items()}
    tiles = {name: _ptxas_resources(libs[lib]["ptxas"], symbol)
             for lib, symbol, name in TILE_SYMBOLS}
    emit({"phase": "build", "libraries": libs, "tile_kernels": tiles})
    return {name: lib["ptxas"] for name, lib in libs.items()}


def phase_kernels(device, batches=(4096, 4097, 1000, 33, 31, 1),
                  time_batch=4096):
    """K2 and K1 equal to their plain versions at every B of ``batches``
    and every block_b of :data:`BLOCK_B_CHECKED`, at lg-2400 width, on a
    2-layer stack, on a fan-in-8 stack (tables past 64 entries, read word
    by word), on a PEN grid and on models larger than a block's shared
    memory (fan-in 10 and 15: the last layer split over blocks; fan-in 16:
    the model read from global memory), each launch's layout held to
    that; then each timed at the served buckets in CUDA graphs, its
    block_b swept at ``time_batch``.  Last the zero kernel of a split
    launch on its own, against ``Tensor.zero_``."""
    import torch
    from repro_torch.kernels.fused import kernel as K
    from repro_torch.kernels.fused import ref as R
    from repro_torch.kernels.fused.ops import prepare_operands
    from repro_torch.core.thermometer import quantize_fixed_point
    from repro_torch.kernels.autotune import DEFAULT_CONFIG

    block_default = DEFAULT_CONFIG.block_b
    rng = np.random.default_rng(0)
    F, T, m, n, C = (LG[k] for k in ("F", "T", "m", "n", "C"))
    x_all = rng.uniform(-1, 1, (max(batches), F)).astype(np.float32)
    # (case, LUTs per layer, fan-in, PEN fraction bits, batches, where
    # the model must be: "split" = staged, the last layer over at least
    # two blocks from B = 4096 on; "global" = read from global memory)
    cases = [("lg-2400", (m,), n, None, batches, None),
             ("stack-120-50", (120, 50), n, None, batches[2:], None),
             ("stack-fan8-256-60", (256, 60), 8, None, batches[1:], None),
             ("lg-2400-pen9", (m,), n, 8, batches[:3], None),
             ("fan10-2050", (2050,), 10, None, batches, "split"),
             ("fan15-70", (70,), 15, None, batches[2:], "split"),
             ("fan16-40", (40,), 16, None, batches[1:], "global"),
             ("stack-fan16-40-70", (40, 70), 16, None, batches[2:],
              "global")]
    kernels = {"packed": (K.fused_dwn_packed, R.fused_dwn_packed_plain),
               "batch-major": (K.fused_dwn_batch_major,
                               R.fused_dwn_batch_major_plain)}
    checks, max_err, timing = [], {v: 0.0 for v in kernels}, {}
    for case, counts, fan_in, frac, bs, where in cases:
        th, maps, tabs = make_model(rng, F, T, counts, fan_in, frac)
        th_d = torch.from_numpy(th).to(device)
        maps_d = [torch.from_numpy(a).to(device) for a in maps]
        tabs_d = [torch.from_numpy(a).to(device) for a in tabs]
        for variant, (kern, plain) in kernels.items():
            ops = prepare_operands(th_d, maps_d, tabs_d, C, variant)
            for B in bs:
                xb = x_all[:B]
                if frac is not None:
                    xb = quantize_fixed_point(xb, frac).astype(np.float32)
                x = torch.from_numpy(np.ascontiguousarray(xb)).to(device)
                ref_c, ref_i = plain(x, *ops)
                for block_b in (block_default, *BLOCK_B_CHECKED):
                    got_c, got_i = kern(x, *ops, block_b=block_b)
                    torch.cuda.synchronize()
                    err = float((got_c - ref_c).abs().max()) if B else 0.0
                    equal = bool(torch.equal(got_c, ref_c)
                                 and torch.equal(got_i, ref_i))
                    lay = K.last_launch()
                    placed = (where is None or not B
                              or (where == "global") == (not lay["staged"])
                              and (where != "split" or B < 4096
                                   or lay["slices"] > 1))
                    checks.append({"case": case, "variant": variant,
                                   "B": B, "block_b": block_b,
                                   "equal": equal, "layout": lay})
                    max_err[variant] = max(max_err[variant], err)
                    if not (equal and placed):
                        emit({"phase": "kernels", "checks": checks})
                        raise SystemExit(
                            f"{variant} kernel differs from its plain "
                            f"version or is not {where}: {case}, B={B}, "
                            f"block_b={block_b}, max |diff| {err}, {lay}")
            if case == "lg-2400":
                x = torch.from_numpy(x_all[:time_batch]).to(device)
                timing[variant] = {
                    "ms": graph_ms(lambda: kern(x, *ops,
                                                block_b=block_default)),
                    "eager_ms": time_ms(lambda: kern(
                        x, *ops, block_b=block_default), iters=200,
                        warmup=10),
                    "plain_ms": time_ms(lambda: plain(x, *ops), iters=5,
                                        warmup=1),
                    **_bound(variant, time_batch, F, T, counts, n, C),
                    "bucket_ms": {
                        B: graph_ms(lambda B=B: kern(
                            x[:B], *ops, block_b=block_default))
                        for B in SERVED_BUCKETS},
                    "bucket_layout": {
                        B: (kern(x[:B], *ops, block_b=block_default),
                            K.last_launch())[1]
                        for B in SERVED_BUCKETS},
                    "bucket_bound_ms": {
                        B: _bound(variant, B, F, T, counts, n, C)[
                            "bound_ms"] for B in SERVED_BUCKETS},
                    "block_b_ms": {
                        bb: graph_ms(lambda bb=bb: kern(x, *ops,
                                                        block_b=bb))
                        for bb in BLOCK_B_SWEEP}}
    timing["zero"] = _zero_kernel(device, F=F, C=C)
    emit({"phase": "kernels", "checks": len(checks),
          "all_equal": all(c["equal"] for c in checks),
          "max_abs_err": max_err, "timing_batch": time_batch,
          "block_b": block_default,
          "layouts": sorted({(c["case"], c["layout"]["staged"],
                              c["layout"]["slices"]) for c in checks
                             if c["B"]}),
          "timing": timing})
    return max_err, timing


def _zero_kernel(device, F, C, B=1024):
    """The zero kernel on its own at the size a split launch of B rows
    gives it (B*C counts and a counter per tile of 32), on a buffer of
    garbage: equal to ``Tensor.zero_``, then timed beside it in CUDA
    graphs."""
    import torch
    from repro_torch.kernels.fused import kernel as K
    n = B * C + (B + 31) // 32
    buf = torch.randint(1, 2 ** 30, (n,), dtype=torch.int32, device=device)
    K.fused_dwn_zero(buf)
    torch.cuda.synchronize()
    err = float(buf.abs().max())
    if err:
        raise SystemExit(f"fused_dwn_zero left {err} in its buffer")
    nbytes = 4 * n
    zero_ms = graph_ms(lambda: buf.zero_())
    return {"ms": graph_ms(lambda: K.fused_dwn_zero(buf)),
            "plain_ms": zero_ms, "library_ms": zero_ms, "max_abs_err": err,
            "bound_ms": nbytes / PEAK_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "bytes": nbytes, "B": B}


STAGES = {
    # kernel: (source, the TPU kernel it replaces, bytes/ops variant)
    "thermometer_encode_packed": (
        "src/repro_torch/kernels/thermometer/csrc/thermometer.cu",
        "src/repro/kernels/thermometer/kernel.py:78", "thermometer"),
    "lut_eval_packed": (
        "src/repro_torch/kernels/lut_eval/csrc/lut_eval.cu",
        "src/repro/kernels/lut_eval/kernel.py:99", "lut_eval"),
    "popcount_classify_packed": (
        "src/repro_torch/kernels/popcount/csrc/popcount.cu",
        "src/repro/kernels/popcount/kernel.py:79", "popcount"),
}


def _bound(variant, B, F, T, counts, n, C):
    nbytes, ops = model_bytes_and_ops(variant, B, F, T, counts, n, C)
    by_bytes, by_ops = nbytes / PEAK_BYTES_PER_S, ops_seconds(ops)
    return {"bound_ms": max(by_bytes, by_ops) * 1e3,
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "bytes": nbytes, "operations": sum(ops.values()),
            "operations_by_class": ops}


def _stage_kernels():
    """The wrapper modules of the stage kernels (thermometer, LUT layer,
    popcount; each holds a float and a packed kernel)."""
    from repro_torch.kernels.lut_eval import kernel as KL
    from repro_torch.kernels.popcount import kernel as KP
    from repro_torch.kernels.thermometer import kernel as KT
    return KT, KL, KP


def _kernel_modules():
    """Every kernel wrapper module: the fused kernels', the stages' and
    flash attention's."""
    from repro_torch.kernels.flash_attn import kernel as KA
    from repro_torch.kernels.fused import kernel as KF
    return (KF, *_stage_kernels(), KA)


def _reset_counts():
    for K in _kernel_modules():
        K.reset_launch_counts()


def _expect_launches(what, want):
    """Every kernel's launches since :func:`_reset_counts`; raise unless
    they are ``want`` (kernels it does not name: 0)."""
    got = {name: n for K in _kernel_modules()
           for name, n in K.launch_counts().items()}
    want = {name: want.get(name, 0) for name in got}
    if got != want:
        raise SystemExit(f"{what} launched {got}, not {want}")
    return {name: n for name, n in got.items() if n}


def _staged_pass(x, th, maps, tabs, C):
    """One pass of the staged path through the public ops, counts set to
    0 just before and read just after; returns (counts, idx, launches)."""
    import torch
    from repro_torch.kernels.lut_eval.ops import evaluate_packed
    from repro_torch.kernels.popcount.ops import classify_packed
    from repro_torch.kernels.thermometer.ops import encode_packed
    _reset_counts()
    packed = encode_packed(x, th)
    for mp, tb in zip(maps, tabs):
        packed = evaluate_packed(packed, mp, tb)
    counts, idx = classify_packed(packed, C)
    torch.cuda.synchronize()
    launches = _expect_launches("staged pass", {
        "thermometer_encode_packed": 1, "lut_eval_packed": len(maps),
        "popcount_classify_packed": 1})
    return counts, idx, launches


#: the LUT-layer kernel's path on each staged case ("tiles": the layer
#: staged per block; "rows": the rows kernel, for rows too wide for a tile
#: or fan-in 16, whose word of LUTs does not fit a block)
K4_PATHS = {"fan16-480": "rows", "wide-7264": "rows"}
#: the packed encode's path on each staged case ("tiles" where not named:
#: tiles of 32 samples, the slice's thresholds staged per block; "rows":
#: the rows kernel, for features too many for a tile)
K3_PATHS = {"wide-500x4": "rows"}
#: the packed classify's path on each staged case ("tiles" where not
#: named: a block a tile of 32 samples, the rows and the masks staged in
#: shared memory; "rows": the rows kernel, for rows too wide for a tile
#: and for more than 32 classes)
K5_PATHS = {"wide-1566": "rows", "c33": "rows"}
#: K5 alone: (case, W words, C classes, masks): random masks with all-zero
#: and all-one words, strided masks (bit i to class i % C), MNIST-lg
#: (2000 LUTs, 10 classes: 63 words), the widest row a tile takes at 5
#: classes and one word wider, 32 classes (the most a tile takes) and 33,
#: and all-zero words (every class ties, idx 0) under lg's class groups
K5_CASES = (("random-masks", 75, 5, "random"), ("strided", 75, 5, "strided"),
            ("mnist-lg-c10", 63, 10, "groups"),
            ("wide-1565", 1565, 5, "random"),
            ("wide-1566", 1566, 5, "random"), ("c32", 75, 32, "strided"),
            ("c33", 75, 33, "random"), ("zero-words", 75, 5, "groups"))


def _k5_operands(rng, case, W, C, kind, B, device):
    """K5's words (B, W) and class masks (C, W), int32 bit patterns on
    ``device``, for a case of :data:`K5_CASES`."""
    import torch
    from repro_torch.core import bitpack as bp
    if kind == "groups":
        masks = bp.group_masks_np(32 * W - 32 * W % C, C).astype(np.uint64)
    elif kind == "strided":
        masks = bp.pack_bits_np(np.arange(W * 32)[None] % C
                                == np.arange(C)[:, None]).astype(np.uint64)
    else:
        masks = rng.integers(0, 2 ** 32, (C, W), dtype=np.uint64)
        masks[:, ::5] = 0
        masks[:, 1::7] = 2 ** 32 - 1
    words = rng.integers(0, 2 ** 32, (B, W), dtype=np.uint64)
    if case == "zero-words":
        words[:] = 0
    return tuple(bp.to_word_pattern(torch.from_numpy(a.astype(
        np.int64))).to(device) for a in (words, masks))


def phase_staged(device, batches=(4096, 4097, 1000, 33, 31, 1),
                 time_batch=4096):
    """The three stage kernels equal to their plain versions (K4 also at
    fan-in 1, 10 and 16, on the widest input rows it takes and in a CUDA
    graph replay, each launch's path held to :data:`K4_PATHS`; K3 also on
    NaN and denormal features, thresholds too large for a block, features
    too many for a tile and in a CUDA graph replay, each launch's path
    held to :data:`K3_PATHS`; K5 also on :data:`K5_CASES` and in a CUDA
    graph replay, each launch's path held to :data:`K5_PATHS`); the staged
    path equal to the fused kernel and the float oracle; timings, K3, K4
    and K5 also at the served buckets beside their first designs, and the
    launch floor (the zero kernel on one element in a CUDA graph)."""
    import torch
    from repro_torch.core import bitpack as bp
    from repro_torch.core.classifier import predict
    from repro_torch.core.model import JSC_PRESETS, FrozenDWN, apply_hard
    from repro_torch.core.thermometer import quantize_fixed_point
    from repro_torch.kernels.fused import kernel as KF
    from repro_torch.kernels.fused import ref as FR
    from repro_torch.kernels.fused.ops import make_forward_packed
    from repro_torch.kernels.lut_eval import kernel as KL
    from repro_torch.kernels.lut_eval import ref as RL
    from repro_torch.kernels.popcount import kernel as KP
    from repro_torch.kernels.popcount import ref as RP
    from repro_torch.kernels.thermometer import kernel as KT
    from repro_torch.kernels.thermometer import ref as RT

    rng = np.random.default_rng(1)
    F, T, m, n, C = (LG[k] for k in ("F", "T", "m", "n", "C"))
    x_all = rng.uniform(-1, 1, (max(batches), F)).astype(np.float32)
    # (case, F, T, LUTs per layer, fan-in, PEN fraction bits, batches)
    cases = [("lg-2400", F, T, (m,), n, None, batches),
             ("stack-120-50", F, T, (120, 50), n, None, batches[2:]),
             ("lg-2400-pen9", F, T, (m,), n, 8, batches[:3]),
             ("ragged-3x7", 3, 7, (40,), n, None, batches[2:]),
             ("fan1-480", F, T, (480,), 1, None, batches[2:4]),
             ("fan10-480", F, T, (480,), 10, None, batches[2:4]),
             ("fan16-480", F, T, (480,), 16, None, batches[2:4])]
    checks, max_err, models = [], dict.fromkeys(STAGES, 0.0), {}
    k4_paths, k3_paths, k5_paths = {}, {}, {}

    def held(name, case, B, got, ref, **extra):
        err = float((got.double() - ref.double()).abs().max()) if B else 0.0
        equal = bool(torch.equal(got, ref))
        checks.append({"kernel": name, "case": case, "B": B,
                       "equal": equal, **extra})
        max_err[name] = max(max_err[name], err)
        if not equal:
            emit({"phase": "staged", "checks": checks})
            raise SystemExit(f"{name} differs from its plain version: "
                             f"{case}, B={B}, max |diff| {err}")

    def k3_held(case, B, x, th_d):
        words = KT.thermometer_encode_packed(x, th_d)
        torch.cuda.synchronize()
        path = KT.last_launch()["path"]
        k3_paths[case] = path
        held("thermometer_encode_packed", case, B,
             bp.from_word_pattern(words),
             RT.thermometer_packed_plain(x, th_d), path=path)
        if path != K3_PATHS.get(case, "tiles"):
            raise SystemExit(f"thermometer_encode_packed took the {path} "
                             f"path on {case}, B={B}")
        return words

    def k4_held(case, B, words, widx, boff, tab):
        out = KL.lut_eval_packed(words, widx, boff, tab)
        torch.cuda.synchronize()
        path = KL.last_launch()["path"]
        k4_paths[case] = path
        held("lut_eval_packed", case, B, bp.from_word_pattern(out),
             RL.lut_eval_packed_plain(words, widx, boff, tab), path=path)
        if B and path != K4_PATHS.get(case, "tiles"):
            raise SystemExit(f"lut_eval_packed took the {path} path on "
                             f"{case}, B={B}")
        m_l = widx.shape[0]
        if bp.unpack_bits(out, out.shape[1] * 32)[:, m_l:].any():
            raise SystemExit(f"lut_eval_packed set a pad bit past "
                             f"LUT {m_l}: {case}, B={B}")
        return out

    def k5_held(case, B, words, masks):
        got_c, got_i = KP.popcount_classify_packed(words, masks)
        torch.cuda.synchronize()
        path = KP.last_launch()["path"]
        k5_paths[case] = path
        ref_c, ref_i = RP.popcount_classify_packed_plain(words, masks)
        held("popcount_classify_packed", case, B, got_c, ref_c, path=path)
        held("popcount_classify_packed", case, B, got_i, ref_i, path=path)
        if path != K5_PATHS.get(case, "tiles"):
            raise SystemExit(f"popcount_classify_packed took the {path} "
                             f"path on {case}, B={B}")
        return got_c, got_i

    for case, Fc, Tc, counts, fan_in, frac, bs in cases:
        th, maps, tabs = make_model(rng, Fc, Tc, counts, fan_in, frac)
        th_d = torch.from_numpy(th).to(device)
        maps_d = [torch.from_numpy(a).to(device) for a in maps]
        tabs_d = [torch.from_numpy(a).to(device) for a in tabs]
        layers, cand = [], Fc * Tc
        for mp, tb in zip(maps_d, tabs_d):
            stack = FR.LayerStack.build([mp], [tb], cand, device)
            layers.append(next(stack.layers()))
            cand = mp.shape[0]
        masks = bp.to_word_pattern(bp.group_masks(cand, C, device))
        models[case] = (th, maps, tabs, th_d, maps_d, tabs_d, layers, masks)
        for B in bs:
            xb = np.ascontiguousarray(x_all[:B, :Fc])
            if frac is not None:
                xb = quantize_fixed_point(xb, frac).astype(np.float32)
            x = torch.from_numpy(xb).to(device)
            words = k3_held(case, B, x, th_d)
            for widx, boff, tab in layers:
                words = k4_held(case, B, words, widx, boff, tab)
            k5_held(case, B, words, masks)

    # K4 alone on the widest input rows the rows kernel takes (7264 words:
    # rows path) and on the widest a tile takes (454 words), random words
    for case, W_in, B in (("wide-7264", 7264, 100), ("wide-454", 454, 1000)):
        words = bp.to_word_pattern(torch.from_numpy(rng.integers(
            0, 2 ** 32, (B, W_in), dtype=np.uint64).astype(np.int64))).to(
            device)
        mp = torch.from_numpy(rng.integers(0, W_in * 32, (256, n)).astype(
            np.int32)).to(device)
        tb = torch.from_numpy(rng.integers(0, 2, (256, 2 ** n)).astype(
            np.int32)).to(device)
        k4_held(case, B, words,
                *next(FR.LayerStack.build([mp], [tb], W_in * 32,
                                          device).layers()))
    # K3 alone, features from a generator of their own: NaN and denormal
    # features (IEEE compares: NaN is false, a denormal above a 0.0
    # threshold), thresholds too large for one block (16 x 4000, 250 KB:
    # several slices at any B) and features too many for a tile (500: the
    # rows kernel)
    rng3 = np.random.default_rng(5)
    for case, Fc, Tc in (("nan-denormal", F, T), ("th-16x4000", 16, 4000),
                         ("wide-500x4", 500, 4)):
        xs = rng3.uniform(-1, 1, (max(batches), Fc)).astype(np.float32)
        ths = np.sort(rng3.uniform(-1, 1, (Fc, Tc)).astype(np.float32),
                      axis=1)
        if case == "nan-denormal":
            xs[::7, 3] = np.nan
            xs[1::7, 0], xs[2::7, 0], ths[0, 0] = 1e-40, -1e-40, 0.0
        ths_d = torch.from_numpy(ths).to(device)
        for B in batches:
            k3_held(case, B, torch.from_numpy(xs[:B]).to(device), ths_d)
    # K5 alone (K5_CASES), operands from a generator of their own
    rng5 = np.random.default_rng(6)
    for case, W5, C5, kind in K5_CASES:
        words, masks5 = _k5_operands(rng5, case, W5, C5, kind,
                                     max(batches), device)
        for B in batches:
            got_c, got_i = k5_held(case, B, words[:B], masks5)
            if case == "zero-words" and (got_c.any() or got_i.any()):
                raise SystemExit(f"zero-words: a count or a class is not 0 "
                                 f"at B={B}")
    # a CUDA graph replay equals the eager call (lg-2400, B = 4096)
    th_d, layers = models["lg-2400"][3], models["lg-2400"][6]
    x = torch.from_numpy(x_all[:time_batch]).to(device)
    w0 = KT.thermometer_encode_packed(x, th_d)
    held("thermometer_encode_packed", "lg-2400-graph-replay", time_batch,
         replayed(lambda: KT.thermometer_encode_packed(x, th_d)), w0)
    eager = KL.lut_eval_packed(w0, *layers[0])
    graphed = replayed(lambda: KL.lut_eval_packed(w0, *layers[0]))
    held("lut_eval_packed", "lg-2400-graph-replay", time_batch, graphed,
         eager)
    w1, masks = eager, models["lg-2400"][7]
    replay = replayed(lambda: KP.popcount_classify_packed(w1, masks))
    for got, want in zip(replay, KP.popcount_classify_packed(w1, masks)):
        held("popcount_classify_packed", "lg-2400-graph-replay", time_batch,
             got, want)

    # the staged path end to end at dwn-jsc-lg width, then on the stack
    launches = dict.fromkeys(STAGES, 0)
    passes = {}
    for case in ("lg-2400", "stack-120-50"):
        th, maps, tabs, th_d, maps_d, tabs_d, _, _ = models[case]
        counts, idx, got = _staged_pass(x, th_d, maps_d, tabs_d, C)
        for name in launches:
            launches[name] += got[name]
        k2_c, k2_i = make_forward_packed(th_d, maps_d, tabs_d, C)(x)
        cfg = (JSC_PRESETS["lg-2400"] if case == "lg-2400" else
               dataclasses.replace(JSC_PRESETS["lg-2400"],
                                   lut_counts=(120, 50)))
        oracle = apply_hard(FrozenDWN(cfg, th, maps, tabs), x)
        passes[case] = {
            "launches": got,
            "equal_fused_packed": bool(torch.equal(counts, k2_c)
                                       and torch.equal(idx, k2_i)),
            "equal_apply_hard": bool(torch.equal(counts, oracle) and
                                     torch.equal(idx, predict(oracle)))}
        if not all(v for k, v in passes[case].items() if k != "launches"):
            emit({"phase": "staged", "passes": passes})
            raise SystemExit(f"staged path differs on {case}: "
                             f"{passes[case]}")

    # times at time_batch, lg-2400, prepared operands
    th, maps, tabs, th_d, maps_d, tabs_d, layers, masks = models["lg-2400"]
    [(widx, boff, tab)] = layers
    w0 = KT.thermometer_encode_packed(x, th_d)
    w1 = KL.lut_eval_packed(w0, widx, boff, tab)
    shape = (time_batch, F, T, (m,), n, C)
    kern = {"thermometer_encode_packed": (
                lambda: KT.thermometer_encode_packed(x, th_d),
                lambda: RT.thermometer_packed_plain(x, th_d)),
            "lut_eval_packed": (
                lambda: KL.lut_eval_packed(w0, widx, boff, tab),
                lambda: RL.lut_eval_packed_plain(w0, widx, boff, tab)),
            "popcount_classify_packed": (
                lambda: KP.popcount_classify_packed(w1, masks),
                lambda: RP.popcount_classify_packed_plain(w1, masks))}
    # "ms": the card's time per launch (CUDA graph); "eager_ms": a loop of
    # wrapper calls, which measures the host where it is the slower
    timing = {}
    for name, (fn, plain) in kern.items():
        timing[name] = {"ms": graph_ms(fn),
                        "eager_ms": time_ms(fn, iters=200, warmup=10),
                        "plain_ms": time_ms(plain, iters=5, warmup=1),
                        **_bound(STAGES[name][2], *shape)}
    # K4 at the served buckets, with each launch's layout
    timing["lut_eval_packed"]["bucket_ms"] = {
        B: graph_ms(lambda B=B: KL.lut_eval_packed(w0[:B], widx, boff, tab))
        for B in SERVED_BUCKETS}
    timing["lut_eval_packed"]["bucket_layout"] = {
        B: (KL.lut_eval_packed(w0[:B], widx, boff, tab),
            KL.last_launch())[1] for B in SERVED_BUCKETS}
    timing["lut_eval_packed"]["bucket_bound_ms"] = {
        B: _bound("lut_eval", B, *shape[1:])["bound_ms"]
        for B in SERVED_BUCKETS}
    # the first design (one warp a sample), kept as the rows kernel, in the
    # same call, and its output at time_batch held to the plain version
    out_rows = torch.empty_like(w1)

    def k4_rows(B):
        return rows_kernel(
            KL.LIBRARY, KL._SIGNATURES, "lut_eval_packed_rows_launch",
            w0.data_ptr(), B, w0.shape[1], widx.data_ptr(),
            boff.data_ptr(), tab.data_ptr(), m, n, tab.shape[1],
            out_rows.data_ptr(), 1)
    timing["lut_eval_packed"]["rows_kernel_bucket_ms"] = {
        B: graph_ms(k4_rows(B)) for B in SERVED_BUCKETS}
    out_rows.zero_()
    k4_rows(time_batch)()
    torch.cuda.synchronize()
    held("lut_eval_packed", "lg-2400-rows-kernel", time_batch,
         bp.from_word_pattern(out_rows),
         RL.lut_eval_packed_plain(w0, widx, boff, tab))
    # K3 at the served buckets, with each launch's layout, beside its
    # first design (one warp a sample's 32 words), kept as the rows kernel,
    # whose output at time_batch is held to the plain version
    k3 = timing["thermometer_encode_packed"]
    k3["bucket_ms"] = {
        B: graph_ms(lambda B=B: KT.thermometer_encode_packed(x[:B], th_d))
        for B in SERVED_BUCKETS}
    k3["bucket_layout"] = {
        B: (KT.thermometer_encode_packed(x[:B], th_d), KT.last_launch())[1]
        for B in SERVED_BUCKETS}
    k3["bucket_bound_ms"] = {
        B: _bound("thermometer", B, *shape[1:])["bound_ms"]
        for B in SERVED_BUCKETS}
    enc_rows = torch.empty_like(w0)

    def k3_rows(B):
        return rows_kernel(
            KT.LIBRARY, KT._SIGNATURES,
            "thermometer_encode_packed_rows_launch", x.data_ptr(),
            th_d.data_ptr(), B, F, T, enc_rows.data_ptr())
    k3["rows_kernel_bucket_ms"] = {B: graph_ms(k3_rows(B))
                                   for B in SERVED_BUCKETS}
    # the wrapper's own cost on each path in this call: loops of wrapper
    # calls at time_batch with the plan the shapes give (tiles; its loop is
    # "eager_ms") and with the rows plan put in its place
    enc = kern["thermometer_encode_packed"][0]
    k3["host_ms"] = host_ms(enc)
    planner = KT.plan_thermometer_encode_packed
    KT.plan_thermometer_encode_packed = \
        lambda *a: KT.EncodePlan("rows", 1, w0.shape[1], 0)
    try:
        k3["rows_host_ms"] = host_ms(enc)
        k3["rows_eager_ms"] = time_ms(enc, iters=200, warmup=10)
    finally:
        KT.plan_thermometer_encode_packed = planner
    enc_rows.zero_()
    k3_rows(time_batch)()
    torch.cuda.synchronize()
    held("thermometer_encode_packed", "lg-2400-rows-kernel", time_batch,
         bp.from_word_pattern(enc_rows), RT.thermometer_packed_plain(x, th_d))
    # K5 likewise: at the served buckets with each launch's plan, beside its
    # first design (one warp a sample), kept as the rows kernel, whose
    # output at time_batch is held to the plain version; the wrapper's host
    # time a call; and the launch floor, the least time one launch takes
    # in a CUDA graph on this card: the zero kernel on one element
    k5 = timing["popcount_classify_packed"]
    k5["bucket_ms"] = {
        B: graph_ms(lambda B=B: KP.popcount_classify_packed(w1[:B], masks))
        for B in SERVED_BUCKETS}
    k5["bucket_layout"] = {
        B: (KP.popcount_classify_packed(w1[:B], masks), KP.last_launch())[1]
        for B in SERVED_BUCKETS}
    k5["bucket_bound_ms"] = {
        B: _bound("popcount", B, *shape[1:])["bound_ms"]
        for B in SERVED_BUCKETS}
    k5["kernel"] = "popcount_classify_packed_kernel"
    cls_rows = (torch.empty((time_batch, C), dtype=torch.float32,
                            device=device),
                torch.empty((time_batch,), dtype=torch.int32, device=device))

    def k5_rows(B):
        return rows_kernel(
            KP.LIBRARY, KP._SIGNATURES,
            "popcount_classify_packed_rows_launch", w1.data_ptr(), B,
            w1.shape[1], masks.data_ptr(), C, cls_rows[0].data_ptr(),
            cls_rows[1].data_ptr())
    k5["rows_kernel_bucket_ms"] = {B: graph_ms(k5_rows(B))
                                   for B in SERVED_BUCKETS}
    k5["host_ms"] = host_ms(kern["popcount_classify_packed"][0])
    one = torch.ones((1,), dtype=torch.int32, device=device)
    k5["launch_floor_ms"] = graph_ms(lambda: KF.fused_dwn_zero(one))
    cls_rows[0].fill_(-1.0)
    cls_rows[1].fill_(-1)
    k5_rows(time_batch)()
    torch.cuda.synchronize()
    for got, want in zip(cls_rows,
                         RP.popcount_classify_packed_plain(w1, masks)):
        held("popcount_classify_packed", "lg-2400-rows-kernel", time_batch,
             got, want)
    fused = make_forward_packed(th_d, maps_d, tabs_d, C)

    def three():
        return KP.popcount_classify_packed(KL.lut_eval_packed(
            KT.thermometer_encode_packed(x, th_d), widx, boff, tab), masks)
    staged = {
        "kernels_ms": graph_ms(three),
        "kernels_eager_ms": time_ms(three, iters=200, warmup=10),
        "ops_ms": time_ms(lambda: _staged_pass(x, th_d, maps_d, tabs_d, C),
                          iters=20, warmup=2),
        "bound_ms": sum(t["bound_ms"] for t in timing.values()),
        "fused_packed_ms": graph_ms(lambda: fused(x)),
        "fused_packed_eager_ms": time_ms(lambda: fused(x), iters=200,
                                         warmup=10),
        "fused_packed_bound_ms": _bound("packed", *shape)["bound_ms"]}
    emit({"phase": "staged", "checks": len(checks),
          "all_equal": all(c["equal"] for c in checks),
          "lut_eval_packed_paths": k4_paths,
          "thermometer_encode_packed_paths": k3_paths,
          "popcount_classify_packed_paths": k5_paths,
          "max_abs_err": max_err, "passes": passes,
          "timing_batch": time_batch, "timing": timing, "staged": staged})
    return max_err, timing, launches


FLOAT = {
    # kernel: (source, the TPU kernel it replaces, bytes/ops variant)
    "thermometer_encode": (
        "src/repro_torch/kernels/thermometer/csrc/thermometer.cu",
        "src/repro/kernels/thermometer/kernel.py:44", "float_thermometer"),
    "lut_eval": (
        "src/repro_torch/kernels/lut_eval/csrc/lut_eval.cu",
        "src/repro/kernels/lut_eval/kernel.py:54", "float_lut_eval"),
    "popcount_classify": (
        "src/repro_torch/kernels/popcount/csrc/popcount.cu",
        "src/repro/kernels/popcount/kernel.py:41", "float_popcount"),
    "fused_dwn": (
        "src/repro_torch/kernels/fused/csrc/fused_dwn.cu",
        "src/repro/kernels/fused/kernel.py:107", "float_fused"),
    # K6's second kernel: each class's chunk sums in order, the argmax
    "fused_dwn_combine": (
        "src/repro_torch/kernels/fused/csrc/fused_dwn.cu",
        "src/repro/kernels/fused/kernel.py:107", "float_combine"),
}
#: where an operand is not {0,1} the float kernels are held to their plain
#: versions within a tolerance (nvcc contracts a*b+c into FMA, eager
#: PyTorch rounds twice): the reference's own for soft bits in the LUT
#: layer (tests/test_kernels.py:54) and for float tables in the fused
#: kernel (tests/test_kernels.py:85).  Every other check is exact.
SOFT_BITS_ATOL = 1e-5
FLOAT_TABLES_ATOL = 1e-4
#: fused_dwn's samples per tile (rounded up to 32) and most LUTs per slice
#: (cut to whole chunks of 32 and class groups; None, the default: as
#: many as fit, one class group of 480 LUTs at lg-2400) swept at B=4096
FUSED_DWN_BLOCK_B_SWEEP = (32, 64, 128)
FUSED_DWN_BLOCK_M_SWEEP = (64, 128, 256, None)
#: (block_b, block_m) fused_dwn is also held to its plain version at, B =
#: 1000: below a chunk, one sample a tile, between chunks, the
#: FusedConfig default, more samples than a block holds, more LUTs than a
#: tile block holds (cut to the widest slice that fits; the most the rows
#: kernel took at fan-in 6)
FUSED_DWN_CHECKED = ((7, 7), (1, 256), (64, 100), (32, 128), (4096, 512),
                     (32, 764))
#: features of the float phase's wide case: two tiles of 32 samples'
#: features take over half a block, so fused_dwn sends it to the rows
#: kernel (K6_PATHS)
WIDE_F = 500
#: the float fused kernel's path on each float case ("tiles" where not
#: named: the model's slice staged per block; "rows": the rows kernel)
K6_PATHS = {"wide-500": "rows"}
#: the float LUT layer's path on each float case ("tiles" where not named:
#: tiles of 16 rows, lanes over LUTs; "rows": the rows kernel, for rows
#: too wide for a tile, over 3632 bits)
K8_PATHS = {"wide-3633": "rows", "wide-58112": "rows"}
#: (case, C bits, LUTs, fan-in) of the float LUT layer alone, on random
#: {0,1} bits: the widest rows a tile takes, the narrowest the rows kernel
#: takes and the widest it takes
WIDE_K8 = (("wide-3632", 3632, 300, 6), ("wide-3633", 3633, 300, 6),
           ("wide-58112", 58_112, 64, 6))


def _float_pass(x, th, maps, tabs, C):
    """One pass of the float staged path through the public ops, counts
    set to 0 just before and read just after; returns (counts, idx,
    launches)."""
    import torch
    from repro_torch.kernels.lut_eval.ops import evaluate
    from repro_torch.kernels.popcount.ops import classify
    from repro_torch.kernels.thermometer.ops import encode
    _reset_counts()
    bits = encode(x, th)
    for mp, tb in zip(maps, tabs):
        bits = evaluate(bits, mp, tb)
    counts, idx = classify(bits, C)
    torch.cuda.synchronize()
    launches = _expect_launches("float pass", {
        "thermometer_encode": 1, "lut_eval": len(maps),
        "popcount_classify": 1})
    return counts, idx, launches


def _forward_pass(x, th, mapping, tables, C):
    """One call of the float fused op, counts set to 0 just before and
    read just after; returns (counts, idx, launches)."""
    import torch
    from repro_torch.kernels.fused.ops import forward
    _reset_counts()
    counts, idx = forward(x, th, mapping, tables, C)
    torch.cuda.synchronize()
    return (counts, idx,
            _expect_launches("forward", {"fused_dwn": 1,
                                         "fused_dwn_combine": 1}))


def phase_float(device, batches=(4096, 4097, 1000, 33, 31, 1),
                time_batch=4096):
    """The four float kernels equal to their plain versions (K6 at fan-in
    1 to 8, at every (block_b, block_m) of :data:`FUSED_DWN_CHECKED`,
    bitwise the same in two calls and in a CUDA graph replay on float
    tables, its combine kernel alone; K8 at fan-in 1 to 8, on the widest
    rows of each path and in a CUDA graph replay, each launch's path held
    to :data:`K8_PATHS`); the float staged path equal to the
    float fused kernel, the packed staged path, the packed fused kernel
    and the float oracle; timings, K6 and K8 also at the served buckets
    beside their first designs."""
    import torch
    from repro_torch.core.classifier import predict
    from repro_torch.core.model import JSC_PRESETS, FrozenDWN, apply_hard
    from repro_torch.core.thermometer import quantize_fixed_point
    from repro_torch.kernels.autotune import FusedConfig
    from repro_torch.kernels.fused import kernel as KF
    from repro_torch.kernels.fused import ref as RF
    from repro_torch.kernels.fused.ops import make_forward_packed
    from repro_torch.kernels.lut_eval import ref as RL
    from repro_torch.kernels.popcount import ref as RP
    from repro_torch.kernels.thermometer import ref as RT
    KT, KL, KP = _stage_kernels()

    rng = np.random.default_rng(2)
    F, T, m, n, C = (LG[k] for k in ("F", "T", "m", "n", "C"))
    x_all = rng.uniform(-1, 1, (max(batches), F)).astype(np.float32)
    # (case, F, T, LUTs per layer, fan-in, PEN fraction bits, batches)
    cases = [("lg-2400", F, T, (m,), n, None, batches),
             ("stack-120-50", F, T, (120, 50), n, None, batches[2:]),
             ("lg-2400-pen9", F, T, (m,), n, 8, batches[:3]),
             ("ragged-3x7", 3, 7, (40,), n, None, batches[2:]),
             ("lg-2402", F, T, (m + 2,), n, None, batches[:3]),
             *((f"fan{k}-1000", F, T, (1000,), k, None, batches[2:4])
               for k in range(1, 9) if k != n),
             ("wide-500", WIDE_F, 4, (130,), n, None, (4097, 1000, 33))]
    # features of the wide case, from a generator of their own
    x_wide = np.random.default_rng(3).uniform(
        -1, 1, (max(batches), WIDE_F)).astype(np.float32)
    checks, max_err, models = [], dict.fromkeys(FLOAT, 0.0), {}
    k6_paths, k8_paths = {}, {}

    def held(name, case, got, ref, atol=0.0, **extra):
        B = got.shape[0]
        err = float((got.double() - ref.double()).abs().max()) if B else 0.0
        ok = bool(torch.equal(got, ref)) if atol == 0.0 else err <= atol
        checks.append({"kernel": name, "case": case, "B": B,
                       "atol": atol, "ok": ok, **extra})
        max_err[name] = max(max_err[name], err)
        if not ok:
            emit({"phase": "float", "checks": checks})
            raise SystemExit(f"{name} differs from its plain version: "
                             f"{case}, B={B}, max |diff| {err} > {atol}")

    def corner_major(tab):
        return tab.to(torch.float32).T.contiguous()

    def k8_held(case, bits, mp, tb, atol=0.0):
        out = KL.lut_eval(bits, mp, corner_major(tb))
        torch.cuda.synchronize()
        path = KL.last_float_launch()["path"]
        k8_paths[case] = path
        held("lut_eval", case, out, RL.lut_eval_plain(bits, mp, tb), atol,
             path=path)
        if path != K8_PATHS.get(case, "tiles"):
            raise SystemExit(f"lut_eval took the {path} path on {case}, "
                             f"B={bits.shape[0]}")
        return out

    for case, Fc, Tc, counts, fan_in, frac, bs in cases:
        th, maps, tabs = make_model(rng, Fc, Tc, counts, fan_in, frac)
        th_d = torch.from_numpy(th).to(device)
        maps_d = [torch.from_numpy(a).to(device) for a in maps]
        tabs_d = [torch.from_numpy(a).to(device) for a in tabs]
        models[case] = (th, maps, tabs, th_d, maps_d, tabs_d)
        for B in bs:
            xb = np.ascontiguousarray((x_all if Fc <= F else x_wide)[:B, :Fc])
            if frac is not None:
                xb = quantize_fixed_point(xb, frac).astype(np.float32)
            x = torch.from_numpy(xb).to(device)
            bits = KT.thermometer_encode(x, th_d)
            torch.cuda.synchronize()
            held("thermometer_encode", case, bits,
                 RT.thermometer_plain(x, th_d))
            bits = bits.reshape(B, Fc * Tc)
            for mp, tb in zip(maps_d, tabs_d):
                bits = k8_held(case, bits, mp, tb)
            if bits.shape[1] % C == 0:
                got_c, got_i = KP.popcount_classify(bits, C)
                torch.cuda.synchronize()
                ref_c, ref_i = RP.popcount_classify_plain(bits, C)
                held("popcount_classify", case, got_c, ref_c)
                held("popcount_classify", case, got_i, ref_i)
            if len(counts) == 1:
                tab_f = tabs_d[0].to(torch.float32)
                ref_c, ref_i = RF.fused_dwn_plain(x, th_d, maps_d[0], tab_f,
                                                  C)
                blocks = [(KF.FUSED_DWN_BLOCK_B, None)]
                if B == 1000 and case == "lg-2400":
                    blocks += FUSED_DWN_CHECKED
                for bb, bm in blocks:
                    got_c, got_i = KF.fused_dwn(x, th_d, maps_d[0], tab_f, C,
                                                block_b=bb, block_m=bm)
                    torch.cuda.synchronize()
                    lay = KF.last_float_launch()
                    k6_paths[case] = lay["path"]
                    held("fused_dwn", case, got_c, ref_c, block_b=bb,
                         block_m=bm, path=lay["path"],
                         slices=lay["slices"])
                    held("fused_dwn", case, got_i, ref_i, block_b=bb,
                         block_m=bm)
                    if B and lay["path"] != K6_PATHS.get(case, "tiles"):
                        raise SystemExit(f"fused_dwn took the "
                                         f"{lay['path']} path: {case}, "
                                         f"B={B}, {bb}/{bm}")

    # denormal features against 0.0 thresholds: IEEE compares (no
    # flush-to-zero), so 1e-40 is above 0.0 and -1e-40 is not
    dn = torch.tensor([[1e-40, -1e-40, 0.0]], device=device)
    dn_bits = KT.thermometer_encode(dn, torch.zeros((3, 2), device=device))
    torch.cuda.synchronize()
    held("thermometer_encode", "denormals", dn_bits.reshape(1, 6),
         torch.tensor([[1.0, 1.0, 0.0, 0.0, 0.0, 0.0]], device=device))

    # the float LUT layer alone on random {0,1} bits from a generator of
    # its own: the widest rows of each path
    rng8 = np.random.default_rng(6)
    for case, Cw, mw, nw in WIDE_K8:
        bs = (1, 33, 100) if Cw > 3633 else (1, 33, 1000)
        bw = torch.from_numpy((rng8.random((max(bs), Cw)) < 0.5).astype(
            np.float32)).to(device)
        mpw = torch.from_numpy(rng8.integers(0, Cw, (mw, nw)).astype(
            np.int32)).to(device)
        tbw = torch.from_numpy(rng8.integers(0, 2, (mw, 2 ** nw)).astype(
            np.int32)).to(device)
        for B in bs:
            k8_held(case, bw[:B], mpw, tbw)

    # operands off {0,1}: soft bits into the LUT layer, float tables in
    # both; held within the stated tolerances
    th, maps, tabs, th_d, maps_d, tabs_d = models["lg-2400"]
    mp = maps_d[0]
    soft = torch.from_numpy(rng.uniform(0, 1, (1000, F * T)).astype(
        np.float32)).to(device)
    ftab = torch.from_numpy(rng.uniform(-1, 1, (m, 2 ** n)).astype(
        np.float32)).to(device)
    for label, tb in (("binary-tables", tabs_d[0].to(torch.float32)),
                      ("float-tables", ftab)):
        k8_held(f"soft-bits-{label}", soft, mp, tb, atol=SOFT_BITS_ATOL)
    x = torch.from_numpy(x_all[:time_batch]).to(device)
    for B in (time_batch, 4097, 1000, 33, 1):
        xb = torch.from_numpy(x_all[:B]).to(device)
        got_c, got_i = KF.fused_dwn(xb, th_d, mp, ftab, C)
        torch.cuda.synchronize()
        ref_c, ref_i = RF.fused_dwn_plain(xb, th_d, mp, ftab, C)
        held("fused_dwn", "float-tables", got_c, ref_c,
             atol=FLOAT_TABLES_ATOL)
        top2 = ref_c.topk(2, dim=-1).values
        clear = (top2[:, 0] - top2[:, 1]) > FLOAT_TABLES_ATOL
        held("fused_dwn", "float-tables-idx", got_i[clear], ref_i[clear],
             rows_compared=int(clear.sum()))
        # deterministic: a second call and a graph replay, bit for bit
        again = KF.fused_dwn(xb, th_d, mp, ftab, C)
        graphed = replayed(lambda: KF.fused_dwn(xb, th_d, mp, ftab, C))
        torch.cuda.synchronize()
        for label, out in (("again", again), ("graph-replay", graphed)):
            held("fused_dwn", f"float-tables-{label}", out[0], got_c)
            held("fused_dwn", f"float-tables-{label}", out[1], got_i)
    # the combine kernel alone on random chunk sums: the plain version
    # adds in the same order, so the two agree bit for bit
    cpc = -(-(m // C) // 32)
    part = torch.from_numpy(rng.uniform(-16, 16, (C * cpc, time_batch))
                            .astype(np.float32)).to(device)
    got = KF.fused_dwn_combine(part, C)
    torch.cuda.synchronize()
    ref = RF.fused_dwn_combine_plain(part, C)
    held("fused_dwn_combine", "random-chunk-sums", got[0], ref[0])
    held("fused_dwn_combine", "random-chunk-sums", got[1], ref[1])

    # the float path end to end at dwn-jsc-lg width, then on the stack
    launches = dict.fromkeys(FLOAT, 0)
    passes = {}
    for case in ("lg-2400", "stack-120-50"):
        th, maps, tabs, th_d, maps_d, tabs_d = models[case]
        counts, idx, got = _float_pass(x, th_d, maps_d, tabs_d, C)
        for name, k in got.items():
            launches[name] += k
        passes[case] = {"float_pass_launches": got}
        sc, si, _ = _staged_pass(x, th_d, maps_d, tabs_d, C)
        k2_c, k2_i = make_forward_packed(th_d, maps_d, tabs_d, C)(x)
        cfg = (JSC_PRESETS["lg-2400"] if case == "lg-2400" else
               dataclasses.replace(JSC_PRESETS["lg-2400"],
                                   lut_counts=(120, 50)))
        oracle = apply_hard(FrozenDWN(cfg, th, maps, tabs), x)
        same = {"equal_staged_packed": (sc, si),
                "equal_fused_packed": (k2_c, k2_i),
                "equal_apply_hard": (oracle, predict(oracle))}
        if case == "lg-2400":
            fc, fi, fgot = _forward_pass(x, th_d, maps_d[0], tabs_d[0], C)
            for name in ("fused_dwn", "fused_dwn_combine"):
                launches[name] += fgot[name]
            passes[case]["forward_launches"] = fgot
            same["equal_fused_dwn"] = (fc, fi)
        for key, (c, i) in same.items():
            passes[case][key] = bool(torch.equal(counts, c)
                                     and torch.equal(idx, i))
        if not all(v for k, v in passes[case].items() if k.startswith("eq")):
            emit({"phase": "float", "passes": passes})
            raise SystemExit(f"float path differs on {case}: "
                             f"{passes[case]}")

    # times at time_batch, lg-2400, prepared operands
    th, maps, tabs, th_d, maps_d, tabs_d = models["lg-2400"]
    B, g = time_batch, m // C
    mp, tab_f = maps_d[0], tabs_d[0].to(torch.float32)
    tab_t = corner_major(tab_f)
    bits = KT.thermometer_encode(x, th_d).reshape(B, -1)
    out = KL.lut_eval(bits, mp, tab_t)
    held("lut_eval", "lg-2400-graph-replay",
         replayed(lambda: KL.lut_eval(bits, mp, tab_t)), out)
    shape = (B, F, T, (m,), n, C)
    # name: (kernel, plain version, eager yardstick of two PyTorch calls
    # or None where no PyTorch call computes the function)
    kern = {
        "thermometer_encode": (
            lambda: KT.thermometer_encode(x, th_d),
            lambda: RT.thermometer_plain(x, th_d),
            lambda: (x[:, :, None] > th_d).float()),
        "lut_eval": (
            lambda: KL.lut_eval(bits, mp, tab_t),
            lambda: RL.lut_eval_plain(bits, mp, tab_f), None),
        "popcount_classify": (
            lambda: KP.popcount_classify(out, C),
            lambda: RP.popcount_classify_plain(out, C),
            lambda: out.view(B, C, g).sum(-1).argmax(-1)),
        "fused_dwn": (
            lambda: KF.fused_dwn(x, th_d, mp, tab_f, C),
            lambda: RF.fused_dwn_plain(x, th_d, mp, tab_f, C), None),
        "fused_dwn_combine": (
            lambda: KF.fused_dwn_combine(part, C),
            lambda: RF.fused_dwn_combine_plain(part, C),
            lambda: part.view(C, cpc, B).sum(1).argmax(0))}
    # "ms": the card's time per launch (CUDA graph); "eager_ms": a loop of
    # wrapper calls, which measures the host where it is the slower
    timing = {}
    for name, (fn, plain, yardstick) in kern.items():
        timing[name] = {
            "ms": graph_ms(fn),
            "eager_ms": time_ms(fn, iters=200, warmup=10),
            "plain_ms": time_ms(plain, iters=5, warmup=1),
            "library_ms": graph_ms(yardstick) if yardstick else None,
            **_bound(FLOAT[name][2], *shape)}
    # K8 at the served buckets, with each launch's layout, beside its first
    # design (8 rows a block, two blocks an SM), kept as the rows kernel,
    # whose output at B is held to the plain version
    k8 = timing["lut_eval"]
    k8["bucket_ms"] = {b: graph_ms(lambda b=b: KL.lut_eval(bits[:b], mp,
                                                           tab_t))
                       for b in SERVED_BUCKETS}
    k8["bucket_layout"] = {
        b: (KL.lut_eval(bits[:b], mp, tab_t), KL.last_float_launch())[1]
        for b in SERVED_BUCKETS}
    k8["bucket_bound_ms"] = {
        b: _bound("float_lut_eval", b, *shape[1:])["bound_ms"]
        for b in SERVED_BUCKETS}
    lut_rows = torch.empty_like(out)

    def k8_rows(b):
        return rows_kernel(
            KL.LIBRARY, KL._SIGNATURES, "lut_eval_rows_launch",
            bits.data_ptr(), b, F * T, mp.data_ptr(), tab_t.data_ptr(), m,
            n, KL.FLOAT_ROWS, lut_rows.data_ptr())
    k8["rows_kernel_bucket_ms"] = {b: graph_ms(k8_rows(b))
                                   for b in SERVED_BUCKETS}
    lut_rows.zero_()
    k8_rows(B)()
    torch.cuda.synchronize()
    held("lut_eval", "lg-2400-rows-kernel", lut_rows,
         RL.lut_eval_plain(bits, mp, tab_f))
    # K6 at the served buckets and over its tile parameters, each launch's
    # layout beside its time
    timing["fused_dwn"]["float_tables_ms"] = graph_ms(
        lambda: KF.fused_dwn(x, th_d, mp, ftab, C))
    timing["fused_dwn"]["bucket_ms"] = {
        B: graph_ms(lambda B=B: KF.fused_dwn(x[:B], th_d, mp, tab_f, C))
        for B in SERVED_BUCKETS}
    timing["fused_dwn"]["bucket_layout"] = {
        B: (KF.fused_dwn(x[:B], th_d, mp, tab_f, C),
            KF.last_float_launch())[1] for B in SERVED_BUCKETS}
    timing["fused_dwn"]["bucket_bound_ms"] = {
        B: _bound("float_fused", B, *shape[1:])["bound_ms"]
        for B in SERVED_BUCKETS}
    # the first design (lanes over LUTs, 16 rows and 256 LUTs a step),
    # kept as the rows kernel, in the same call, and its output at B held
    # to the plain version
    counts_rows = torch.empty((B, C), device=device)
    idx_rows = torch.empty((B,), dtype=torch.int32, device=device)

    def k6_rows(b):
        return rows_kernel(
            KF.LIBRARY, KF._SIGNATURES, "fused_dwn_rows_launch",
            x.data_ptr(), th_d.data_ptr(), b, F, T, mp.data_ptr(),
            tab_f.data_ptr(), m, n, C, counts_rows.data_ptr(),
            idx_rows.data_ptr(), 16, 256)
    timing["fused_dwn"]["rows_kernel_bucket_ms"] = {
        b: graph_ms(k6_rows(b)) for b in SERVED_BUCKETS}
    counts_rows.zero_()
    idx_rows.fill_(-1)
    k6_rows(B)()
    torch.cuda.synchronize()
    ref_c, ref_i = RF.fused_dwn_plain(x, th_d, mp, tab_f, C)
    held("fused_dwn", "lg-2400-rows-kernel", counts_rows, ref_c)
    held("fused_dwn", "lg-2400-rows-kernel", idx_rows, ref_i)
    timing["fused_dwn"]["block_b_block_m_ms"] = {
        f"{bb}/{bm}": graph_ms(lambda bb=bb, bm=bm: KF.fused_dwn(
            x, th_d, mp, tab_f, C, block_b=bb, block_m=bm), iters=50)
        for bb in FUSED_DWN_BLOCK_B_SWEEP for bm in FUSED_DWN_BLOCK_M_SWEEP}

    # the float staged path beside the packed one and the fused kernels
    from repro_torch.core import bitpack as bp
    stack = RF.LayerStack.build([mp], [tabs_d[0]], F * T, device)
    [(widx, boff, tab_w)] = list(stack.layers())
    masks = bp.to_word_pattern(bp.group_masks(m, C, device))
    k2 = make_forward_packed(th_d, maps_d, tabs_d, C)
    k1 = make_forward_packed(th_d, maps_d, tabs_d, C,
                             config=FusedConfig("batch-major"))

    def float_three():
        b = KT.thermometer_encode(x, th_d).reshape(B, -1)
        return KP.popcount_classify(KL.lut_eval(b, mp, tab_t), C)

    def packed_three():
        return KP.popcount_classify_packed(KL.lut_eval_packed(
            KT.thermometer_encode_packed(x, th_d), widx, boff, tab_w), masks)
    float_bound = sum(timing[k]["bound_ms"] for k in
                      ("thermometer_encode", "lut_eval",
                       "popcount_classify"))
    packed_bound = sum(_bound(STAGES[k][2], *shape)["bound_ms"]
                       for k in STAGES)
    staged = {
        "float_kernels_ms": graph_ms(float_three),
        "float_kernels_eager_ms": time_ms(float_three, iters=50, warmup=5),
        "float_ops_ms": time_ms(
            lambda: _float_pass(x, th_d, maps_d, tabs_d, C), iters=20,
            warmup=2),
        "float_bound_ms": float_bound,
        "packed_kernels_ms": graph_ms(packed_three),
        "packed_bound_ms": packed_bound,
        "fused_dwn_ms": graph_ms(kern["fused_dwn"][0]),
        "fused_packed_ms": graph_ms(lambda: k2(x)),
        "fused_packed_bound_ms": _bound("packed", *shape)["bound_ms"],
        "batch_major_ms": graph_ms(lambda: k1(x)),
        "batch_major_bound_ms": _bound("batch-major", *shape)["bound_ms"]}
    staged["float_over_packed"] = (staged["float_kernels_ms"]
                                   / staged["packed_kernels_ms"])
    staged["float_bound_over_packed_bound"] = float_bound / packed_bound
    staged["fused_dwn_over_fused_packed"] = (staged["fused_dwn_ms"]
                                             / staged["fused_packed_ms"])
    emit({"phase": "float", "checks": len(checks),
          "all_ok": all(c["ok"] for c in checks),
          "fused_dwn_paths": k6_paths, "lut_eval_paths": k8_paths,
          "max_abs_err": max_err, "passes": passes,
          "timing_batch": time_batch, "timing": timing, "staged": staged})
    return max_err, timing, launches


FLASH = ("src/repro_torch/kernels/flash_attn/csrc/flash_attn.cu",
         "src/repro/kernels/flash_attn/kernel.py:74")
#: what every flash-attention kernel's symbol holds; the profile split
#: finds K10 by it
FLASH_SYMBOL = "flash_attn_kernel"
#: the qwen3-8b attention head shape: query heads, KV heads, head_dim
QWEN_HEADS = (32, 8, 128)
#: the other head shapes the LM zoo's pallas archs give K10: three more
#: at hd 128 (llava-next-34b's 56 query heads over 8, groups of 7), hd 96
#: and hd 64, all on the Hopper design
ZOO_HEADS = {"qwen2-7b": (28, 4, 128), "qwen3-14b": (40, 8, 128),
             "phi3-mini-3.8b": (32, 32, 96),
             "granite-moe-3b-a800m": (24, 8, 64),
             "llava-next-34b": (56, 8, 128)}
#: (B, S) of an arch's served prefill, checked and timed beside the zoo's
#: sizes: llava's 2 x (2880 patches + 1024 text tokens), whose last
#: 128-row query block holds 64 rows and whose last 96-key tile 64 keys
FLASH_SERVED_SIZES = {"llava-next-34b": (2, 3904)}
#: (B, S) checked at the zoo's head shapes: S on either side of the
#: Hopper design's 128-row query blocks and of its 96-key (hd 96, 128) and
#: 128-key (hd 64) tiles, and of the first design's 64-row blocks; at
#: (3, 2000) and (4, 2048) phi3-mini's K and V (74 and 101 MB) run in
#: groups of 13 and 12 (b, h) pairs (``head_group``)
ZOO_FLASH_SIZES = ((1, 1), (2, 63), (1, 65), (1, 95), (2, 97), (1, 127),
                   (1, 129), (2, 191), (1, 193), (2, 255), (1, 257),
                   (3, 2000), (4, 2048))
#: (B, S) at which K and V pass head_group's 40 MB at a head shape with
#: several query heads a KV head, where the blocks still run by query
#: block alone: qwen3-8b's at 8 x 2048, the lm_head phase's classify
#: requests (67 MB), and granite-moe's at 10 x 2048 (42 MB)
FLASH_GQA_PAST_L2_SIZES = {QWEN_HEADS: ((8, 2048),),
                           (24, 8, 64): ((10, 2048),)}
#: the symbols of the Hopper design's instances, whose ptxas lines are
#: held to no spills and no wgmma serialisation, and of the kept first
#: designs at hd 32, 64, 96 and 256 (timed beside them, held to no
#: spills); one
#: symbol an instance, since a template's name holds every instance's
FLASH_WS_SYMBOLS = {hd: f"{FLASH_SYMBOL}_wsILi{hd}E"
                    for hd in (16, 32, 64, 96, 128, 256)}
FLASH_MMA_SYMBOLS = {hd: f"{FLASH_SYMBOL}_mmaILi{hd}E"
                     for hd in (16, 32, 64, 96, 256)}
#: flash attention (bf16 out, P rounded to bf16) against its float32
#: plain version: the reference's bf16 bar (tests/test_flash_kernel.py:41),
#: absolute and relative, as torch.testing.assert_close applies them
FLASH_TOL = 2e-2
#: and per query row: max |diff| over the row's head dims over max |want|
#: there.  Deep in a flat softmax |o| is about 1 / sqrt(0.78 * row), far
#: below FLASH_TOL, so the elementwise bar alone passes a kernel that
#: drops a key tile or skips the rescale of O; bf16 rounding of P and of
#: the output stays within a few 1e-3 of each row's largest value
FLASH_ROW_REL = 1e-2
#: scales of q (k and v are N(0, 1)): a flat softmax (scores with a
#: standard deviation of 0.5) and a peaked one (4), where |o| is O(1)
FLASH_Q_SCALES = (0.5, 4.0)
#: K10 prefill logits and teacher-forced decode logits against the masked
#: path on the same params: max |diff| over max |logit|, the reference's
#: prefill/decode consistency bar (tests/test_decode_consistency.py:44)
LOGITS_REL = 0.05


#: ex2.approx a clock an SM (the special-function unit's throughput at
#: compute capability 9.0, CUDA C Programming Guide): the softmax takes
#: one a score
EX2_PER_CLOCK = 16


def flash_bytes_and_ops(B, S, H, KH, hd, causal=True):
    """Bytes of q, k, v and o (bf16, each once), the tensor-core
    operations of the two products over the keys each query sees, and
    those (query, key) scores, one ex2 each: B·H·S(S+1)/2 causal, B·H·S²
    not."""
    nbytes = 2 * B * S * hd * (2 * H + 2 * KH)
    pairs = S * (S + 1) // 2 if causal else S * S
    return nbytes, 4 * B * H * hd * pairs, B * H * pairs


def flash_bound(B, S, H, KH, hd, causal=True):
    """K10's least time on the card: the larger of its bytes at
    PEAK_BYTES_PER_S and its tensor-core operations at
    PEAK_BF16_OPS_PER_S.  ``terms_ms`` also gives "ex2_sfu", its scores'
    ex2 at EX2_PER_CLOCK on SMS SMs at SM_CLOCK_HZ: the floor of a design
    that takes every ex2 on the special-function unit, not of the
    function (part of them can run on the FMA pipe), so it sets no
    bound."""
    nbytes, nops, scores = flash_bytes_and_ops(B, S, H, KH, hd, causal)
    by_bytes, by_ops = nbytes / PEAK_BYTES_PER_S, nops / PEAK_BF16_OPS_PER_S
    ex2 = scores / (EX2_PER_CLOCK * SMS * SM_CLOCK_HZ)
    return {"bound_ms": max(by_bytes, by_ops) * 1e3,
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "terms_ms": {"bytes": by_bytes * 1e3, "tensor_ops": by_ops * 1e3,
                         "ex2_sfu": ex2 * 1e3},
            "bytes": nbytes, "operations": nops, "scores": scores}


def ptxas_entry(lines, symbol):
    """Registers, shared memory and spill bytes of the kernel whose mangled
    name holds ``symbol``, from ptxas's -v lines (an entry's lines follow
    its "Compiling entry" line), and any wgmma serialisation warning."""
    out = {"warnings": [line for line in lines
                        if "Performance Loss" in line and symbol in line]}
    inside = False
    for line in lines:
        if "Compiling entry" in line:
            inside = symbol in line
        elif inside and "spill" in line:
            out["spill_bytes"] = [int(n) for n in re.findall(
                r"(\d+) bytes spill", line)]
        elif inside and "Used" in line:
            out["registers"] = int(re.search(r"Used (\d+) registers",
                                             line).group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            out["static_smem_bytes"] = int(smem.group(1)) if smem else 0
    return out


def _ptxas_resources(lines, symbol):
    """:func:`ptxas_entry`, raising if the kernel's lines are missing, if
    it spills or if ptxas serialised its wgmmas."""
    out = ptxas_entry(lines, symbol)
    if "registers" not in out or "spill_bytes" not in out:
        raise SystemExit(f"ptxas reported no registers or spills for "
                         f"{symbol!r}: {out}")
    if any(out["spill_bytes"]) or out["warnings"]:
        raise SystemExit(f"ptxas spilled or serialised the wgmmas of "
                         f"{symbol!r}: {out}")
    return out


def flash_errors(got, want):
    """``got`` (the kernel's bf16) against ``want`` (float32): the largest
    |diff|, the largest per-row relative error (see FLASH_ROW_REL) and
    whether both bars and finiteness hold."""
    import torch
    diff = (got.float() - want).abs()
    row_rel = float((diff.amax(-1) / want.abs().amax(-1).clamp_min(1e-30))
                    .max())
    ok = bool((diff <= FLASH_TOL + FLASH_TOL * want.abs()).all()
              and torch.isfinite(got).all() and row_rel <= FLASH_ROW_REL)
    return {"max_abs_err": float(diff.max()), "row_rel_err": row_rel,
            "ok": ok}


def _flash_checks(device, rng, heads, sizes, checks):
    """K10 against its plain version at one head shape over ``sizes``,
    each q scale of FLASH_Q_SCALES, causal and not; appends each check to
    ``checks`` and raises on the first outside FLASH_TOL / FLASH_ROW_REL.
    Returns (largest |diff|, largest per-row relative error)."""
    import torch
    from repro_torch.kernels.flash_attn import kernel as KA
    from repro_torch.kernels.flash_attn.ref import attention_ref
    H, KH, hd = heads
    max_err = row_rel = 0.0
    for B, S in sizes:
        for q_scale in FLASH_Q_SCALES:
            q, k, v = _flash_operands(device, rng, B, S, heads, q_scale)
            for causal in (True, False):
                got = KA.flash_attention(q, k, v, causal=causal)
                torch.cuda.synchronize()
                want = attention_ref(q.float(), k.float(), v.float(),
                                     causal=causal)
                res = flash_errors(got, want)
                checks.append({"H": H, "KH": KH, "hd": hd, "B": B, "S": S,
                               "q_scale": q_scale, "causal": causal, **res})
                max_err = max(max_err, res["max_abs_err"])
                row_rel = max(row_rel, res["row_rel_err"])
                if not res["ok"]:
                    emit({"phase": "flash", "checks": checks})
                    raise SystemExit(
                        f"flash_attention differs from its plain version "
                        f"beyond {FLASH_TOL} elementwise or {FLASH_ROW_REL} "
                        f"per row: H={H}, KH={KH}, hd={hd}, B={B}, S={S}, "
                        f"q_scale={q_scale}, causal={causal}, {res}")
    return max_err, row_rel


def _flash_operands(device, rng, B, S, heads, q_scale=0.5):
    import torch
    H, KH, hd = heads
    return [torch.from_numpy(
        rng.standard_normal((B, S, h, hd)).astype(np.float32) * sc).to(
            device).bfloat16() for h, sc in ((H, q_scale), (KH, 1.0),
                                             (KH, 1.0))]


def kept_first_design(hd):
    """Whether ``flash_attn_mma_launch`` keeps the first design (mma.sync)
    beside the Hopper instance that runs head dim ``hd``: at hd 8 and 16
    (its instance 16) and at 32, 64, 96 and 256."""
    from repro_torch.kernels.flash_attn import kernel as KA
    return (KA.instance_for(hd)[1] == "tma"
            and (hd <= 16 or hd in FLASH_MMA_SYMBOLS))


def _flash_timing(device, rng, heads, B, S):
    """K10 at (B, S) and one head shape in a CUDA graph and eagerly, its
    plain version, the SDPA yardstick and the bound from shapes; at hd 64
    and 96 also the kept first design (mma.sync) in a CUDA graph, through
    ``flash_attn_mma_launch``, uncounted, its output held to the plain
    version."""
    import torch
    from repro_torch.kernels.flash_attn import kernel as KA
    from repro_torch.kernels.flash_attn.ref import attention_ref
    q, k, v = _flash_operands(device, rng, B, S, heads)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    H, KH, hd = heads
    first = {}
    if kept_first_design(hd):
        out = torch.zeros_like(q)
        mma = rows_kernel(KA.LIBRARY, KA._SIGNATURES, "flash_attn_mma_launch",
                          q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          out.data_ptr(), B, S, H, KH, hd, 1)
        mma()
        torch.cuda.synchronize()
        res = flash_errors(out, attention_ref(q.float(), k.float(),
                                              v.float(), causal=True))
        if not res["ok"]:
            raise SystemExit(f"K10's first design at hd {hd} differs from "
                             f"its plain version: {res}")
        first = {"first_design_ms": graph_ms(mma, iters=20),
                 "first_design_max_abs_err": res["max_abs_err"]}
    timing = {
        "B": B, "S": S, "H": heads[0], "KH": heads[1], "hd": heads[2],
        "ms": graph_ms(lambda: KA.flash_attention(q, k, v, causal=True),
                       iters=20),
        "eager_ms": time_ms(lambda: KA.flash_attention(q, k, v, causal=True),
                            iters=50, warmup=5),
        "plain_ms": time_ms(lambda: attention_ref(q, k, v, causal=True),
                            iters=3, warmup=1),
        "library_ms": graph_ms(lambda: sdpa(qt, kt, vt, is_causal=True,
                                            enable_gqa=True), iters=20),
        **first, **flash_bound(B, S, *heads)}
    timing["tflops"] = timing["operations"] / timing["ms"] / 1e9
    timing["bound_share"] = timing["bound_ms"] / timing["ms"]
    return timing


def phase_flash(device, ptxas=(), sizes=((1, 1), (2, 33), (1, 129),
                                         (2, 255), (4, 512), (4, 2048)),
                time_shape=(4, 2048)):
    """K10 within FLASH_TOL and FLASH_ROW_REL of its plain version at the
    qwen3-8b head shape (sizes that straddle its 128-row query blocks and
    96-key tiles among them, q at each of FLASH_Q_SCALES) and at the LM
    zoo's head shapes (ZOO_HEADS over ZOO_FLASH_SIZES), and where GQA
    heads' K and V pass 40 MB (FLASH_GQA_PAST_L2_SIZES); K10, its plain
    version and the SDPA yardstick timed at each head shape, with the kept
    first design at hd 64 and 96; the Hopper design's instances' and the
    first designs' registers, shared memory and spills as ptxas reported
    them, none spilled and no wgmma serialised."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attn import kernel as KA
    rng = np.random.default_rng(3)
    checks = []
    max_err, row_rel = _flash_checks(
        device, rng, QWEN_HEADS,
        tuple(sizes) + FLASH_GQA_PAST_L2_SIZES[QWEN_HEADS], checks)
    per_hd = {}
    for name, heads in ZOO_HEADS.items():
        served = FLASH_SERVED_SIZES.get(name)
        err = _flash_checks(device, rng, heads, ZOO_FLASH_SIZES
                            + FLASH_GQA_PAST_L2_SIZES.get(heads, ())
                            + ((served,) if served else ()), checks)
        hd_err = per_hd.setdefault(heads[2], [0.0, 0.0])
        hd_err[:] = [max(a, b) for a, b in zip(hd_err, err)]
    smem_bytes = _build.load(KA.LIBRARY).flash_attn_smem_bytes
    smem_bytes.argtypes, smem_bytes.restype = [ctypes.c_int], ctypes.c_int
    timing = _flash_timing(device, rng, QWEN_HEADS, *time_shape)
    zoo = {name: _flash_timing(device, rng, heads, *time_shape)
           for name, heads in ZOO_HEADS.items()}
    served = {name: _flash_timing(device, rng, ZOO_HEADS[name], *shape)
              for name, shape in FLASH_SERVED_SIZES.items()}
    lines = list(ptxas)
    resources = {f"hd{hd}": {**_ptxas_resources(lines, symbol),
                             "dynamic_smem_bytes": smem_bytes(hd)}
                 for hd, symbol in FLASH_WS_SYMBOLS.items()}
    for hd, symbol in FLASH_MMA_SYMBOLS.items():
        resources[f"hd{hd} first design"] = _ptxas_resources(lines, symbol)
    B, S = time_shape
    H, KH, hd = QWEN_HEADS
    emit({"phase": "flash", "checks": checks, "tolerance": FLASH_TOL,
          "row_tolerance": FLASH_ROW_REL, "max_abs_err": max_err,
          "row_rel_err": row_rel,
          "max_abs_err_by_hd": {hd: e[0] for hd, e in per_hd.items()},
          "timing_shape": {"B": B, "S": S, "H": H, "KH": KH, "hd": hd},
          "timing": timing, "zoo_timing": zoo, "served_timing": served,
          "ptxas": resources})
    errs = {"max_abs_err": max_err, "row_rel_err": row_rel}
    by_hd = {hd: {"max_abs_err": e[0], "row_rel_err": e[1]}
             for hd, e in per_hd.items()}
    return errs, timing, by_hd, zoo, served


def _ffn_params(cfg):
    """Parameters of one layer's FFN: SwiGLU, or every expert's and the
    router."""
    D, F = cfg.d_model, cfg.d_ff
    if cfg.family == "moe":
        return cfg.num_experts * 3 * D * F + D * cfg.num_experts
    return 3 * D * F


def _ffn_ops(cfg, B, S):
    """Matrix operations of one layer's FFN over B rows of S tokens, as
    the reference computes it: SwiGLU on every token, or the router on
    every token and all E experts over ``cap`` slots a row (empty slots
    included)."""
    from repro_torch.models.layers import moe_capacity
    D, F = cfg.d_model, cfg.d_ff
    if cfg.family != "moe":
        return 2 * 3 * D * F * B * S
    E = cfg.num_experts
    cap = moe_capacity(S, cfg.top_k, E, cfg.capacity_factor)
    return 2 * 3 * D * F * E * cap * B + 2 * D * E * B * S


def _pairs(S, W=None):
    """(query, key) pairs a causal attention over S positions scores,
    keys at most W back where W is given."""
    W = min(S, W or S)
    return W * (W + 1) // 2 + (S - W) * W


def _mixed_bound(nbytes, bf16_ops, fp32_ops=0):
    """The least time of work moving ``nbytes`` and doing ``bf16_ops`` on
    the tensor cores and ``fp32_ops`` float32 operations outside them
    (each at its own peak, one after the other)."""
    by_bytes = nbytes / PEAK_BYTES_PER_S
    by_ops = bf16_ops / PEAK_BF16_OPS_PER_S + fp32_ops / PEAK_FP32_OPS_PER_S
    return {"bound_ms": max(by_bytes, by_ops) * 1e3,
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "bytes": nbytes, "operations": bf16_ops + fp32_ops,
            "fp32_operations": fp32_ops}


def lm_bounds(cfg, B, S, gen):
    """Least times of one prefill of B x S tokens and of one decode step,
    counted from the shapes (:func:`_mixed_bound`): prefill by its matrix
    operations as the reference types them (bf16 operands on the tensor
    cores; the RG-LRU gates' float32 products outside them), attention
    over the keys each query sees (at most a window's; a VLM's patch
    positions count in S; the SSD's chunk products as the port computes
    them), the last position alone unembedded; decode by the bytes of
    every weight (every expert's), the token rows of the embedding, the
    valid KV cache at the middle step (cross K/V over the frames), and
    the recurrent state read and written."""
    D, L, V = cfg.d_model, cfg.num_layers, cfg.vocab_padded(1)
    H, KH, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    attn = D * hd * (H + 2 * KH) + H * hd * D
    n = lm_params_total(cfg)
    unembed = 2 * B * D * V

    def kv_bytes(layers, kv):
        return 2 * 2 * layers * B * kv * KH * hd

    fp32 = fp32_step = state = 0
    if cfg.family in ("dense", "moe", "vlm"):
        S = S + (cfg.num_patches if cfg.family == "vlm" else 0)
        pf = (2 * attn * L * B * S + L * _ffn_ops(cfg, B, S)
              + L * 4 * B * H * hd * _pairs(S, cfg.swa_window) + unembed)
        kv = min(S + gen // 2, cfg.swa_window or S + gen)
        state = kv_bytes(L, kv)
        step = 2 * (attn * L + D * V) * B + L * _ffn_ops(cfg, B, 1)
    elif cfg.family == "ssm":
        di = cfg.ssm_expand * D
        Hs, P, G, N = di // cfg.ssm_headdim, cfg.ssm_headdim, \
            cfg.ssm_ngroups, cfg.ssm_state
        per_tok = D * (2 * di + 2 * G * N + Hs) + di * D
        Q = min(cfg.ssm_chunk, S)
        nc = -(-S // Q)
        ssd = 2 * B * nc * (G * Q * Q * N + Hs * Q * Q * P
                            + 2 * Q * Hs * P * N)
        pf = 2 * per_tok * L * B * S + L * ssd + unembed
        state = 2 * 4 * L * B * Hs * P * N \
            + 2 * 2 * L * B * (cfg.ssm_conv - 1) * (di + 2 * G * N)
        step = 2 * (per_tok * L + D * V) * B
    elif cfg.family == "hybrid":
        W, F = cfg.lru_width, cfg.d_ff
        n_attn = cfg.num_layers // 3
        n_rec = L - n_attn
        rec_tok, attn_tok = 3 * D * W + 3 * D * F, attn + 3 * D * F
        pf = (2 * B * S * (n_rec * rec_tok + n_attn * attn_tok)
              + n_attn * 4 * B * H * hd * _pairs(S, cfg.local_window)
              + unembed)
        fp32 = 2 * B * S * n_rec * 2 * W * W
        kv = min(S + gen // 2, cfg.local_window)
        state = (kv_bytes(n_attn, kv) + 2 * 4 * n_rec * B * W
                 + 2 * 2 * n_rec * B * 3 * W)
        step = 2 * B * (n_rec * rec_tok + n_attn * attn_tok + D * V) \
            + n_attn * 4 * B * H * hd * kv
        fp32_step = 2 * B * n_rec * 2 * W * W
        n += n_rec * 2 * W * W           # wa, wx in float32: 4 bytes
    elif cfg.family == "encdec":
        F, Fr, Le = cfg.d_ff, cfg.enc_frames, cfg.enc_layers
        enc_tok = attn + 2 * D * F
        dec_tok = attn + 2 * H * hd * D + 2 * D * F
        pf = (2 * B * Fr * Le * enc_tok + Le * 4 * B * H * hd * Fr * Fr
              + 2 * B * Fr * L * 2 * D * KH * hd
              + 2 * B * S * L * dec_tok
              + L * 4 * B * H * hd * (_pairs(S) + S * Fr) + unembed)
        kv = S + gen // 2
        state = kv_bytes(L, kv) + kv_bytes(L, Fr)
        step = 2 * B * (L * dec_tok + D * V) \
            + L * 4 * B * H * hd * (kv + Fr)
        n -= Le * whisper_counts(cfg)[0] + 2 * D    # the encoder's
    else:
        raise ValueError(f"no bounds for family {cfg.family!r}")
    if not _tied(cfg):               # decode reads B rows of the table
        n -= V * D
    prefill_bytes = 2 * lm_params_total(cfg)
    decode_bytes = 2 * n + 2 * B * D + state
    if cfg.family == "hybrid":
        prefill_bytes += 2 * n_rec * 2 * W * W
    return {"prefill": _mixed_bound(prefill_bytes, pf, fp32),
            "decode_step": _mixed_bound(decode_bytes, step, fp32_step)}


def flash_per_prefill(cfg):
    """K10's launches in one prefill: one a layer of the transformer under
    ``pallas``, none under a sliding window (the reference's pallas path
    skips the kernel there), another attn_impl or another family's
    module (the SSM, hybrid and encoder-decoder models call no kernel)."""
    on = (cfg.attn_impl == "pallas" and cfg.swa_window is None
          and cfg.family in ("dense", "moe", "vlm"))
    return cfg.num_layers if on else 0


def _lm_pass(engine, stream):
    """Counts set to 0, the stream served, counts read: every prefill
    launches flash attention ``flash_per_prefill`` times, nothing else
    launches."""
    import torch
    _reset_counts()
    for p in stream:
        engine.submit(p)
    done = engine.drain()
    torch.cuda.synchronize()
    launches = _expect_launches("lm pass", {
        "flash_attention": flash_per_prefill(engine.cfg) * len(stream)})
    return done, launches


def _rel(a, b):
    return float((a.float() - b.float()).abs().max()
                 / b.float().abs().max())


def phase_lm(device, batch=4, requests=2, prompt_len=2048, gen=16):
    """qwen3-8b at full width served through K10; the masked path on the
    same params as its reference; times beside bounds."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import api
    from repro_torch.serving import ServingEngine
    cfg = dataclasses.replace(get_arch("qwen3-8b"), attn_impl="pallas")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine = ServingEngine(cfg, prompt_len=prompt_len, gen=gen,
                           device=device, seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(engine.params))
    param_bytes = sum(t.numel() * t.element_size()
                      for t in _leaves(engine.params))
    t0 = time.perf_counter()
    engine.warmup(batch)
    warmup_s = time.perf_counter() - t0
    stream = [engine.make_request(batch, seed=100 + i)
              for i in range(requests)]
    done, launches = _lm_pass(engine, stream)
    for r in done:
        toks = r.result["tokens"]
        if toks.shape != (batch, gen) or not (
                (toks >= 0) & (toks < cfg.vocab_size)).all():
            raise SystemExit(f"request {r.rid}: tokens {toks.shape}")

    # per prefill and per decode step, through the engine's own steps
    batch0 = stream[0]
    _reset_counts()
    logits, cache = api.make_prefill(cfg, cache_len=prompt_len + gen)(
        engine.params, batch0)
    torch.cuda.synchronize()
    per_prefill = _expect_launches("one prefill", {
        "flash_attention": cfg.num_layers})
    masked = dataclasses.replace(cfg, attn_impl="masked")
    m_logits, m_cache = api.make_prefill(
        masked, cache_len=prompt_len + gen)(engine.params, batch0)
    prefill_rel = _rel(logits, m_logits)
    same_argmax = float((logits[:, :cfg.vocab_size].argmax(-1)
                         == m_logits[:, :cfg.vocab_size].argmax(-1))
                        .float().mean())
    decode = api.make_decode_step(cfg)
    m_decode = api.make_decode_step(masked)
    feed = torch.from_numpy(done[0].result["tokens"]).to(device)
    step_rel = []
    _reset_counts()
    for t in range(gen):
        tok = {"tokens": feed[:, t:t + 1]}
        logits, cache = decode(engine.params, cache, tok)
        m_logits, m_cache = m_decode(engine.params, m_cache, tok)
        step_rel.append(_rel(logits, m_logits))
    torch.cuda.synchronize()
    _expect_launches("teacher-forced decode", {})
    worst = max([prefill_rel] + step_rel)
    check = {"prefill_rel": prefill_rel, "decode_rel_max": max(step_rel),
             "decode_rel": step_rel, "tolerance": LOGITS_REL,
             "prefill_same_argmax": same_argmax}
    if not worst < LOGITS_REL:
        emit({"phase": "lm", "check": check})
        raise SystemExit(f"K10 prefill disagrees with the masked path: "
                         f"{worst} >= {LOGITS_REL}")
    # the card's time for one decode step at the cache's last position:
    # the step captured in a CUDA graph, so no Python runs between its
    # kernels (the served loop's time less this is the host's share)
    pos = cache["pos"] - 1
    tok = {"tokens": feed[:, -1:]}

    def one_step():
        cache["pos"] = pos
        decode(engine.params, cache, tok)
    decode_graph_ms = graph_ms(one_step, iters=4, replays=5)
    prefill = api.make_prefill(cfg, cache_len=prompt_len + gen)
    profiles = {
        "prefill": device_profile(
            lambda: prefill(engine.params, batch0),
            min(r.result["prefill_s"] for r in done)),
        "decode_step": device_profile(
            one_step, min(r.result["decode_s_per_tok"] for r in done))}
    k10_ms = profiles["prefill"].get("flash_attention_ms")
    if k10_ms is not None and per_prefill["flash_attention"] and not k10_ms:
        emit({"phase": "lm", "profiles": profiles})
        raise SystemExit(
            f"the prefill profile finds no time in K10 though "
            f"{per_prefill['flash_attention']} launches were counted: its "
            f"kernel's name no longer holds {FLASH_SYMBOL!r}")
    del cache, m_cache, logits, m_logits
    rep = engine.report()
    bounds = lm_bounds(cfg, batch, prompt_len, gen)
    out = {"phase": "lm", "arch": cfg.name, "attn_impl": cfg.attn_impl,
           "layers": cfg.num_layers, "d_model": cfg.d_model,
           "params": n_params, "param_bytes": param_bytes,
           "batch": batch, "prompt_len": prompt_len, "gen": gen,
           "init_s": init_s, "warmup_s": warmup_s,
           "launches": launches, "launches_per_prefill": per_prefill,
           "launches_per_decode": 0,
           "prefill_s": [r.result["prefill_s"] for r in done],
           "decode_s_per_tok": [r.result["decode_s_per_tok"] for r in done],
           "decode_step_graph_ms": decode_graph_ms,
           "profiles": profiles,
           "bounds": bounds,
           "peak_memory_bytes": torch.cuda.max_memory_allocated(),
           "check": check, "sample": done[0].result["tokens"][0].tolist(),
           "report": {k: rep[k] for k in ("mode", "prompt_len", "generated",
                                          "served", "latency")}}
    out["prefill_s_over_bound"] = (min(out["prefill_s"])
                                   / (bounds["prefill"]["bound_ms"] / 1e3))
    out["decode_over_bound"] = (min(out["decode_s_per_tok"])
                                / (bounds["decode_step"]["bound_ms"] / 1e3))
    emit(out)
    # what the dryrun phase prices: the steps timed here, their bounds
    step = {
        "cfg": cfg, "batch": batch, "prompt_len": prompt_len, "gen": gen,
        "prefill_ms": min(out["prefill_s"]) * 1e3,
        "decode_ms": decode_graph_ms,
        "decode_served_ms": min(out["decode_s_per_tok"]) * 1e3,
        "prefill_bound_ms": bounds["prefill"]["bound_ms"],
        "decode_bound_ms": bounds["decode_step"]["bound_ms"],
        "max_memory_allocated": out["peak_memory_bytes"]}
    return launches, step


#: bytes of the card a served model's bf16 weights leave free: the masked
#: attention's float32 scores at 2 x 6144 tokens (1.6 GB a 1024-key chunk,
#: several temporaries) and the teacher-forced gate's expert products at
#: capacity factor 8 (mixtral: 10,002 slots an expert, 2.3 GB each of
#: g, u and h in bf16 beside 4.6 GB of float32 SiLU input)
LM_SERVE_HEADROOM_BYTES = 20e9
#: llava-next-34b's own: under pallas at 2 x (2880 + 1024) positions its
#: KV cache is 1.9 GB and a layer's FFN temporaries (bf16 g, u and h,
#: float32 SiLU input) 1.6 GB; the masked check at B = 1 holds about 4 GB
#: of float32 scores a 1024-key chunk and the teacher-forced forward 0.5
#: GB of logits; 14 GB leave all 60 layers (68.8 GB) on an 85 GB card
LLAVA_HEADROOM_BYTES = 14e9


class ZooCell(NamedTuple):
    """One arch of phase lm_zoo: its attn_impl, prompts a request, prompt
    tokens (text; a VLM's patches come on top), the teacher-forced gate's
    prompt (B = 1), the bytes its weights leave free, the batch of the
    pallas-against-masked check (None: the request's) and the tokens
    generated a request."""
    impl: str
    batch: int
    prompt_len: int
    tf_len: int
    headroom: float = LM_SERVE_HEADROOM_BYTES
    check_batch: int | None = None
    gen: int = 16


#: the LM zoo served at full width in phase lm_zoo.  mixtral's window
#: skips K10 (as the reference's pallas path does), so it runs the masked
#: path, on prompts longer than its 4096-token window and no multiple of
#: it, so that the ring wraps unaligned (fault 10); llava prefills 2880
#: patch positions and 1024 text tokens through K10 at 56 query heads over
#: 8, its last 128-row query block ragged (3904 = 30.5 x 128);
#: recurrentgemma's 3000 tokens wrap its 2048-token local window
#: unaligned (fault 11); whisper's 432 + 16 tokens are its 448-token text
#: context; the SSM, hybrid and encoder-decoder models call no kernel
ZOO = {"qwen2-7b": ZooCell("pallas", 4, 2048, 2048),
       "qwen3-14b": ZooCell("pallas", 4, 2048, 2048),
       "phi3-mini-3.8b": ZooCell("pallas", 4, 2048, 2048),
       "granite-moe-3b-a800m": ZooCell("pallas", 4, 2048, 2048),
       "mixtral-8x7b": ZooCell("masked", 2, 6144, 5000),
       "llava-next-34b": ZooCell("pallas", 2, 1024, 1024,
                                 LLAVA_HEADROOM_BYTES, check_batch=1, gen=8),
       "mamba2-1.3b": ZooCell("masked", 4, 2048, 2048),
       "recurrentgemma-2b": ZooCell("masked", 4, 3000, 3000),
       "whisper-large-v3": ZooCell("masked", 4, 432, 432)}
#: the capacity factor of the teacher-forced gate's MoE archs, as
#: tests/test_decode_consistency.py sets it: the S and S + 1 passes then
#: drop nothing, so they route alike
TEACHER_CAPACITY = 8.0
#: the tri-against-masked gate: one prompt of 8192 tokens on qwen2-7b,
#: twice the recursion's 4096-token leaf
TRI_ARCH, TRI_TOKENS = "qwen2-7b", 8192


def lm_serve_layers(cfg, total_bytes, headroom=LM_SERVE_HEADROOM_BYTES):
    """The most layers of a transformer whose bf16 weights leave
    ``headroom`` bytes free, as :func:`lm_train_layers` picks its depth."""
    layer, table, other = lm_param_counts(cfg)
    fit = (total_bytes - headroom - 2 * (table + other)) // (2 * layer)
    return int(max(1, min(cfg.num_layers, fit)))


def _teacher_forced(params, cfg, S, seed=7):
    """A prefill of S tokens (B = 1, with the stub frontend's inputs) and
    one decode step against the last logits of ``forward`` on the S + 1
    tokens: their relative error."""
    import torch
    from repro_torch.models import api
    from repro_torch.serving.engine import stub_inputs
    mod = api.module_for(cfg)
    dev = params["embed"]["table"].device
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, S + 1))).to(
        dev)
    stub = stub_inputs(cfg, rng, 1, dev)
    full = mod.forward(params, cfg, {"tokens": toks, **stub})[0]
    want = full[:, -1].clone()
    del full
    _, cache = mod.prefill(params, cfg, {"tokens": toks[:, :S], **stub},
                           cache_len=S + 1)
    got, _ = mod.decode_step(params, cfg, cache, toks[:, S:])
    return _rel(got, want)


def _lm_zoo_arch(device, arch, requests, total_bytes):
    """One arch of the LM zoo served at full width (a transformer's depth
    cut to what the card holds, recorded as ``reduced``); its gates; its
    line."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import api, layers, transformer
    from repro_torch.serving import ServingEngine
    cell = ZOO[arch]
    impl, batch, prompt_len, tf_len = cell[:4]
    gen = cell.gen
    full = get_arch(arch)
    cfg = dataclasses.replace(full, attn_impl=impl)
    reduced = None
    if cfg.family in transformer.FAMILIES:
        depth = lm_serve_layers(cfg, total_bytes, cell.headroom)
        if depth < cfg.num_layers:
            cfg = dataclasses.replace(cfg, num_layers=depth)
            reduced = {"num_layers": [depth, full.num_layers],
                       "why": f"bf16 weights of {full.num_layers} layers "
                              f"exceed the card; {depth} leave "
                              f"{cell.headroom / 1e9:.0f} GB free"}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine = ServingEngine(cfg, prompt_len=prompt_len, gen=gen,
                           device=device, seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    params = engine.params
    n_params = sum(t.numel() for t in _leaves(params))
    param_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    if n_params != lm_params_total(cfg):
        raise SystemExit(f"{arch}: {n_params} parameters, lm_params_total "
                         f"says {lm_params_total(cfg)}")
    engine.warmup(batch)
    stream = [engine.make_request(batch, seed=100 + i)
              for i in range(requests)]
    done, launches = _lm_pass(engine, stream)
    for r in done:
        toks = r.result["tokens"]
        if toks.shape != (batch, gen) or not (
                (toks >= 0) & (toks < cfg.vocab_size)).all():
            raise SystemExit(f"{arch} request {r.rid}: tokens {toks.shape}")
    prefill = api.make_prefill(cfg, cache_len=prompt_len + gen)
    batch0 = stream[0]
    check = {"tolerance": LOGITS_REL}
    _reset_counts()
    if cfg.family == "moe":
        with layers.count_moe_slots() as slots:
            logits, _ = prefill(params, batch0)
        kept, routed = (sum(c) for c in zip(*slots))
        moe = {"capacity_factor": cfg.capacity_factor,
               "slots_routed": routed, "slots_kept": kept,
               "dropped_share": 1 - kept / routed}
    else:
        logits, _ = prefill(params, batch0)
        moe = None
    torch.cuda.synchronize()
    per_prefill = _expect_launches(f"{arch} prefill", {
        "flash_attention": flash_per_prefill(cfg)})
    if impl == "pallas":
        # on the request's first check_batch prompts where the masked
        # path's float32 scores would not fit beside the request's
        rows = cell.check_batch or batch
        sub = {k: v[:rows] for k, v in batch0.items()}
        if rows < batch:
            logits, _ = prefill(params, sub)
        masked = dataclasses.replace(cfg, attn_impl="masked")
        m_logits, _ = api.make_prefill(masked, cache_len=prompt_len + gen)(
            params, sub)
        check["pallas_vs_masked_rel"] = _rel(logits, m_logits)
        check["pallas_vs_masked_batch"] = rows
        del m_logits
    del logits
    tf_cfg = (dataclasses.replace(cfg, capacity_factor=TEACHER_CAPACITY)
              if cfg.family == "moe" else cfg)
    check["teacher_forced_rel"] = _teacher_forced(params, tf_cfg, tf_len)
    check["teacher_forced_prompt"] = tf_len
    if arch == TRI_ARCH:
        toks = {"tokens": torch.from_numpy(np.random.default_rng(8).integers(
            0, cfg.vocab_size, (1, TRI_TOKENS))).to(device)}
        tri, _ = transformer.prefill(
            params, dataclasses.replace(cfg, attn_impl="tri"), toks)
        ref, _ = transformer.prefill(
            params, dataclasses.replace(cfg, attn_impl="masked"), toks)
        check["tri_vs_masked_rel"] = _rel(tri, ref)
        check["tri_tokens"] = TRI_TOKENS
        del tri, ref
    worst = max(v for k, v in check.items() if k.endswith("_rel"))
    if not worst < LOGITS_REL:
        emit({"phase": "lm_zoo", "arch": arch, "check": check})
        raise SystemExit(f"{arch}: a logits gate failed: {check}")
    profile = device_profile(lambda: prefill(params, batch0),
                             min(r.result["prefill_s"] for r in done))
    bounds = lm_bounds(cfg, batch, prompt_len, gen)
    out = {"phase": "lm_zoo", "arch": arch, "source": full.source,
           "family": cfg.family, "attn_impl": impl,
           "positions": prompt_len + (cfg.num_patches
                                      if cfg.family == "vlm" else 0),
           "layers": cfg.num_layers, "reduced": reduced,
           "d_model": cfg.d_model,
           "heads": [cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_],
           "params": n_params, "param_bytes": param_bytes,
           "batch": batch, "prompt_len": prompt_len, "gen": gen,
           "requests": requests, "init_s": init_s,
           "launches": launches, "launches_per_prefill": per_prefill,
           "prefill_s": [r.result["prefill_s"] for r in done],
           "decode_s_per_tok": [r.result["decode_s_per_tok"] for r in done],
           "bounds": bounds, "prefill_profile": profile, "moe": moe,
           "peak_memory_bytes": torch.cuda.max_memory_allocated(),
           "check": check, "sample": done[0].result["tokens"][0].tolist()}
    out["prefill_s_over_bound"] = (min(out["prefill_s"])
                                   / (bounds["prefill"]["bound_ms"] / 1e3))
    out["decode_over_bound"] = (min(out["decode_s_per_tok"])
                                / (bounds["decode_step"]["bound_ms"] / 1e3))
    emit(out)
    return launches.get("flash_attention", 0)


def phase_lm_zoo(device, requests=2):
    """The LM zoo's ten archs at full width through ``ServingEngine``
    (ZOO): each serves ``requests`` requests of greedy tokens, the
    pallas archs through K10 (none under mixtral's window; the SSM, hybrid
    and encoder-decoder modules call no kernel), and is held to the
    masked path (pallas archs), to its own forward (a teacher-forced
    decode step) and, for qwen2-7b, ``tri`` to ``masked``; each model is
    freed before the next.  Fails unless every pallas arch launched K10
    on its served pass.  Returns each arch's K10 launches there."""
    import gc

    import torch
    total = torch.cuda.get_device_properties(0).total_memory
    out = {}
    for arch, cell in ZOO.items():
        out[arch] = _lm_zoo_arch(device, arch, requests, total)
        if cell.impl == "pallas" and not out[arch]:
            raise SystemExit(f"{arch}'s served pass launched no K10")
        gc.collect()
        torch.cuda.empty_cache()
    return out


#: substrings of the names of cuBLAS's matrix-product kernels on Hopper
GEMM_KERNELS = ("gemm", "nvjet", "xmma", "cutlass")


def device_profile(fn, wall_s, top=6):
    """One call of ``fn`` under ``torch.profiler``: the device's busy time
    (the kernels' own time, summed), split into cuBLAS matrix products,
    the flash-attention kernel and everything else (norms, RoPE, SiLU,
    casts, copies, the plain attention), the kernels that take most of
    it, and the idle share of ``wall_s``, the call's time unprofiled.
    None where the profiler records no device time ("not measured")."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    # a record_function range (the model's "lm.attention") shows on the
    # device timeline too, spanning its kernels: not a kernel of its own
    rows = sorted(((e.self_device_time_total / 1e3, e.key, e.count)
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.self_device_time_total > 0
                   and not getattr(e, "is_user_annotation", False)),
                  reverse=True)
    if not rows:
        return {"device_busy_ms": None, "device_idle_share": None}
    busy = sum(r[0] for r in rows)
    split = {"matmul_ms": 0.0, "flash_attention_ms": 0.0, "other_ms": 0.0}
    for ms, name, _ in rows:
        key = ("flash_attention_ms" if FLASH_SYMBOL in name else
               "matmul_ms" if any(g in name for g in GEMM_KERNELS) else
               "other_ms")
        split[key] += ms
    return {"device_busy_ms": busy, "wall_ms": wall_s * 1e3,
            "device_idle_share": max(0.0, 1 - busy / (wall_s * 1e3)),
            **split, "kernels": len(rows),
            "launches": sum(r[2] for r in rows),
            "top": [{"kernel": name[:100], "ms": ms, "calls": n}
                    for ms, name, n in rows[:top]]}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _served(done):
    return sum(r.size for r in done)


def _serve_pass(engine, stream, kernel_names):
    """Counts set to 0, the stream served, counts read; returns stats.
    Fails unless one of ``kernel_names`` was launched."""
    from repro_torch.kernels.fused.kernel import (launch_counts,
                                                  reset_launch_counts)
    from repro_torch.serving.scheduler import latency_stats
    reset_launch_counts()
    for p in stream:
        engine.submit(p)
    t0 = time.perf_counter()
    done = engine.drain()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    if not any(launches[k] for k in kernel_names):
        raise SystemExit(f"none of {kernel_names} was launched on its "
                         f"pass: {launches}")
    lat = latency_stats(done)["compute_ms"]
    return done, launches, {
        "kernels": list(kernel_names), "requests": len(done),
        "served": _served(done), "launches": launches,
        "throughput_samples_per_s": _served(done) / wall,
        "compute_ms_p50": lat["p50"], "compute_ms_p99": lat["p99"]}


def _step_split(step, x_np, device, reps=50):
    """Median ms of host-to-device copy, ``step`` on the device rows (its
    launches and the kernels), and device-to-host copy of one step."""
    import torch
    h2d, comp, d2h = [], [], []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        xd = torch.from_numpy(x_np).to(device)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        counts, pred = step(xd)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        counts.cpu().numpy(), pred.cpu().numpy()
        t3 = time.perf_counter()
        h2d.append(t1 - t0)
        comp.append(t2 - t1)
        d2h.append(t3 - t2)
    med = lambda v: float(np.median(v)) * 1e3  # noqa: E731
    return {"rows": int(x_np.shape[0]), "h2d_ms": med(h2d),
            "launch_compute_ms": med(comp), "d2h_ms": med(d2h)}


def _replay_and_eager_split(engine, x_np):
    """The step split of the fused backend at x's bucket with the config
    in effect: as served (a CUDA graph replay) and as an eager call of
    the same wrapper."""
    from repro_torch.kernels.fused import ops as fused_ops
    model, bucket = engine.model, x_np.shape[0]
    eager = fused_ops.make_forward_packed(
        model.thresholds, model.mappings, model.tables, model.num_classes,
        config=model.tuned_configs.get(bucket))
    return {"replay": _step_split(
                engine.backends["fused-packed"].step_for(bucket), x_np,
                engine.device),
            "eager": _step_split(eager, x_np, engine.device)}


def _check_against_oracle(engine, done):
    """Every request's counts and predictions equal the float oracle's."""
    import torch
    oracle = engine.backends["float-oracle"]
    for r in done:
        x = torch.from_numpy(np.ascontiguousarray(r.payload)).to(
            engine.device)
        c, p = (t.cpu().numpy() for t in oracle(x))
        if not (np.array_equal(c, r.result[0])
                and np.array_equal(p, r.result[1])):
            raise SystemExit(f"request {r.rid} differs from the oracle")


def _same_results(a_done, b_done, what):
    for a, b in zip(a_done, b_done):
        if not (np.array_equal(a.result[0], b.result[0])
                and np.array_equal(a.result[1], b.result[1])):
            raise SystemExit(f"request {a.rid}: {what} disagree")


def _check_compiles(engine):
    """At most one step built (one CUDA graph captured) per (backend,
    bucket), at ladder buckets only."""
    counts = engine.compile_counts()
    for name, per_bucket in counts.items():
        if not set(per_bucket) <= set(engine.scheduler.buckets) or \
                any(n > 1 for n in per_bucket.values()):
            raise SystemExit(f"{name} built more than one step a bucket: "
                             f"{per_bucket}")
    return counts


#: per-step losses of the card against the port's CPU steps, from one
#: numpy init: float32 sums taken in other orders (the (m·n, B) x (B, C)
#: product, the reductions over C) move a loss by ~1e-7
TRAIN_LOSS_TOL = 1e-5
#: scores after the steps, card against CPU: the reference's own bar for
#: two orders of the same arithmetic (tests/test_training.py)
TRAIN_SCORES_TOL = 1e-4
#: minibatch steps compared between the card and the CPU
TRAIN_STEPS = 4
#: float32 scalar rate outside the tensor cores (NVIDIA data sheet, H100
#: SXM): the softmax-STE product ``gb`` runs in full float32
PEAK_FP32_OPS_PER_S = 67e12


# ---------------------------------------------------------------------------
# LM training and the DWN head on the LM backbone
# ---------------------------------------------------------------------------

#: the reduced qwen3-8b's four card steps against the CPU's from one init:
#: bf16 products on another device round otherwise, and the step's
#: arithmetic carries that into the loss and the gradient norm
LM_TRAIN_LOSS_REL, LM_TRAIN_GNORM_REL = 1e-3, 5e-3
#: bytes of the card the full-width training state leaves free: a step's
#: activations (one residual a layer, one layer recomputed at a time),
#: the cross-entropy over 152,064 padded logits a position (float32, with
#: its gradient) and Adam's per-leaf temporaries (the largest leaf, the
#: embedding table, is 2.49 GB).  At 12 layers the 2 x 2048 step peaked
#: at 64.7 GB of the H100's 85.0 (NVIDIA H100 80GB HBM3, 700 W), 21.9 GB
#: above its 42.7 GB of weights and moments; 20 GB leaves 14 layers
LM_TRAIN_HEADROOM_BYTES = 20e9
#: the DWN head's features from the narrow unembedding (16 columns)
#: against the full one's on the card: about two bf16 ulps of a pooled
#: logit mean times 0.3
HEAD_FEAT_TOL = 5e-3


def lm_param_counts(cfg):
    """(parameters of one layer, of the embedding table, of everything
    else outside the layers: the unembedding, none when tied, and the
    final norm)."""
    D, hd = cfg.d_model, cfg.head_dim_
    H, KH, V = cfg.num_heads, cfg.num_kv_heads, cfg.vocab_padded(1)
    layer = (D * hd * (H + 2 * KH) + H * hd * D + _ffn_params(cfg) + 2 * D
             + (2 * hd if cfg.qk_norm else 0)
             + ((H + 2 * KH) * hd if cfg.qkv_bias else 0))
    return layer, V * D, (0 if cfg.tie_embeddings else V * D) + D


def whisper_counts(cfg):
    """(parameters of one encoder layer, of one decoder layer) of the
    encoder-decoder family: LayerNorms with biases, attention with q/k/v
    and output biases, GELU MLPs with biases."""
    D, F, hd = cfg.d_model, cfg.d_ff, cfg.head_dim_
    H, KH = cfg.num_heads, cfg.num_kv_heads
    attn = D * hd * (H + 2 * KH) + H * hd * D + (H + 2 * KH) * hd + D
    mlp = 2 * D * F + F + D
    return 4 * D + attn + mlp, 6 * D + 2 * attn + mlp


def _tied(cfg):
    """Whether the unembedding reads the embedding table (whisper's always
    does, whatever its config's flag says)."""
    return cfg.tie_embeddings or cfg.family == "encdec"


def lm_params_total(cfg):
    """Every parameter of the port's model of ``cfg``, counted from the
    shapes, for every family (the transformer's from
    :func:`lm_param_counts`)."""
    D, V, L = cfg.d_model, cfg.vocab_padded(1), cfg.num_layers
    if cfg.family in ("dense", "moe", "vlm"):
        layer, table, other = lm_param_counts(cfg)
        return L * layer + table + other
    table = V * D * (1 if _tied(cfg) else 2)
    if cfg.family == "ssm":
        di = cfg.ssm_expand * D
        H, G, N = di // cfg.ssm_headdim, cfg.ssm_ngroups, cfg.ssm_state
        conv = di + 2 * G * N
        layer = (D + D * (2 * di + 2 * G * N + H) + 3 * H
                 + (cfg.ssm_conv + 1) * conv + di + di * D)
        return L * layer + table + D
    if cfg.family == "hybrid":
        W, F, hd = cfg.lru_width, cfg.d_ff, cfg.head_dim_
        H, KH = cfg.num_heads, cfg.num_kv_heads
        rec = 2 * D + 3 * D * W + 2 * W * W + 8 * W + 3 * D * F
        attn = 2 * D + D * hd * (H + 2 * KH) + H * hd * D + 3 * D * F
        n_attn = L // 3
        return (L - n_attn) * rec + n_attn * attn + table + D
    if cfg.family == "encdec":
        enc, dec = whisper_counts(cfg)
        return cfg.enc_layers * enc + L * dec + table + 4 * D
    raise ValueError(f"no parameter count for family {cfg.family!r}")


def lm_train_layers(cfg, total_bytes):
    """The most layers whose float32 weights, gradients and two Adam
    moments (16 B a parameter) leave LM_TRAIN_HEADROOM_BYTES free."""
    layer, table, other = lm_param_counts(cfg)
    fit = (total_bytes - LM_TRAIN_HEADROOM_BYTES - 16 * (table + other)) \
        // (16 * layer)
    return int(max(1, min(cfg.num_layers, fit)))


def lm_train_bound(cfg, tokens):
    """Least time of one training step, the larger of 6 * parameters *
    tokens (every parameter but the embedding table's lookups) at the
    bf16 tensor-core peak and Adam's bytes (read the weight, gradient and
    two moments, write the weight and moments: 28 B a parameter) at the
    memory peak."""
    layer, table, other = lm_param_counts(cfg)
    n = cfg.num_layers * layer + table + other
    ops = 6 * (n - table) * tokens
    by_ops, by_bytes = ops / PEAK_BF16_OPS_PER_S, 28 * n / PEAK_BYTES_PER_S
    return {"bound_ms": max(by_ops, by_bytes) * 1e3,
            "bound_by": "operations" if by_ops >= by_bytes else "bytes",
            "operations": ops, "adam_bytes": 28 * n, "params": n}


def _lm_steps(cfg, init, device, batches):
    """``make_train_step`` over ``batches`` from a copy of ``init`` on
    ``device``: (params, [(loss, grad norm)])."""
    import torch
    from repro_torch.models import api
    from repro_torch.optim.adam import map_tree
    step, opt = api.make_train_step(cfg)
    params = map_tree(lambda t: t.to(device, copy=True), init)
    state = opt.init(params)
    hist = []
    for raw in batches:
        batch = {k: torch.from_numpy(v).to(device) for k, v in raw.items()}
        params, state, m = step(params, state, batch)
        hist.append((float(m["loss"]), float(m["grad_norm"])))
    return params, hist


def _lm_step_profile(step, params, state, batch):
    """One training step under ``torch.profiler``: the device's busy time
    split into the attention (its ``lm.attention`` ranges, the layers'
    recomputation included, and the backward of every op they ran), the
    cross-entropy (likewise), Adam and the clip (their ranges), the other
    matrix products (cuBLAS kernels) and the rest (norms, RoPE, SiLU,
    casts, the embedding's gather and its backward, autograd's own
    work).  A backward op belongs to the range of the forward op that
    made it (the profiler's forward thread and sequence number)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.autograd.DeviceType.CUDA
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = step(params, state, batch)
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    events = prof.events()

    def owner(e):
        while e is not None:
            if e.name.startswith("lm."):
                return e.name
            e = e.cpu_parent
        return None

    made_by = {}
    for e in events:
        if e.device_type != cuda and e.sequence_nr >= 0 and owner(e):
            made_by[(e.thread, e.sequence_nr)] = owner(e)
    split = {"attention_ms": 0.0, "cross_entropy_ms": 0.0, "adam_ms": 0.0,
             "clip_ms": 0.0, "matmul_ms": 0.0, "other_ms": 0.0}
    key_of = {"lm.attention": "attention_ms",
              "lm.cross_entropy": "cross_entropy_ms",
              "lm.adam": "adam_ms", "lm.clip": "clip_ms"}
    linked = 0.0
    for e in events:
        if e.device_type == cuda or not e.kernels:
            continue
        name = owner(e)
        a = e
        while name is None and a is not None:
            if a.name.startswith("autograd::engine::evaluate_function"):
                name = made_by.get((a.fwd_thread, a.sequence_nr))
            a = a.cpu_parent
        for k in e.kernels:
            ms = k.duration / 1e3
            linked += ms
            if name in key_of:
                split[key_of[name]] += ms
            elif any(g in k.name for g in GEMM_KERNELS):
                split["matmul_ms"] += ms
            else:
                split["other_ms"] += ms
    busy = sum(e.self_device_time_total for e in events
               if e.device_type == cuda and not e.is_user_annotation) / 1e3
    split["other_ms"] += max(0.0, busy - linked)     # tied to no host op
    return out, {"device_busy_ms": busy or None, "wall_ms": wall,
                 "device_idle_share": (max(0.0, 1 - busy / wall)
                                       if busy else None), **split}


def _train_cli(argv):
    """``repro_torch.launch.train`` in this process: its last JSON line."""
    import io
    from repro_torch.launch import train
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        if train.main(argv) != 0:
            raise SystemExit(f"launch.train {argv} did not exit 0")
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def _lm_restart(device, steps=6, crash_at=5):
    """The train CLI with ``--ckpt-dir`` on the card (reduced qwen3-8b, a
    checkpoint every 2 steps) run whole and with one injected crash at
    ``crash_at``: the crashed run resumes from its step-4 checkpoint on
    the card and ends equal to the whole run within 3 * lr * steps."""
    import torch
    from repro_torch.models import api
    from repro_torch.runtime import checkpoint as ck
    from repro_torch.runtime import fault
    base = ROOT / "build" / "chip_smoke_lm_ckpt"
    shutil.rmtree(base, ignore_errors=True)
    argv = ["--arch", "qwen3-8b", "--reduced", "--steps", str(steps),
            "--save-every", "2", "--log-every", "100", "--device", device]
    whole = _train_cli(argv + ["--ckpt-dir", str(base / "whole")])
    make, injector, seen = api.make_train_step, fault.FaultInjector(
        {crash_at}), set()

    def crashing(*a, **kw):
        step, opt = make(*a, **kw)

        def wrapped(params, state, batch):
            seen.add(params["embed"]["table"].device.type)
            injector.maybe_crash(int(state.step) + 1)
            return step(params, state, batch)
        return wrapped, opt

    api.make_train_step = crashing
    try:
        crashed = _train_cli(argv + ["--ckpt-dir", str(base / "crashed")])
    finally:
        api.make_train_step = make
    extra, trees = None, {}
    for name in ("whole", "crashed"):
        d = base / name
        manifest = json.loads((d / f"step_{steps:08d}" / "manifest.json")
                              .read_text())
        trees[name] = {k: torch.from_numpy(np.load(
            d / f"step_{steps:08d}" / v["file"]))
            for k, v in manifest["leaves"].items()}
        extra = manifest["extra"]
    diff = max(float((trees["whole"][k].double()
                      - trees["crashed"][k].double()).abs().max())
               for k in trees["whole"])
    bar = 3 * 3e-4 * steps
    out = {"steps": steps, "crash_at": crash_at, "fired": injector.fired,
           "devices_seen": sorted(seen), "whole": whole, "crashed": crashed,
           "extra": extra, "max_abs_diff": diff, "tolerance": bar,
           "bit_exact": diff == 0.0,
           "latest_steps": [ck.latest_step(base / n)
                            for n in ("whole", "crashed")]}
    shutil.rmtree(base, ignore_errors=True)
    if not (injector.fired == 1 and seen == {device} and diff <= bar
            and crashed["steps"] == whole["steps"] == steps
            and extra == {"data": {"step": steps}}):
        emit({"phase": "lm_train", "restart": out})
        raise SystemExit(f"the crashed LM run did not resume to the whole "
                         f"run's state: {out}")
    return out


def phase_lm_train(device, shapes=((8, 128, 10), (2, 2048, 10))):
    """LM training of qwen3-8b on the card: the reduced model's steps equal
    to the CPU's, then the full width (the layers cut to what the card
    holds) for ``shapes`` (batch, sequence, steps) of ``TokenStream``
    batches with step times, the bound, a profiler split and peak memory;
    a crashed and resumed run; the train CLI."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.data.tokens import TokenStream
    from repro_torch.models import api, transformer
    torch.cuda.empty_cache()
    # the gate: four steps of the reduced model, card against CPU
    small = get_arch("qwen3-8b").reduced()
    init = transformer.init_params(small, seed=0, dtype=torch.float32)
    stream = TokenStream(small.vocab_size, 128, 8, seed=0)
    batches = [stream.next_batch() for _ in range(4)]
    _reset_counts()
    cpu_p, cpu_h = _lm_steps(small, init, "cpu", batches)
    card_p, card_h = _lm_steps(small, init, device, batches)
    torch.cuda.synchronize()
    _expect_launches("LM training", {})
    from repro_torch.optim.adam import leaves
    param_diff = max(float((a - b.cpu()).abs().max())
                     for a, b in zip(leaves(cpu_p), leaves(card_p)))
    gate = {"cpu": cpu_h, "card": card_h, "param_max_abs_diff": param_diff,
            "loss_rel": LM_TRAIN_LOSS_REL, "gnorm_rel": LM_TRAIN_GNORM_REL,
            "param_tolerance": 3 * 3e-4 * 4}
    ok = all(abs(g[0] - c[0]) <= LM_TRAIN_LOSS_REL * c[0]
             and abs(g[1] - c[1]) <= LM_TRAIN_GNORM_REL * c[1]
             for c, g in zip(cpu_h, card_h)) and param_diff <= 3 * 3e-4 * 4
    if not ok:
        emit({"phase": "lm_train", "gate": gate})
        raise SystemExit("the card's LM train steps disagree with the CPU's")
    del cpu_p, card_p

    # full width, depth cut to what the card holds
    total = torch.cuda.get_device_properties(0).total_memory
    full = get_arch("qwen3-8b")
    cfg = dataclasses.replace(full, num_layers=lm_train_layers(full, total))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = transformer.init_params(cfg, seed=0, device=device,
                                     dtype=torch.float32)
    step, opt = api.make_train_step(cfg)
    state = opt.init(params)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    state_bytes = 3 * sum(t.numel() * 4 for t in leaves(params))
    runs = []
    _reset_counts()
    for B, S, n in shapes:
        stream = TokenStream(cfg.vocab_size, S, B, seed=0)
        losses, gnorms, step_ms = [], [], []
        for _ in range(n):
            raw = stream.next_batch()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            batch = {k: torch.from_numpy(v).to(device)
                     for k, v in raw.items()}
            params, state, m = step(params, state, batch)
            end.record()
            losses.append(float(m["loss"]))
            gnorms.append(float(m["grad_norm"]))
            torch.cuda.synchronize()
            step_ms.append(start.elapsed_time(end))
        raw = stream.next_batch()
        batch = {k: torch.from_numpy(v).to(device) for k, v in raw.items()}
        (params, state, m), profile = _lm_step_profile(step, params, state,
                                                      batch)
        runs.append({"batch": B, "seq": S, "steps": n + 1,
                     "losses": losses + [float(m["loss"])],
                     "grad_norms": gnorms + [float(m["grad_norm"])],
                     "step_ms": step_ms,
                     "step_ms_median": float(np.median(step_ms[1:])),
                     # the caching allocator's retries (a cudaFree of its
                     # cache and a synchronize each) so far in the phase
                     "alloc_retries": torch.cuda.memory_stats().get(
                         "num_alloc_retries"),
                     "bound": lm_train_bound(cfg, B * S),
                     "profile": profile})
    torch.cuda.synchronize()
    launches = _expect_launches("full-width LM training", {})
    peak = torch.cuda.max_memory_allocated()
    for r in runs:
        r["over_bound"] = r["step_ms_median"] / r["bound"]["bound_ms"]
        # the profiler slows the host: the idle share against an
        # unprofiled step's time
        busy = r["profile"]["device_busy_ms"]
        r["profile"]["device_idle_share_of_step_ms"] = (
            max(0.0, 1 - busy / r["step_ms_median"]) if busy else None)
        ls = r["losses"]
        if not (np.isfinite(ls).all() and np.isfinite(r["grad_norms"]).all()
                and ls[-1] < ls[0]):
            emit({"phase": "lm_train", "runs": runs})
            raise SystemExit(f"the full-width loss did not fall or is not "
                             f"finite at {r['batch']} x {r['seq']}: {ls}")
    del params, state, step, opt, m, batch
    torch.cuda.empty_cache()

    restart = _lm_restart(device)
    t0 = time.perf_counter()
    cli = _train_cli(["--arch", "qwen3-8b", "--reduced", "--steps", "20"])
    cli_s = time.perf_counter() - t0
    if not (cli["device"] == "cuda" and cli["steps"] == 20
            and cli["last_loss"] < cli["first_loss"]):
        raise SystemExit(f"launch.train --arch qwen3-8b: {cli}")
    layer, table, other = lm_param_counts(cfg)
    emit({"phase": "lm_train", "gate": gate,
          "full_width": {"arch": cfg.name, "layers": cfg.num_layers,
                         "layers_of_the_model": full.num_layers,
                         "d_model": cfg.d_model, "d_ff": cfg.d_ff,
                         "heads": [cfg.num_heads, cfg.num_kv_heads],
                         "vocab": cfg.vocab_size,
                         "attn_impl": cfg.attn_impl, "remat": cfg.remat,
                         "params": cfg.num_layers * layer + table + other,
                         "state_bytes_weights_and_moments": state_bytes,
                         "card_bytes": total,
                         "headroom_bytes": LM_TRAIN_HEADROOM_BYTES,
                         "init_s": init_s, "peak_memory_bytes": peak,
                         "launches": launches, "runs": runs},
          "restart": restart, "cli": cli, "cli_s": cli_s})
    return {"layers": cfg.num_layers, "peak_memory_bytes": peak}


def phase_lm_head(device, batch=4, classify_batch=8, requests=2,
                  prompt_len=2048, gen=16):
    """The DWN head on the LM backbone at full width: an lm-head split made
    on the card, dwn-lm-head trained one epoch there, frozen and packed,
    then ``ServingEngine(qwen3-8b with attn_impl="pallas", dwn_head=art)``
    serving LM and classify requests in one drain through K10 and K2,
    every head count against ``apply_hard``; a classify request's time
    split; the serve CLI's ``--dwn-head dwn-lm-head``."""
    import gc
    import io
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.core.model import apply_hard
    from repro_torch.dwn import DWNArtifact, resolve_spec
    from repro_torch.launch import serve
    from repro_torch.models import api
    from repro_torch.serving import ServingEngine
    from repro_torch.workloads import load_workload
    from repro_torch.workloads.lm_head import FEATS, pool_features
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    data = load_workload("lm-head", 1024, 512, seed=0, device=device)
    split_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    art = DWNArtifact(resolve_spec("dwn-lm-head")).train(
        data, epochs=1, device=device)
    art.freeze().pack(device)
    train_s = time.perf_counter() - t0
    x_test = torch.from_numpy(data.x_test).to(device)
    test_acc = float((apply_hard(art.frozen, x_test).argmax(-1).cpu()
                      .numpy() == data.y_test).mean())

    cfg = dataclasses.replace(get_arch("qwen3-8b"), attn_impl="pallas")
    _reset_counts()
    t0 = time.perf_counter()
    engine = ServingEngine(cfg, prompt_len=prompt_len, gen=gen,
                           device=device, seed=0, dwn_head=art)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    startup = {name: n for K in _kernel_modules()
               for name, n in K.launch_counts().items() if n}
    if engine.head_bit_exact is not True:
        raise SystemExit("the DWN head's startup gate did not pass")
    if startup.get("flash_attention") != cfg.num_layers:
        raise SystemExit(f"the head's startup gate launched {startup}, not "
                         f"{cfg.num_layers} flash attentions")
    lm_reqs = [engine.make_request(batch, seed=100 + i)
               for i in range(requests)]
    cls_reqs = [engine.make_request(classify_batch, seed=200 + i,
                                    classify=True) for i in range(requests)]
    step = engine._head_backend.step_for(classify_batch)
    per_replay = step.launches
    _reset_counts()
    for lm_req, cls_req in zip(lm_reqs, cls_reqs):
        engine.submit(lm_req)
        engine.submit(cls_req)
    done = engine.drain()
    torch.cuda.synchronize()
    want = {"flash_attention": cfg.num_layers * 2 * requests,
            **{name: n * requests for name, n in per_replay.items()}}
    launches = _expect_launches("the LM + DWN-head drain", want)
    heads = [r for r in done if "pred" in r.result]
    lms = [r for r in done if "tokens" in r.result]
    if len(heads) != requests or len(lms) != requests:
        raise SystemExit(f"the drain served {len(lms)} LM and {len(heads)} "
                         f"classify requests, not {requests} each")
    for r in lms:
        toks = r.result["tokens"]
        if toks.shape != (batch, gen) or not (
                (toks >= 0) & (toks < cfg.vocab_size)).all():
            raise SystemExit(f"LM request {r.rid}: tokens {toks.shape}")
    for r in heads:
        feats = torch.from_numpy(r.result["features"]).to(device)
        want_counts = apply_hard(art.frozen, feats).cpu().numpy()
        if not (np.array_equal(r.result["counts"], want_counts) and
                np.array_equal(r.result["pred"], want_counts.argmax(-1))):
            raise SystemExit(f"classify request {r.rid}: K2's counts differ "
                             f"from apply_hard on its features")

    # a classify request's time, split
    toks = torch.from_numpy(cls_reqs[0]["tokens"]).to(device)
    mod = api.module_for(cfg)
    with torch.no_grad():
        backbone = lambda: mod.forward(  # noqa: E731
            engine.params, cfg, {"tokens": toks}, vocab_cols=FEATS)[0]
        logits16 = backbone()
        feats = pool_features(logits16)
        split = {"backbone_forward_ms": time_ms(backbone, 3, 1),
                 "pooling_ms": time_ms(lambda: pool_features(logits16), 20,
                                       3),
                 "k2_ms": time_ms(lambda: step(feats), 20, 3)}
        t0 = time.perf_counter()
        for _ in range(3):
            engine._head_step(cls_reqs[0])
        split["classify_request_wall_ms"] = \
            (time.perf_counter() - t0) * 1e3 / 3
        # the narrow unembedding against the full one, one sequence
        full = mod.forward(engine.params, cfg, {"tokens": toks[:1]})[0]
        narrow_diff = float((pool_features(full)
                             - pool_features(logits16[:1])).abs().max())
        del full
    narrow = {"max_abs_diff": narrow_diff, "tolerance": HEAD_FEAT_TOL,
              "equal": narrow_diff == 0.0}
    if not narrow_diff <= HEAD_FEAT_TOL:
        raise SystemExit(f"the 16-column unembedding's features differ from "
                         f"the full one's by {narrow_diff}")
    rep = engine.report()
    if not (rep["dwn_head"]["bit_exact_vs_oracle"] and
            rep["dwn_head"]["served"] == classify_batch * (requests + 3)):
        raise SystemExit(f"report dwn_head: {rep['dwn_head']}")
    report = {k: rep[k] for k in ("dwn_head", "prefill_s",
                                  "decode_s_per_tok", "served", "latency")}
    del engine, step, logits16, feats, toks
    gc.collect()
    torch.cuda.empty_cache()

    # the CLI, as a user runs it (the arch's own masked attention)
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        serve.main(["--arch", "qwen3-8b", "--dwn-head", "dwn-lm-head",
                    "--device", device])
    cli_s = time.perf_counter() - t0
    cli = json.loads(buf.getvalue().strip().splitlines()[-1])
    if not (cli["dwn_head"]["bit_exact_vs_oracle"] and
            len(cli["head_sample"]) == 4 and cli["device"] == "cuda"):
        raise SystemExit(f"serve --dwn-head: {cli}")
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "lm_head", "split_s": split_s, "head_train_s": train_s,
          "head_test_accuracy": test_acc,
          "head_calibration": art.calibration,
          "arch": cfg.name, "layers": cfg.num_layers,
          "attn_impl": cfg.attn_impl, "init_s": init_s,
          "startup_launches": startup, "launches": launches,
          "k2_launches_per_classify_request": per_replay,
          "lm_requests": [batch, prompt_len, gen],
          "classify_requests": [classify_batch, prompt_len],
          "classify_split": split, "narrow_unembed": narrow,
          "report": report, "cli_s": cli_s,
          "cli": {k: cli[k] for k in ("dwn_head", "head_sample", "sample",
                                      "prefill_s", "decode_s_per_tok")}})
    return launches


def train_bytes_and_ops(cfg, batch):
    """What one minibatch step must move and compute, from the shapes.

    ``bytes``: each input read once and each output written once: the
    parameters and both Adam moments read and written, the batch's bit
    rows and labels read, the loss written.  ``passes_bytes``: the
    traffic of the step's unfused passes over the (m, n, C) scores, 18 of
    them (2 forward: max, first argmax; 9 in the softmax-STE backward:
    exp, its sum, the product out, the sum of e·gb, the final expression;
    7 in Adam: read p, m, v, g, write p, m, v).  ``ops``: the gb product,
    2·B·m·n·C float32 operations."""
    layers = cfg.layer_specs()
    params = sum(s.num_luts * s.fan_in * s.num_candidates
                 + s.num_luts * s.table_size for s in layers)
    scores = sum(s.num_luts * s.fan_in * s.num_candidates for s in layers)
    rows = batch * layers[0].num_candidates + batch * 8
    ops = sum(2 * batch * s.num_luts * s.fan_in * s.num_candidates
              for s in layers)
    nbytes = 2 * 3 * params * 4 + rows + 4
    return {"bytes": nbytes, "ops": ops,
            "bound_ms": max(nbytes / PEAK_BYTES_PER_S,
                            ops / PEAK_FP32_OPS_PER_S) * 1e3,
            "bound_by": ("bytes" if nbytes / PEAK_BYTES_PER_S
                         >= ops / PEAK_FP32_OPS_PER_S else "operations"),
            "passes_bytes": 18 * scores * 4,
            "passes_bound_ms": 18 * scores * 4 / PEAK_BYTES_PER_S * 1e3}


def _train_state(cfg, data, device):
    """One numpy init (seed 0) as the port's params, Adam state, encoded
    split and labels on ``device``."""
    import torch
    from repro_torch.core.model import params_from_numpy
    from repro_torch.core.thermometer import fit_thresholds
    from repro_torch.training.engine import encode_dataset
    rng = np.random.default_rng(0)
    layers = [{"scores": (rng.standard_normal(
                   (s.num_luts, s.fan_in, s.num_candidates), np.float32)
                   * np.float32(0.01)),
               "tables": rng.uniform(-1, 1, (s.num_luts, s.table_size))
               .astype(np.float32)} for s in cfg.layer_specs()]
    th = fit_thresholds(data.x_train, cfg.thermometer)
    params, buffers = params_from_numpy({"layers": layers},
                                        {"thresholds": th}, device=device)
    bits = encode_dataset(data.x_train, buffers["thresholds"])
    y = torch.from_numpy(data.y_train.astype(np.int64)).to(device)
    return params, buffers, bits, y


def _run_steps(program, state, perm, steps, *, eager=False):
    """``steps`` steps of ``program`` from ``state`` (params, buffers,
    bits, y; not written): the per-step losses and the params after."""
    import torch
    from repro_torch.optim.adam import map_tree
    params, _, bits, y = state
    params = map_tree(torch.clone, params)
    opt_state = program.opt.init(params)
    program.load(params, opt_state, bits, y)
    program.begin_epoch(perm)
    for _ in range(steps):
        program.step(eager=eager)
    program.store(params, opt_state)
    return program.losses[:steps].clone(), params


def _wiring_flips(scores_a, scores_b):
    """Where the first argmax of two score tensors differs: (lut, input,
    wire here, wire there, the top two scores here)."""
    import torch
    wa = torch.argmax(scores_a, -1)
    wb = torch.argmax(scores_b, -1)
    out = []
    for lut, inp in (wa != wb).nonzero().tolist()[:20]:
        top = torch.topk(scores_a[lut, inp], 2).values.tolist()
        out.append([lut, inp, int(wa[lut, inp]), int(wb[lut, inp]), top])
    return int((wa != wb).sum()), out


def _profiled(fn):
    """``fn()`` once under ``torch.profiler``: the device's busy time (its
    kernels', copies' and fills' own time, summed), that time split by
    the ``record_function`` range named ``train.*`` whose host-side span
    launched it (the nearest such ancestor of the launching op; the
    range's device-side twin, which spans the gaps between its kernels,
    is not counted), and the largest work no range holds, by launching
    op, or by kernel name where the profiler tied it to no op."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.autograd.DeviceType.CUDA
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.events()
    busy = sum(e.self_device_time_total for e in events
               if e.device_type == cuda and not e.is_user_annotation) / 1e3
    ranges, rest, linked, on_device = {}, {}, {}, {}
    for e in events:
        if e.device_type == cuda:
            if not e.is_user_annotation:
                on_device[e.name] = on_device.get(e.name, 0.0) + \
                    e.self_device_time_total / 1e3
            continue
        for k in e.kernels:
            linked[k.name] = linked.get(k.name, 0.0) + k.duration / 1e3
        if not e.kernels:
            continue
        ms = sum(k.duration for k in e.kernels) / 1e3
        owner = e
        while owner is not None and not owner.name.startswith("train."):
            owner = owner.cpu_parent
        into, key = (ranges, owner.name) if owner else (rest, e.name)
        into[key] = into.get(key, 0.0) + ms
    # device work the profiler tied to no host op (by kernel name)
    for name, ms in on_device.items():
        if ms - linked.get(name, 0.0) > 1e-6:
            rest["unlinked: " + name[:80]] = ms - linked.get(name, 0.0)
    top = sorted(rest.items(), key=lambda kv: -kv[1])[:8]
    return busy, ranges, dict(top)


def _wall_ms(fn, reps):
    """Host milliseconds per call of ``fn`` over ``reps`` calls, waiting
    for the card at the end (unprofiled)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def _step_profile(program, perm, replays=20):
    """The profiler's split of one eager step by the step's ranges (the
    row gathers, the forward mapping and table read, the table's EFD
    backward, the softmax-STE elementwise work, the gb product, Adam;
    the rest is the loss and autograd's own work), and the device's
    busy time over ``replays`` replays of the captured step; each idle
    share against the same work's unprofiled wall time."""
    program.begin_epoch(perm)
    _profiled(lambda: program.step(eager=True))      # the profiler's setup
    program.begin_epoch(perm)
    wall = _wall_ms(lambda: program.step(eager=True), 10)
    busy, ranges, rest = _profiled(lambda: program.step(eager=True))
    named = {"softmax_ste_ms": ranges.get("train.ste", 0.0),
             "gb_product_ms": ranges.get("train.gb", 0.0),
             "adam_ms": ranges.get("train.adam", 0.0),
             "gathers_ms": ranges.get("train.gather", 0.0)}
    # the rest: the forward mapping, the table read and its EFD
    # backward, the loss and autograd's own work
    named["rest_ms"] = busy - sum(named.values())
    out = {"eager": {"device_busy_ms": busy or None, "wall_ms": wall,
                     "ranges_ms": ranges, **named,
                     "outside_ranges_total_ms": busy - sum(ranges.values()),
                     "outside_ranges_ms": rest,
                     "device_idle_share": (max(0.0, 1 - busy / wall)
                                           if busy else None)}}

    def replay():
        program.begin_epoch(perm)
        for _ in range(replays):
            program.step()
    wall = _wall_ms(replay, 3)
    busy, _, _ = _profiled(replay)
    out["replayed"] = {"steps": replays, "device_busy_ms": busy or None,
                       "wall_ms": wall,
                       "device_idle_share": (max(0.0, 1 - busy / wall)
                                             if busy else None)}
    return out


def phase_train(device, n_train=20000, n_test=5000, batch=128):
    """DWN training at dwn-jsc-lg width (F=16, T=200, one layer of 2400
    LUT6, 5 classes), the paper protocol (batch 128, Adam lr 1e-3,
    StepLR(30, 0.1), clamp (-1, 1)), on ``load_jsc(20000, 5000)``: the
    card's steps against the CPU's from one numpy init, a replay against
    the eager step, two card runs bit for bit, one epoch and eval through
    ``ScanTrainer`` timed beside the step's bound, a profiler split of the
    step, then ``DWNArtifact.train`` frozen, packed and served through
    ``ServingEngine`` bit-exact against ``apply_hard``."""
    import torch
    from repro_torch.core.model import JSC_PRESETS, apply_hard
    from repro_torch.data.jsc import load_jsc
    from repro_torch.dwn import DWNArtifact, get_spec
    from repro_torch.serving import ServingEngine
    from repro_torch.training import ScanTrainer, step_program
    from repro_torch.training.engine import epoch_permutation
    cfg = JSC_PRESETS["lg-2400"]
    data = load_jsc(n_train, n_test, seed=0)
    perm_np = epoch_permutation(n_train, n_train // batch, batch, seed=0,
                                epoch=0).astype(np.int64)
    key = (n_train, cfg.thermometer.total_bits, batch, 1e-3, "steplr")
    torch.cuda.reset_peak_memory_stats()

    # 1. TRAIN_STEPS steps on the card and on the CPU from one init
    t0 = time.perf_counter()
    card = _train_state(cfg, data, device)
    prog = step_program(cfg, *key, device)
    perm = torch.from_numpy(perm_np).to(device)
    loss_r, params_r = _run_steps(prog, card, perm, TRAIN_STEPS)
    capture_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    host = _train_state(cfg, data, "cpu")
    loss_c, params_c = _run_steps(step_program(cfg, *key, "cpu"), host,
                                  torch.from_numpy(perm_np), TRAIN_STEPS)
    cpu_s = time.perf_counter() - t0
    sc_r = params_r["layers"][0]["scores"].detach().cpu()
    sc_c = params_c["layers"][0]["scores"].detach()
    tab_r = params_r["layers"][0]["tables"].detach().cpu()
    tab_c = params_c["layers"][0]["tables"].detach()
    flips, flipped = _wiring_flips(sc_r, sc_c)
    vs_cpu = {"steps": TRAIN_STEPS, "loss_card": loss_r.tolist(),
              "loss_cpu": loss_c.tolist(),
              "loss_max_abs": float((loss_r.cpu() - loss_c).abs().max()),
              "loss_tol": TRAIN_LOSS_TOL,
              "scores_max_abs": float((sc_r - sc_c).abs().max()),
              "scores_tol": TRAIN_SCORES_TOL,
              "table_signs_differ": int(((tab_r > 0) != (tab_c > 0)).sum()),
              "wiring_flips": flips, "flipped": flipped,
              "cpu_s": cpu_s}
    if not (vs_cpu["loss_max_abs"] <= TRAIN_LOSS_TOL
            and vs_cpu["scores_max_abs"] <= TRAIN_SCORES_TOL):
        emit({"phase": "train", "vs_cpu": vs_cpu})
        raise SystemExit("the card's training steps disagree with the CPU's")

    # 2. a replay equals the eager step; two card runs are the same
    loss_e, params_e = _run_steps(prog, card, perm, TRAIN_STEPS, eager=True)
    loss_r2, params_r2 = _run_steps(prog, card, perm, TRAIN_STEPS)
    same = {
        "replay_vs_eager_losses": bool(torch.equal(loss_r, loss_e)),
        "replay_vs_eager_params": all(
            torch.equal(a, b) for a, b in zip(
                _leaves(params_r), _leaves(params_e))),
        "two_runs_losses": bool(torch.equal(loss_r, loss_r2)),
        "two_runs_params": all(
            torch.equal(a, b) for a, b in zip(
                _leaves(params_r), _leaves(params_r2)))}
    if not all(same.values()):
        emit({"phase": "train", "vs_cpu": vs_cpu, "bitwise": same,
              "replay_vs_eager_max_abs": float(
                  (loss_r - loss_e).abs().max())})
        raise SystemExit(f"training steps are not reproducible: {same}")

    # 3-4. one epoch and eval through ScanTrainer; the step's times
    params, buffers, _, _ = card
    trainer = ScanTrainer(cfg, data, batch=batch, params=params,
                          buffers=buffers, device=device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = trainer.run_epochs(1)
    epoch_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    acc = trainer.evaluate()
    eval_s = time.perf_counter() - t0
    if not (np.isfinite(losses).all() and 0.2 < acc <= 1.0):
        raise SystemExit(f"the epoch's losses or accuracy are off: "
                         f"{losses.mean()} {acc}")
    steps = trainer.steps_per_epoch
    prog.begin_epoch(perm)
    replay_ms = time_ms(prog.step, iters=100, warmup=0)
    prog.begin_epoch(perm)
    eager_ms = time_ms(lambda: prog.step(eager=True), iters=20, warmup=0)
    profile_split = _step_profile(prog, perm)

    # 6. DWNArtifact.train -> freeze -> pack -> serve, against apply_hard
    art = DWNArtifact(get_spec("dwn-jsc-lg")).train(
        data, epochs=1, seed=0, device=device)
    engine = ServingEngine(art, device=device, max_bucket=4096,
                           n_train=n_train, seed=0)
    if not all(engine.bit_exact.values()):
        raise SystemExit(f"the trained model fails the startup oracle "
                         f"check: {engine.bit_exact}")
    stream = [engine.make_request(4096, seed=3000 + i) for i in range(4)]
    for r in stream:
        engine.submit(r)
    done = engine.drain()
    for r in done:
        x = torch.from_numpy(np.ascontiguousarray(r.payload)).to(device)
        want = apply_hard(art.frozen, x).cpu().numpy()
        if not np.array_equal(want, r.result[0]):
            raise SystemExit(f"request {r.rid}: served counts differ from "
                             f"apply_hard")
    bound = train_bytes_and_ops(cfg, batch)
    emit({"phase": "train", "arch": "dwn-jsc-lg", "n_train": n_train,
          "batch": batch, "steps_per_epoch": steps,
          "first_steps_s": capture_s, "vs_cpu": vs_cpu, "bitwise": same,
          "epoch_s": epoch_s, "steps_per_s": steps / epoch_s,
          "eval_s": eval_s, "epoch_loss": float(losses.mean()),
          "soft_test_acc": acc, "step_ms_replayed": replay_ms,
          "step_ms_eager": eager_ms, **bound,
          "replayed_over_bound": replay_ms / bound["bound_ms"],
          "profile": profile_split,
          "peak_memory_bytes": torch.cuda.max_memory_allocated(),
          "artifact": {"calibration": art.calibration,
                       "history": art.history, "stage": art.stage,
                       "bit_exact_vs_oracle": engine.bit_exact,
                       "served": sum(r.size for r in done)}})


def phase_serve(device, batch=4096, requests=16, n_train=20000):
    """dwn-jsc-lg pinned to the fused backend (K2, then K1 per bucket),
    then ``backend="auto"`` (tuned, calibrated), each step a CUDA graph
    replay; then the artifact saved, loaded and served again."""
    from repro_torch.dwn import DWNArtifact
    from repro_torch.kernels.autotune import DEFAULT_CONFIG, FusedConfig
    from repro_torch.serving import ServingEngine
    t0 = time.perf_counter()
    engine = ServingEngine("dwn-jsc-lg", device=device, max_bucket=batch,
                           n_train=n_train, seed=0)
    startup_s = time.perf_counter() - t0
    if engine.bit_exact != {"fused-packed": True, "packed-eager": True}:
        raise SystemExit(f"startup verification incomplete: "
                         f"{engine.bit_exact}")
    if not engine.report()["cuda_graphs"]["fused-packed"]:
        raise SystemExit("the fused backend does not replay CUDA graphs")
    stream = [engine.make_request(batch, seed=1000 + i)
              for i in range(requests)]
    engine.warmup(batch)
    done_k2, launches_k2, k2 = _serve_pass(engine, stream,
                                           ["fused_dwn_packed"])
    split_k2 = _replay_and_eager_split(engine, stream[0])

    for bucket in engine.scheduler.buckets:
        engine.model.tuned_configs[bucket] = FusedConfig(
            "batch-major", block_b=DEFAULT_CONFIG.block_b)
    engine.warmup(batch)
    done_k1, launches_k1, k1 = _serve_pass(engine, stream,
                                           ["fused_dwn_batch_major"])
    split_k1 = _replay_and_eager_split(engine, stream[0])
    _same_results(done_k2, done_k1, "the two kernels")
    _check_against_oracle(engine, done_k2)

    engine.model.tuned_configs.clear()
    rng = np.random.default_rng(7)
    ragged = [engine.make_request(int(rng.integers(1, batch + 1)),
                                  seed=2000 + i) for i in range(requests)]
    done_rg, launches_rg, rg = _serve_pass(engine, ragged,
                                           ["fused_dwn_packed"])
    _check_against_oracle(engine, done_rg)
    emit({"phase": "serve", "arch": "dwn-jsc-lg", "luts": engine.spec.luts,
          "startup_s": startup_s, "bit_exact_vs_oracle": engine.bit_exact,
          "passes": [k2, k1, dict(rg, ragged=True)],
          "compiles": engine.compile_counts(),
          "step_split": {"fused_dwn_packed": split_k2,
                         "fused_dwn_batch_major": split_k1}})

    # backend="auto": the tuner races K1 against K2 per bucket into a
    # fresh cache (main() points REPRO_AUTOTUNE_CACHE at it), the
    # selector calibrates the ladder, each bucket replays its graph
    t0 = time.perf_counter()
    auto = ServingEngine("dwn-jsc-lg", device=device, backend="auto",
                         max_bucket=batch, n_train=n_train, seed=0)
    auto_startup_s = time.perf_counter() - t0
    rep = auto.report()
    if sorted(rep["auto"]["choice"]) != sorted(auto.scheduler.buckets) or \
            sorted(rep["tuned_configs"]) != sorted(auto.scheduler.buckets):
        raise SystemExit(f"auto did not cover the ladder: {rep['auto']}")
    if not all(auto.bit_exact.values()):
        raise SystemExit(f"auto verification failed: {auto.bit_exact}")
    fused = ["fused_dwn_packed", "fused_dwn_batch_major"]
    auto.warmup(batch)
    done_a, launches_a, pa = _serve_pass(auto, stream, fused)
    done_ar, launches_ar, par = _serve_pass(auto, ragged, fused)
    compiles = _check_compiles(auto)     # before the oracle's own steps
    _check_against_oracle(auto, done_a + done_ar)
    _same_results(done_k2, done_a, "auto and the pinned kernel")
    cache = json.loads(Path(os.environ["REPRO_AUTOTUNE_CACHE"]).read_text())
    emit({"phase": "serve", "mode": "auto", "startup_s": auto_startup_s,
          "choice": {b: {"backend": c,
                         "config": rep["tuned_configs"][b]}
                     for b, c in rep["auto"]["choice"].items()},
          "timings_ms": rep["auto"]["timings_ms"],
          "tuner_us": {k.split(":")[1]: v["timings_us"]
                       for k, v in cache["entries"].items()},
          "compiles": compiles, "cuda_graphs": rep["cuda_graphs"],
          "passes": [pa, dict(par, ragged=True)]})

    # the served artifact saved, loaded back and served bit-exact
    ckpt = ROOT / "build" / "chip_smoke_artifact"
    shutil.rmtree(ckpt, ignore_errors=True)
    auto.artifact.save(ckpt)
    loaded = DWNArtifact.load(ckpt, device=device)
    again = ServingEngine(loaded, device=device, backend="auto",
                          max_bucket=batch, n_train=n_train, seed=0)
    done_l, _, pl = _serve_pass(again, stream[:4] + ragged[:4], fused)
    _same_results(done_a[:4] + done_ar[:4], done_l,
                  "the loaded artifact and the served one")
    _check_against_oracle(again, done_l)
    shutil.rmtree(ckpt, ignore_errors=True)
    emit({"phase": "serve", "mode": "artifact", "stage": loaded.stage,
          "fingerprint": loaded.spec.fingerprint(),
          "choice": again.report()["auto"]["choice"], "pass": pl})

    # the zero kernel runs before a launch that splits its tiles (the
    # ragged pass's requests of fewer than 132 * 32 rows)
    zeroed = sum(n["fused_dwn_zero"]
                 for n in (launches_k2, launches_k1, launches_rg))
    if not zeroed:
        raise SystemExit("fused_dwn_zero was not launched on the passes")
    return {"fused_dwn_packed": launches_k2["fused_dwn_packed"],
            "fused_dwn_batch_major": launches_k1["fused_dwn_batch_major"],
            "fused_dwn_zero": zeroed}


#: the load phase's fixed parameters: the engine's ladder, the loop's SLO
#: (queued samples; a submit that finds no room is rejected at once), the
#: open-loop traffic (one tenant, Poisson, request sizes, deadline, seed),
#: the offered levels as fractions of the closed-loop capacity and each
#: level's length, the burst level and the correctness stream
LOAD_BUCKET = 4096
LOAD_QUEUE_SAMPLES = 16 * 4096
LOAD_SIZES = (256, 4096)
LOAD_DEADLINE_MS = 5.0
LOAD_SEED = 0
LOAD_LEVELS = (0.5, 1.0, 1.3)
LOAD_DURATION_S = 2.0
LOAD_BURST = dict(burst_factor=4.0, burst_every_s=0.5, burst_len_s=0.1)
#: the burst, two-tenant and garbage-collector-off levels run 1 s, in
#: continuous mode only, and so does the profiled one
LOAD_SHORT_S = 1.0
#: the gates' ragged stream: 40 requests of 1-4096 rows, three of them
#: oversize (3 * 4096 + 17 rows, served in four chunks)
LOAD_STREAM_REQUESTS = 40
LOAD_OVERSIZE = 3 * LOAD_BUCKET + 17
WAIT_S = 300.0


class _Recorded:
    """An engine as ``loadgen.run_async`` drives it, keeping every
    request it admits so the level's results can be checked."""

    def __init__(self, engine):
        self.engine, self.reqs = engine, []

    def start_serving(self, **kwargs):
        self.engine.start_serving(**kwargs)

    def stop_serving(self, **kwargs):
        self.engine.stop_serving(**kwargs)

    def submit_async(self, *args, **kwargs):
        req = self.engine.submit_async(*args, **kwargs)
        self.reqs.append(req)
        return req


def _gate_stream(engine):
    rng = np.random.default_rng(LOAD_SEED)
    sizes = [int(n) for n in rng.integers(1, LOAD_BUCKET + 1,
                                          LOAD_STREAM_REQUESTS)]
    for i in (5, 18, 31):
        sizes[i] = LOAD_OVERSIZE
    return [engine.make_request(n, seed=3000 + i)
            for i, n in enumerate(sizes)]


def _async_gate(engine, stream, pinned):
    """The stream through the sync drain, then through ``serve()`` /
    ``submit_async`` with the counts set to 0 once the session's loop
    runs and read when it has stopped.  Holds every async result to the
    sync drain's (which is held to ``apply_hard``), every bucket's step of
    the served backend built when the loop starts, ``compile_counts()``
    the same from the loop's start to its stop, and the launches
    to what the session's steps replay: each step's bucket is tallied
    (a wrapper on the engine's step) and each bucket's graph replayed
    once after the session to read what one replay launches."""
    import torch
    from repro_torch.kernels.fused.kernel import (launch_counts,
                                                  reset_launch_counts)
    from repro_torch.serving import SLOConfig
    for p in stream:
        engine.submit(p)
    sync = sorted(engine.drain(), key=lambda r: r.rid)
    _check_against_oracle(engine, sync)
    buckets = []
    step = engine._dwn_step

    def tallied(x):
        buckets.append(x.shape[0])
        return step(x)
    engine._dwn_step = tallied
    try:
        with engine.serve(slo=SLOConfig(max_queue_samples=1 << 20)):
            during = engine.compile_counts()
            buckets.clear()               # the ladder's warm steps
            torch.cuda.synchronize()
            reset_launch_counts()
            t0 = time.perf_counter()
            reqs = [engine.submit_async(p) for p in stream]
            results = [r.future.result(timeout=WAIT_S) for r in reqs]
            wall = time.perf_counter() - t0
        launches = launch_counts()
    finally:
        del engine._dwn_step
    after = engine.compile_counts()
    if during != after:
        raise SystemExit(f"a step was built during the session: {during} "
                         f"-> {after}")
    served = ({b: engine.backend.name for b in engine.scheduler.buckets}
              if pinned else engine.auto.choice)
    unbuilt = [b for b, name in served.items()
               if b not in during.get(name, {})]
    if unbuilt:
        raise SystemExit(f"buckets {unbuilt} had no step when the loop "
                         f"started: {during}")
    for res, want in zip(results, sync):
        if not (res.ok and np.array_equal(res.value[0], want.result[0])
                and np.array_equal(res.value[1], want.result[1])):
            raise SystemExit(f"async request {res.rid} ({res.shed}) "
                             f"differs from the sync drain")
    counters = engine.report()["async"]
    if len(buckets) != counters["steps"]:
        raise SystemExit(f"{len(buckets)} steps tallied, the loop counted "
                         f"{counters['steps']}")
    per_bucket = {}
    for b in sorted(set(buckets)):
        reset_launch_counts()
        engine._dwn_step(engine.data.x_test[:b])
        torch.cuda.synchronize()
        per_bucket[b] = launch_counts()
    expected = {k: sum(per_bucket[b][k] for b in buckets) for k in launches}
    fused = launches["fused_dwn_packed"] + launches["fused_dwn_batch_major"]
    fused_steps = sum(served[b] == "fused-packed" for b in buckets)
    if launches != expected or fused != fused_steps or (
            pinned and (fused_steps != counters["steps"]
                        or launches["fused_dwn_batch_major"])):
        raise SystemExit(f"launches {launches} are not the session's "
                         f"{counters['steps']} steps' {expected}")
    return launches, {
        "requests": len(stream), "rows": sum(len(p) for p in stream),
        "oversize_requests": sum(len(p) > LOAD_BUCKET for p in stream),
        "wall_s": wall, "steps": counters["steps"], "launches": launches,
        "steps_by_bucket": {b: buckets.count(b) for b in sorted(set(buckets))},
        "served_by": served, "compiles": after, "all_ok": True,
        "equal_to_sync_and_oracle": True}


def _tenant_rate(capacity, fraction):
    """Requests a second that offer ``fraction`` of ``capacity`` samples a
    second at the mean request size."""
    return fraction * capacity / (sum(LOAD_SIZES) / 2)


def _payloads(engines, arrivals, seed):
    from repro_torch.launch import loadgen
    return [loadgen._engine_for(engines, a).make_request(a.size,
                                                         seed=seed + i)
            for i, a in enumerate(arrivals)]


def _continuous_level(engines, arrivals, payloads, slo, gc_off=False):
    """One open-loop run through the continuous path, each engine's step
    estimates seeded anew from its calibration (a level does not inherit
    the last one's); holds every arrival served, shed or rejected, every
    ok result on time, and each engine's shed count to its non-ok
    results.  ``gc_off``: Python's garbage collector off for the run (a
    diagnostic of what its pauses cost the loop)."""
    import gc
    from repro_torch.launch import loadgen
    recorded = {p: _Recorded(e) for p, e in engines.items()}
    before = {p: e.report() for p, e in engines.items()}
    for e in engines.values():
        e.estimator = None
    if gc_off:
        gc.disable()
    try:
        m = loadgen.run_async(recorded, arrivals, payloads, slo=slo)
    finally:
        gc.enable()
    if m["served_requests"] + m["shed_requests"] != len(arrivals) or \
            m["rejected_requests"] > m["shed_requests"]:
        raise SystemExit(f"arrivals unaccounted for: {len(arrivals)}, {m}")
    per_engine = {}
    for p, rec in recorded.items():
        results = [r.future.result(timeout=WAIT_S) for r in rec.reqs]
        late_ok = [r.rid for r, res in zip(rec.reqs, results)
                   if res.ok and r.deadline is not None
                   and r.t_done > r.deadline]
        if late_ok:
            raise SystemExit(f"{p}: ok past the deadline: {late_ok[:8]}")
        rep = engines[p].report()
        not_ok = sum(not res.ok for res in results)
        shed = rep["shed"]["requests"] - before[p]["shed"]["requests"]
        if shed != not_ok:
            raise SystemExit(f"{p}: report sheds {shed}, results {not_ok}")
        c = rep["async"]
        launched = sum(r.size for r, res in zip(rec.reqs, results)
                       if res.value is not None)
        per_engine[p] = {
            "steps": c["steps"],
            "samples_per_step": launched / c["steps"] if c["steps"] else 0,
            "mean_step_ms": c["busy_s"] / c["steps"] * 1e3 if c["steps"]
            else None,
            "busy_share": c["busy_s"] / c["session_wall_s"],
            "shed_by_reason": c["shed_by_reason"],
            "queue_depth_max_samples": c["queue_depth_max_samples"],
            "step_estimates_ms": c["step_estimates_ms"],
            "straggler_events": rep["straggler"]["events"]
            - before[p]["straggler"]["events"]}
    return {**_level_numbers(m), "per_engine": per_engine}


def _level_numbers(m):
    keys = ("offered_samples_per_s", "throughput_samples_per_s",
            "latency_ms_p50", "latency_ms_p99", "latency_ms_p999",
            "shed_rate", "served_requests", "shed_requests",
            "rejected_requests", "wall_s")
    return {**{k: m.get(k) for k in keys},
            "submit_lag_ms_p99": m["submit_lag_ms"].get("p99")}


def _sync_level(engines, arrivals, payloads):
    from repro_torch.launch import loadgen
    m = loadgen.run_sync(engines, arrivals, payloads)
    if m["served_requests"] != len(arrivals):
        raise SystemExit(f"sync: arrivals unaccounted for: {m}")
    return _level_numbers(m)


def _load_level(name, engines, spec, slo, modes=("continuous", "sync"),
                gc_off=False):
    from repro_torch.launch import loadgen
    arrivals = loadgen.make_arrivals(spec)
    payloads = _payloads(engines, arrivals, spec.seed)
    out = {"level": name, "rate_rps": spec.rate_rps,
           "arrivals": len(arrivals), "duration_s": spec.duration_s}
    if "continuous" in modes:
        out["continuous"] = _continuous_level(engines, arrivals, payloads,
                                              slo, gc_off=gc_off)
    if "sync" in modes:
        out["sync"] = _sync_level(engines, arrivals, payloads)
    emit({"phase": "load", **out})
    return out


def _load_profile(engine, spec, slo):
    """``torch.profiler`` over one continuous run: the card's busy time
    split into the served kernels, the copies in and out and the rest,
    against the run's wall; and the loop's own busy share of it."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch import loadgen
    arrivals = loadgen.make_arrivals(spec)
    payloads = _payloads({"e": engine}, arrivals, spec.seed)
    engine.estimator = None
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        m = loadgen.run_async({"e": engine}, arrivals, payloads, slo=slo)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    split = {"kernels_ms": 0.0, "h2d_ms": 0.0, "d2h_ms": 0.0, "other_ms": 0.0}
    launches = 0
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA or \
                e.self_device_time_total <= 0:
            continue
        ms = e.self_device_time_total / 1e3
        key = ("h2d_ms" if "HtoD" in e.key else "d2h_ms" if "DtoH" in e.key
               else "kernels_ms" if "fused" in e.key else "other_ms")
        split[key] += ms
        launches += e.count if key == "kernels_ms" else 0
    busy = sum(split.values())
    c = engine.report()["async"]
    return {"arrivals": len(arrivals), "wall_ms": wall * 1e3,
            "device_busy_ms": busy or None,
            "device_idle_share": (1 - busy / (wall * 1e3)) if busy else None,
            **split, "kernel_launches": launches, "steps": c["steps"],
            "mean_step_ms": c["busy_s"] / c["steps"] * 1e3 if c["steps"]
            else None,
            "loop_busy_share": c["busy_s"] / c["session_wall_s"],
            "throughput_samples_per_s": m["throughput_samples_per_s"],
            "shed_rate": m["shed_rate"]}


def phase_load(device, n_train=20000):
    """dwn-jsc-lg through the continuous-batching loop: the gates (every
    async result equal to the sync drain and ``apply_hard``, no capture
    in a session, K1/K2 launches accounted for by the steps) pinned to
    K2 and under ``backend="auto"``; then the open-loop latency-throughput
    curve, a burst level, two engines in two loop threads at once
    (dwn-jsc-lg and dwn-mnist-lg) and a profiled second at the capacity."""
    from repro_torch.launch import loadgen
    from repro_torch.serving import ServingEngine, SLOConfig
    smi = nvidia_smi_line()
    launches = {}
    engines = {}
    for backend in ("fused-packed", "auto"):
        t0 = time.perf_counter()
        engine = ServingEngine("dwn-jsc-lg", device=device, backend=backend,
                               max_bucket=LOAD_BUCKET, min_bucket=8,
                               n_train=n_train, seed=0)
        startup_s = time.perf_counter() - t0
        got, gate = _async_gate(engine, _gate_stream(engine),
                                pinned=backend != "auto")
        for k, n in got.items():
            launches[k] = launches.get(k, 0) + n
        emit({"phase": "load", "gate": backend, "startup_s": startup_s,
              **gate})
        engines[backend] = engine
    lg = engines["auto"]
    del engines

    slo = SLOConfig(max_queue_samples=LOAD_QUEUE_SAMPLES,
                    submit_timeout_s=0.0)
    sizes = f"uniform:{LOAD_SIZES[0]}:{LOAD_SIZES[1]}"
    capacity = {"dwn-jsc-lg": loadgen.measure_capacity(lg)}
    tenant = loadgen.Tenant(name="dwn-jsc-lg", size=sizes,
                            deadline_ms=LOAD_DEADLINE_MS)
    emit({"phase": "load", "nvidia_smi": smi, "engine": "dwn-jsc-lg auto",
          "max_bucket": LOAD_BUCKET, "slo": dataclasses.asdict(slo),
          "sizes": sizes, "deadline_ms": LOAD_DEADLINE_MS,
          "capacity_samples_per_s": capacity["dwn-jsc-lg"]})
    curve = []
    for frac in LOAD_LEVELS:
        spec = loadgen.LoadSpec(
            rate_rps=_tenant_rate(capacity["dwn-jsc-lg"], frac),
            duration_s=LOAD_DURATION_S, seed=LOAD_SEED, tenants=(tenant,))
        curve.append(_load_level(f"poisson {frac}", {"dwn-jsc-lg": lg},
                                 spec, slo))
    spec = loadgen.LoadSpec(
        rate_rps=_tenant_rate(capacity["dwn-jsc-lg"], 0.5),
        duration_s=LOAD_SHORT_S, seed=LOAD_SEED, tenants=(tenant,),
        **LOAD_BURST)
    curve.append(_load_level("burst 0.5", {"dwn-jsc-lg": lg}, spec, slo,
                             modes=("continuous",)))
    spec = loadgen.LoadSpec(
        rate_rps=_tenant_rate(capacity["dwn-jsc-lg"], 1.0),
        duration_s=LOAD_SHORT_S, seed=LOAD_SEED, tenants=(tenant,))
    curve.append(_load_level("poisson 1.0, gc off", {"dwn-jsc-lg": lg},
                             spec, slo, modes=("continuous",), gc_off=True))

    # two engines, each its own loop thread replaying its graphs, at once
    mnist = ServingEngine("dwn-mnist-lg", device=device, backend="auto",
                          max_bucket=LOAD_BUCKET, min_bucket=8,
                          n_train=n_train, seed=0)
    capacity["dwn-mnist-lg"] = loadgen.measure_capacity(mnist)
    pair = {"dwn-jsc-lg": lg, "dwn-mnist-lg": mnist}
    tenants = tuple(loadgen.Tenant(name=p, weight=capacity[p], size=sizes,
                                   deadline_ms=LOAD_DEADLINE_MS, preset=p)
                    for p in pair)
    spec = loadgen.LoadSpec(rate_rps=_tenant_rate(sum(capacity.values()),
                                                  0.5),
                            duration_s=LOAD_SHORT_S, seed=LOAD_SEED,
                            tenants=tenants)
    curve.append(_load_level("two tenants 0.5", pair, spec, slo,
                             modes=("continuous",)))
    compiles = {p: e.compile_counts() for p, e in pair.items()}

    spec = loadgen.LoadSpec(rate_rps=_tenant_rate(capacity["dwn-jsc-lg"],
                                                  1.0),
                            duration_s=LOAD_SHORT_S, seed=LOAD_SEED + 1,
                            tenants=(tenant,))
    prof = _load_profile(lg, spec, slo)
    if {p: e.compile_counts() for p, e in pair.items()} != compiles:
        raise SystemExit("a step was built during the profiled run")
    emit({"phase": "load", "profile": "poisson 1.0", "nvidia_smi": smi,
          **prof})
    emit({"phase": "load", "capacity_samples_per_s": capacity,
          "curve": [{"level": c["level"],
                     **{m: {k: c[m][k] for k in (
                         "offered_samples_per_s", "throughput_samples_per_s",
                         "latency_ms_p99", "shed_rate")}
                        for m in ("continuous", "sync") if m in c}}
                    for c in curve]})
    return launches


#: dwn-mnist-lg's shape: 196 pooled pixels, T = 16 (3136 encoder bits, 98
#: words a sample), one layer of 2000 LUT6, 10 classes
MNIST_LG = dict(F=196, T=16, m=2000, n=6, C=10)
#: the smaller MNIST tiers (T, LUTs) held against the plain kernels in the
#: hw phase: md's groups of 50, sm's 100 LUTs (4 words of the last layer)
MNIST_TIERS = {"mnist-md": (8, 500), "mnist-sm": (8, 100)}
#: vectors of each RTL co-simulation in the hw phase
RTL_ROWS = 256


def _hw_dict(rep):
    """A cost report's LUTs and FFs per component, totals, depth, the
    estimates and the encoder's share of the LUTs."""
    return {"variant": rep.variant, "input_bits": rep.input_bits,
            "luts": dict(rep.luts), "ffs": dict(rep.ffs),
            "total_luts": rep.total_luts, "total_ffs": rep.total_ffs,
            "levels": rep.levels,
            "distinct_comparators": rep.distinct_comparators,
            "fmax_mhz": rep.fmax_mhz, "delay_ns": rep.delay_ns,
            "area_delay": rep.area_delay,
            "encoder_lut_share": rep.luts["encoder"] / rep.total_luts}


def _rtl_against_k2(art, engine, x):
    """``verify_rtl`` (Python evaluator, the oracle on the card) on the
    rows ``x``, then the netlist evaluator's per-class counts and argmax
    against the counts K2 served for the same rows through ``engine``
    (pinned to the default config, so one CUDA graph of K2)."""
    from repro_torch.core.thermometer import encode_np
    from repro_torch.hw.cosim import evaluate_netlist
    from repro_torch.kernels.fused.kernel import (launch_counts,
                                                  reset_launch_counts)
    t0 = time.perf_counter()
    rep = art.verify_rtl(x, backend="python")
    verify_s = time.perf_counter() - t0
    engine.model.tuned_configs.clear()
    reset_launch_counts()
    engine.submit(x)
    (served,) = engine.drain()
    if not launch_counts()["fused_dwn_packed"]:
        raise SystemExit(f"the RTL rows were not served by K2: "
                         f"{launch_counts()}")
    frozen = art.frozen
    res = (evaluate_netlist(rep.src, x=x)
           if frozen.input_frac_bits is not None else
           evaluate_netlist(rep.src, ten_bits=encode_np(x, frozen.thresholds)))
    counts, pred = served.result
    if not (np.array_equal(res.class_counts, counts.astype(np.int64))
            and np.array_equal(res.argmax_idx, pred.astype(np.int64))):
        bad = np.nonzero((res.class_counts != counts).any(-1))[0]
        raise SystemExit(f"{art.spec.label}: the RTL evaluator's counts "
                         f"differ from K2's on {bad.size} of {len(x)} rows")
    return {"spec": art.spec.label, "n_vectors": rep.n_vectors,
            "backends": rep.backends, "counts_checked": rep.counts_checked,
            "verify_s": verify_s, "evaluator_equals_k2": True,
            "verilog_lines": rep.src.count("\n")}


def _mnist_kernel_checks(device, batches=(1, 33, 4096)):
    """K1 and K2 at the smaller MNIST tiers' shapes (random models from a
    numpy seed) equal to their plain versions, each launch's layout held
    to the planner's rule: a batch of at most 88 tiles of 32 samples
    (here B = 1 and 33) splits the last layer's words over blocks, the
    zero kernel first (sm's 4 words: 4 slices); 4096 rows (128 tiles)
    take one slice, the model staged."""
    import torch
    from repro_torch.kernels.fused import kernel as K
    from repro_torch.kernels.fused import ref as R
    from repro_torch.kernels.fused.ops import prepare_operands
    F, n, C = (MNIST_LG[k] for k in ("F", "n", "C"))
    rng = np.random.default_rng(22)
    x_all = torch.from_numpy(rng.uniform(
        -1, 1, (max(batches), F)).astype(np.float32)).to(device)
    layouts = {}
    for tier, (T, m) in MNIST_TIERS.items():
        th, maps, tabs = make_model(rng, F, T, (m,), n)
        operands = [torch.from_numpy(a).to(device) for a in (th, *maps,
                                                              *tabs)]
        for variant, kern, plain in (
                ("packed", K.fused_dwn_packed, R.fused_dwn_packed_plain),
                ("batch-major", K.fused_dwn_batch_major,
                 R.fused_dwn_batch_major_plain)):
            ops = prepare_operands(operands[0], operands[1:2], operands[2:],
                                   C, variant)
            for B in batches:
                got = kern(x_all[:B], *ops)
                lay = K.last_launch()
                want = plain(x_all[:B], *ops)
                layouts[f"{tier} {variant} B={B}"] = lay
                if not (torch.equal(got[0], want[0])
                        and torch.equal(got[1], want[1])):
                    raise SystemExit(f"{variant} differs from its plain "
                                     f"version at {tier}, B={B}: {lay}")
                split = B <= 33
                if (lay["slices"] > 1) != split or \
                        bool(lay["zeroed"]) != split or not lay["staged"]:
                    raise SystemExit(f"{tier} {variant} at B={B} is not "
                                     f"laid out as planned: {lay}")
    return layouts


def phase_hw(device, batch=4096, requests=16, n_train=20000, n_test=5000):
    """The paper's hardware model at full width on the card:
    ``dwn-mnist-lg`` trained one epoch on ``load_mnist(20000, 5000)``,
    frozen, packed and served through K2, K1 (pinned) and
    ``backend="auto"`` in CUDA graphs, every served row equal to
    ``apply_hard``, K2 once more after auto and a 4096-row step's copies
    and replay split; K1 and K2 at its shape timed beside their bounds (and
    held to their plain versions at the md and sm tiers' shapes); its cost
    report (TEN, and PEN at 9 bits on the same params); ``verify_rtl`` on
    256 test rows, the evaluator's per-class counts equal to K2's; the
    checkpoint saved, loaded and served again bit-exact; then the paper's
    ``dwn-jsc-lg`` at PEN 9 bits from a warm start on the card: its cost
    report and the same RTL check.  Returns the launches of K1, K2 and
    the zero kernel on the served passes."""
    import torch
    from repro_torch.core.warmstart import warmstart_dwn
    from repro_torch.data.jsc import load_jsc
    from repro_torch.dwn import DWNArtifact, get_spec
    from repro_torch.kernels.autotune import DEFAULT_CONFIG, FusedConfig
    from repro_torch.kernels.fused import kernel as K
    from repro_torch.kernels.fused import ref as R
    from repro_torch.kernels.fused.ops import prepare_operands
    from repro_torch.serving import ServingEngine
    from repro_torch.workloads.mnist import load_mnist
    seconds = {}
    fused = ["fused_dwn_packed", "fused_dwn_batch_major"]

    # 1. train, freeze, pack
    t0 = time.perf_counter()
    data = load_mnist(n_train, n_test, seed=0)
    spec = get_spec("dwn-mnist-lg")
    art = DWNArtifact(spec).train(data, epochs=1, seed=0, device=device)
    art.freeze().pack(device)
    seconds["train"] = time.perf_counter() - t0

    # 2. serve the 4096-row and the ragged stream pinned to K2, pinned to
    # K1, with backend="auto", then K2 again
    t0 = time.perf_counter()
    engine = ServingEngine(art, device=device, max_bucket=batch,
                           n_train=n_train, seed=0)
    if engine.bit_exact != {"fused-packed": True, "packed-eager": True}:
        raise SystemExit(f"mnist-lg fails the startup oracle check: "
                         f"{engine.bit_exact}")
    stream = [engine.make_request(batch, seed=4000 + i)
              for i in range(requests)]
    rng = np.random.default_rng(8)
    ragged = [engine.make_request(int(rng.integers(1, batch + 1)),
                                  seed=5000 + i) for i in range(requests)]
    auto = ServingEngine(art, device=device, backend="auto",
                         max_bucket=batch, n_train=n_train, seed=0)
    passes, done, launches = [], {}, {}
    for mode, eng, kernels, variant in (
            ("K2", engine, ["fused_dwn_packed"], None),
            ("K1", engine, ["fused_dwn_batch_major"], "batch-major"),
            ("auto", auto, fused, None),
            ("K2 after auto", engine, ["fused_dwn_packed"], None)):
        if eng is engine:
            engine.model.tuned_configs.clear()
            for bucket in engine.scheduler.buckets if variant else ():
                engine.model.tuned_configs[bucket] = FusedConfig(
                    variant, block_b=DEFAULT_CONFIG.block_b)
        eng.warmup(batch)
        for name, reqs in (("4096", stream), ("ragged", ragged)):
            d, n, p = _serve_pass(eng, reqs, kernels)
            passes.append(dict(p, mode=mode, stream=name))
            done[mode, name] = d
            launches[mode, name] = n
            _same_results(done["K2", name], d, f"{mode} and K2 at mnist-lg")
    compiles = _check_compiles(auto)
    _check_against_oracle(auto, done["auto", "4096"] + done["auto", "ragged"])
    _check_against_oracle(engine, [r for (mode, _), d in done.items()
                                   if mode != "auto" for r in d])
    # where a 4096-row step's time goes: the 3.2 MB of features copied
    # in, the replay, the counts copied back
    engine.model.tuned_configs.clear()
    split_k2 = _replay_and_eager_split(engine, stream[0])
    cache = json.loads(Path(os.environ["REPRO_AUTOTUNE_CACHE"]).read_text())
    tuned = sorted(int(k.split(":")[1]) for k in cache["entries"]
                   if k.startswith(spec.fingerprint() + ":"))
    if tuned != sorted(auto.scheduler.buckets):
        raise SystemExit(f"mnist-lg was not tuned at its own keys: {tuned}")
    seconds["serve"] = time.perf_counter() - t0

    # 3. K1 and K2 at the mnist-lg shape, B = 4096, in CUDA graphs
    t0 = time.perf_counter()
    F, T, m, n, C = (MNIST_LG[k] for k in ("F", "T", "m", "n", "C"))
    x = torch.from_numpy(np.ascontiguousarray(data.x_test[:batch])).to(
        device)
    p = art.packed
    timing, max_err = {}, {}
    for variant, kern, plain in (
            ("packed", K.fused_dwn_packed, R.fused_dwn_packed_plain),
            ("batch-major", K.fused_dwn_batch_major,
             R.fused_dwn_batch_major_plain)):
        ops = prepare_operands(p.thresholds, p.mappings, p.tables, C,
                               variant)
        got, want = kern(x, *ops), plain(x, *ops)
        torch.cuda.synchronize()
        max_err[variant] = float((got[0] - want[0]).abs().max())
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1],
                                                             want[1])):
            raise SystemExit(f"{variant} differs from its plain version "
                             f"at mnist-lg")
        timing[variant] = {
            "ms": graph_ms(lambda: kern(x, *ops)),
            "plain_ms": time_ms(lambda: plain(x, *ops), iters=5, warmup=1),
            **_bound(variant, batch, F, T, (m,), n, C),
            "layout": K.last_launch(),
            "bucket_ms": {B: graph_ms(lambda B=B: kern(x[:B], *ops))
                          for B in SERVED_BUCKETS},
            "bucket_layout": {B: (kern(x[:B], *ops), K.last_launch())[1]
                              for B in SERVED_BUCKETS},
            "bucket_bound_ms": {B: _bound(variant, B, F, T, (m,), n, C)[
                "bound_ms"] for B in SERVED_BUCKETS}}
    tier_layouts = _mnist_kernel_checks(device)
    seconds["kernels"] = time.perf_counter() - t0

    # 4. cost reports: TEN, and PEN at 9 bits on the same params
    t0 = time.perf_counter()
    pen = DWNArtifact(dataclasses.replace(
        spec, variant="PEN", input_bits=9)).adopt(
            art.params, art.buffers, note="hw phase").freeze()
    hw = {"TEN": _hw_dict(art.hw_report()), "PEN-9": _hw_dict(
        pen.hw_report())}
    seconds["hw_report"] = time.perf_counter() - t0

    # 5. the RTL against the oracle and against K2's served counts
    t0 = time.perf_counter()
    rtl = _rtl_against_k2(art, engine, data.x_test[:RTL_ROWS])
    seconds["rtl"] = time.perf_counter() - t0

    # 6. checkpoint, reload, re-serve bit-exact
    t0 = time.perf_counter()
    ckpt = ROOT / "build" / "chip_smoke_hw_artifact"
    shutil.rmtree(ckpt, ignore_errors=True)
    art.save(ckpt)
    loaded = DWNArtifact.load(ckpt, device=device)
    again = ServingEngine(loaded, device=device, max_bucket=batch,
                          n_train=n_train, seed=0)
    done_l, _, pl = _serve_pass(again, stream[:4] + ragged[:4],
                                ["fused_dwn_packed"])
    _same_results(done["K2", "4096"][:4] + done["K2", "ragged"][:4], done_l,
                  "the reloaded mnist-lg artifact and the served one")
    if loaded.verilog() != art.verilog():
        raise SystemExit("the reloaded artifact emits other RTL")
    shutil.rmtree(ckpt, ignore_errors=True)
    seconds["checkpoint"] = time.perf_counter() - t0
    emit({"phase": "hw", "arch": "dwn-mnist-lg", "shape": MNIST_LG,
          "n_train": n_train, "calibration": art.calibration,
          "bit_exact_vs_oracle": engine.bit_exact,
          "passes": passes, "step_split_k2": split_k2,
          "auto_choice": auto.report()["auto"]["choice"],
          "auto_compiles": compiles, "tuned_buckets": tuned,
          "kernels": timing, "max_abs_err": max_err,
          "tier_layouts": tier_layouts, "hw": hw, "rtl": rtl,
          "reloaded": {"stage": loaded.stage, "pass": pl},
          "seconds": seconds})

    # 7. the paper's model: dwn-jsc-lg, PEN at 9 bits, warm start
    t0 = time.perf_counter()
    jdata = load_jsc(n_train, n_test, seed=0)
    jspec = dataclasses.replace(get_spec("dwn-jsc-lg"), variant="PEN",
                                input_bits=9)
    params, buffers = warmstart_dwn(torch.Generator().manual_seed(0),
                                    jspec.dwn_config(), jdata.x_train,
                                    jdata.y_train, device=device)
    jart = DWNArtifact(jspec).adopt(params, buffers, note="warm start")
    jart.freeze().pack(device)
    jten = DWNArtifact(get_spec("dwn-jsc-lg")).adopt(
        params, buffers, note="warm start").freeze()
    jeng = ServingEngine(jart, device=device, max_bucket=RTL_ROWS,
                         n_train=n_train, seed=0)
    if jeng.bit_exact != {"fused-packed": True, "packed-eager": True}:
        raise SystemExit(f"jsc-lg PEN-9 fails the startup oracle check: "
                         f"{jeng.bit_exact}")
    jrtl = _rtl_against_k2(jart, jeng, jdata.x_test[:RTL_ROWS])
    emit({"phase": "hw", "arch": "dwn-jsc-lg", "spec": jspec.label,
          "hw": {"TEN": _hw_dict(jten.hw_report()),
                 "PEN-9": _hw_dict(jart.hw_report())},
          "rtl": jrtl, "seconds": time.perf_counter() - t0})
    zeroed = sum(n["fused_dwn_zero"] for n in launches.values())
    if not zeroed:
        raise SystemExit("fused_dwn_zero was not launched on the hw passes")
    return {name: sum(n[name] for n in launches.values())
            for name in ("fused_dwn_packed", "fused_dwn_batch_major",
                         "fused_dwn_zero")}, timing


SWEEP_RTL_ROWS = 256


def _sweep_rows_equal(got, want, what):
    """Raise unless two lists of sweep rows hold the same points with
    equal hardware fields and accuracies."""
    from repro_torch.sweep.results import EXACT_FIELDS
    if [r.point for r in got] != [r.point for r in want]:
        raise SystemExit(f"{what}: the grids differ")
    for a, b in zip(got, want):
        diff = {f: (getattr(a, f), getattr(b, f)) for f in EXACT_FIELDS
                if getattr(a, f) != getattr(b, f)}
        if diff or a.failed or b.failed:
            raise SystemExit(f"{what}: {a.point.label} differs: {diff} "
                             f"(failed: {a.error} / {b.error})")


@contextlib.contextmanager
def _recording_drains():
    """Record every ``ServingEngine.drain`` in the block: each kernel's
    launches during it, and each step it served as (backend, bucket,
    step) through ``BoundBackend.step_for``.  Yields the list of
    records, one per drain."""
    from repro_torch.serving import backends, engine
    drain, step_for = engine.ServingEngine.drain, \
        backends.BoundBackend.step_for
    drains: list = []
    open_steps: list = []

    def rec_step_for(self, bucket):
        step = step_for(self, bucket)
        if open_steps:
            open_steps[-1].append((self.name, bucket, step))
        return step

    def rec_drain(self):
        before = _all_launch_counts()
        open_steps.append([])
        try:
            out = drain(self)
        finally:
            steps = open_steps.pop()
        after = _all_launch_counts()
        drains.append({"launched": {k: after[k] - before[k] for k in after
                                    if after[k] != before[k]},
                       "steps": steps})
        return out

    engine.ServingEngine.drain = rec_drain
    backends.BoundBackend.step_for = rec_step_for
    try:
        yield drains
    finally:
        engine.ServingEngine.drain = drain
        backends.BoundBackend.step_for = step_for


def _all_launch_counts() -> dict:
    return {name: n for K in _kernel_modules()
            for name, n in K.launch_counts().items()}


def _served_on_fused(what, drain, kernels):
    """Raise unless every step of one recorded drain ran on
    ``fused-packed`` and replayed a captured graph of exactly one of
    ``kernels`` (and the zero kernel where the launch split), and the
    launches during the drain are exactly those replays.  Returns
    {kernel: steps} and {bucket: kernel}."""
    per_kernel: dict = {}
    by_bucket: dict = {}
    want: dict = {}
    for backend, bucket, step in drain["steps"]:
        launches = getattr(step, "launches", {})
        main = set(launches) - {"fused_dwn_zero"}
        if backend != "fused-packed" or len(main) != 1 or \
                not main <= set(kernels) or launches[next(iter(main))] != 1:
            raise SystemExit(f"{what}: a served step at bucket {bucket} ran "
                             f"on {backend} launching {launches}, not one "
                             f"of {kernels} replayed")
        kernel = next(iter(main))
        per_kernel[kernel] = per_kernel.get(kernel, 0) + 1
        by_bucket[bucket] = kernel
        for name, n in launches.items():
            want[name] = want.get(name, 0) + n
    if not drain["steps"] or drain["launched"] != want:
        raise SystemExit(f"{what}: the drain launched {drain['launched']}, "
                         f"not its steps' replays {want}")
    return per_kernel, by_bucket


def phase_sweep(device):
    """The encoding design-space sweep on the card: ``run_grid("paper")``
    at the reference's defaults (n_train 4000, n_test 2000, 256-row K2
    calls, 2 served requests of 64 rows) into a fresh cache, every point's
    timed calls and served steps counted per point (each timed call one K2
    launch, plus the zero kernel where the launch split; the launches
    during each drain exactly the served steps' replays of K2, never K1);
    the Table I check; the same grid on the CPU equal point for point;
    lg-2400's points served under ``backend="auto"`` (the launches during
    each drain exactly the served steps' replays, each of the kernel the
    tuner chose for its bucket, K1 or K2); the rerun all cache hits; the
    ``tiny`` grid through two worker processes equal to the serial run;
    autodesign's RTL verified on the card.  Returns the K1, K2 and
    zero-kernel launches of the paper grid and of the auto serve axis."""
    import io
    from repro_torch.kernels.fused import kernel as K
    from repro_torch.launch.sweep import check_paper_points
    from repro_torch.sweep import (ExecutorSettings, SweepSettings,
                                   choose_design, emit_verified, pipeline,
                                   run_grid, run_grid_parallel)
    seconds = {}
    build = ROOT / "build"
    cache = build / "chip_smoke_sweep_cache"
    shutil.rmtree(cache, ignore_errors=True)
    card = SweepSettings(device=device, kernel=True, serve=True)

    # 1. the paper grid on the card, each point's launches counted
    per_point: dict = {}
    runner_cls = pipeline.SweepRunner
    time_kernel, serve_point = runner_cls._time_kernel, \
        runner_cls._serve_point

    def counted(axis, fn, label_of):
        def wrapped(self, arg):
            before = K.launch_counts()
            out = fn(self, arg)
            after = K.launch_counts()
            per_point.setdefault(label_of(arg), {})[axis] = {
                k: after[k] - before[k] for k in after}
            if axis == "kernel":
                per_point[label_of(arg)]["zeroed"] = \
                    bool(K.last_launch()["zeroed"])
            return out
        return wrapped

    runner_cls._time_kernel = counted("kernel", time_kernel,
                                      lambda art: art.spec.label)
    runner_cls._serve_point = counted("serve", serve_point,
                                      lambda pt: pt.label)
    t0 = time.perf_counter()
    try:
        _reset_counts()
        with _recording_drains() as drains:
            res = run_grid("paper", card, cache_dir=str(cache))
        launched = {name: n for name, n in _all_launch_counts().items()
                    if n}
    finally:
        runner_cls._time_kernel, runner_cls._serve_point = \
            time_kernel, serve_point
    seconds["card"] = time.perf_counter() - t0
    table1 = io.StringIO()
    with contextlib.redirect_stdout(table1):
        failures = check_paper_points(res)
    if failures:
        raise SystemExit(f"Table I TEN outside tolerance: {failures}")
    calls = 1 + card.kernel_iters                # the untimed first call
    for r in res.points:
        got = per_point.get(r.point.label, {})
        k, s = got.get("kernel", {}), got.get("serve", {})
        want_k = {"fused_dwn_packed": calls,
                  "fused_dwn_zero": calls if got.get("zeroed") else 0}
        if {n: k.get(n, 0) for n in want_k} != want_k or \
                sum(k.values()) != calls + want_k["fused_dwn_zero"]:
            raise SystemExit(f"{r.point.label}: the timed calls launched "
                             f"{k}, not {want_k}")
        if s.get("fused_dwn_batch_major", 0):
            raise SystemExit(f"{r.point.label}: the serve axis launched "
                             f"{s}, not K2 alone")
        if not (r.kernel_us > 0 and r.serve_throughput > 0):
            raise SystemExit(f"{r.point.label}: an axis was not measured")
    if len(drains) != len(res.points):
        raise SystemExit(f"{len(drains)} drains served the "
                         f"{len(res.points)} points")
    for r, drain in zip(res.points, drains):
        served, _ = _served_on_fused(f"{r.point.label} served", drain,
                                     ("fused_dwn_packed",))
        if served != {"fused_dwn_packed": card.serve_requests}:
            raise SystemExit(f"{r.point.label}: served {served}, not "
                             f"{card.serve_requests} steps of K2")
        per_point[r.point.label]["served"] = drain["launched"]

    # 2. the same grid on the CPU: equal point for point
    t0 = time.perf_counter()
    cpu = run_grid("paper", SweepSettings(device="cpu", kernel=False,
                                          serve=False), cache_dir=None)
    _sweep_rows_equal(res.points, cpu.points, "paper grid, card against CPU")
    seconds["cpu"] = time.perf_counter() - t0

    # 2b. lg-2400's points served under backend="auto": the tuner races K1
    # against K2 per bucket and each served step replays the choice
    t0 = time.perf_counter()
    lg = [r for r in res.points if r.point.preset == "lg-2400"]
    _reset_counts()
    with _recording_drains() as auto_drains:
        auto = run_grid([r.point for r in lg],
                        dataclasses.replace(card, kernel=False,
                                            serve_backend="auto"),
                        cache_dir=None)
    auto_launched = {name: n for name, n in _all_launch_counts().items()
                     if n}
    _sweep_rows_equal(auto.points, lg, "lg-2400 served under auto")
    if set(auto_launched) - {"fused_dwn_packed", "fused_dwn_batch_major",
                             "fused_dwn_zero"} or \
            len(auto_drains) != len(lg):
        raise SystemExit(f"the auto serve axis launched {auto_launched} "
                         f"in {len(auto_drains)} drains")
    auto_served = []
    for r, drain in zip(auto.points, auto_drains):
        served, chose = _served_on_fused(
            f"{r.point.label} served under auto", drain,
            ("fused_dwn_packed", "fused_dwn_batch_major"))
        if sum(served.values()) != card.serve_requests:
            raise SystemExit(f"{r.point.label}: served {served} under "
                             f"auto, not {card.serve_requests} steps")
        auto_served.append({"steps": served, "kernel_by_bucket": chose,
                            "launched": drain["launched"]})
    seconds["auto"] = time.perf_counter() - t0

    # 3. the rerun: every point from the cache
    t0 = time.perf_counter()
    again = run_grid("paper", card, cache_dir=str(cache))
    ex = again.executor
    if (ex["computed"], ex["cache_hits"]) != (0, len(res.points)):
        raise SystemExit(f"the rerun computed points: {ex}")
    seconds["rerun"] = time.perf_counter() - t0

    # 4. the tiny grid through two worker processes sharing the card
    t0 = time.perf_counter()
    light = SweepSettings(device=device, kernel=False, serve=False)
    wcache = build / "chip_smoke_sweep_workers"
    shutil.rmtree(wcache, ignore_errors=True)
    par = run_grid_parallel("tiny", light, cache_dir=str(wcache),
                            executor=ExecutorSettings(workers=2))
    serial = run_grid("tiny", light, cache_dir=None)
    _sweep_rows_equal(par.points, serial.points,
                      "tiny grid, two workers against serial")
    if par.executor["computed"] != len(serial.points) or \
            par.executor["failed"]:
        raise SystemExit(f"the executor did not compute every point: "
                         f"{par.executor}")
    shutil.rmtree(wcache, ignore_errors=True)
    seconds["executor"] = time.perf_counter() - t0

    # 5. autodesign: a floor between the grid's accuracies, RTL verified
    t0 = time.perf_counter()
    accs = sorted(r.accuracy for r in res.points)
    floor = (accs[0] + accs[-1]) / 2
    choice = choose_design(res, acc_floor=floor)
    out_dir = build / "chip_smoke_autodesign"
    shutil.rmtree(out_dir, ignore_errors=True)
    summary = emit_verified(choice, card, out_dir=out_dir,
                            n_vectors=SWEEP_RTL_ROWS, log=None)
    ver = summary["verification"]
    if ver["n_vectors"] != SWEEP_RTL_ROWS or not ver["counts_checked"] \
            or not (out_dir / "dwn_autodesign.v").exists():
        raise SystemExit(f"autodesign's RTL was not verified: {ver}")
    shutil.rmtree(out_dir, ignore_errors=True)
    seconds["autodesign"] = time.perf_counter() - t0
    shutil.rmtree(cache, ignore_errors=True)

    emit({"phase": "sweep", "grid": "paper", "settings": res.settings,
          "points": [{
              "label": r.point.label, "total_luts": r.total_luts,
              "luts": r.luts, "paper_luts": r.paper_luts,
              "lut_error_pct": r.lut_error_pct,
              "encoder_share": r.encoder_share, "accuracy": r.accuracy,
              "kernel_us": r.kernel_us, "kernel_batch": r.kernel_batch,
              "serve_samples_per_s": r.serve_throughput,
              "serve_p50_ms": r.serve_p50_ms,
              "launches": per_point[r.point.label]} for r in res.points],
          "table1": table1.getvalue().strip().splitlines(),
          "cpu_equal": True,
          "auto": [{"label": r.point.label,
                    "serve_samples_per_s": r.serve_throughput,
                    "serve_p50_ms": r.serve_p50_ms, "served": served}
                   for r, served in zip(auto.points, auto_served)],
          "auto_launches": auto_launched,
          "rerun": {k: ex[k] for k in (
              "computed", "cache_hits", "wall_s")},
          "executor": par.executor, "executor_serial_equal": True,
          "autodesign": {"objective": choice.objective,
                         "chosen": choice.point.label,
                         "total_luts": choice.result.total_luts,
                         "accuracy": choice.result.accuracy,
                         "verification": {k: ver[k] for k in (
                             "n_vectors", "backends", "counts_checked")}},
          "launches": launched, "seconds": seconds})
    names = ("fused_dwn_packed", "fused_dwn_batch_major", "fused_dwn_zero")
    return {"sweep paper": {n: launched.get(n, 0) for n in names},
            "sweep auto lg-2400": {n: auto_launched.get(n, 0)
                                   for n in names}}


def _cli_sweeps(seconds):
    """``python -m repro_torch.launch.sweep --grid paper --fresh`` on the
    card (K2 timed and served; exit 0 means Table I within tolerance),
    then the same grid through two worker processes sharing the card
    without the kernel and serve axes; the two equal on every hardware
    field and accuracy.  Returns both results."""
    from repro_torch.sweep import SweepResult
    sweep_cache = ROOT / "build" / "sweep_cache_smoke"
    sweeps = {}
    for name, extra in (("serial", []),
                        ("workers", ["--workers", "2", "--no-kernel",
                                     "--no-serve"])):
        out_json = ROOT / "build" / f"sweep_paper_{name}.json"
        argv = ["-m", "repro_torch.launch.sweep", "--grid", "paper",
                "--fresh", "--cache-dir", str(sweep_cache), "--out",
                str(out_json), *extra]
        t0 = time.perf_counter()
        out = subprocess.run([sys.executable, *argv], cwd=ROOT,
                             env=dict(os.environ, PYTHONPATH=str(SRC)),
                             capture_output=True, text=True, timeout=600)
        seconds[f"sweep {name}"] = time.perf_counter() - t0
        if out.returncode != 0:
            raise SystemExit(f"python {' '.join(argv)} exited "
                             f"{out.returncode}:\n{out.stdout[-3000:]}\n"
                             f"{out.stderr[-4000:]}")
        sweeps[name] = SweepResult.load(out_json)
        out_json.unlink()
    shutil.rmtree(sweep_cache, ignore_errors=True)
    _sweep_rows_equal(sweeps["workers"].points, sweeps["serial"].points,
                      "sweep --workers 2 against the serial CLI run")
    return sweeps


def phase_cli(device):
    import gc

    import torch
    from repro_torch.launch import serve, train
    seconds = {}
    records = {}
    # every LM family through the serve CLI at full width (the arch's own
    # attn_impl; llava's 2 x (2880 patches + 32 tokens) masked), each
    # model freed before the next
    lm = [(serve.main, ["--arch", arch, "--batch", "2", "--prompt-len",
                        "32", "--gen", "4"])
          for arch in ("qwen3-8b", "llava-next-34b", "mamba2-1.3b",
                       "recurrentgemma-2b", "whisper-large-v3")]
    for main, argv in (
            (serve.main, ["--arch", "dwn-jsc-lg", "--requests", "4"]),
            (serve.main, ["--arch", "dwn-jsc-lg", "--requests", "4",
                          "--backend", "auto"]),
            *lm,
            (train.main, ["--arch", "dwn-jsc-lg", "--workload", "jsc",
                          "--epochs", "1"])):
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        main(argv + ["--device", device])
        seconds[" ".join(argv)] = time.perf_counter() - t0
    # the lifecycle smoke and the co-simulation gate, as a user runs them
    # (each on the card by default); both must exit 0
    ckpt = ROOT / "build" / "chip_smoke_lifecycle"
    shutil.rmtree(ckpt, ignore_errors=True)
    for argv in (["-m", "repro_torch.dwn.smoke", "--workload", "mnist",
                  "--preset", "mnist-lg", "--variant", "TEN", "--bits",
                  "16", "--epochs", "1", "--ckpt-dir", str(ckpt)],
                 ["-m", "repro_torch.hw.cosim", "--presets",
                  "dwn-jsc-lg,dwn-mnist-lg", "--n", "256"],
                 ["-m", "repro_torch.launch.serve", "--arch", "dwn-jsc-lg",
                  "--continuous", "--deadline-ms", "50"],
                 ["-m", "repro_torch.launch.loadgen", "--preset",
                  "dwn-jsc-lg", "--max-bucket", "4096", "--levels", "0.5",
                  "--duration", "1", "--mode", "both"]):
        t0 = time.perf_counter()
        out = subprocess.run([sys.executable, *argv], cwd=ROOT,
                             env=dict(os.environ, PYTHONPATH=str(SRC)),
                             capture_output=True, text=True, timeout=600)
        seconds[argv[1]] = time.perf_counter() - t0
        if out.returncode != 0:
            raise SystemExit(f"python {' '.join(argv)} exited "
                             f"{out.returncode}:\n{out.stdout[-2000:]}\n"
                             f"{out.stderr[-4000:]}")
        records[argv[1]] = out.stdout.strip().splitlines()[-4:]
    shutil.rmtree(ckpt, ignore_errors=True)
    sweeps = _cli_sweeps(seconds)
    smoke = json.loads(records["repro_torch.dwn.smoke"][-1])
    if not smoke["roundtrip_bit_exact"]:
        raise SystemExit(f"the lifecycle smoke is not bit-exact: {smoke}")
    cont = json.loads(records["repro_torch.launch.serve"][-1])
    if not (cont["continuous"] and cont["device"] == "cuda" and
            cont["requests"] + cont["shed"]["requests"] == 64):
        raise SystemExit(f"serve --continuous: requests unaccounted for: "
                         f"{cont}")
    level = json.loads(records["repro_torch.launch.loadgen"][-1])
    for mode in ("continuous", "sync"):
        m = level[mode]
        if m["served_requests"] + m["shed_requests"] != level["arrivals"]:
            raise SystemExit(f"loadgen {mode}: arrivals unaccounted for: "
                             f"{level}")
    emit({"phase": "cli", "seconds": seconds,
          "lifecycle": {k: smoke[k] for k in ("device", "hw", "serve",
                                              "roundtrip_bit_exact")},
          "cosim": records["repro_torch.hw.cosim"],
          "serve_continuous": {k: cont[k] for k in (
              "requests", "served", "shed", "throughput_samples_per_s",
              "latency_ms_p50", "latency_ms_p99", "async")},
          "loadgen": level,
          "sweep": {name: {"executor": r.executor, "points": [
              {"point": p.point.to_dict(), "total_luts": p.total_luts,
               "accuracy": p.accuracy, "kernel_us": p.kernel_us,
               "serve_samples_per_s": p.serve_throughput}
              for p in r.points]} for name, r in sweeps.items()}})


#: the registered DWN archs whose prefill datapaths ``dwn_arch`` runs
#: (corner/contig, gather, strided, fused, pruned encoders), each at 4096
#: samples: one card's share of dwn_serve_1m on the 256-card mesh
DWN_ARCH_NAMES = ("dwn-jsc-lg2400", "dwn-jsc-lg2400-opt1",
                  "dwn-jsc-lg2400-opt2", "dwn-jsc-lg2400-opt3",
                  "dwn-jsc-lg2400-opt4", "dwn-jsc-md360-pruned",
                  "dwn-jsc-sm50-pruned")
DWN_ARCH_ROWS = 4096
#: the arch run at the whole dwn_serve_1m shape: 4096 x 256 samples in the
#: fused variant's 16 blocks
DWN_ARCH_FULL = "dwn-jsc-lg2400-opt3"
#: (microbatches, samples a microbatch) of the train steps: one card's
#: share of dwn_train_1m, held to the CPU, then 16 times that, timed
DWN_TRAIN_CHECKED = (4, 1024)
DWN_TRAIN_TIMED = (4, 16384)
DWN_TRAIN_STEPS = 3
DWN_TRAIN_TOL = 1e-5


def dwn_prefill_bound(cfg, B):
    """Least time of ``dwn_arch.prefill`` on B samples, counting what these
    inputs need: the features, thresholds, scores and tables read once and
    the counts written once; the wiring's first argmax over the scores
    (m n F T compares), and per sample the F T threshold compares, m n bit
    selects and m table reads (``int``) and m class adds (``fp32``), as
    :func:`model_bytes_and_ops` counts K2's.  ``dense_product_bound_ms``
    is the least time of the reference's algorithm alone, its dense
    one-hot selection product (2 B (m n) (F T) bf16 tensor-core
    operations); it is not the function's bound."""
    F, T, m, C = cfg.d_model, cfg.dwn_bits, cfg.dwn_luts, cfg.vocab_size
    n = 6                                   # dwn_arch's LUT fan-in
    nbytes = 4 * (B * F + F * T + m * n * F * T + m * 2 ** n + B * C)
    ops = {"int": m * n * F * T + B * (F * T + m * n + m), "fp32": B * m}
    by_bytes, by_ops = nbytes / PEAK_BYTES_PER_S, ops_seconds(ops)
    return {"bound_ms": max(by_bytes, by_ops) * 1e3,
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "bytes": nbytes, "operations": sum(ops.values()),
            "dense_product_bound_ms":
                2 * B * m * n * F * T / PEAK_BF16_OPS_PER_S * 1e3}


def _dwn_features(rng, B, device):
    import torch
    x = rng.standard_normal((B, 16), dtype=np.float32) * 0.7
    return torch.from_numpy(x).to(device)


def _k2_counts(params, cfg, x):
    """``dwn_arch``'s params frozen (``dwn_arch.artifact``) and served at
    x's rows through the spec's fused-packed backend: one CUDA graph of
    K2, captured by a first call, then replayed with the counts set to 0
    just before and read just after.  Returns the counts and the
    replay's launches."""
    from repro_torch.kernels.fused.kernel import (launch_counts,
                                                  reset_launch_counts)
    from repro_torch.models import dwn_arch
    from repro_torch.serving.backends import BoundBackend, get_backend
    art = dwn_arch.artifact(params, cfg).pack(x.device)
    bound = BoundBackend(get_backend("fused-packed"), art.serving_model())
    if not bound.graphed:
        raise SystemExit("the fused-packed backend does not replay a graph")
    bound(x)
    reset_launch_counts()
    counts, _ = bound(x)
    counts = counts.clone()
    launches = launch_counts()
    if launches["fused_dwn_packed"] != 1 or launches["fused_dwn_batch_major"]:
        raise SystemExit(f"{cfg.name}: K2 did not carry the check: "
                         f"{launches}")
    return counts, launches


def _dwn_train_steps(cfg, params, batches, device):
    """``api.make_train_step(num_micro)`` steps from a copy of ``params``
    on ``device``: the losses, each step's ms by CUDA events on the card,
    and the last params."""
    import torch
    from repro_torch.models import api
    p = {k: v.to(device).clone() for k, v in params.items()}
    step, opt = api.make_train_step(cfg, num_micro=batches[0][0].shape[0])
    state = opt.init(p)
    losses, ms = [], []
    for x, y in batches:
        b = {"features": x.to(device), "labels": y.to(device)}
        if device.type == "cuda":
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        p, state, m = step(p, state, b)
        losses.append(float(m["loss"]))
        if device.type == "cuda":
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
    return losses, ms, p


def _dwn_batches(rng, cfg, micro, rows, steps):
    import torch
    out = []
    for _ in range(steps):
        x = rng.standard_normal((micro, rows, cfg.d_model),
                                dtype=np.float32) * 0.7
        y = rng.integers(0, cfg.vocab_size, (micro, rows)).astype(np.int32)
        out.append((torch.from_numpy(x), torch.from_numpy(y)))
    return out


def _dp_world_one(device, rng):
    """``ServingEngine(dwn-jsc-lg)`` under a one-rank NCCL process group:
    the reference's rule leaves it alone (``devices`` 1, not data
    parallel); 4 requests of 4096 rows served through K2, each equal to
    ``apply_hard``."""
    import socket

    import torch
    import torch.distributed as dist
    from repro_torch.core.model import apply_hard
    from repro_torch.serving import ServingEngine
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    try:
        engine = ServingEngine("dwn-jsc-lg", device=device, max_bucket=4096,
                               n_train=2000, seed=0)
        rep = engine.report()
        if (rep["devices"], rep["data_parallel"]) != (1, False):
            raise SystemExit(f"one rank: devices {rep['devices']}, data "
                             f"parallel {rep['data_parallel']}")
        stream = [engine.make_request(4096, seed=int(rng.integers(1 << 30)))
                  for _ in range(4)]
        engine.warmup(4096)
        done, launches, stats = _serve_pass(engine, stream,
                                            ["fused_dwn_packed"])
        for r in done:
            want = apply_hard(engine.artifact.frozen, torch.from_numpy(
                np.ascontiguousarray(r.payload)).to(device))
            if not np.array_equal(want.cpu().numpy(), r.result[0]):
                raise SystemExit(f"request {r.rid}: counts differ from "
                                 f"apply_hard")
        return {"world": dist.get_world_size(), "backend":
                dist.get_backend(), "devices": rep["devices"],
                "data_parallel": rep["data_parallel"],
                "served": stats["served"]}, launches
    finally:
        dist.destroy_process_group()


def phase_dwn_arch(device):
    """The DWN behind the model zoo's interface (``models.dwn_arch`` via
    ``models.api``) on the card: every variant's prefill of 4096 samples
    against K2 serving the same params, corner against gather, the whole
    dwn_serve_1m shape, train steps against the CPU, and data-parallel
    serving under a one-rank process group."""
    import dataclasses as dc

    import torch
    from repro_torch.configs import DWN_SHAPES, get_arch
    from repro_torch.models import api, dwn_arch
    dev = torch.device(device)
    rng = np.random.default_rng(29)
    x = _dwn_features(rng, DWN_ARCH_ROWS, dev)
    k2 = {"fused_dwn_packed": 0, "fused_dwn_zero": 0}
    variants = []
    for i, name in enumerate(DWN_ARCH_NAMES):
        cfg = get_arch(name)
        params = dwn_arch.init_params(torch.Generator().manual_seed(i), cfg,
                                      device=dev)
        prefill = api.make_prefill(cfg)
        counts, _ = prefill(params, {"features": x})
        other = dc.replace(cfg, dwn_datapath="gather"
                           if cfg.dwn_datapath == "corner" else "corner")
        counts_other, _ = api.make_prefill(other)(params, {"features": x})
        want, launches = _k2_counts(params, cfg, x)
        if not torch.equal(counts, want):
            raise SystemExit(f"{name}: prefill counts differ from K2's in "
                             f"{int((counts != want).any(1).sum())} rows")
        if not torch.equal(counts, counts_other):
            raise SystemExit(f"{name}: corner and gather disagree")
        for k in k2:
            k2[k] += launches[k]
        ms = time_ms(lambda: prefill(params, {"features": x}), 3, 1)
        variants.append({"arch": name, "datapath": cfg.dwn_datapath,
                         "grouping": cfg.dwn_grouping,
                         "fused": cfg.dwn_fused, "bits": cfg.dwn_bits,
                         "luts": cfg.dwn_luts, "ms": ms,
                         **dwn_prefill_bound(cfg, DWN_ARCH_ROWS),
                         "k2_launches": launches["fused_dwn_packed"]})
        emit({"phase": "dwn_arch", "variant": variants[-1]})
        del params
    # the whole dwn_serve_1m shape, features made on the card
    shape = DWN_SHAPES["dwn_serve_1m"]
    cfg = get_arch(DWN_ARCH_FULL)
    B = shape.global_batch * shape.seq_len
    params = dwn_arch.init_params(torch.Generator().manual_seed(99), cfg,
                                  device=dev)
    gen = torch.Generator(device=dev).manual_seed(99)
    xf = torch.randn((B, cfg.d_model), generator=gen, device=dev) * 0.7
    prefill = api.make_prefill(cfg)
    prefill(params, {"features": xf[:DWN_ARCH_ROWS * 16]})
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    full_ms = time_ms(lambda: prefill(params, {"features": xf}), 2, 0)
    peak_total = torch.cuda.max_memory_allocated()
    peak = peak_total - base
    counts, _ = prefill(params, {"features": xf})
    want, launches = _k2_counts(params, cfg, xf)
    if counts.shape != (B, cfg.vocab_size) or not torch.equal(counts, want):
        raise SystemExit(f"{cfg.name} at {B} samples: prefill differs "
                         f"from K2")
    for k in k2:
        k2[k] += launches[k]
    full = {"arch": cfg.name, "shape": shape.name, "samples": B,
            "blocks": dwn_arch.FUSED_BLOCKS, "ms": full_ms,
            "samples_per_s": B / full_ms * 1e3,
            "peak_bytes_above_inputs": peak,
            **dwn_prefill_bound(cfg, B)}
    emit({"phase": "dwn_arch", "full_shape": full})
    priced_step = {"cfg": cfg, "shape": shape, "ms": full_ms,
                   "bound_ms": full["bound_ms"],
                   "max_memory_allocated": peak_total}
    del params, xf, counts, want
    # training: the card's steps against the CPU's, then 16 times the rows
    cfg = get_arch("dwn-jsc-lg2400")
    params = dwn_arch.init_params(torch.Generator().manual_seed(7), cfg)
    batches = _dwn_batches(rng, cfg, *DWN_TRAIN_CHECKED, DWN_TRAIN_STEPS)
    cpu_losses, _, _ = _dwn_train_steps(cfg, params, batches,
                                        torch.device("cpu"))
    card_losses, card_ms, _ = _dwn_train_steps(cfg, params, batches, dev)
    diff = max(abs(a - b) for a, b in zip(card_losses, cpu_losses))
    if not diff < DWN_TRAIN_TOL:
        raise SystemExit(f"train steps: card {card_losses} against CPU "
                         f"{cpu_losses}")
    batches = _dwn_batches(rng, cfg, *DWN_TRAIN_TIMED, DWN_TRAIN_STEPS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    big_losses, big_ms, _ = _dwn_train_steps(cfg, params, batches, dev)
    peak = torch.cuda.max_memory_allocated() - base
    if not all(np.isfinite(big_losses)):
        raise SystemExit(f"train steps: {big_losses}")
    train = {"arch": cfg.name, "checked": {
                 "micro": DWN_TRAIN_CHECKED, "losses_card": card_losses,
                 "losses_cpu": cpu_losses, "max_abs_diff": diff,
                 "tolerance": DWN_TRAIN_TOL, "step_ms": card_ms},
             "timed": {"micro": DWN_TRAIN_TIMED, "losses": big_losses,
                       "step_ms": big_ms, "peak_bytes": peak}}
    emit({"phase": "dwn_arch", "train": train})
    dp, launches = _dp_world_one(dev, rng)
    emit({"phase": "dwn_arch", "data_parallel": dp,
          "launches": {k: launches[k] for k in k2}})
    # K2's replays above only cross-check dwn_arch's counts; the engine's
    # launches are a serving path's
    return {"variants": variants, "full_shape": full, "train": train,
            "data_parallel": dp, "priced_step": priced_step,
            "check_launches": k2,
            "dp_launches": {k: launches[k] for k in k2}}


#: the dry-run cells the dryrun phase writes: (arch, shapes, meshes)
DRYRUN_CELLS = (("qwen3-8b", ("train_4k", "prefill_32k", "decode_32k",
                              "long_500k"), (False, True)),
                ("dwn-jsc-lg2400", ("dwn_serve_1m",), (False,)))


def _terms(rec):
    r = rec["roofline"]
    return {k: r[k] for k in ("compute_s", "memory_s", "collective_s",
                              "bound", "step_s_lower_bound")}


def phase_dryrun(device, lm, dwn):
    """The dry-run (``launch.dryrun``, on the meta device) of qwen3-8b's
    four shapes at pod1 and pod2 and of dwn-jsc-lg2400 at dwn_serve_1m,
    each record's terms, bound and seconds printed (a record holding an
    error fails the phase); then, on a (1, 1) mesh, the steps the lm and
    dwn_arch phases timed on the card (``lm``, ``dwn``: what
    :func:`phase_lm` and :func:`phase_dwn_arch` return of them):
    qwen3-8b's prefill of their batch of prompts (bf16 weights, K10's
    attention counted at its plain version) and its decode step at the
    cache's length, and dwn-jsc-lg2400-opt3 at 1,048,576 samples.  Each priced step's measured
    ms beside its three terms, measured over the lower bound, the phase's
    own hand-counted bound and the peak device memory beside the
    argument bytes; the measured time must reach the compute term and
    the argument bytes over HBM's rate."""
    del device
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import HBM_BW
    from repro_torch.sharding import AbstractMesh
    records = []
    for arch, shapes, meshes in DRYRUN_CELLS:
        for multi_pod in meshes:
            for name in shapes:
                t0 = time.perf_counter()
                rec = dryrun.run_cell(arch, name, multi_pod=multi_pod,
                                      force=True)
                seconds = time.perf_counter() - t0
                if "error" in rec:
                    raise SystemExit(f"dry-run {rec['cell']}: "
                                     f"{rec['error']}")
                row = {"cell": rec["cell"], "seconds": seconds}
                if rec.get("skipped"):
                    row["skipped"] = rec["reason"]
                else:
                    row.update(_terms(rec), lower_s=rec["lower_s"],
                               meta_run_reused=rec["meta_run_reused"],
                               argument_bytes=rec["memory_analysis"][
                                   "argument_bytes"],
                               useful_flops_ratio=rec["useful_flops_ratio"])
                emit({"phase": "dryrun", "record": row})
                records.append(row)
    one = AbstractMesh(("data", "model"), (1, 1))
    steps = {
        "qwen3-8b prefill": (lm["cfg"], ShapeConfig(
            "lm_prefill", lm["prompt_len"], lm["batch"], "prefill"),
            {"serve_bf16"}, lm["prefill_ms"], lm["prefill_bound_ms"],
            lm["max_memory_allocated"]),
        "qwen3-8b decode step": (lm["cfg"], ShapeConfig(
            "lm_decode", lm["prompt_len"] + lm["gen"], lm["batch"],
            "decode"), {"serve_bf16"}, lm["decode_ms"],
            lm["decode_bound_ms"], lm["max_memory_allocated"]),
        "dwn-jsc-lg2400-opt3 at 1,048,576 samples": (
            dwn["cfg"], dwn["shape"], set(), dwn["ms"], dwn["bound_ms"],
            dwn["max_memory_allocated"])}
    priced = {}
    for what, (cfg, shape, variants, ms, hand_ms, peak) in steps.items():
        rec = dryrun.analyze_cell(cfg, shape, one, variants=variants)
        t = _terms(rec)
        arg = rec["memory_analysis"]["argument_bytes"]
        row = {"measured_ms": ms, **t,
               "measured_over_lower_bound": ms / 1e3
               / t["step_s_lower_bound"],
               "hand_bound_ms": hand_ms,
               "max_memory_allocated": peak, "argument_bytes": arg,
               "flops": rec["flops_per_chip"],
               "hbm_bytes": rec["hbm_bytes_per_chip"],
               "lower_s": rec["lower_s"]}
        if what == "qwen3-8b decode step":
            row["served_ms"] = lm["decode_served_ms"]
        emit({"phase": "dryrun", "priced": what, **row})
        if not ms / 1e3 >= t["compute_s"]:
            raise SystemExit(f"{what}: {ms} ms on the card is under the "
                             f"compute term {t['compute_s'] * 1e3} ms")
        if not ms / 1e3 >= arg / HBM_BW:
            raise SystemExit(f"{what}: {ms} ms on the card is under the "
                             f"argument bytes' {arg / HBM_BW * 1e3} ms")
        priced[what] = row
    return {"records": records, "priced": priced}



# ---------------------------------------------------------------------------
# the model over a DeviceMesh (tensor parallelism, FSDP, expert
# parallelism, sharded restore) at world size 1
# ---------------------------------------------------------------------------

#: the mesh phase's served shape: 2 requests of 4 x 2048 tokens, 16
#: generated (the lm phase's)
MESH_SERVED = dict(batch=4, requests=2, prompt_len=2048, gen=16)
#: its training steps: 3 of 8 x 128 TokenStream tokens, qwen3-8b at the
#: lm_train phase's depth
MESH_TRAIN_STEPS, MESH_TRAIN_SHAPE = 3, (8, 128)


@contextlib.contextmanager
def _nccl_world_one():
    """A one-rank NCCL process group on a free localhost port for the
    block, destroyed after it."""
    import socket

    import torch.distributed as dist
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _lm_served(engine, stream):
    """The stream through the LM engine: (its results in order, K10's
    launches over them)."""
    done, launches = _lm_pass(engine, stream)
    return done, launches.get("flash_attention", 0)


#: the SSM, hybrid and encoder-decoder archs served through the one-rank
#: mesh at full width, all layers, at the lm_zoo phase's shapes (ZOO)
MESH_FAMILY_ARCHS = ("mamba2-1.3b", "recurrentgemma-2b", "whisper-large-v3")
#: the data-parallel continuous session: the load phase's gate stream
#: (dwn-jsc-lg, 4096-row buckets) cut to its first 12 requests, one of
#: them oversize
MESH_DP_REQUESTS = 12


def _mesh_family(device, arch):
    """``arch`` (ZOO's shape) served by the meshless engine and, on the
    same params and prompts, through a one-rank NCCL mesh, in turns
    (meshless, mesh, mesh, meshless): tokens equal, the prefill's logits
    equal bit for bit (no collective runs at world 1); each path's
    prefill s and decode s a token, the peak memory of both engines."""
    import gc

    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import api
    from repro_torch.serving import ServingEngine
    from repro_torch.sharding.partition import is_device_mesh
    cell = ZOO[arch]
    B, S, gen = cell.batch, cell.prompt_len, cell.gen
    cfg = get_arch(arch)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    plain = ServingEngine(cfg, prompt_len=S, gen=gen, device=device, seed=0)
    plain.warmup(B)
    stream = [plain.make_request(B, seed=300 + i)
              for i in range(MESH_SERVED["requests"])]
    with _nccl_world_one():
        engine = ServingEngine(cfg, prompt_len=S, gen=gen, device=device,
                               seed=0, model_parallel=1)
        rep = engine.report()
        if not (is_device_mesh(engine.mesh) and rep["model_parallel"] == 1
                and rep["devices"] == 1):
            raise SystemExit(f"{arch}: the engine is not on a one-rank "
                             f"mesh: {engine.mesh}")
        engine.warmup(B)
        turns = {"meshless": [], "mesh": []}
        for name in ("meshless", "mesh", "mesh", "meshless"):
            done, _ = _lm_served(plain if name == "meshless" else engine,
                                 stream)
            turns[name].append(done)
        want = [r.result["tokens"] for r in turns["meshless"][0]]
        for done in turns["mesh"] + turns["meshless"][1:]:
            for r, w in zip(done, want):
                if not np.array_equal(r.result["tokens"], w):
                    raise SystemExit(f"{arch} request {r.rid}: the mesh "
                                     f"path's tokens differ from the "
                                     f"meshless engine's")
        plain_logits = api.make_prefill(cfg, cache_len=S + gen)(
            plain.params, stream[0])[0]
        logits = api.make_prefill(cfg, cache_len=S + gen, mesh=engine.mesh)(
            engine.params, stream[0])[0]
        torch.cuda.synchronize()
        if not torch.equal(logits, plain_logits):
            raise SystemExit(f"{arch}: the mesh prefill's logits differ "
                             f"from the meshless path's by "
                             f"{_rel(logits, plain_logits)}")
        peak = torch.cuda.max_memory_allocated()
        del engine, logits
    del plain, plain_logits

    def times(name, key):
        return [r.result[key] for done in turns[name] for r in done]
    return {"batch": B, "prompt_len": S, "gen": gen,
            "layers": cfg.num_layers, "d_model": cfg.d_model,
            "turns": ["meshless", "mesh", "mesh", "meshless"],
            "tokens_equal": True, "prefill_logits_bit_equal": True,
            "prefill_s": times("mesh", "prefill_s"),
            "prefill_s_meshless": times("meshless", "prefill_s"),
            "decode_s_per_tok": times("mesh", "decode_s_per_tok"),
            "decode_s_per_tok_meshless": times("meshless",
                                               "decode_s_per_tok"),
            "peak_memory_bytes_both_engines": peak}


def _mesh_dp_continuous(device):
    """One continuous session of dwn-jsc-lg on an engine made with
    ``data_parallel=True`` inside a one-rank NCCL world (the load phase's
    gate, ``_async_gate``, pinned to K2, on MESH_DP_REQUESTS of its
    requests): every result equal to the sync drain's and to
    ``apply_hard``; the loop that ran (at world 1 the engine serves
    alone, ``data_parallel`` False, so the one-device loop: the leader
    and follower loops run on gloo ranks in the CPU tests); the
    session's K1/K2 launches."""
    import torch
    from repro_torch.core.model import apply_hard
    from repro_torch.serving import ServingEngine
    with _nccl_world_one():
        engine = ServingEngine("dwn-jsc-lg", device=device,
                               backend="fused-packed",
                               max_bucket=LOAD_BUCKET, min_bucket=8,
                               n_train=20000, seed=0, data_parallel=True)
        stream = _gate_stream(engine)[:MESH_DP_REQUESTS]
        launches, gate = _async_gate(engine, stream, pinned=True)
        for p in stream:
            engine.submit(p)
        for r in engine.drain():
            x = torch.from_numpy(np.ascontiguousarray(r.payload, np.float32))
            want = apply_hard(engine.artifact.frozen, x.to(engine.device))
            if not np.array_equal(r.result[0], want.cpu().numpy()):
                raise SystemExit(f"data-parallel engine request {r.rid} "
                                 f"differs from apply_hard")
        rep = engine.report()
        loop = {"continuous_loop": rep["continuous_loop"],
                "data_parallel": rep["data_parallel"],
                "devices": rep["devices"]}
        del engine
    if loop["continuous_loop"] != "one-device":
        raise SystemExit(f"a one-rank world ran the {loop} loop")
    return {**gate, **loop, "equal_to_apply_hard": True,
            "why": "at world 1 the engine sets data_parallel False "
                   "(serving/engine.py, _init_dwn), so the one-device loop "
                   "ran; the leader and follower loops run on gloo ranks "
                   "(tests/test_torch_data_parallel.py)"}, launches


def _train_steps(cfg, device, batches, mesh=None):
    """``make_train_step`` from the seed-0 float32 init (as DTensors on
    ``mesh`` when given) over ``batches``: ([(loss, grad norm)], the
    final state, each step's ms by CUDA events)."""
    import torch
    from repro_torch.models import api, transformer
    params = transformer.init_params(cfg, seed=0, device=device,
                                     dtype=torch.float32)
    if mesh is not None:
        params = api.shard_params(cfg, params, mesh)
    step, opt = api.make_train_step(cfg, mesh=mesh)
    state = opt.init(params)
    hist, ms = [], []
    for raw in batches:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        batch = {k: torch.from_numpy(v).to(device) for k, v in raw.items()}
        params, state, m = step(params, state, batch)
        end.record()
        torch.cuda.synchronize()
        hist.append((float(m["loss"]), float(m["grad_norm"])))
        ms.append(start.elapsed_time(end))
    return hist, (params, state), ms


def phase_mesh(device):
    """qwen3-8b served at full width through the ("data", "model")
    ``DeviceMesh`` of a one-rank NCCL group against the meshless engine
    on the same params and prompts; granite-moe's experts sharded
    (``moe_ep``) against ``ep=False``; training steps through the mesh
    against the meshless ones; a sharded save and restore; mamba2,
    recurrentgemma and whisper at full width through the mesh against the
    meshless engine (``_mesh_family``); a continuous session on a
    data-parallel DWN engine (``_mesh_dp_continuous``).  Returns K10's
    launches on the mesh paths and the session's K1/K2 launches."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.data.tokens import TokenStream
    from repro_torch.models import api, transformer
    from repro_torch.sharding.partition import is_device_mesh
    from repro_torch.optim.adam import AdamState, leaves
    from repro_torch.runtime import checkpoint
    from repro_torch.serving import ServingEngine
    t_phase = time.perf_counter()
    B, n, S, gen = (MESH_SERVED[k] for k in ("batch", "requests",
                                            "prompt_len", "gen"))
    cfg = dataclasses.replace(get_arch("qwen3-8b"), attn_impl="pallas")
    torch.cuda.empty_cache()
    # the meshless engine first (made with no process group, it stays
    # meshless), then the mesh's; the two serve the stream in turns
    plain = ServingEngine(cfg, prompt_len=S, gen=gen, device=device, seed=0)
    plain.warmup(B)
    stream = [plain.make_request(B, seed=300 + i) for i in range(n)]
    out = {"phase": "mesh", "world": 1, "backend": "nccl",
           "arch": cfg.name, "layers": cfg.num_layers, **MESH_SERVED}
    with _nccl_world_one():
        torch.cuda.reset_peak_memory_stats()
        engine = ServingEngine(cfg, prompt_len=S, gen=gen, device=device,
                               seed=0, model_parallel=1)
        rep = engine.report()
        if not (is_device_mesh(engine.mesh) and rep["model_parallel"] == 1
                and rep["devices"] == 1):
            raise SystemExit(f"the engine is not on a one-rank mesh: "
                             f"{engine.mesh}, {rep['model_parallel']}")
        engine.warmup(B)
        turns = {"meshless": [], "mesh": []}
        k10 = {"meshless": 0, "mesh": 0}
        for name in ("meshless", "mesh", "mesh", "meshless"):
            done, launched = _lm_served(
                plain if name == "meshless" else engine, stream)
            turns[name].append(done)
            k10[name] += launched
        want = [r.result["tokens"] for r in turns["meshless"][0]]
        for done in turns["mesh"] + turns["meshless"][1:]:
            for r, w in zip(done, want):
                if not np.array_equal(r.result["tokens"], w):
                    raise SystemExit(f"request {r.rid}: the mesh path's "
                                     f"tokens differ from the meshless "
                                     f"engine's")
        prefill = api.make_prefill(cfg, cache_len=S + gen)
        plain_logits = prefill(plain.params, stream[0])[0]
        mesh_prefill = api.make_prefill(cfg, cache_len=S + gen,
                                        mesh=engine.mesh)
        _reset_counts()
        logits = mesh_prefill(engine.params, stream[0])[0]
        torch.cuda.synchronize()
        per_prefill = _expect_launches("one mesh prefill", {
            "flash_attention": cfg.num_layers})
        rel = _rel(logits, plain_logits)
        if not rel < LOGITS_REL:
            raise SystemExit(f"mesh prefill logits {rel} >= {LOGITS_REL} "
                             f"of the meshless path's")

        def times(name, key):
            return [r.result[key] for done in turns[name] for r in done]
        out["serve"] = {
            "turns": ["meshless", "mesh", "mesh", "meshless"],
            "tokens_equal": True, "logits_rel": rel,
            "logits_max_abs_err": float((logits.float()
                                         - plain_logits.float()).abs().max()),
            "tolerance": LOGITS_REL,
            # over each path's two served passes
            "k10_launches": k10["mesh"],
            "k10_launches_meshless": k10["meshless"],
            "k10_per_prefill": per_prefill["flash_attention"],
            "prefill_s": times("mesh", "prefill_s"),
            "prefill_s_meshless": times("meshless", "prefill_s"),
            "decode_s_per_tok": times("mesh", "decode_s_per_tok"),
            "decode_s_per_tok_meshless": times("meshless",
                                               "decode_s_per_tok"),
            "peak_memory_bytes_both_engines":
                torch.cuda.max_memory_allocated()}
        k10 = k10["mesh"]
        mesh = engine.mesh
        del engine, plain, logits, plain_logits
        torch.cuda.empty_cache()

        # granite-moe, experts over "model" (padded to 48) against
        # ep=False on the same 40 live experts and router columns
        base = dataclasses.replace(get_arch("granite-moe-3b-a800m"),
                                   attn_impl="pallas")
        ep = dataclasses.replace(base, moe_ep=True)
        params = transformer.init_params(ep, seed=0, device=device)
        E = base.num_experts
        unpadded = {**params, "layers": [
            {**lp, "moe": {k: (v[:, :E] if k == "router" else v[:E])
                           for k, v in lp["moe"].items()}}
            for lp in params["layers"]]}
        gen_ = torch.Generator(device=device).manual_seed(0)
        batch = {"tokens": torch.randint(0, base.vocab_size, (B, S),
                                         generator=gen_, device=device)}
        sharded = api.shard_params(ep, params, mesh)
        _reset_counts()
        ep_logits = api.make_prefill(ep, cache_len=S, mesh=mesh)(
            sharded, batch)[0]
        torch.cuda.synchronize()
        ep_k10 = _expect_launches("granite moe_ep prefill", {
            "flash_attention": base.num_layers})["flash_attention"]
        want = api.make_prefill(base, cache_len=S)(unpadded, batch)[0]
        rel = _rel(ep_logits, want)
        if not rel < LOGITS_REL:
            raise SystemExit(f"granite-moe moe_ep prefill {rel} >= "
                             f"{LOGITS_REL} of ep=False")
        out["moe_ep"] = {"arch": ep.name, "experts": int(
            params["layers"][0]["moe"]["w_gate"].shape[0]),
            "live_experts": E, "logits_rel": rel, "k10_launches": ep_k10,
            "head_dim": base.head_dim_}
        del params, unpadded, sharded, ep_logits, want
        torch.cuda.empty_cache()

        # training: the lm_train phase's depth, meshless then the mesh
        total = torch.cuda.get_device_properties(0).total_memory
        full = get_arch("qwen3-8b")
        tcfg = dataclasses.replace(full,
                                   num_layers=lm_train_layers(full, total))
        Bt, St = MESH_TRAIN_SHAPE
        ts = TokenStream(tcfg.vocab_size, St, Bt, seed=0)
        batches = [ts.next_batch() for _ in range(MESH_TRAIN_STEPS)]
        want_h, state, want_ms = _train_steps(tcfg, device, batches)
        del state
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        got_h, state, got_ms = _train_steps(tcfg, device, batches, mesh)
        peak_train = torch.cuda.max_memory_allocated()
        del state
        torch.cuda.empty_cache()
        ok = all(abs(g[0] - w[0]) <= LM_TRAIN_LOSS_REL * w[0]
                 for g, w in zip(got_h, want_h))
        out["train"] = {"layers": tcfg.num_layers, "batch": Bt, "seq": St,
                        "mesh": got_h, "meshless": want_h,
                        "loss_rel": LM_TRAIN_LOSS_REL,
                        "step_ms": got_ms, "step_ms_meshless": want_ms,
                        "peak_memory_bytes": peak_train}
        if not ok:
            emit(out)
            raise SystemExit("the mesh path's train losses disagree with "
                             "the meshless steps'")

        # a sharded save and restore: the reduced qwen3-8b trained on the
        # mesh (a full-width state is 40+ GB of files), restored onto the
        # mesh by its shardings, every leaf equal
        small = get_arch("qwen3-8b").reduced()
        ts = TokenStream(small.vocab_size, 128, 8, seed=0)
        _, (params, state), _ = _train_steps(
            small, device, [ts.next_batch() for _ in range(3)], mesh)
        ckdir = ROOT / "build" / "chip_smoke_mesh_ckpt"
        shutil.rmtree(ckdir, ignore_errors=True)
        checkpoint.save(ckdir, 3, (params, state))
        like = api.abstract_params(small, 1)
        ps = api.param_shardings(small, like, mesh)
        (rp, rs), _ = checkpoint.restore(
            ckdir, 3, (like, AdamState(state.step, like, like)),
            shardings=(ps, AdamState(None, ps, ps)))
        shutil.rmtree(ckdir, ignore_errors=True)
        equal = all(torch.equal(a.to_local(), b.to_local())
                    for a, b in zip(leaves((rp, rs.mu, rs.nu)),
                                    leaves((params, state.mu, state.nu))))
        if not (equal and int(rs.step) == 3):
            raise SystemExit("the restored mesh state differs from the "
                             "saved one")
        out["restore"] = {"arch": small.name, "leaves": len(leaves(
            (rp, rs))), "equal": True,
            "dtensors": all(hasattr(t, "placements") for t in leaves(rp))}
    emit(out)
    for arch in MESH_FAMILY_ARCHS:
        t0 = time.perf_counter()
        fam = _mesh_family(device, arch)
        emit({"phase": "mesh", "arch": arch, **fam,
              "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    dp, dp_launches = _mesh_dp_continuous(device)
    emit({"phase": "mesh", "continuous_data_parallel": dp,
          "seconds": time.perf_counter() - t0})
    emit({"phase": "mesh", "seconds": time.perf_counter() - t_phase})
    return {"k10": {"qwen3-8b": k10, "granite-moe moe_ep": ep_k10},
            "dp_launches": dp_launches}


#: the shapes the card's kernels once refused for their size alone, at
#: full size (the CPU tests hold reduced versions of them to the
#: reference): W1a, jsc-lg at a 4096-threshold encoder
#: (``DWNConfig(bits_per_feature=4096, lut_counts=(2400,))``); W1b, two
#: hidden layers of 32,000 LUTs; W2, 28 x 28 pixels at T = 16; W3, twelve
#: layers; W4, one layer of 480 LUTs at fan-in 10 and 16
LIMITS = {
    "W1a": dict(F=16, T=4096, luts=(2400,), n=6, C=5),
    "W1b": dict(F=16, T=200, luts=(32000, 32000, 2400), n=6, C=5),
    "W2": dict(F=784, T=16, luts=(8000, 1280), n=6, C=10),
    "W3": dict(F=16, T=200, luts=(2400,) * 12, n=6, C=5),
    "W4n10": dict(F=16, T=200, luts=(480,), n=10, C=5),
    "W4n16": dict(F=16, T=200, luts=(480,), n=16, C=5),
}
#: batches every shape's fused and staged paths are held at
LIMITS_BATCHES = (4096, 1000, 33, 1)
#: batches of the float path (K7's output is 256 KB a sample at W1a;
#: K8's plain version at fan-in 16 holds (rows, 480, 32768) floats)
LIMITS_FLOAT_BATCHES = {"W4n16": (33, 1)}
LIMITS_FLOAT_DEFAULT = (256, 33, 1)
#: K4 alone on rows of 8192 words: F = 16 features at T = 16,384 after K3
K4_WIDE = dict(F=16, T=16384, m=2400, n=6)
#: K4 on rows of one word more than a block stages: the kept global kernel
K4_GLOBAL_WORDS = 58_113
#: K10 at head dims without an instance of their own, or new instances:
#: (B, S, H, KH), causal and not; hd 16 at B x H = 65,600 (all on grid.x
#: on the Hopper design; the mma.sync design folds grid.y into grid.x)
LIMITS_FLASH = (2, 1000, 8, 2)
LIMITS_FLASH_HDS = (8, 16, 32, 80, 256)
LIMITS_FLASH_WIDE_BH = (8200, 64, 8, 8, 16)
#: the Hopper design's hd-16, hd-32 and hd-256 instances at full size,
#: (B, S, H, KH, hd), causal and not: recurrentgemma-2b's heads (10 over 1
#: KV head, hd 256; causal equals its local attention while S is within
#: its 2048-key window) and qwen3-8b's (32 over 8) at hd 32 and 16; they
#: and LIMITS_FLASH at hd 8, 16, 32 and 256 also hold the kept mma.sync
#: instances
LIMITS_FLASH_FULL = {
    "flash_attention hd256 recurrentgemma-2b": (4, 2048, 10, 1, 256),
    "flash_attention hd32 qwen3-8b heads": (4, 2048, 32, 8, 32),
    "flash_attention hd16 qwen3-8b heads": (4, 2048, 32, 8, 16)}
#: the per-row bar for rows of 8 to 31 head dims: their largest value is
#: no steady scale, and over a million rows the bf16 algorithm itself (P
#: and the output rounded to bf16: flash_rounded, in plain PyTorch on the
#: same inputs) and SDPA read above FLASH_ROW_REL as the kernel does (on
#: an H100 up to 0.0109 at hd 16 x 65,600 pairs, all three; PERF.md);
#: a dropped key tile (flash_rounded's witness) reads 30 times this or
#: more there, and each check asserts that it fails the bar
FLASH_ROW_REL_NARROW = 2e-2
#: rows of fewer head dims are held to FLASH_TOL alone: a row of one value
#: has no scale but itself
FLASH_ROW_MIN_HD = 8
#: the witness's dropped keys, (first key, keys): left out of every query
#: row past them
FLASH_DROP_KEYS = (16, 16)
#: rows each request of the phase's served streams holds (ragged)
LIMITS_SERVED = (1000, 33, 1, 700)
#: the new paths' symbols, held to no spill (TILE_SYMBOLS holds the rest)
LIMITS_SYMBOLS = (
    ("fused_dwn", "fused_tiles_kernelILb0ELb0ELb1E",
     "fused_dwn_packed, scratch"),
    ("fused_dwn", "fused_tiles_kernelILb1ELb0ELb1E",
     "fused_dwn_batch_major, scratch"),
    ("fused_dwn", "fused_dwn_global_kernelILb1E",
     "fused_dwn global, features staged"),
    ("fused_dwn", "fused_dwn_global_kernelILb0E", "fused_dwn global"),
    *(("lut_eval", f"lut_eval_wide_kernelILi{h}E",
       f"lut_eval wide, corner blocks of {2 ** h}") for h in range(1, 6)),
    ("lut_eval", "lut_eval_packed_rows_kernelILb0E",
     "lut_eval_packed, rows from global memory"),
    ("lut_eval", "lut_eval_packed_block_kernelILb1E",
     "lut_eval_packed, block rows, layer in registers"),
    ("lut_eval", "lut_eval_packed_block_kernelILb0E",
     "lut_eval_packed, block rows"))


def flash_row_bar(hd):
    """The per-row bar at head dim ``hd``: FLASH_ROW_REL from 32 on,
    FLASH_ROW_REL_NARROW from FLASH_ROW_MIN_HD, else None."""
    if hd >= 32:
        return FLASH_ROW_REL
    return FLASH_ROW_REL_NARROW if hd >= FLASH_ROW_MIN_HD else None


def flash_rounded(q, k, v, causal, drop=None):
    """Attention as a flash kernel rounds it, in plain PyTorch: scores in
    float32 from bf16 (B, S, heads, hd) operands at hd^-0.5, P = exp(s -
    the row's max) rounded to bf16 before P V, the float32 row sum, the
    output rounded to bf16.  ``drop``: (first key, keys) left out of every
    query row past them, a kernel that drops a key tile."""
    import torch
    H, KH, hd = q.shape[2], k.shape[2], q.shape[3]
    qf, kf, vf = (t.float().transpose(1, 2) for t in (q, k, v))
    kf, vf = (t.repeat_interleave(H // KH, 1) for t in (kf, vf))
    s = qf @ kf.transpose(-1, -2) * hd ** -0.5
    S = q.shape[1]
    mask = torch.zeros((S, S), dtype=torch.bool, device=q.device)
    if causal:
        mask |= torch.ones_like(mask).triu(1)
    if drop is not None:
        first, keys = drop
        mask[first + keys:, first:first + keys] = True
    s = s.masked_fill(mask, float("-inf"))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    out = (p.bfloat16().float() @ vf) / p.sum(-1, keepdim=True)
    return out.transpose(1, 2).bfloat16()


def _limits_flash_check(got, q, k, v, causal, where):
    """K10's output ``got`` against its plain version: FLASH_TOL
    elementwise and ``flash_row_bar`` per row; beside it the same errors
    of SDPA and of ``flash_rounded`` on the same inputs, and where the row
    bar applies, the row error of a dropped key tile, which must fail it.
    Raises on a failed check."""
    import torch
    from repro_torch.kernels.flash_attn.ref import attention_ref
    hd = q.shape[3]
    want = attention_ref(q.float(), k.float(), v.float(), causal=causal)
    res = flash_errors(got, want)
    bar = flash_row_bar(hd)
    res["row_tolerance"] = bar
    res["ok"] = bool(torch.isfinite(got).all() and (
        (got.float() - want).abs() <= FLASH_TOL + FLASH_TOL * want.abs())
        .all() and (bar is None or res["row_rel_err"] <= bar))
    sdpa = torch.nn.functional.scaled_dot_product_attention(
        *(t.transpose(1, 2) for t in (q, k, v)), is_causal=causal,
        enable_gqa=True).transpose(1, 2)
    res["library_row_rel_err"] = flash_errors(sdpa, want)["row_rel_err"]
    res["rounded_row_rel_err"] = flash_errors(
        flash_rounded(q, k, v, causal), want)["row_rel_err"]
    if bar is not None and q.shape[1] > sum(FLASH_DROP_KEYS):
        res["dropped_tile_row_rel_err"] = flash_errors(
            flash_rounded(q, k, v, causal, FLASH_DROP_KEYS),
            want)["row_rel_err"]
        if res["dropped_tile_row_rel_err"] <= bar:
            raise SystemExit(f"limits: the row bar {bar} passes a dropped "
                             f"key tile at {where}: {res}")
    check = {**where, "causal": causal, **res}
    if not res["ok"]:
        raise SystemExit(f"limits: K10 differs from its plain version: "
                         f"{check}")
    return check


def _limits_flash_routing():
    """``flash_attn_instance`` (the instance and design flash_attn_launch
    runs in C) against ``instance_for`` at every head dim 1-256; raises
    on a head dim where they differ."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attn import kernel as KA
    fn = _build.load(KA.LIBRARY).flash_attn_instance
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int
    differ = {}
    for hd in range(1, KA.MAX_HEAD_DIM + 1):
        inst, design = KA.instance_for(hd)
        if fn(hd) != (inst if design == "tma" else -inst):
            differ[hd] = [fn(hd), inst, design]
    if differ:
        raise SystemExit(f"limits: flash_attn_instance and instance_for "
                         f"differ at {differ}")
    return {"head_dims": KA.MAX_HEAD_DIM, "agree": True,
            "on_tma": sum(KA.instance_for(hd)[1] == "tma"
                          for hd in range(1, KA.MAX_HEAD_DIM + 1))}


def _limits_flash_mma_checks(device, rng, shape):
    """The kept mma.sync instance at ``shape`` (B, S, H, KH, hd), through
    ``flash_attn_mma_launch`` (uncounted), held as K10 is
    (``_limits_flash_check``), each q scale, causal and not."""
    import torch
    from repro_torch.kernels.flash_attn import kernel as KA
    B, S, H, KH, hd = shape
    checks = []
    for q_scale in FLASH_Q_SCALES:
        q, kk, v = _flash_operands(device, rng, B, S, (H, KH, hd), q_scale)
        for causal in (True, False):
            got = torch.zeros_like(q)
            rows_kernel(KA.LIBRARY, KA._SIGNATURES, "flash_attn_mma_launch",
                        q.data_ptr(), kk.data_ptr(), v.data_ptr(),
                        got.data_ptr(), B, S, H, KH, hd, int(causal))()
            torch.cuda.synchronize()
            checks.append({"design": "mma", **_limits_flash_check(
                got, q, kk, v, causal, {"B": B, "S": S, "H": H, "KH": KH,
                                        "hd": hd, "q_scale": q_scale})})
    return checks


def _limits_counts():
    """Every DWN kernel's launches since the last reset."""
    out = {}
    for K in _stage_kernels() + (_kernel_modules()[0],):
        out.update(K.launch_counts())
    return out


def _limits_equal(what, got, want):
    """Equal tensors (words in either carrier), else the run fails."""
    import torch
    from repro_torch.core.bitpack import from_word_pattern
    got, want = (t if isinstance(t, (tuple, list)) else (t,)
                 for t in (got, want))
    for a, b in zip(got, want):
        if a.dtype != b.dtype and not a.is_floating_point():
            a, b = from_word_pattern(a), from_word_pattern(b)
        if not torch.equal(a.cpu(), b.cpu()):
            raise SystemExit(f"limits: {what} differ")


def _limits_shape(device, name, s, rng, paths):
    """One shape: K2 and K1, the staged path (K3 -> K4 per layer -> K5),
    the float path (K7 -> K8 per layer -> K9) and, for one layer, K6,
    driven at every batch with the counts set to 0 (the launches of the
    path), then each kernel held bit for bit to its plain version on the
    same inputs and every path's counts to ``apply_hard``.  ``paths``
    collects each new path's launches, by name, from each launch's own
    record (``last_launch`` / ``last_float_launch``), read in the drive
    and held to the plan."""
    import torch
    from repro_torch.core.bitpack import to_word_pattern
    from repro_torch.core.model import DWNConfig, FrozenDWN, apply_hard
    from repro_torch.kernels.fused import kernel as KF
    from repro_torch.kernels.fused import ops as tfused
    from repro_torch.kernels.fused import ref as FR
    from repro_torch.kernels.lut_eval import kernel as KL
    from repro_torch.kernels.lut_eval import ref as LR
    from repro_torch.kernels.lut_eval.ops import packed_wire_indices
    from repro_torch.kernels.popcount import ops as tpc
    from repro_torch.kernels.popcount import ref as PR
    from repro_torch.kernels.thermometer import ops as tth
    from repro_torch.kernels.thermometer import ref as TR
    from repro_torch.kernels.lut_eval import ops as tlut
    from repro_torch.kernels._launch import sm_count
    F, T, luts, n, C = (s[k] for k in ("F", "T", "luts", "n", "C"))
    th, maps, tabs = make_model(rng, F, T, luts, n)
    x = torch.from_numpy(rng.uniform(-1, 1, (max(LIMITS_BATCHES), F))
                         .astype(np.float32)).to(device)
    thd = torch.from_numpy(th).to(device)
    mapsd = [torch.from_numpy(a).to(device) for a in maps]
    tabsd = [torch.from_numpy(a).to(device) for a in tabs]
    ops = {v: tfused.prepare_operands(thd, mapsd, tabsd, C, v)
           for v in ("packed", "batch-major")}
    kern = {"packed": KF.fused_dwn_packed,
            "batch-major": KF.fused_dwn_batch_major}
    float_batches = LIMITS_FLOAT_BATCHES.get(name, LIMITS_FLOAT_DEFAULT)
    # the drive: every path at every batch, counted from 0
    _reset_counts()
    fused, layouts, staged, floats, k6 = {}, {}, {}, {}, {}
    k4_paths, k8_paths = {}, {}
    t0 = time.perf_counter()
    for B in LIMITS_BATCHES:
        xb = x[:B]
        for v in ("packed", "batch-major"):
            fused[v, B] = kern[v](xb, *ops[v])
            layouts[v, B] = KF.last_launch()
        words = [tth.encode_packed(xb, thd)]
        for layer, (mp, tb) in enumerate(zip(mapsd, tabsd)):
            words.append(tlut.evaluate_packed(words[-1], mp, tb))
            k4_paths[B, layer] = KL.last_launch()["path"]
        staged[B] = (words, tpc.classify_packed(words[-1], C))
        if len(luts) == 1:
            k6[B] = (tfused.forward(xb, thd, mapsd[0], tabsd[0], C),
                     KF.last_float_launch())
    for B in float_batches:
        bits = [tth.encode(x[:B], thd)]
        for layer, (mp, tb) in enumerate(zip(mapsd, tabsd)):
            bits.append(tlut.evaluate(bits[-1], mp, tb))
            k8_paths[B, layer] = KL.last_float_launch()["path"]
        floats[B] = (bits, tpc.classify(bits[-1], C))
    torch.cuda.synchronize()
    drive_s = time.perf_counter() - t0
    launches = _limits_counts()
    # the checks: plain versions on the same inputs (no launches)
    frozen = FrozenDWN(DWNConfig(num_features=F, bits_per_feature=T,
                                 lut_counts=tuple(luts), fan_in=n,
                                 num_classes=C), th, maps, tabs)
    plain = {"packed": FR.fused_dwn_packed_plain,
             "batch-major": FR.fused_dwn_batch_major_plain}
    for B in LIMITS_BATCHES:
        xb = x[:B]
        want = apply_hard(frozen, xb)
        for v in ("packed", "batch-major"):
            counts, idx = fused[v, B]
            _limits_equal(f"{name} {v} B={B} against its plain version",
                          (counts, idx), plain[v](xb, *ops[v]))
            _limits_equal(f"{name} {v} B={B} against apply_hard", counts,
                          want)
            path = KF.check_activation_width(
                v, F, T if v == "packed" else 0, luts, C)
            lay = layouts[v, B]
            if lay["scratch"] != (path == "global") or \
                    lay["device_layers"] != max(
                        0, len(luts) - KF.INLINE_LAYERS):
                raise SystemExit(f"limits: {name} {v} B={B} took {lay}, "
                                 f"planned {path}")
            kname = ("fused_dwn_packed" if v == "packed"
                     else "fused_dwn_batch_major")
            paths[f"{kname} scratch"] += lay["scratch"]
            paths[f"{kname} deep"] += lay["device_layers"] > 0
        words, (counts, idx) = staged[B]
        _limits_equal(f"{name} K3 B={B}", words[0].words,
                      to_word_pattern(TR.thermometer_packed_plain(xb, thd)))
        for layer, (mp, tb) in enumerate(zip(mapsd, tabsd)):
            widx, boff = packed_wire_indices(mp)
            m_pad = FR.round_up(mp.shape[0], 32)
            tab_words = FR.pack_table_words(torch.nn.functional.pad(
                tb.long(), (0, 0, 0, m_pad - mp.shape[0])))
            pad = torch.nn.functional.pad
            wplain = LR.lut_eval_packed_plain(
                words[layer].words, pad(widx, (0, 0, 0, m_pad - len(mp))),
                pad(boff, (0, 0, 0, m_pad - len(mp))), tab_words)
            _limits_equal(f"{name} K4 layer {layer} B={B}",
                          words[layer + 1].words, to_word_pattern(wplain))
            plan = KL.plan_lut_eval_packed(B, words[layer].words.shape[1],
                                           m_pad, n, sm_count(device))
            if k4_paths[B, layer] != plan.path:
                raise SystemExit(f"limits: {name} K4 layer {layer} B={B} "
                                 f"took {k4_paths[B, layer]}, planned "
                                 f"{plan.path}")
            paths["lut_eval_packed global rows"] += \
                k4_paths[B, layer] == "global"
        _limits_equal(f"{name} K5 B={B}", (counts, idx),
                      PR.popcount_classify_packed_plain(
                          words[-1].words,
                          tpc.class_masks(luts[-1], C, device)))
        _limits_equal(f"{name} staged B={B} against apply_hard", counts,
                      want)
        if B in k6:
            (counts, idx), plan = k6[B]
            _limits_equal(f"{name} K6 B={B}", (counts, idx),
                          FR.fused_dwn_plain(xb, thd, mapsd[0], tabsd[0], C))
            _limits_equal(f"{name} K6 B={B} against apply_hard", counts,
                          want)
            if plan["path"] == "global":
                paths["fused_dwn global"] += 1
    for B in float_batches:
        bits, (counts, idx) = floats[B]
        _limits_equal(f"{name} K7 B={B}", bits[0],
                      TR.thermometer_plain(x[:B], thd).reshape(B, -1))
        for layer, (mp, tb) in enumerate(zip(mapsd, tabsd)):
            _limits_equal(f"{name} K8 layer {layer} B={B}", bits[layer + 1],
                          LR.lut_eval_plain(bits[layer], mp,
                                            tb.to(torch.float32)))
            plan = KL.plan_lut_eval(B, bits[layer].shape[1], mp.shape[0],
                                    sm_count(device), n)
            if k8_paths[B, layer] != plan.path:
                raise SystemExit(f"limits: {name} K8 layer {layer} B={B} "
                                 f"took {k8_paths[B, layer]}, planned "
                                 f"{plan.path}")
            paths["lut_eval wide"] += k8_paths[B, layer] == "global"
        _limits_equal(f"{name} K9 B={B}", (counts, idx),
                      PR.popcount_classify_plain(bits[-1], C))
        _limits_equal(f"{name} float B={B} against apply_hard", counts,
                      apply_hard(frozen, x[:B]))
    return {"shape": s, "drive_s": drive_s, "launches": launches,
            "batches": list(LIMITS_BATCHES), "float_batches":
            list(float_batches),
            "k2_layout": layouts["packed", max(LIMITS_BATCHES)],
            "k1_layout": layouts["batch-major", max(LIMITS_BATCHES)]}, \
        (x, thd, ops, mapsd, tabsd, frozen)


def _limits_time(fn, plain, nbytes, ops, iters=10):
    """A new path timed once in a CUDA graph beside its plain version and
    its bound (bytes over HBM's rate, or operations over the SMs')."""
    by_bytes = nbytes / PEAK_BYTES_PER_S
    by_ops = ops_seconds(ops)
    return {"ms": graph_ms(fn, iters=iters, replays=2),
            "plain_ms": time_ms(plain, iters=1, warmup=1),
            "bound_ms": max(by_bytes, by_ops) * 1e3,
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "library_ms": None}


def _limits_served(device):
    """W1a served through ``ServingEngine`` pinned to K2 and under
    ``backend="auto"``, and W2 pinned to K2 (a workload of 784 features
    registered for it, data made from a seed): every request's counts and
    predictions equal to ``apply_hard``; K2's launches counted over each
    drain."""
    import torch
    from repro_torch.core.classifier import predict
    from repro_torch.core.model import DWNConfig, apply_hard
    from repro_torch.dwn import DWNArtifact, DWNSpec
    from repro_torch.kernels.fused import kernel as KF
    from repro_torch.serving import ServingEngine
    from repro_torch.workloads import base as wbase
    name = "limits-784"
    if name not in wbase.list_workloads():
        def loader(n_train, n_test, seed):
            from repro_torch.data.jsc import JSCData
            r = np.random.default_rng(seed)
            return JSCData(*(a.astype(dt) for a, dt in (
                (r.uniform(-1, 1, (n_train, 784)), np.float32),
                (r.integers(0, 10, n_train), np.int32),
                (r.uniform(-1, 1, (n_test, 784)), np.float32),
                (r.integers(0, 10, n_test), np.int32))))
        wbase.register_workload(wbase.Workload(
            name, 784, 10, loader, {"w2": DWNConfig(
                num_features=784, bits_per_feature=16,
                lut_counts=(8000, 1280), num_classes=10)},
            "28 x 28 features made from a seed"))
    cells = {"W1a fused-packed": (DWNSpec(preset="lg-2400", bits=4096),
                                  "fused-packed"),
             "W1a auto": (DWNSpec(preset="lg-2400", bits=4096), "auto"),
             "W2 fused-packed": (DWNSpec(preset="w2", bits=16,
                                         workload=name), "fused-packed")}
    out = {}
    rng = np.random.default_rng(11)
    for cell, (spec, backend) in cells.items():
        eng = ServingEngine(DWNArtifact(spec), backend=backend,
                            device=device, max_bucket=1024, min_bucket=256,
                            n_train=2000)
        F = spec.dwn_config().num_features
        stream = [rng.uniform(-1, 1, (r, F)).astype(np.float32)
                  for r in LIMITS_SERVED]
        KF.reset_launch_counts()
        for p in stream:
            eng.submit(p)
        done = eng.drain()
        launches = KF.launch_counts()
        for r in done:
            xr = torch.from_numpy(np.ascontiguousarray(r.payload)).to(device)
            want = apply_hard(eng.artifact.frozen, xr)
            if not (np.array_equal(r.result[0], want.cpu().numpy())
                    and np.array_equal(r.result[1],
                                       predict(want).cpu().numpy())):
                raise SystemExit(f"limits: {cell} request {r.rid} differs "
                                 f"from apply_hard")
        if not (launches["fused_dwn_packed"]
                or launches["fused_dwn_batch_major"]):
            raise SystemExit(f"limits: {cell} launched no fused kernel: "
                             f"{launches}")
        out[cell] = {"served": _served(done), "launches": launches,
                     "bit_exact": eng.bit_exact,
                     "choice": (dict(eng.auto.choice) if eng.auto else
                                backend)}
        del eng
        torch.cuda.empty_cache()
    return out


def phase_limits(device, ptxas=()):
    """The shapes the card's kernels once refused (LIMITS, K4_WIDE, the
    K10 head dims): every kernel of every path bit-exact to its plain
    version, every path's counts equal to ``apply_hard`` (_limits_shape),
    W1a and W2 served through ``ServingEngine`` (_limits_served), K4 on
    rows of 8192 words (block rows) and of K4_GLOBAL_WORDS (global), K10
    at hd 8, 16, 32, 80 and 256, at full size (LIMITS_FLASH_FULL) and at
    B x H = 65,600 within FLASH_TOL; each new path timed once beside its
    bound and its plain version (K4's block rows beside the kept global
    kernel in turns), its launches counted over the phase's drives; the
    new kernels' ptxas lines held to no spill."""
    import torch
    from repro_torch.kernels.fused import kernel as KF
    from repro_torch.kernels.fused import ref as FR
    from repro_torch.kernels.flash_attn import kernel as KA
    from repro_torch.kernels.flash_attn.ref import attention_ref
    from repro_torch.kernels.lut_eval import kernel as KL
    from repro_torch.kernels.lut_eval import ref as LR
    from repro_torch.kernels.lut_eval.ops import packed_wire_indices
    from repro_torch.kernels.thermometer import ops as tth
    from repro_torch.core.bitpack import to_word_pattern
    lines = [line for lib in ptxas for line in lib]
    resources = {label: _ptxas_resources(lines, symbol)
                 for _, symbol, label in LIMITS_SYMBOLS}
    rng = np.random.default_rng(23)
    paths = dict.fromkeys(("fused_dwn_packed scratch",
                           "fused_dwn_batch_major scratch",
                           "fused_dwn_packed deep",
                           "fused_dwn_batch_major deep", "fused_dwn global",
                           "lut_eval wide", "lut_eval_packed block rows",
                           "lut_eval_packed global rows"), 0)
    shapes, kept = {}, {}
    for name, s in LIMITS.items():
        shapes[name], kept[name] = _limits_shape(device, name, s, rng, paths)
        if name not in ("W1a", "W2", "W3", "W4n10"):
            del kept[name]
        torch.cuda.empty_cache()
    timing = {}
    # K2 and K1 on the scratch: W1a's 2048 encoded words, W2's features
    x, thd, ops, mapsd, tabsd, _ = kept["W1a"]
    s = LIMITS["W1a"]
    timing["fused_dwn_packed scratch"] = {"shape": "W1a", "B": 4096, **(
        _limits_time(lambda: KF.fused_dwn_packed(x, *ops["packed"]),
                     lambda: FR.fused_dwn_packed_plain(x, *ops["packed"]),
                     *model_bytes_and_ops("packed", 4096, s["F"], s["T"],
                                          s["luts"], s["n"], s["C"])))}
    x, thd, ops, mapsd, tabsd, _ = kept["W2"]
    s = LIMITS["W2"]
    timing["fused_dwn_batch_major scratch"] = {"shape": "W2", "B": 4096, **(
        _limits_time(
            lambda: KF.fused_dwn_batch_major(x, *ops["batch-major"]),
            lambda: FR.fused_dwn_batch_major_plain(x, *ops["batch-major"]),
            *model_bytes_and_ops("batch-major", 4096, s["F"], s["T"],
                                 s["luts"], s["n"], s["C"])))}
    # twelve layers: the layers past INLINE_LAYERS read from device memory
    x, thd, ops, mapsd, tabsd, _ = kept["W3"]
    s = LIMITS["W3"]
    timing["fused_dwn_packed deep"] = {"shape": "W3", "B": 4096, **(
        _limits_time(lambda: KF.fused_dwn_packed(x, *ops["packed"]),
                     lambda: FR.fused_dwn_packed_plain(x, *ops["packed"]),
                     *model_bytes_and_ops("packed", 4096, s["F"], s["T"],
                                          s["luts"], s["n"], s["C"])))}
    timing["fused_dwn_batch_major deep"] = {"shape": "W3", "B": 4096, **(
        _limits_time(
            lambda: KF.fused_dwn_batch_major(x, *ops["batch-major"]),
            lambda: FR.fused_dwn_batch_major_plain(x, *ops["batch-major"]),
            *model_bytes_and_ops("batch-major", 4096, s["F"], s["T"],
                                 s["luts"], s["n"], s["C"])))}
    # K6 at fan-in 10; K8 at fan-in 10 and on W1a's 65,536-bit rows
    x, thd, ops, mapsd, tabsd, _ = kept["W4n10"]
    s = LIMITS["W4n10"]
    timing["fused_dwn global"] = {"shape": "W4n10", "B": 4096, **(
        _limits_time(
            lambda: KF.fused_dwn(x, thd, mapsd[0], tabsd[0].float(), 5),
            lambda: FR.fused_dwn_plain(x, thd, mapsd[0], tabsd[0], 5),
            *model_bytes_and_ops("float_fused", 4096, s["F"], s["T"],
                                 s["luts"], s["n"], s["C"])))}
    for shape, B in (("W4n10", 256), ("W1a", 256)):
        x, thd, ops, mapsd, tabsd, _ = kept[shape]
        s = LIMITS[shape]
        bits = tth.encode(x[:B], thd)
        tab_t = tabsd[0].float().T.contiguous()
        timing[f"lut_eval wide {shape}"] = {"shape": shape, "B": B, **(
            _limits_time(lambda: KL.lut_eval(bits, mapsd[0], tab_t),
                         lambda: LR.lut_eval_plain(bits, mapsd[0],
                                                   tabsd[0].float()),
                         *model_bytes_and_ops("float_lut_eval", B, s["F"],
                                              s["T"], s["luts"], s["n"],
                                              s["C"]), iters=3))}
    kept.clear()
    torch.cuda.empty_cache()
    # K4 alone on rows of 8192 words (after K3): the block rows kernel;
    # then on rows of K4_GLOBAL_WORDS random words: the global kernel
    k = K4_WIDE
    th, maps, tabs = make_model(rng, k["F"], k["T"], (k["m"],), k["n"])
    x = torch.from_numpy(rng.uniform(-1, 1, (4096, k["F"])).astype(
        np.float32)).to(device)
    words = tth.encode_packed(x, torch.from_numpy(th).to(device)).words
    widx, boff = (t.to(device).contiguous() for t in
                  packed_wire_indices(torch.from_numpy(maps[0])))
    tab_words = FR.pack_table_words(torch.from_numpy(tabs[0])).to(device)
    W_in = words.shape[1]
    group, bufs = KL.block_rows_shape(W_in)
    for where, rows, path, rows_staged in (
            ("8192-word rows", words, "block_rows", group * bufs),
            (f"{K4_GLOBAL_WORDS}-word rows", None, "global", 0)):
        if rows is None:
            rows = torch.from_numpy(rng.integers(
                -2 ** 31, 2 ** 31, (max(LIMITS_BATCHES), K4_GLOBAL_WORDS),
                dtype=np.int64).astype(np.int32)).to(device)
            wide = torch.from_numpy(rng.integers(
                0, 32 * K4_GLOBAL_WORDS, (k["m"], k["n"])).astype(
                    np.int32)).to(device)
            wi, bo = wide >> 5, wide & 31
        else:
            wi, bo = widx, boff
        _reset_counts()
        for B in LIMITS_BATCHES:
            got = KL.lut_eval_packed(rows[:B], wi, bo, tab_words)
            last = KL.last_launch()
            if (last["path"], last["staged_rows"]) != (path, rows_staged):
                raise SystemExit(f"limits: K4 on {where} took {last}")
            if path == "block_rows" and B == 4096:
                layout = last
            _limits_equal(f"K4 on {where} B={B}", got,
                          to_word_pattern(LR.lut_eval_packed_plain(
                              rows[:B], wi, bo, tab_words)))
        name = {"block_rows": "lut_eval_packed block rows",
                "global": "lut_eval_packed global rows"}[path]
        paths[name] += _limits_counts()["lut_eval_packed"]
    del rows, wide, wi, bo
    # at K4_WIDE, B = 4096: the block rows kernel through the wrapper, the
    # kept global kernel and the block rows kernel with one group of as
    # many rows as a block holds (no overlap) through their C entries,
    # uncounted, each held bit for bit to the plain version first; then
    # timed in turns (A B C C B A)
    from repro_torch.kernels._launch import sm_count
    out = torch.empty((4096, k["m"] // 32), dtype=torch.int32,
                      device=device)
    ptrs = (words.data_ptr(), 4096, W_in, widx.data_ptr(), boff.data_ptr(),
            tab_words.data_ptr(), k["m"], k["n"], tab_words.shape[1],
            out.data_ptr())
    cap = KL.MAX_SMEM_BYTES // (4 * W_in)
    info = (ctypes.c_int * 3)()
    calls = {
        "block rows": lambda: KL.lut_eval_packed(words, widx, boff,
                                                  tab_words),
        "global": rows_kernel(KL.LIBRARY, KL._SIGNATURES,
                              "lut_eval_packed_rows_launch", *ptrs, 0),
        "one group": rows_kernel(
            KL.LIBRARY, KL._SIGNATURES, "lut_eval_packed_block_launch",
            *ptrs, cap, 1, sm_count(device), cap * W_in * 4, info)}
    want = to_word_pattern(LR.lut_eval_packed_plain(words, widx, boff,
                                                    tab_words))
    for name, fn in calls.items():
        out.zero_()
        got = fn()
        torch.cuda.synchronize()
        _limits_equal(f"K4 {name} at K4_WIDE", out if got is None else got,
                      want)
    runs = {name: [] for name in calls}
    for order in (list(calls), list(calls)[::-1]):
        for name in order:
            runs[name].append(graph_ms(calls[name], iters=10, replays=2))
    bound = _limits_time(calls["block rows"],
                         lambda: LR.lut_eval_packed_plain(words, widx, boff,
                                                          tab_words),
                         *model_bytes_and_ops("lut_eval", 4096, k["F"],
                                              k["T"], (k["m"],), k["n"], 5))
    timing["lut_eval_packed block rows"] = {
        "shape": "K4_WIDE", "B": 4096, **bound, "layout": layout,
        "turns_ms": {name: t for name, t in runs.items()},
        "one_group_rows": cap, "one_group_cached": bool(info[2])}
    timing["lut_eval_packed global rows"] = {
        "shape": "K4_WIDE", "B": 4096, **bound,
        "ms": sum(runs["global"]) / 2,
        "turns_ms": {name: t for name, t in runs.items()},
        "launched": "through lut_eval_packed_rows_launch (staged=0), "
                    "uncounted; its launches are the wrapper's at "
                    f"{K4_GLOBAL_WORDS} words"}
    del words, x, out, want
    # K10's instances as flash_attn_launch routes them in C, against
    # instance_for's, at every head dim
    routing = _limits_flash_routing()
    # K10 at head dims 8, 16, 32, 80 and 256, at hd 16, 32 and 256 at full
    # size, and hd 16 past 65,535 (b, h), each counted from 0 on its own
    Bf, Sf, H, KH = LIMITS_FLASH
    checks, flash_launches = [], {}
    shapes_checked = {f"flash_attention hd{hd}": (Bf, Sf, H, KH, hd)
                      for hd in LIMITS_FLASH_HDS}
    shapes_checked.update(LIMITS_FLASH_FULL)
    mma_checks = []
    for name, (Bc, Sc, Hc, KHc, hd) in shapes_checked.items():
        KA.reset_launch_counts()
        for q_scale in FLASH_Q_SCALES:
            q, kk, v = _flash_operands(device, rng, Bc, Sc, (Hc, KHc, hd),
                                       q_scale)
            where = {"B": Bc, "S": Sc, "H": Hc, "KH": KHc, "hd": hd,
                     "q_scale": q_scale}
            for causal in (True, False):
                got = KA.flash_attention(q, kk, v, causal=causal)
                checks.append({"entry": name, **_limits_flash_check(
                    got, q, kk, v, causal, where)})
                del got
        flash_launches[name] = KA.launch_counts()["flash_attention"]
        if kept_first_design(hd):
            # the kept mma.sync instance on the same shapes, uncounted
            mma_checks += [{"entry": name, **c} for c in
                           _limits_flash_mma_checks(
                               device, rng, (Bc, Sc, Hc, KHc, hd))]
        torch.cuda.empty_cache()
    Bw, Sw, Hw, KHw, hdw = LIMITS_FLASH_WIDE_BH
    KA.reset_launch_counts()
    for q_scale in FLASH_Q_SCALES:
        q, kk, v = _flash_operands(device, rng, Bw, Sw, (Hw, KHw, hdw),
                                   q_scale)
        for causal in (True, False):
            got = KA.flash_attention(q, kk, v, causal=causal)
            checks.append({"entry": "flash_attention hd16 folded grid",
                           **_limits_flash_check(
                               got, q, kk, v, causal,
                               {"B": Bw, "S": Sw, "H": Hw, "KH": KHw,
                                "hd": hdw, "q_scale": q_scale})})
            # the folded grid against the same rows in two launches
            # whose batch x heads fit grid.y (no fold), launched after the
            # count is read
            checks[-1]["unfolded"] = (q, kk, v, causal, got)
    flash_launches["flash_attention hd16 folded grid"] = \
        KA.launch_counts()["flash_attention"]
    for c in checks:
        if "unfolded" not in c:
            continue
        q, kk, v, causal, got = c.pop("unfolded")
        half = Bw // 2
        parts = [KA.flash_attention(q[i:i + half], kk[i:i + half],
                                    v[i:i + half], causal=causal)
                 for i in (0, half)]
        c["equal_unfolded"] = bool(torch.equal(got, torch.cat(parts)))
        if not c["equal_unfolded"]:
            raise SystemExit(f"limits: K10 at B x H = {Bw * Hw} differs "
                             f"from its two unfolded halves: {c}")
    del q, kk, v, got, parts
    for name, (Bc, Sc, Hc, KHc, hd) in shapes_checked.items():
        timing[name] = {"instance": KA.instance_for(hd),
                        **_flash_timing(device, rng, (Hc, KHc, hd), Bc, Sc)}
        torch.cuda.empty_cache()
    timing["flash_attention hd16 folded grid"] = {
        "instance": KA.instance_for(hdw),
        **_flash_timing(device, rng, (Hw, KHw, hdw), Bw, Sw)}
    served = _limits_served(device)
    emit({"phase": "limits", "shapes": shapes, "paths": paths,
          "served": served, "flash_checks": checks,
          "flash_mma_checks": mma_checks, "flash_routing": routing,
          "flash_launches": flash_launches, "timing": timing,
          "ptxas": resources})
    missing = [p for p, n in {**paths, **flash_launches}.items() if not n]
    if missing:
        raise SystemExit(f"limits: no launch took {missing}")
    return paths, timing, flash_launches, checks, mma_checks


def main() -> int:
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}",
              file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "runs the port on a CUDA card", file=sys.stderr)
        return 3
    sys.path.insert(0, str(SRC))
    # the serve phase tunes into a fresh cache of its own
    cache = ROOT / "build" / "chip_smoke_autotune.json"
    cache.parent.mkdir(exist_ok=True)
    cache.unlink(missing_ok=True)
    os.environ["REPRO_AUTOTUNE_CACHE"] = str(cache)
    # full float32 in float32 products (the masked attention path's scores)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = nvidia_smi_line()
    global SM_CLOCK_HZ
    SM_CLOCK_HZ = max_sm_clock_hz()
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    emit({"phase": "device", "name": kind, "count": count,
          "nvidia_smi": smi, "clocks_max_sm_hz": SM_CLOCK_HZ,
          "torch": torch.__version__,
          "cuda": torch.version.cuda})
    seconds = {}

    def run(name, phase, *args):
        t0 = time.perf_counter()
        out = phase(*args)
        seconds[name] = time.perf_counter() - t0
        return out

    ptxas = run("build", phase_build)
    max_err, timing = run("kernels", phase_kernels, "cuda")
    stage_err, stage_timing, stage_launches = run("staged", phase_staged,
                                                  "cuda")
    float_err, float_timing, float_launches = run("float", phase_float,
                                                  "cuda")
    (flash_err, flash_timing, flash_err_by_hd, zoo_timing,
     served_timing) = run("flash", phase_flash, "cuda", ptxas["flash_attn"])
    flash_launches, lm_step = run("lm", phase_lm, "cuda")
    zoo_launches = run("lm_zoo", phase_lm_zoo, "cuda")
    head_launches = run("lm_head", phase_lm_head, "cuda")
    run("lm_train", phase_lm_train, "cuda")
    # training runs with the library's float32 product settings (its
    # step forces full float32 itself), not with this script's
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    run("train", phase_train, "cuda")
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = tf32
    launches = run("serve", phase_serve, "cuda")
    load_launches = run("load", phase_load, "cuda")
    hw_launches, hw_timing = run("hw", phase_hw, "cuda")
    sweep_launches = run("sweep", phase_sweep, "cuda")
    run("cli", phase_cli, "cuda")
    dwn_arch = run("dwn_arch", phase_dwn_arch, "cuda")
    run("dryrun", phase_dryrun, "cuda", lm_step, dwn_arch["priced_step"])
    mesh = run("mesh", phase_mesh, "cuda")
    mesh_launches = mesh["k10"]
    (limit_paths, limit_timing, limit_flash, limit_checks,
     limit_mma_checks) = run(
        "limits", phase_limits, "cuda", list(ptxas.values()))
    emit({"phase": "seconds", "seconds": seconds,
          "total": sum(seconds.values())})

    src = "src/repro_torch/kernels/fused/csrc/fused_dwn.cu"
    replaces = {"fused_dwn_packed": "src/repro/kernels/fused/kernel.py:189",
                "fused_dwn_batch_major":
                    "src/repro/kernels/fused/kernel.py:286"}
    variant_of = {"fused_dwn_packed": "packed",
                  "fused_dwn_batch_major": "batch-major"}
    # each main path's launches, counted from 0 over its own passes: the
    # served dwn-jsc-lg (serve phase), its continuous-batching sessions
    # (load phase), dwn-mnist-lg (hw phase) and the paper grid's timed
    # calls and served steps (sweep phase)
    by_path = {name: {"serve dwn-jsc-lg": launches[name],
                      "load dwn-jsc-lg": load_launches[name],
                      "hw dwn-mnist-lg": hw_launches[name],
                      **{path: n[name] for path, n in
                         sweep_launches.items()},
                      "lm_head dwn-lm-head on qwen3-8b":
                          head_launches.get(name, 0),
                      "dwn_arch cross-check: K2 replays of its frozen "
                      "params": dwn_arch["check_launches"].get(name, 0),
                      "dp serving dwn-jsc-lg at world 1":
                          dwn_arch["dp_launches"].get(name, 0),
                      "mesh continuous session, data-parallel engine at "
                      "world 1": mesh["dp_launches"].get(name, 0)}
               for name in launches}
    summary = []
    for name in ("fused_dwn_batch_major", "fused_dwn_packed"):
        t = timing[variant_of[name]]
        mnist = hw_timing[variant_of[name]]
        summary.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces[name], "launches": launches[name],
            "launches_by_path": by_path[name],
            "equal": True, "max_abs_err": max_err[variant_of[name]],
            "ms": t["ms"], "bucket_ms": t["bucket_ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None,
            "mnist_lg": {k: mnist[k] for k in (
                "ms", "bucket_ms", "plain_ms", "bound_ms", "bound_by")}})
    t = timing["zero"]
    summary.append({
        "name": "fused_dwn_zero", "route": "cuda", "source": src,
        "replaces": replaces["fused_dwn_packed"],
        "part_of": ["fused_dwn_packed", "fused_dwn_batch_major"],
        "launches": launches["fused_dwn_zero"],
        "launches_by_path": by_path["fused_dwn_zero"], "equal": True,
        "max_abs_err": t["max_abs_err"], "ms": t["ms"],
        "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": t["library_ms"],
        "library": "Tensor.zero_", "B": t["B"]})
    for name, (source, replaced, _) in STAGES.items():
        t = stage_timing[name]
        summary.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaced, "launches": stage_launches[name],
            "equal": True, "max_abs_err": stage_err[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None,
            **{k: t[k] for k in ("kernel", "bucket_ms",
                                 "rows_kernel_bucket_ms", "eager_ms",
                                 "host_ms", "rows_host_ms", "rows_eager_ms",
                                 "launch_floor_ms") if k in t}})
    for name, (source, replaced, _) in FLOAT.items():
        t = float_timing[name]
        summary.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaced, "launches": float_launches[name],
            "equal": True, "max_abs_err": float_err[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "library": ("two eager calls" if t["library_ms"] is not None
                        else None),
            **{k: t[k] for k in ("bucket_ms", "rows_kernel_bucket_ms")
               if k in t},
            **({"part_of": ["fused_dwn"]} if name == "fused_dwn_combine"
               else {})})
    # K10's launches on every LM path, counted from 0 over each path's
    # served pass; hd 128 times at the qwen3-8b head shape (the zoo's
    # other hd-128 shapes under "head_shapes"), the hd-64 and hd-96
    # instances their own entries at the one arch that launches each
    flash_paths = {"lm qwen3-8b": flash_launches["flash_attention"],
                   "lm_head dwn-lm-head on qwen3-8b":
                       head_launches["flash_attention"],
                   **{f"lm_zoo {a}": n for a, n in zoo_launches.items()},
                   "mesh qwen3-8b on a one-rank NCCL mesh":
                       mesh_launches["qwen3-8b"]}
    t = flash_timing
    summary.append({
        "name": "flash_attention", "route": "cuda", "source": FLASH[0],
        "replaces": FLASH[1], "launches": flash_launches["flash_attention"],
        "launches_by_path": flash_paths, "head_dim": 128,
        "equal": False, "tolerance": FLASH_TOL,
        "row_tolerance": FLASH_ROW_REL, **flash_err,
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": t["library_ms"],
        "library": "scaled_dot_product_attention",
        "head_shapes": {a: {k: zoo_timing[a][k] for k in (
            "H", "KH", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")} for a, (_, _, hd) in ZOO_HEADS.items()
            if hd == 128},
        "served_shapes": {a: {k: t[k] for k in (
            "B", "S", "H", "KH", "ms", "eager_ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms", "tflops", "bound_share")}
            for a, t in served_timing.items()}})
    for arch, (_, _, hd) in ZOO_HEADS.items():
        if hd == 128:
            continue
        t = zoo_timing[arch]
        summary.append({
            "name": f"flash_attention hd{hd}", "route": "cuda",
            "source": FLASH[0], "replaces": FLASH[1],
            "launches": zoo_launches[arch],
            "launches_by_path": {f"lm_zoo {arch}": zoo_launches[arch], **(
                {"mesh granite-moe moe_ep on a one-rank NCCL mesh":
                 mesh_launches["granite-moe moe_ep"]} if hd == 64 else {})},
            "head_dim": hd, "heads": [t["H"], t["KH"]], "equal": False,
            "tolerance": FLASH_TOL, "row_tolerance": FLASH_ROW_REL,
            **flash_err_by_hd[hd], "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            "library": "scaled_dot_product_attention",
            **{k: t[k] for k in ("eager_ms", "tflops", "bound_share",
                                 "first_design_ms")}})
        if not zoo_launches[arch]:
            raise SystemExit(f"K10 at hd {hd} launched no time on the "
                             f"{arch} path")
    if not all(mesh_launches.values()):
        raise SystemExit(f"K10 launched no time on a mesh path: "
                         f"{mesh_launches}")
    # the paths for the shapes the kernels once refused (limits phase):
    # their launches over the phase's drives, each timed once at one shape
    fused_src = "src/repro/kernels/fused/kernel.py"
    lut_src = "src/repro/kernels/lut_eval/kernel.py"
    limit_entries = {
        "fused_dwn_packed scratch": (src, f"{fused_src}:189"),
        "fused_dwn_batch_major scratch": (src, f"{fused_src}:286"),
        "fused_dwn_packed deep": (src, f"{fused_src}:189"),
        "fused_dwn_batch_major deep": (src, f"{fused_src}:286"),
        "fused_dwn global": (src, f"{fused_src}:107"),
        "lut_eval wide": (STAGES["lut_eval_packed"][0], f"{lut_src}:54"),
        "lut_eval_packed block rows": (STAGES["lut_eval_packed"][0],
                                       f"{lut_src}:99"),
        "lut_eval_packed global rows": (STAGES["lut_eval_packed"][0],
                                        f"{lut_src}:99")}
    for name, (source, replaced) in limit_entries.items():
        t = dict(limit_timing[name if name != "lut_eval wide"
                              else "lut_eval wide W1a"])
        if name == "lut_eval wide":
            t["fan_in_10"] = limit_timing["lut_eval wide W4n10"]
        summary.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaced, "launches": limit_paths[name],
            "equal": True, "max_abs_err": 0.0, **t})
    for name, launches in limit_flash.items():
        t = limit_timing[name]
        hd = t["hd"]
        mine = [c for c in limit_checks if c["entry"] == name]
        first = [c for c in limit_mma_checks if c["entry"] == name]
        summary.append({
            "name": name, "route": "cuda", "source": FLASH[0],
            "replaces": FLASH[1], "launches": launches, "head_dim": hd,
            "equal": False, "tolerance": FLASH_TOL,
            "row_tolerance": flash_row_bar(hd),
            "max_abs_err": max(c["max_abs_err"] for c in mine),
            "row_rel_err": max(c["row_rel_err"] for c in mine),
            "library_row_rel_err": max(c["library_row_rel_err"]
                                       for c in mine),
            **{k: t[k] for k in (
                "instance", "B", "S", "H", "KH", "ms", "eager_ms",
                "plain_ms", "bound_ms", "bound_by", "terms_ms",
                "library_ms", "tflops", "bound_share")},
            **({"first_design_ms": t["first_design_ms"],
                "first_design_max_abs_err": max(
                    c["max_abs_err"] for c in first),
                "first_design_row_rel_err": max(
                    c["row_rel_err"] for c in first)} if first else {}),
            "library": "scaled_dot_product_attention"})
    emit({"kernels": summary})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": count}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
