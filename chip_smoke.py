#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (built for an H100).

    python3 chip_smoke.py [--out results.json]

Needs one CUDA device, ``nvcc`` and the checkout this file lies in; no
network.  Imports nothing of JAX or of the JAX package.  Phases, each of
which ends the run with a non-zero exit code if it fails:

1. device: ``nvidia-smi`` name and power limit, torch / CUDA / nvcc versions;
2. build: the six CUDA sources, from ``src/repro_torch/kernels/csrc``;
3. kernels: each kernel against its plain PyTorch version on the card, at
   every shape one EdgeNeXt-S forward gives it at batch 16 and at ragged /
   odd / bfloat16 cases (fused_ibn also at the four batch-1 shapes, at
   RWKV-6's channel mix in bfloat16, M = 4 x 512, D = 2048, F = 7168,
   relu^2, which the model leaves to two library products, and at cases
   that split F over the grid with a ragged last tile, M = 1 and gated
   bfloat16; each fused_ibn record carries ``splits`` and ``ctas`` from
   ``kernels.fused_ibn.plan``), ``|a-b| <= tol + tol*|b|`` with tol 3e-5 for
   float32 (2e-4 attention and WKV, the JAX tests' own) and 2e-2 for
   bfloat16: float32 sums taken in another order, bfloat16 rounding of
   the result.  ``matmul_ln`` is on no model forward: it runs at the three
   EdgeNeXt-S shapes the scheduler lowers at batch 16 (M = 16384 / 4096 /
   1024, K = N = 96 / 160 / 304), the two LM widths it lowers (512 x 2048
   -> 2048, 448 x 2560 -> 2560), two ragged cases, bfloat16 cases (also
   at 512 x 2048 -> 2048) and two calls at 448 x 2560 -> 2560 that must
   give the same bits, each with the blocks ``search.lower`` gives that
   shape.  The kernel splits N over a thread-block cluster of up to 8
   blocks, takes the row statistics through distributed shared memory in
   rank order and multiplies in 3xTF32 (float32) or bf16 on the tensor
   cores; each matmul_ln record, here and in the lowered phase, carries
   ``splits`` and ``ctas`` from ``kernels.matmul_ln.plan``.
   ``flash_attention`` runs at the three XCA shapes of a batch-16 forward
   (in the sums) and of a batch-1 forward (timed, outside the sums), at
   causal, windowed, ragged and bfloat16 cases, at Sk = 128 and 129 (the
   boundary of its whole-row regime), with D shared out unevenly over
   the cluster, with rows that see no key, and twice at 64 x 40 x 256,
   where the two calls must give the same bits; then, in the online
   regime, the dense path's prefill shapes (timed, outside the sums:
   h2o-danube-1.8b 4 x 32 x 512 and 1 x 32 x 4608 under a window of 4096,
   D 80, K / V made on 8 heads and repeated over 32; olmo-1b 4 x 16 x 512,
   D 128; bfloat16, causal; the operations bound counts only the unmasked
   q.k pairs, the library call is SDPA with ``is_causal`` or a boolean
   mask), the encoder-decoder's (timed, outside the sums: the Seamless
   encoder, 4 x 16 x 512 and 1 x 16 x 1500, and the cross-attention of one
   decoder token against 512 and 1500 frames; bfloat16, D 64, non-causal,
   SDPA with ``is_causal=False``), qwen3-moe's 32 / 4 heads at D 128, the
   decoder's first token (Sq = Sk = 1, whole rows), a float32 cross-
   attention 1 -> 700, the 1500-frame encoder twice with the same bits,
   RecurrentGemma's local attention (timed, outside the sums, 8 launches
   a prefill: 10 query heads over 1 KV head at D 256, bfloat16, causal, at
   4 x 512, at 1 x 4608 under the window of 2048 and at a ragged 1 x 700;
   the build's ``ptxas`` registers and spill bytes of each online instance
   are printed after the build),
   a float32 causal 1 x 4 x 300 (ragged against the 64-row tile),
   minitron-4b's 24 / 8 heads at D 128, a causal bf16 prompt of the
   whole-row regime, D chunked over the grid, and twice at the served
   shape, where the two calls must give the same bits; each record, here
   and in the lowered phase, carries ``regime``, ``splits``,
   ``row_splits`` and ``ctas`` from ``kernels.flash_attention.plan``.
   ``depthwise_conv2d`` runs at the nine shapes of a batch-16 forward (in
   the sums) and of a batch-1 forward (timed, outside the sums), the first
   SDTA split of a stage as the channel slice the model hands over, and at
   the generic instance's sizes (4 x 2, 1 x 1, 11 x 11), a 3 x 5 image under
   7 x 7, C = 1 and 3, the stage-3 cascade slice at channel 54 of 160 in
   float32 and bfloat16, and twice at 16 x 16 x 16 x 160 under 7 x 7, where
   the two calls must give the same bits; each record carries ``th``,
   ``tw``, ``cb``, ``cv``, ``ctas`` and ``smem`` from
   ``kernels.depthwise_conv.plan``.
   ``wkv_chunked`` runs at RWKV-6's served prefill shape (B*H = 4*32,
   T = 512, K = V = 64, chunk 64; bfloat16 r/k/v with float32 logw and u,
   and a float32 copy), the B = 1 x 200 prompt's shape (32 x 200, bf16),
   every pow2 chunk 8..256 at T = 512, the JAX tests' ragged T / chunk
   50/16, 33/8, 100/64, T < chunk (50 / 64), RecurrentGemma's K = 1,
   V = 2560, T = 448 at chunks 64 and 256, decays at the extremes
   (-exp(N(2.5, 1)), 0, -1e-6; float32 and bf16) and twice at the served
   shape, where the two calls must give the same bits; each record
   carries the outputs pass's plan from ``kernels.rwkv_chunk.plan``
   (``wv``, ``warps``, ``rows``, ``ctas``) and the states pass's
   blocks (``states_ctas``), and, where timed, the bytes of the float32
   workspace of entering states (written once, read once).  Each
   is timed with CUDA events, one pair around each call, the L2 cache
   flushed before each, median of the repeats: the kernel, the plain
   version, and a library call of the same function as a yardstick the
   port never uses (none for WKV: no single PyTorch call computes it);
4. main path, EdgeNeXt-S: full width and depth (256x256x3, dims
   48/96/160/304, depths 3/3/9/3, 1000 classes, float32, seeded random
   weights) answers 4 requests of 16 images and 2 of 1 through
   ``serve_edgenext.serve``.  The launch counters are set to 0 just before
   and read just after: 18 fused_ibn, 21 depthwise, 3 attention launches a
   forward.  Logits must be finite, [B, 1000], within 2e-3 of the same
   model run with the plain versions on the card, and for one single-image
   request within 2e-3 of the plain model on the CPU.  Then the same model
   as ``runtime.capture.captured(model)`` (``edgenext_captured``): captured
   at B = 16 and at B = 1 on images of its own, the counters set to 0
   before each capture and read after it: 18 / 21 / 3 for the capture and
   as many for each of the ``WARMUP`` eager forwards before it; then the
   six requests and one more single image replayed (four fresh batches at
   B = 16, three at B = 1): no counter moves, and the logits equal the
   eager ones bit for bit and are within 2e-3 of the plain model's;
   request ms of both forms in turns (10 rounds at each batch size), by
   CUDA events and by the host's clock from the call to a synchronise; the
   peak device memory of a request in each form and the memory the
   capture reserved;
5. main path, RWKV-6 1.6B (``rwkv6_path``): full width and depth (24
   layers, d 2048, 32 heads of 64, d_ff 7168, vocab 65536, 1,599,873,024
   parameters), weights float32 from seed 0 made on the host with numpy
   (``params.init_params``), served as ``launch.serve`` serves it
   (bfloat16 compute): 3 requests of 4 x 512-token prompts and 1 of
   1 x 200 tokens (ragged at chunk 64), each followed by 32 greedy tokens.
   Around each prefill and each decode loop the counters are set to 0 and
   read: 24 wkv_chunked launches a prefill, none in decode, no other
   kernel.  Checks: the float32 model (same weights) against itself on
   ``ref.PLAIN`` on the card, one 4 x 512 prefill and 8 decode steps
   (last hidden state, WKV states, logits within 2e-3 (1 + |b|)); the
   served bfloat16 run against the plain bfloat16 model, teacher-forced
   with the served tokens (``BF16_LOGITS_TOL``, ``BF16_AGREEMENT``); one
   1 x 64 float32 request and 4 decode steps against the plain model on
   the CPU within 2e-3.  Then the steps ``launch.serve`` serves on the
   card (``launch.serve.captured_steps``, ``rwkv6_captured``): the prefill
   captured at 4 x 512 and 1 x 200 and the donated decode step at B = 4 and
   1, on prompts of their own: 24 wkv_chunked for each prefill capture and
   as many for each ``WARMUP`` run, none for a decode capture; the four
   requests replayed move no counter and give the eager steps' last
   hidden state, prefill cache, every step's tokens and logits and last
   cache bit for bit; the bfloat16 check above on the captured requests
   too, and the float32 request through the float32 model's captured
   steps (bit for bit its eager run, within 2e-3 of the plain model);
   prefill ms (10 rounds) and decode ms a token (5 loops of 32 steps) of
   both forms in turns, both clocks; peak memory of a 4 x 512 request in
   each form, and each capture's host seconds and reserved memory.  Last,
   ``wkv_graph_edge``: one ``wkv_chunked`` call captured alone, the types of
   the graph's edges as the driver gives them (whether the outputs pass's
   programmatic dependent launch stays one in a graph), a replay on new
   inputs bit for bit the eager call, and both forms' time;
5b. dense (``dense_path``, ``lm_phase``): ``h2o-danube-1.8b`` uncut (24 layers, d 2560,
   32 query heads over 8 KV heads of 80, d_ff 6912 SwiGLU, vocab 32000,
   window 4096, 1,831,201,280 parameters), weights float32 from seed 0 made
   on the host, bfloat16 compute, served as ``launch.serve`` serves it: 2
   requests of 4 x 512-token prompts with 32 greedy tokens and 1 of a
   1 x 4608 prompt (longer than the window: the banded prefill and a ring
   cache of 4096) with 8.  Around each prefill and each decode loop the
   counters are set to 0 and read: 24 flash_attention a prefill, none in
   decode, no other kernel.  Logits finite, of their shapes, the K cache
   of the prompt's length (a ring of 4096 past the window); the first and
   the last request held to the plain model (``kernels=ref.PLAIN``)
   teacher-forced with the served tokens (``BF16_LOGITS_TOL``,
   ``BF16_AGREEMENT``).  Then the captured steps (``lm_captured``):
   captures at 4 x 512 and 1 x 4608 (24 a
   prefill capture and as many for each ``WARMUP`` run, none for decode),
   the three requests replayed bit for bit the eager steps with no
   launch; prefill ms and decode ms a token eager and captured in turns,
   both clocks; peak memory; capture seconds; the device's busy share of
   one ``torch.profiler`` trace of three captured 4 x 512 prefills;
5c. MoE (``moe_path``, ``lm_phase``): ``qwen2-moe-a2.7b`` at full width and
   8 of its 24 layers (``reduced: num_layers 24 -> 8``: every layer has the
   same shapes, and the uncut 15.1 B parameters would be 60.6 GB of float32
   made on the host; d 2048, 16 heads of 128, 60 routed experts padded to
   64, top 4, 4 shared experts, vocab 151936; 5,463,656,448 parameters),
   served as ``launch.serve`` serves it: 2 requests of 4 x 512 with 32
   greedy tokens, 1 of 1 x 200 with 16.  8 flash_attention a prefill, none
   in decode; then the captured steps, held bit for bit to the eager ones
   (as in 5b, ``lm_captured``), a trace of three captured 4 x 512 prefills;
   the first and the last request held to the plain model teacher-forced
   (``BF16_LOGITS_TOL``, ``BF16_AGREEMENT``), with the share of (token,
   choice) routings the two models agree on.  Then float32 on the first 2
   layers of the same weights: a 2 x 256 prefill and 4 greedy steps through
   the kernels, within 2e-3 (1 + |b|) of the plain model fed the same
   tokens (a routing that flips between the two moves a logit by more than
   rounding, which the bf16 limits alone would not tell apart);
5d. encoder-decoder (``audio_path``, ``lm_phase``): ``seamless-m4t-large-v2``
   uncut (24 + 24 layers, d 1024, 16 heads of 64, d_ff 8192, vocab 256206;
   1,632,358,400 parameters), frames [B, T, 1024] drawn after the tokens,
   the tokens' first column the decoder's prefix, the self cache sized
   T + gen: 2 requests of 4 x 512 frames with 32 tokens, 1 of 1 x 1500 with
   16.  72 flash_attention a prefill (24 encoder, non-causal; 24 decoder
   self, Sq = Sk = 1; 24 cross, 1 query row against the frames), none in
   decode; captured, traced and held to the plain model as in 5c.  Each of
   5c and 5d prints prefill ms and decode ms a token eager and captured,
   peak memory, capture seconds and its own wall seconds;
5e. hybrid (``hybrid_path``, ``lm_phase``): ``recurrentgemma-2b`` uncut (26
   layers in the pattern recurrent, recurrent, attention: 18 RG-LRU blocks
   and 8 local-attention blocks; d 2560, 10 query heads over 1 KV head of
   256, window 2048, GeGLU d_ff 7680, LRU width 2560, vocab 256000;
   3,549,934,080 parameters): 2 requests of 4 x 512 with 32 greedy tokens,
   1 of 1 x 4608 with 8 (past the window: the banded prefill, a ring of
   2048, the RG-LRU's doubling scan over 4608 rows).  8 flash_attention a
   prefill, none in decode; the recurrent states of their shapes and types;
   captured, traced and held to the plain model as in 5c.  Then float32 on
   the first 3 layers (recurrent, recurrent, attention) of the same
   weights: a 2 x 300 prefill and 4 greedy steps through the kernels within
   2e-3 (1 + |b|) of the plain model fed the same tokens, every cache leaf
   included;
5f. train (``train_path``, run right after 5b on its weights while they are
   on the host): ``h2o-danube-1.8b`` uncut, float32 master weights,
   bfloat16 compute with remat, ``runtime.build_train_step`` as
   ``launch.train`` builds it (AdamW, warmup 5 then cosine from lr 3e-4,
   clip 1.0) over 20 batches of 4 x 512 tokens of ``data.synthetic`` (vocab
   32000, seed 0).  First the four ``ops`` entries without a backward are
   each given a CUDA weight that requires grad: each must raise, naming its
   kernel, with its counter unchanged.  The first step's gradients
   (``build_grad_fn``) launch 24 + 24 flash_attention (the forward and
   remat's recompute) and 24 flash_attention_bwd and nothing else; against
   the same step under ``kernels=ref.PLAIN`` (both bfloat16, so they
   differ in the 24 attention calls only): loss within 1e-2, every
   gradient leaf within a relative L2 error of 5e-2, the global norm
   within 1 %; run twice, the same bits; float32 on the first 2 layers of
   the same weights: every gradient leaf within 2e-3 (1 + |b|) of the plain
   step's.  Then the 20 steps, the counters set to 0 before and read after
   (20 x 48 and 20 x 24), each timed by CUDA events and the host's clock:
   every loss and gradient norm finite, the mean loss of the last 5 steps
   below that of the first 5, peak memory; a checkpoint
   (``checkpoint.save_checkpoint``) after step 10, restored
   (``checkpoint.restore``) into fresh tensors once the run is over, must
   give steps 10-19 again bit for bit (losses, gradient norms, and the
   final parameters and moments by digest).  Step ms is the median of the
   last 10; tokens/s = 2048 / step;
6. lowered (the scheduler's path): ``auto_schedule`` of every registered
   workload, each schedule verified by ``repro_torch.check.verify_schedule``
   (the static checker and the Hopper launch lint; any finding fails the
   run and names the workload, code and key), and only then every
   ``lowered`` entry launched at the layer's true
   shapes with exactly the emitted ``block_*`` or ``chunk``
   (fused_ibn: M = b*ox*oy, D = c*fx*fy, F = k, Do = the projection's k;
   matmul_ln: M, K = c*fx*fy, N = k; flash_attention: B*H = b, Sq = ox,
   D = c, Sk = the softmax extent, non-causal; rwkv_chunk: BH = b, T =
   ox, K = c, V = k), each distinct (kernel, shapes, blocks) once,
   against its plain version with the tolerances above.  The launch
   counters are set to 0 before and read after: every kernel but the
   depthwise convolution (which is not lowered) launches here, matmul_ln
   only here; an entry whose kernel is not ported fails the run.  Then
   the checker is held to the kernels (``check_phase``): the mutation
   corpus (``check.mutations.run_corpus``) must catch 21 of 21, and for
   each kernel with a block menu (fused_ibn, flash_attention, matmul_ln)
   one emitted entry takes the corpus's ``oversize_block`` and
   ``non_pow2_block`` corruptions; the lint must flag each with
   ``lint.block_menu`` and the ``ops`` entry point must refuse it on
   CUDA tensors at the entry's launch shape with its launch counter
   unchanged.  ``rwkv_chunk`` at a chunk other than min(CHUNK, T) must
   be a ``lint.scan_chunk`` finding; ``ops.wkv_chunked`` runs any chunk
   (C = min(chunk, T) is a run-time argument of the kernel), so it is not
   asked to refuse it.  A lint finding that ``ops`` accepts, or the other
   way round, fails the run;
7. serve (``serve_phase``), the schedule store of ``repro_torch.serve``
   on the card's host: (1) a ``ServeStore(verify=True)`` warms EdgeNeXt-S
   and RWKV-6 at batch levels 1, 4, 16 and 64 over a pool of 4 spawned
   processes while this process holds the card's context: 8 entries, 8
   searched, no worker failed; (2) a fresh store on the same directory
   answers all 8 requests from disk (one ``cache.hit`` and one
   ``check.pass`` each, 0 findings), then from memory, and a store
   without the checker from disk: each hit timed on the host clock; (3)
   every lowered entry of the EdgeNeXt-S answers that the lowered phase
   did not run (deduplicated on kernel, launch shape and blocks across
   both phases: the batch-16 and batch-64 shapes) launched once against
   its plain version with the tolerances above, the counters set to 0
   before and read after, then each timed as phase 3 times a shape; a
   degraded answer is never launched, and RWKV-6's answers are verified
   only; (4) a chaos session (``serve.chaos_session``, every fault at 0.3
   with crashes that outlast the store's three search attempts, seed 0)
   over 24 EdgeNeXt-S requests at batches 1 and 4 on a store of its own:
   every request served, every answer verified (a degraded one with its
   marker), and no launch while it runs;
8. one JSON line ``{"check": {...}}`` (findings by workload, the corpus
   caught, the agreement cases), one JSON line ``{"kernels": [...]}``,
   the device line, and last ``{"ok": true, "device": {...}}``.

Per kernel the JSON line sums over one forward: ``ms``, ``plain_ms``,
``library_ms`` and ``bound_ms`` are each the sum over the forward's
launches of that kernel (per-shape time x how often the shape occurs):
a batch-16 EdgeNeXt-S forward for the first three, once each of the
three EdgeNeXt-S shapes matmul_ln is lowered at, and one 4 x 512 RWKV-6
prefill (24 launches at the served shape) for wkv_chunked, one train step
(24 launches at 4 x 32 x 512 x 80) for flash_attention_bwd; ``shapes``
holds the per-shape numbers.  ``launches`` is the count of the path the
kernel is on: the EdgeNeXt-S requests for the first three, the lowered
phase for matmul_ln, the RWKV-6 requests for wkv_chunked, the 20 train
steps for flash_attention_bwd (``launches_by_path`` has all nine paths:
the dense, MoE, encoder-decoder and hybrid requests as ``dense_serve``,
``moe_serve``, ``audio_serve`` and ``hybrid_serve``, the train steps as
``dense_train``, the serve phase's new launches as ``serve_store``).
The backward is held to autograd of ``ref.attention_ref`` (2e-3 (1 + |b|)
float32, 2e-2 bfloat16) at the trained heads (h2o 80, olmo 128,
Seamless 64 self and cross, RecurrentGemma 256), its ``library_ms`` is
SDPA's backward and each of its records also times the forward with and
without its lse; its operations are five products of 2 Sq Sk D over the
unmasked pairs.  ``bound_ms`` is the larger
of bytes / 3.35 TB/s (each input read once, each output written once)
and operations / peak: 495 TFLOP/s (TF32 tensor cores, the card's rate
for a float32 matrix product) for the products of fused_ibn, attention,
matmul_ln and WKV (2 * ``core.workload.scan_macs`` at the run's chunk;
its sums are float32 whatever the input type), 67 TFLOP/s (float32
outside the tensor cores) for the depthwise convolution, which has no
matrix product; 989 TFLOP/s for bfloat16 products.  The matrix
products' shapes also carry ``bound_fp32_cuda_core_ms``, the same bound
at 67 TFLOP/s, the rate of the exact float32 multiply-adds attention's
online regime runs (fused_ibn, matmul_ln, attention's whole-row regime
and WKV run 3xTF32 on the tensor cores: three TF32 products for each one
counted here).
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import dataclasses
import json
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402
from torch.utils import _pytree as pytree  # noqa: E402

from repro_torch import obs  # noqa: E402
from repro_torch.check import lint_doc, verify_schedule  # noqa: E402
from repro_torch.check.mutations import MUTATIONS, run_corpus  # noqa: E402
from repro_torch.checkpoint import restore, save_checkpoint  # noqa: E402
from repro_torch.configs import ShapeConfig, get_config  # noqa: E402
from repro_torch.configs.edgenext_s import CONFIG  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels import depthwise_conv as dw_mod  # noqa: E402
from repro_torch.kernels import flash_attention as fa_mod  # noqa: E402
from repro_torch.kernels import flash_attention_bwd as fab_mod  # noqa: E402
from repro_torch.kernels import fused_ibn as ibn_mod  # noqa: E402
from repro_torch.kernels import matmul_ln as mln_mod  # noqa: E402
from repro_torch.kernels import rwkv_chunk as wkv_mod  # noqa: E402
from repro_torch.launch import serve as lm_serve  # noqa: E402
from repro_torch.models import (edgenext, recurrentgemma, rwkv6,  # noqa: E402
                                seamless, transformer)
from repro_torch.models import layers as lm_layers  # noqa: E402
from repro_torch.data.synthetic import make_dataset  # noqa: E402
from repro_torch.models.params import (count_params, init_params,  # noqa: E402
                                       tree_leaves, tree_map)
from repro_torch.optim import adamw_init, warmup_cosine  # noqa: E402
from repro_torch.runtime import (build_decode_step, build_grad_fn,  # noqa: E402
                                 build_prefill_step, build_train_step)
from repro_torch.runtime.capture import WARMUP, captured  # noqa: E402
from repro_torch.search import (WORKLOADS, auto_schedule,  # noqa: E402
                                get_workload, lower)
from repro_torch.core.workload import NORM, PWCONV, SCAN, Layer, scan_macs  # noqa: E402
from repro_torch.serve import (BATCH_LEVELS, ChaosPlan, ServeStore,  # noqa: E402
                               chaos_session)
from repro_torch.serve_edgenext import serve  # noqa: E402
from repro_torch.profile_edgenext import trace  # noqa: E402

MEM_BYTES_S = 3.35e12
PEAK_TF32 = 495e12
PEAK_FP32 = 67e12
PEAK_BF16 = 989e12
BATCH = 16
SEED = 0

KERNELS = {
    "fused_ibn": dict(module=ibn_mod,
                      source="src/repro_torch/kernels/csrc/fused_ibn.cu",
                      replaces="src/repro/kernels/fused_ibn.py:102"),
    "depthwise_conv2d": dict(module=dw_mod,
                             source="src/repro_torch/kernels/csrc/depthwise_conv.cu",
                             replaces="src/repro/kernels/depthwise_conv.py:42"),
    "flash_attention": dict(module=fa_mod,
                            source="src/repro_torch/kernels/csrc/flash_attention.cu",
                            replaces="src/repro/kernels/flash_attention.py:86"),
    "matmul_ln": dict(module=mln_mod,
                      source="src/repro_torch/kernels/csrc/matmul_ln.cu",
                      replaces="src/repro/kernels/matmul_ln.py:70"),
    "wkv_chunked": dict(module=wkv_mod,
                        source="src/repro_torch/kernels/csrc/wkv_chunked.cu",
                        replaces="src/repro/kernels/rwkv_chunk.py:88"),
    "flash_attention_bwd": dict(module=fab_mod,
                                source="src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
                                replaces="src/repro/models/attention.py:111"),
}
# the path whose run gives each kernel's ``launches``: the EdgeNeXt-S
# forward launches the first three, the RWKV-6 prefill wkv_chunked, and
# matmul_ln runs only on the lowered path (flash_attention also runs on the
# dense path: ``launches_by_path``), the attention backward only in training
MAIN_PATH = {"fused_ibn": "edgenext_serve", "depthwise_conv2d": "edgenext_serve",
             "flash_attention": "edgenext_serve", "matmul_ln": "lowered",
             "wkv_chunked": "rwkv6_serve", "flash_attention_bwd": "dense_train"}
# lowered kernel name -> the kernel that runs it
LOWERED = {"fused_ibn": "fused_ibn", "flash_attention": "flash_attention",
           "matmul_ln": "matmul_ln", "rwkv_chunk": "wkv_chunked"}

# RWKV-6 traffic: (batch, prompt tokens) per request, greedy tokens each
# the serve phase: the store warms these workloads at every batch level over
# a pool of SERVE_JOBS spawned processes, and launches the lowered entries of
# SERVE_LAUNCHED's answers; its chaos session arms every fault at 0.3, with
# crashes that outlast the store's three search attempts, so that some
# answers come off the degraded rungs
SERVE_WORKLOADS = ("edgenext-s", "rwkv6")
SERVE_LAUNCHED = "edgenext-s"
SERVE_JOBS = 4
CHAOS_PLAN = "all=0.3,crash_attempts=3"
CHAOS_REQUESTS = 24
CHAOS_BATCHES = (1, 4)
RWKV_REQUESTS = [(4, 512)] * 3 + [(1, 200)]
RWKV_GEN = 32
RWKV_PARAMS = 1_599_873_024
# the dense phase: h2o-danube-1.8b uncut, (batch, prompt tokens, greedy
# tokens) per request; the 1 x 4608 prompt is longer than the window (4096):
# the banded prefill and a ring cache
DENSE_ARCH = "h2o-danube-1.8b"
DENSE_REQUESTS = [(4, 512, 32), (4, 512, 32), (1, 4608, 8)]
DENSE_PARAMS = 1_831_201_280
# the MoE phase: qwen2-moe-a2.7b at full width and MOE_LAYERS of its 24
# layers (every layer has the same shapes; uncut, its 15.1 B parameters are
# 60.6 GB of float32 made on the host); its float32 check: (layers, batch,
# prompt tokens, greedy steps)
MOE_ARCH = "qwen2-moe-a2.7b"
MOE_LAYERS = 8
MOE_REQUESTS = [(4, 512, 32), (4, 512, 32), (1, 200, 16)]
MOE_PARAMS = 5_463_656_448
MOE_F32 = (2, 2, 256, 4)
# the encoder-decoder phase: seamless-m4t-large-v2 uncut; (batch, source
# frames, greedy tokens) per request, the decoder's prefix one token
AUDIO_ARCH = "seamless-m4t-large-v2"
AUDIO_REQUESTS = [(4, 512, 32), (4, 512, 32), (1, 1500, 16)]
AUDIO_PARAMS = 1_632_358_400
# the hybrid phase: recurrentgemma-2b uncut; (batch, prompt tokens, greedy
# tokens) per request; the 1 x 4608 prompt is longer than the window (2048):
# the banded prefill, a ring cache of 2048, the scan over 4608 rows; its
# float32 check: (layers, batch, prompt tokens, greedy steps), the first
# three layers (recurrent, recurrent, attention) of the served weights
HYBRID_ARCH = "recurrentgemma-2b"
HYBRID_REQUESTS = [(4, 512, 32), (4, 512, 32), (1, 4608, 8)]
HYBRID_PARAMS = 3_549_934_080
HYBRID_F32 = (3, 2, 300, 4)
# the training phase: the dense phase's weights (h2o-danube-1.8b uncut) as
# float32 masters, bfloat16 compute with remat, TRAIN_STEPS steps of
# ``build_train_step`` as ``launch.train`` builds it over (batch, tokens)
# from ``data.synthetic``; a checkpoint after TRAIN_CKPT steps, restored
# into fresh tensors, must give the rest of the run bit for bit; the float32
# check on the first TRAIN_F32_LAYERS layers.  The first step's gradients
# against the plain step's (both bfloat16; they differ in the 24 attention
# calls only): each leaf within a relative L2 error of TRAIN_GRAD_REL, the
# loss within TRAIN_LOSS_TOL, the global norm within TRAIN_NORM_REL.
TRAIN_STEPS = 20
TRAIN_BATCH = (4, 512)
TRAIN_LR, TRAIN_WARMUP, TRAIN_CLIP = 3e-4, 5, 1.0
TRAIN_CKPT = 10
TRAIN_F32_LAYERS = 2
TRAIN_GRAD_REL, TRAIN_LOSS_TOL, TRAIN_NORM_REL = 5e-2, 1e-2, 1e-2
# The served bfloat16 run against the plain bfloat16 model, teacher-forced
# with the served tokens.  The two differ only in the WKV: the kernel and
# ``wkv_ref`` take the same float32 sums in another order and round them to
# bfloat16 (2^-8 relative) at one place, so single-ulp flips of the WKV
# output enter each of 24 residual layers.  Logits here are O(1) (|logits|
# <= ~6 on random weights): a logit that moves by more than BF16_LOGITS_TOL
# (a few percent of that range) is a fault, not rounding.  Greedy tokens
# may flip where the top two logits are closer than the noise, so
# BF16_AGREEMENT asks for most, not all, of them.
BF16_LOGITS_TOL = 0.25
BF16_AGREEMENT = 0.75


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def run_text(cmd: list[str]) -> str:
    return subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True, check=True, timeout=120).stdout.strip()


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

_flush = None


def time_ms(fn, reps: int = 10, warmup: int = 3) -> float:
    """Median device time of ``fn()``: one event pair around each call,
    the 50 MB L2 cache flushed (a 256 MB buffer zeroed) before each."""
    global _flush
    if _flush is None:
        _flush = torch.empty(256 * 1024 * 1024, dtype=torch.int8, device="cuda")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        _flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def both_clocks(fn):
    """(fn(), CUDA-event ms, host wall ms from the call to a synchronise)."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    return out, start.elapsed_time(end), wall


def alternate(forms: dict, rounds: int, per: int = 1) -> dict:
    """Each of ``forms`` (name -> fn) once a round, in turns whose order
    flips every round, under inference mode -> per form the medians of
    both clocks (each divided by ``per``), their difference (the host's
    time outside the device's span) and every reading."""
    names = list(forms)
    got = {n: ([], []) for n in names}
    with torch.inference_mode():
        for r in range(rounds):
            for n in (names if r % 2 == 0 else names[::-1]):
                _, ev, wall = both_clocks(forms[n])
                got[n][0].append(ev / per)
                got[n][1].append(wall / per)
    out = {}
    for n, (ev, wall) in got.items():
        e, w = statistics.median(ev), statistics.median(wall)
        out[n] = dict(event_ms=e, wall_ms=w, wall_minus_event_ms=w - e,
                      event_ms_all=ev, wall_ms_all=wall)
    return out


def peak_mib(fn) -> float:
    """Peak device memory allocated over ``fn()`` (inference mode), MiB."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() / 2 ** 20


def capture_counted(fn) -> tuple:
    """Runs ``fn()`` (a first call that captures) with the launch counters
    set to 0 before and read after -> (its result, the counts, MiB the
    caching allocator reserved for it: the graph's pool and its static
    buffers)."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_reserved()
    reset_counts()
    out = fn()
    counts = read_counts()
    return out, counts, (torch.cuda.memory_reserved() - before) / 2 ** 20


def first_difference(got: list, want: list) -> str | None:
    """None if each pair is bit for bit equal (shape, dtype, bits); else
    which pair differs first and by how much."""
    for i, (g, w) in enumerate(zip(got, want, strict=True)):
        if g.shape != w.shape or g.dtype != w.dtype:
            return f"#{i}: {tuple(g.shape)} {g.dtype} against {tuple(w.shape)} {w.dtype}"
        if not torch.equal(g, w):
            d = (g.float() - w.float()).abs().max().item()
            return f"#{i} {tuple(g.shape)}: max |difference| {d:.3e}"
    return None


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def bound(bytes_moved: int, flops: float, peak: float) -> tuple[float, str]:
    t_bytes = bytes_moved / MEM_BYTES_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def online_ptxas(log: str) -> dict:
    """``ptxas -v``'s registers and spill bytes of each ``online_kernel``
    instance: "float32 128" / "bf16 256" -> (registers, spill stores, spill
    loads)."""
    out, name, spill = {}, None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)", line)
        if m:
            if m.group(1) != name:
                spill = (0, 0)
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        inst = name and re.search(r"online_kernelI(f|13__nv_bfloat16)Li(\d+)E", name)
        if m and inst:
            key = f"{'float32' if inst.group(1) == 'f' else 'bf16'} {inst.group(2)}"
            out[key] = (int(m.group(1)), *spill)
    return dict(sorted(out.items()))


def reset_counts() -> None:
    torch.cuda.synchronize()
    for info in KERNELS.values():
        info["module"].launches = 0


def read_counts() -> dict:
    torch.cuda.synchronize()
    return {name: info["module"].launches for name, info in KERNELS.items()}


def compare(name: str, got: torch.Tensor, want: torch.Tensor, tol: float) -> float:
    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != want.dtype:
        fail(f"{name}: got {tuple(got.shape)} {got.dtype}, "
             f"want {tuple(want.shape)} {want.dtype}")
    g, w = got.float(), want.float()
    if not torch.isfinite(g).all():
        fail(f"{name}: kernel output not finite")
    err = (g - w).abs()
    if not bool((err <= tol + tol * w.abs()).all()):
        fail(f"{name}: disagrees with the plain version, max abs err "
             f"{err.max().item():.3e} at tolerance {tol}")
    return err.max().item()


# ---------------------------------------------------------------------------
# inputs (numpy, from a seed) and the per-kernel cases
# ---------------------------------------------------------------------------

_rng = np.random.default_rng(SEED)


def randn(*shape, scale: float = 1.0, dtype=torch.float32) -> torch.Tensor:
    a = (_rng.standard_normal(shape, dtype=np.float32) * scale)
    return torch.from_numpy(a).to(dtype).cuda()


def ibn_library(x, w1, w2, wg, act):
    """The same function as two library products around the activation."""
    act_fn = {"gelu": lambda t: F.gelu(t, approximate="tanh"), "silu": F.silu,
              "relu2": lambda t: torch.square(torch.relu(t))}[act]
    h = act_fn(torch.matmul(x, w1 if wg is None else wg))
    return torch.matmul(h if wg is None else h * torch.matmul(x, w1), w2)


def ibn_case(M, D, Fd, Do, *, gated=False, act="gelu", dtype=torch.float32,
             timed=False, blocks=None, w_scale=(0.1, 0.1), min_splits=1):
    x = randn(M, D, dtype=dtype)
    w1 = randn(D, Fd, scale=w_scale[0], dtype=dtype)
    w2 = randn(Fd, Do, scale=w_scale[1], dtype=dtype)
    wg = randn(D, Fd, scale=w_scale[0], dtype=dtype) if gated else None
    name = f"fused_ibn[{M}x{D}x{Fd}x{Do} {act}{' gated' if gated else ''} " \
           f"{str(dtype).split('.')[-1]}]"
    tol = 3e-5 if dtype == torch.float32 else 2e-2
    plan = ibn_mod.plan(M, Fd, Do, torch.cuda.get_device_properties(0).multi_processor_count)
    if plan["splits"] < min_splits:
        fail(f"{name}: {plan['splits']} splits, the case needs at least {min_splits}")
    got = ops.fused_ibn(x, w1, w2, wg, activation=act, **(blocks or {}))
    want = ref.fused_ibn_ref(x, w1, w2, wg, activation=act)
    rec = dict(case=name, max_abs_err=compare(name, got, want, tol), tol=tol,
               splits=plan["splits"], ctas=plan["ctas"])
    if timed:
        flops = 2.0 * M * (D * Fd * (2 if gated else 1) + Fd * Do)
        moved = nbytes(x, w1, w2, wg, got)
        peak = PEAK_TF32 if dtype == torch.float32 else PEAK_BF16
        rec["bound_ms"], rec["bound_by"] = bound(moved, flops, peak)
        rec["bound_fp32_cuda_core_ms"] = bound(moved, flops, PEAK_FP32)[0]
        rec["ms"] = time_ms(lambda: ops.fused_ibn(x, w1, w2, wg, activation=act))
        rec["plain_ms"] = time_ms(
            lambda: ref.fused_ibn_ref(x, w1, w2, wg, activation=act))
        rec["library_ms"] = time_ms(lambda: ibn_library(x, w1, w2, wg, act))
        rec["tflops"] = flops / rec["ms"] / 1e9
    return rec


def ibn_rounding_case():
    """relu2(1 + 2^-7) rounds to 1 + 2^-6 in bfloat16, so against
    w2 = [1 + 2^-6, -1] the two terms cancel exactly: the kernel rounds T to
    the input type before the second product, or it returns -6.1e-5."""
    bf16 = torch.bfloat16
    x = torch.tensor([[1.0]], dtype=bf16, device="cuda")
    w1 = torch.tensor([[1.0, 1.0078125]], dtype=bf16, device="cuda")
    w2 = torch.tensor([[1.015625], [-1.0]], dtype=bf16, device="cuda")
    got = ops.fused_ibn(x, w1, w2, activation="relu2")
    name = "fused_ibn[rounding of T, relu2 bfloat16]"
    err = compare(name, got, ref.fused_ibn_ref(x, w1, w2, activation="relu2"), 0.0)
    if got.float().item() != 0.0:
        fail(f"{name}: {got.float().item()} instead of 0")
    return dict(case=name, max_abs_err=err, tol=2e-2)


def dw_case(B, H, W, C, k, *, dtype=torch.float32, slice_of=None, timed=False,
            repeat=False):
    """``k`` is the kernel's size, or (fy, fx)."""
    fy, fx = (k, k) if isinstance(k, int) else k
    if slice_of is None:
        x = randn(B, H, W, C, dtype=dtype)
    else:   # a channel slice of a wider activation, as the SDTA cascade gives
        total, start = slice_of
        x = randn(B, H, W, total, dtype=dtype)[..., start:start + C]
    w = randn(fy, fx, C, scale=0.2, dtype=dtype)
    b = randn(C, scale=0.1, dtype=dtype)
    size = f"k{fy}" if fy == fx else f"k{fy}x{fx}"
    name = f"depthwise_conv2d[{B}x{H}x{W}x{C} {size}" \
           f"{f' slice at {slice_of[1]} of {slice_of[0]}' if slice_of else ''} " \
           f"{str(dtype).split('.')[-1]}]"
    tol = 3e-5 if dtype == torch.float32 else 2e-2
    plan = dw_mod.plan(B, H, W, C, fy, fx,
                       torch.cuda.get_device_properties(0).multi_processor_count,
                       itemsize=x.element_size(),
                       align=dw_mod.alignment(x, w, dw_mod._pixel_stride(x)))
    got = ops.depthwise_conv2d(x, w, b)
    want = ref.depthwise_conv2d_ref(x, w, b)
    rec = dict(case=name, max_abs_err=compare(name, got, want, tol), tol=tol,
               **{key: plan[key] for key in ("th", "tw", "cb", "cv", "ctas", "smem")})
    if repeat:
        again = ops.depthwise_conv2d(x, w, b)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            fail(f"{name}: two calls on the same inputs differ "
                 f"(max {(got - again).abs().max().item():.3e})")
        rec["case"] = name + " twice, same bits"
    if timed:
        flops = 2.0 * B * H * W * C * fy * fx
        rec["bound_ms"], rec["bound_by"] = bound(nbytes(x, w, b, got), flops,
                                                 PEAK_FP32)
        rec["ms"] = time_ms(lambda: ops.depthwise_conv2d(x, w, b))
        rec["plain_ms"] = time_ms(lambda: ref.depthwise_conv2d_ref(x, w, b),
                                  reps=5, warmup=1)
        x_nchw = x.permute(0, 3, 1, 2)            # channels_last memory, no copy
        w_oihw = w.permute(2, 0, 1)[:, None].contiguous()
        rec["library_ms"] = time_ms(
            lambda: F.conv2d(x_nchw, w_oihw, b, padding=(fy // 2, fx // 2), groups=C))
        rec["gbytes_s"] = nbytes(x, w, b, got) / rec["ms"] / 1e6
    return rec


def unmasked_pairs(Sq: int, Sk: int, causal: bool, window) -> int:
    """q.k pairs that no mask removes: what the operations bound counts."""
    qp = np.arange(Sq)
    hi = np.minimum(Sk - 1, qp) if causal else np.full(Sq, Sk - 1)
    lo = np.maximum(0, qp - window + 1) if window is not None else np.zeros(Sq, int)
    return int(np.maximum(0, hi - lo + 1).sum())


def sdpa_library(q, k, v, causal, window, scale):
    """The library call of the same function: SDPA causal, with a boolean
    mask where a window is set, else unmasked."""
    if window is None:
        return lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                                      scale=scale)
    Sq, Sk = q.shape[2], k.shape[2]
    qp = torch.arange(Sq, device=q.device)[:, None]
    kp = torch.arange(Sk, device=q.device)[None, :]
    mask = (qp - kp < window) & ((qp >= kp) if causal else True)
    return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=scale)


def fa_case(B, H, Sq, Sk, D, *, causal=True, window=None, scale=None,
            dtype=torch.float32, xca=False, timed=False, blocks=None,
            repeat=False, kv_heads=None):
    """``kv_heads``: k and v made with that many heads and repeated over
    the query heads' groups, as the LM's GQA hands them over."""
    q = randn(B, H, Sq, D, dtype=dtype)
    hk = kv_heads or H
    k = randn(B, hk, Sk, D, dtype=dtype).repeat_interleave(H // hk, dim=1)
    v = randn(B, hk, Sk, D, dtype=dtype).repeat_interleave(H // hk, dim=1)
    if xca:     # as the model calls it: rows L2-normalised over D, scale 1
        q = (q / q.norm(dim=-1, keepdim=True)).contiguous()
        k = (k / k.norm(dim=-1, keepdim=True)).contiguous()
    name = f"flash_attention[{B}x{H}x{Sq}x{Sk}x{D} causal={causal} " \
           f"window={window} {str(dtype).split('.')[-1]}" \
           f"{f' gqa {H}/{hk}' if kv_heads else ''}]"
    tol = 2e-4 if dtype == torch.float32 else 2e-2
    kw = dict(causal=causal, window=window, scale=scale)
    plan = fa_mod.plan(B * H, Sq, Sk, D, torch.cuda.get_device_properties(0)
                       .multi_processor_count, itemsize=q.element_size())
    got = ops.flash_attention(q, k, v, **kw, **(blocks or {}))
    want = ref.attention_ref(q, k, v, **kw)
    rec = dict(case=name, max_abs_err=compare(name, got, want, tol), tol=tol,
               regime=plan["regime"], splits=plan["splits"],
               row_splits=plan["row_splits"], ctas=plan["ctas"])
    del want
    if repeat:
        again = ops.flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            fail(f"{name}: two calls on the same inputs differ "
                 f"(max {(got - again).abs().max().item():.3e})")
        rec["case"] = name + " twice, same bits"
    if timed:
        pairs = B * H * unmasked_pairs(Sq, Sk, causal, window)
        flops = 4.0 * D * pairs
        peak = PEAK_TF32 if dtype == torch.float32 else PEAK_BF16
        rec["bound_ms"], rec["bound_by"] = bound(nbytes(q, k, v, got), flops, peak)
        rec["unmasked_pairs"] = pairs
        rec["ms"] = time_ms(lambda: ops.flash_attention(q, k, v, **kw))
        rec["plain_ms"] = time_ms(lambda: ref.attention_ref(q, k, v, **kw))
        rec["library_ms"] = time_ms(sdpa_library(q, k, v, causal, window, scale))
        rec["gbytes_s"] = nbytes(q, k, v, got) / rec["ms"] / 1e6
        rec["tflops"] = flops / rec["ms"] / 1e9
    return rec


def bwd_case(B, H, Sq, Sk, D, *, causal=True, window=None, dtype=torch.bfloat16,
             kv_heads=None, timed=False, repeat=False):
    """The attention backward kernel (``flash_attention_bwd``, given the
    forward kernel's out and lse) against autograd of ``ref.attention_ref``
    on the same inputs: dq, dk, dv within 2e-3 (1 + |b|) in float32 (the JAX
    test's tolerance) and 2e-2 in bfloat16; the forward's lse against
    ``ref.attention_fwd_lse_ref``'s within 2e-4.  Timed: the kernel, the
    plain version's backward (autograd of ``attention_ref``), SDPA's
    backward (the library call: timed only), and the forward with and
    without its lse."""
    q = randn(B, H, Sq, D, dtype=dtype)
    hk = kv_heads or H
    k = randn(B, hk, Sk, D, dtype=dtype).repeat_interleave(H // hk, dim=1)
    v = randn(B, hk, Sk, D, dtype=dtype).repeat_interleave(H // hk, dim=1)
    dout = randn(B, H, Sq, D, dtype=dtype)
    name = f"flash_attention_bwd[{B}x{H}x{Sq}x{Sk}x{D} causal={causal} " \
           f"window={window} {str(dtype).split('.')[-1]}" \
           f"{f' gqa {H}/{hk}' if kv_heads else ''}]"
    tol = 2e-3 if dtype == torch.float32 else 2e-2
    kw = dict(causal=causal, window=window)
    out, lse = fa_mod.flash_attention(q, k, v, **kw, return_lse=True)
    lse_err = compare(name + " lse", lse, ref.attention_fwd_lse_ref(q, k, v, **kw)[1],
                      2e-4)
    got = fab_mod.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    plain_out = ref.attention_ref(*leaves, **kw)
    want = torch.autograd.grad(plain_out, leaves, dout, retain_graph=timed)
    err = max(compare(f"{name} {n}", g, w, tol) for n, g, w in zip("qkv", got, want))
    rec = dict(case=name, max_abs_err=err, tol=tol, lse_err=lse_err)
    del want
    if repeat:
        again = fab_mod.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            fail(f"{name}: two calls on the same inputs differ")
        rec["case"] = name + " twice, same bits"
    if timed:
        pairs = B * H * unmasked_pairs(Sq, Sk, causal, window)
        flops = 10.0 * D * pairs        # S, dP, dV, dK, dQ: 2 D flops a pair each
        peak = PEAK_TF32 if dtype == torch.float32 else PEAK_BF16
        rec["bound_ms"], rec["bound_by"] = bound(
            nbytes(q, k, v, out, dout, lse, *got), flops, peak)
        rec["unmasked_pairs"] = pairs
        rec["ms"] = time_ms(lambda: fab_mod.flash_attention_bwd(q, k, v, out, lse,
                                                                dout, **kw))
        rec["plain_ms"] = time_ms(lambda: torch.autograd.grad(
            plain_out, leaves, dout, retain_graph=True))
        lib_out = sdpa_library(*leaves, causal, window, None)()
        rec["library_ms"] = time_ms(lambda: torch.autograd.grad(
            lib_out, leaves, dout, retain_graph=True))
        rec["fwd_ms"] = time_ms(lambda: fa_mod.flash_attention(q, k, v, **kw))
        rec["fwd_lse_ms"] = time_ms(lambda: fa_mod.flash_attention(
            q, k, v, **kw, return_lse=True))
        rec["tflops"] = flops / rec["ms"] / 1e9
    return rec


def mln_blocks(M, K, N):
    """The blocks ``search.lower`` gives a matmul_ln of these extents
    (with the search's default tiles, 64 rows and 128 columns)."""
    lk = lower.lower_matmul_ln(Layer("mac", PWCONV, k=N, c=K, ox=M),
                               Layer("ln", NORM, c=N, ox=M),
                               tile_x=64, tile_c=128)
    return lk.params


def mln_case(M, K, N, *, dtype=torch.float32, blocks=None, timed=False,
             repeat=False):
    x = randn(M, K, dtype=dtype)
    w = randn(K, N, scale=K ** -0.5, dtype=dtype)
    b = randn(N, scale=0.1, dtype=dtype)
    g = (1.0 + randn(N, scale=0.1)).to(dtype)
    be = randn(N, scale=0.1, dtype=dtype)
    blocks = blocks or mln_blocks(M, K, N)
    name = f"matmul_ln[{M}x{K}->{N} block_m={blocks['block_m']} " \
           f"block_k={blocks['block_k']} {str(dtype).split('.')[-1]}]"
    tol = 3e-5 if dtype == torch.float32 else 2e-2
    plan = mln_mod.plan(M, N, torch.cuda.get_device_properties(0).multi_processor_count,
                        block_m=blocks["block_m"])
    got = ops.matmul_ln(x, w, b, g, be, **blocks)
    want = ref.matmul_ln_ref(x, w, b, g, be)
    rec = dict(case=name, max_abs_err=compare(name, got, want, tol), tol=tol,
               splits=plan["splits"], ctas=plan["ctas"])
    if repeat:
        again = ops.matmul_ln(x, w, b, g, be, **blocks)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            fail(f"{name}: two calls on the same inputs differ "
                 f"(max {(got - again).abs().max().item():.3e})")
        rec["case"] = name + " twice, same bits"
    if timed:
        flops = 2.0 * M * N * K
        moved = nbytes(x, w, b, g, be, got)
        peak = PEAK_TF32 if dtype == torch.float32 else PEAK_BF16
        rec["bound_ms"], rec["bound_by"] = bound(moved, flops, peak)
        rec["bound_fp32_cuda_core_ms"] = bound(moved, flops, PEAK_FP32)[0]
        rec["ms"] = time_ms(lambda: ops.matmul_ln(x, w, b, g, be, **blocks))
        rec["plain_ms"] = time_ms(lambda: ref.matmul_ln_ref(x, w, b, g, be))
        rec["library_ms"] = time_ms(
            lambda: F.layer_norm(x @ w + b, (N,), g, be, 1e-6))
        rec["tflops"] = flops / rec["ms"] / 1e9
    return rec


def wkv_inputs(BH, T, K, V, dtype=torch.float32, decay="normal"):
    """r, k, v, u ~ N(0, 0.5^2), logw = -exp(N(0, 0.5^2)), as the JAX WKV
    tests draw them; r, k, v in ``dtype``, logw and u float32.  ``decay``
    "extreme": logw = -exp(N(2.5, 1)) (single steps near -40, a chunk's
    decay far past e^88), "zero": logw = 0, "tiny": logw = -1e-6."""
    r, k, v = (randn(BH, T, n, scale=0.5) for n in (K, K, V))
    logw = {"normal": lambda: -torch.exp(randn(BH, T, K, scale=0.5)),
            "extreme": lambda: -torch.exp(2.5 + randn(BH, T, K)),
            "zero": lambda: torch.zeros(BH, T, K, device="cuda"),
            "tiny": lambda: torch.full((BH, T, K), -1e-6, device="cuda")}[decay]()
    u = randn(BH, K, scale=0.5)
    return r.to(dtype), k.to(dtype), v.to(dtype), logw, u


def wkv_case(BH, T, K, V, chunk, *, dtype=torch.float32, inputs=None,
             timed=False, decay="normal", repeat=False):
    r, k, v, logw, u = inputs or wkv_inputs(BH, T, K, V, dtype, decay)
    C = min(chunk, T)
    name = f"wkv_chunked[{BH}x{T}x{K}->{V} chunk={chunk} " \
           f"{str(r.dtype).split('.')[-1]}{'' if decay == 'normal' else ' ' + decay}]"
    tol = 2e-4 if r.dtype == torch.float32 else 2e-2
    out, state = ops.wkv_chunked(r, k, v, logw, u, chunk=chunk)
    want_out, want_state = ref.wkv_ref(r, k, v, logw, u)
    err = max(compare(name, out, want_out, tol),
              compare(name + " state", state, want_state, 2e-4))
    if repeat:
        again = ops.wkv_chunked(r, k, v, logw, u, chunk=chunk)
        torch.cuda.synchronize()
        if not (torch.equal(out, again[0]) and torch.equal(state, again[1])):
            fail(f"{name}: two calls give different bits")
        name += " twice, same bits"
    p = wkv_mod.plan(BH, T, K, V, C, r.element_size(),
                     logw_itemsize=logw.element_size(),
                     sms=torch.cuda.get_device_properties(0).multi_processor_count)
    rec = dict(case=name, max_abs_err=err, tol=tol,
               **{key: p[key] for key in ("wv", "warps", "rows", "ctas",
                                          "states_ctas")})
    if timed:
        flops = 2.0 * scan_macs(Layer("wkv", SCAN, b=BH, ox=T, c=K, k=V), C)
        moved = nbytes(r, k, v, logw, u, out, state)
        rec["bound_ms"], rec["bound_by"] = bound(moved, flops, PEAK_TF32)
        rec["bound_fp32_cuda_core_ms"] = bound(moved, flops, PEAK_FP32)[0]
        # the float32 workspace of the entering states, written once by the
        # states pass and read once by the outputs pass: bytes the design
        # adds to those of the bound
        rec["workspace_bytes"] = BH * -(-T // C) * K * V * 4
        rec["ms"] = time_ms(lambda: ops.wkv_chunked(r, k, v, logw, u, chunk=chunk))
        rec["plain_ms"] = time_ms(lambda: ref.wkv_ref(r, k, v, logw, u),
                                  reps=5, warmup=1)
        rec["library_ms"] = None     # no single PyTorch call computes WKV6
        rec["gbytes_s"] = moved / rec["ms"] / 1e6
    return rec


def path_shapes(cfg, batch):
    """(kernel, arguments, launches per forward) for every shape one
    forward of ``cfg`` at ``batch`` gives each kernel."""
    ibn, dw, fa = [], [], []
    hw = cfg.img_size // 4
    for si in range(4):
        c, k = cfg.dims[si], cfg.kernel_sizes[si]
        if si:
            hw //= 2
        n_sdta = cfg.sdta_blocks[si]
        n_conv = cfg.depths[si] - n_sdta
        ibn.append(((batch * hw * hw, c + 1, cfg.expan_ratio * c, c),
                    cfg.depths[si]))
        if n_conv:
            dw.append(((batch, hw, hw, c, k, None), n_conv))
        if n_sdta:
            widths = edgenext._split_widths(c, cfg.sdta_scales[si])
            start = widths[0]
            for i, wd in enumerate(widths[1:]):
                # the first split is a channel slice of the activation, the
                # later ones are dense sums
                dw.append(((batch, hw, hw, wd, 3, (c, start) if i == 0 else None),
                           n_sdta))
                start += wd
            fa.append(((batch, cfg.heads, c // cfg.heads, hw * hw), n_sdta))
    return ibn, dw, fa


def merge_counts(items):
    """[(args, n), ...] -> the same with equal args merged."""
    out: dict = {}
    for args, n in items:
        out[args] = out.get(args, 0) + n
    return list(out.items())


def kernels_phase():
    ibn, dw, fa = path_shapes(CONFIG, BATCH)
    per_kernel = {name: dict(shapes=[], extra=[]) for name in KERNELS}

    # fused_ibn: the batch-16 shapes (in the sums), then outside the sums
    # the batch-1 shapes and RWKV-6's channel mix in bfloat16 (D = 2048,
    # F = 7168, relu^2), which the model leaves to two library products
    ibn1, _, _ = path_shapes(CONFIG, 1)
    cmix = get_config("rwkv6-1.6b")
    for (M, D, Fd, Do), n, batch, kw in (
            [(args, n, BATCH, {}) for args, n in merge_counts(ibn)]
            + [(args, 0, 1, {}) for args, _ in merge_counts(ibn1)]
            + [((RWKV_REQUESTS[0][0] * RWKV_REQUESTS[0][1], cmix.d_model, cmix.d_ff,
                 cmix.d_model), 0, RWKV_REQUESTS[0][0],
                dict(act="relu2", dtype=torch.bfloat16,
                     w_scale=(cmix.d_model ** -0.5, cmix.d_ff ** -0.5)))]):
        rec = ibn_case(M, D, Fd, Do, timed=True, **kw)
        rec.update(per_forward=n, batch=batch)
        per_kernel["fused_ibn"]["shapes"].append(rec)
    # depthwise_conv2d: the batch-16 shapes (in the sums), then the batch-1
    # ones outside the sums
    _, dw1, _ = path_shapes(CONFIG, 1)
    for (B, H, W, C, k, sl), n, batch in (
            [(args, n, BATCH) for args, n in merge_counts(dw)]
            + [(args, 0, 1) for args, _ in merge_counts(dw1)]):
        rec = dw_case(B, H, W, C, k, slice_of=sl, timed=True)
        rec.update(per_forward=n, batch=batch)
        per_kernel["depthwise_conv2d"]["shapes"].append(rec)
    # flash_attention: the batch-16 XCA shapes (in the sums), then the
    # batch-1 ones outside the sums
    _, _, fa1 = path_shapes(CONFIG, 1)
    for (B, H, S, D), n, batch in ([(args, n, BATCH) for args, n in merge_counts(fa)]
                                   + [(args, 0, 1) for args, _ in merge_counts(fa1)]):
        rec = fa_case(B, H, S, S, D, causal=False, scale=1.0, xca=True, timed=True)
        rec.update(per_forward=n, batch=batch)
        per_kernel["flash_attention"]["shapes"].append(rec)
    # ... and the dense path's prefill attention (the online regime,
    # outside the sums): h2o-danube-1.8b at 4 x 512 and at 1 x 4608 over
    # its window, olmo-1b at 4 x 512 (bfloat16, causal, GQA-expanded)
    for (B, H, S, D, window, hk), batch in (((4, 32, 512, 80, None, 8), 4),
                                            ((1, 32, 4608, 80, 4096, 8), 1),
                                            ((4, 16, 512, 128, None, None), 4)):
        rec = fa_case(B, H, S, S, D, causal=True, window=window, dtype=torch.bfloat16,
                      kv_heads=hk, timed=True)
        rec.update(per_forward=0, batch=batch)
        per_kernel["flash_attention"]["shapes"].append(rec)
    # ... and the encoder-decoder's (outside the sums): the Seamless encoder
    # at 4 x 512 and 1 x 1500 frames (non-causal, D 64, bfloat16; 1500 =
    # 23 x 64 + 28, a ragged last KV tile), and its prefill's cross-attention
    # of one decoder token (63 empty rows of a 64-row query tile) against
    # them; the library call is SDPA with ``is_causal=False``
    for (B, Sq, Sk), batch in (((4, 512, 512), 4), ((1, 1500, 1500), 1),
                               ((4, 1, 512), 4), ((1, 1, 1500), 1)):
        rec = fa_case(B, 16, Sq, Sk, 64, causal=False, dtype=torch.bfloat16,
                      timed=True)
        rec.update(per_forward=0, batch=batch)
        per_kernel["flash_attention"]["shapes"].append(rec)
    # ... and RecurrentGemma's local attention (outside the sums; each shape
    # launched once an attention block, 8 a prefill): 10 query heads over 1
    # KV head, D 256, bfloat16, causal, at the served 4 x 512, at 1 x 4608
    # under the window of 2048 (the banded prefill), and at a ragged 1 x 700
    rg_attn = get_config(HYBRID_ARCH).block_pattern.count("attention")
    for B, S, window in ((4, 512, None), (1, 4608, 2048), (1, 700, None)):
        rec = fa_case(B, 10, S, S, 256, causal=True, window=window,
                      dtype=torch.bfloat16, kv_heads=1, timed=True)
        rec.update(per_forward=0, batch=B, per_prefill=rg_attn)
        per_kernel["flash_attention"]["shapes"].append(rec)

    # matmul_ln: the EdgeNeXt-S lowered shapes at batch 16 (once each), then
    # the LM widths, ragged and bfloat16 cases (timed, outside the sums)
    mln = [((BATCH * hw * hw, c, c), 1) for hw, c in
           zip((32, 16, 8), CONFIG.dims[1:])]
    mln += [((512, 2048, 2048), 0), ((448, 2560, 2560), 0),
            ((197, 48, 160), 0), ((7, 13, 24), 0)]
    for (M, K, N), n in mln:
        rec = mln_case(M, K, N, timed=True)
        rec["per_forward"] = n
        per_kernel["matmul_ln"]["shapes"].append(rec)
    for M, K, N in ((197, 48, 160), (512, 2048, 2048)):
        rec = mln_case(M, K, N, dtype=torch.bfloat16, timed=True)
        rec["per_forward"] = 0
        per_kernel["matmul_ln"]["shapes"].append(rec)

    # wkv_chunked: the served shape once a layer (24 a prefill), bfloat16
    # r/k/v as served and a float32 copy of the same values; the B = 1 x 200
    # prompt's shape, the chunk sweep and RecurrentGemma's K = 1 shape
    # (timed, outside the sums)
    bf16 = torch.bfloat16
    served = wkv_inputs(128, 512, 64, 64)
    for dtype, n in ((bf16, rwkv6.kernel_launches_per_prefill(
            get_config("rwkv6-1.6b"))["wkv_chunked"]), (torch.float32, 0)):
        rec = wkv_case(128, 512, 64, 64, 64, timed=True, inputs=(
            *(t.to(dtype) for t in served[:3]), *served[3:]))
        rec["per_forward"] = n
        per_kernel["wkv_chunked"]["shapes"].append(rec)
    rec = wkv_case(32, 200, 64, 64, 64, dtype=bf16, timed=True)
    rec["per_forward"] = 0
    per_kernel["wkv_chunked"]["shapes"].append(rec)
    for BH, T, K, V, chunk in [(128, 512, 64, 64, c) for c in (8, 16, 32, 128, 256)] \
            + [(1, 448, 1, 2560, 64), (1, 448, 1, 2560, 256)]:
        rec = wkv_case(BH, T, K, V, chunk, timed=True)
        rec["per_forward"] = 0
        per_kernel["wkv_chunked"]["shapes"].append(rec)

    per_kernel["fused_ibn"]["extra"] = [
        ibn_case(197, 48, 160, 48),
        ibn_case(197, 48, 160, 48, gated=True, act="silu"),
        ibn_case(197, 48, 160, 48, act="relu2"),
        ibn_case(100, 64, 300, 400, gated=True, act="gelu"),   # Do over 2 blocks
        ibn_case(197, 48, 160, 48, dtype=bf16),
        ibn_case(197, 48, 160, 48, gated=True, act="silu", dtype=bf16),
        ibn_rounding_case(),
        # split F: the last share ends in a ragged F tile, a single row,
        # gated bfloat16 over several shares
        ibn_case(64, 49, 1000, 48, min_splits=2),
        ibn_case(197, 97, 330, 96, act="silu", min_splits=2),
        ibn_case(1, 305, 1216, 304, min_splits=2),
        ibn_case(64, 161, 640, 160, gated=True, act="silu", dtype=bf16, min_splits=2),
    ]
    per_kernel["matmul_ln"]["extra"] = [
        # N split unevenly over the cluster, rows far fewer than a tile
        mln_case(1024, 304, 304, blocks=dict(block_m=32, block_k=16)),
        mln_case(1, 2560, 2560), mln_case(7, 2560, 2560),
        mln_case(448, 2560, 2560, repeat=True),
    ]
    per_kernel["depthwise_conv2d"]["extra"] = [
        dw_case(1, 10, 14, 52, 5),
        dw_case(2, 9, 7, 33, 7),
        dw_case(2, 16, 16, 52, 5, dtype=bf16),
        # the generic instance (an even kernel padded as JAX pads it, 1x1,
        # 11x11), an image smaller than the kernel, one and three channels,
        # the stage-3 cascade slice (channel 54 of 160: 8-byte aligned in
        # float32, 4-byte in bf16) and two calls that must give the same bits
        dw_case(2, 10, 14, 52, (4, 2)),
        dw_case(2, 9, 7, 40, 1),
        dw_case(1, 16, 16, 24, 11),
        dw_case(2, 3, 5, 12, 7),
        dw_case(2, 9, 7, 1, 3),
        dw_case(2, 9, 7, 3, 5),
        dw_case(16, 16, 16, 54, 3, slice_of=(160, 54)),
        dw_case(16, 16, 16, 54, 3, slice_of=(160, 54), dtype=bf16),
        dw_case(16, 16, 16, 160, 7, repeat=True),
    ]
    per_kernel["flash_attention"]["extra"] = [
        fa_case(2, 2, 64, 64, 16, causal=True),
        fa_case(2, 2, 64, 128, 16, causal=True, window=24),
        fa_case(1, 2, 160, 304, 16, causal=True, window=48),
        fa_case(1, 2, 197, 197, 16, causal=False),
        fa_case(1, 2, 128, 64, 8, causal=False),
        fa_case(1, 1, 100, 40, 8, causal=True, window=10),   # rows with no key
        fa_case(1, 2, 33, 77, 1500, causal=True),            # D over 8 slices
        fa_case(1, 2, 64, 64, 32, causal=True, dtype=bf16),
        # whole rows: Sk = S_MAX and S_MAX + 1 (the regime boundary), D
        # shared out unevenly (125 units over 8) with the query rows split,
        # rows with no key, bfloat16 XCA shapes, two calls with the same bits
        fa_case(1, 2, 40, 128, 64, causal=False),
        fa_case(1, 2, 40, 129, 64, causal=False),
        fa_case(1, 4, 70, 100, 1000, causal=True),
        fa_case(1, 2, 30, 10, 24, causal=True, window=4),
        fa_case(16, 4, 24, 24, 1024, causal=False, scale=1.0, xca=True, dtype=bf16),
        fa_case(16, 4, 76, 76, 64, causal=False, scale=1.0, xca=True, dtype=bf16),
        fa_case(16, 4, 40, 40, 256, causal=False, scale=1.0, xca=True, repeat=True),
        # the online regime at the LM's shapes: float32 causal ragged against
        # the 64-row tile, minitron-4b's D = 128 over 24 / 8 heads, a prompt
        # of the whole-row regime causal in bf16, D chunked over the grid,
        # and two calls with the same bits at the served shape
        fa_case(1, 4, 300, 300, 80, causal=True),
        fa_case(4, 24, 512, 512, 128, causal=True, dtype=bf16, kv_heads=8),
        fa_case(4, 32, 100, 100, 80, causal=True, dtype=bf16, kv_heads=8),
        fa_case(1, 2, 200, 300, 300, causal=True, dtype=bf16),
        fa_case(1, 2, 150, 200, 1024, causal=False),
        fa_case(4, 32, 512, 512, 80, causal=True, dtype=bf16, kv_heads=8, repeat=True),
        # the MoE and encoder-decoder paths: qwen3-moe's 32 query heads over
        # 4 KV heads at D 128, the decoder's first causal self-attention
        # (Sq = Sk = 1, whole rows), the cross-attention in float32 at a
        # ragged Sk, and the encoder's ragged tail twice with the same bits
        fa_case(4, 32, 512, 512, 128, causal=True, dtype=bf16, kv_heads=4),
        fa_case(4, 16, 1, 1, 64, causal=True, dtype=bf16),
        fa_case(2, 16, 1, 700, 64, causal=False),
        fa_case(1, 16, 1500, 1500, 64, causal=False, dtype=bf16, repeat=True),
    ]
    per_kernel["wkv_chunked"]["extra"] = [
        wkv_case(4, 50, 64, 64, 16),             # the JAX tests' ragged T
        wkv_case(4, 33, 64, 64, 8),
        wkv_case(4, 100, 64, 64, 64),
        wkv_case(4, 50, 64, 64, 64),             # T < chunk
        wkv_case(4, 100, 8, 40, 32),             # narrow K, V off the 32-column tile
        wkv_case(4, 100, 64, 64, 64, dtype=bf16),
        # decays at the extremes: single steps near -40 (a reference at the
        # chunk's start would overflow), none, and nearly none; two calls
        # that must give the same bits
        wkv_case(4, 200, 64, 64, 64, decay="extreme"),
        wkv_case(4, 200, 64, 64, 64, dtype=bf16, decay="extreme"),
        wkv_case(4, 130, 64, 64, 64, decay="zero"),
        wkv_case(4, 130, 64, 64, 64, decay="tiny"),
        wkv_case(128, 512, 64, 64, 64, dtype=bf16, repeat=True),
    ]
    # flash_attention_bwd: the trained shape (h2o-danube-1.8b's 32 query
    # heads over 8 KV heads of 80, 4 x 512, bf16, causal; 24 a train step, in
    # the sums), then outside the sums the other trained heads: olmo-1b's
    # 128, Seamless's 64 (non-causal, and its cross-attention with Sq != Sk),
    # RecurrentGemma's MQA 256 under its window
    for (B, H, Sq, Sk, D, causal, window, hk), n in (
            ((4, 32, 512, 512, 80, True, None, 8),
             transformer.kernel_launches_per_prefill(get_config(DENSE_ARCH))
             ["flash_attention"]),
            ((4, 16, 512, 512, 128, True, None, None), 0),
            ((4, 16, 512, 512, 64, False, None, None), 0),
            ((4, 16, 256, 512, 64, False, None, None), 0),
            ((4, 10, 512, 512, 256, True, 2048, 1), 0)):
        rec = bwd_case(B, H, Sq, Sk, D, causal=causal, window=window, kv_heads=hk,
                       timed=True)
        rec.update(per_forward=n, batch=B)
        per_kernel["flash_attention_bwd"]["shapes"].append(rec)
    per_kernel["flash_attention_bwd"]["extra"] = [
        # float32: a ragged tile, the whole-row forward regime's lse (Sk <=
        # 128), D over 64 columns under a window, Sq != Sk; two calls at the
        # trained shape with the same bits
        bwd_case(1, 4, 300, 300, 72, dtype=torch.float32),
        bwd_case(2, 4, 100, 100, 64, dtype=torch.float32),
        bwd_case(1, 2, 150, 150, 256, window=40, dtype=torch.float32),
        bwd_case(1, 2, 70, 130, 80, causal=False, dtype=torch.float32),
        bwd_case(1, 2, 200, 200, 128, causal=False, window=30),
        bwd_case(4, 32, 512, 512, 80, kv_heads=8, repeat=True),
    ]
    return per_kernel


def lowered_phase():
    """Every registered workload's schedule verified by the static checker,
    then every ``lowered`` entry launched with the emitted blocks (or
    chunk) at the layer's true shapes and held against its plain version;
    identical (kernel, shapes, blocks) once.  Fails on any finding and on
    an entry whose kernel is not ported.  Returns the per-launch records,
    the entries per lowered kernel name, the entries per workload and
    lowered kernel, the launch counts, the findings per workload with the
    seconds the checker took on the host, and the first entry of each
    lowered kernel (workload, key, layers, groups, entry) for
    ``check_phase``."""
    distinct: dict = {}
    entries: dict = {name: 0 for name in LOWERED}
    by_workload: dict = {}
    findings: dict = {}
    samples: dict = {}
    verify_s = 0.0
    for wname in WORKLOADS:
        layers = get_workload(wname)
        sched = auto_schedule(layers, workload=wname)
        t0 = time.perf_counter()
        found = verify_schedule(layers, sched, source="chip_smoke")
        verify_s += time.perf_counter() - t0
        if found:
            fail(f"check: {wname} has {len(found)} findings, first "
                 f"{found[0].code} at {found[0].where}: {found[0].detail}")
        findings[wname] = len(found)
        for key, lk in sched.lowered.items():
            samples.setdefault(lk["kernel"], (wname, key, layers,
                                              sched.groups, lk))
            if lk["kernel"] not in LOWERED:
                fail(f"lowered: {wname}:{key} is lowered onto "
                     f"{lk['kernel']!r}, which no ported kernel runs")
            distinct.setdefault(launch_key(layers, key, lk), []).append(
                f"{wname}:{key}")
            entries[lk["kernel"]] += 1
            per = by_workload.setdefault(lk["kernel"], {})
            per[wname] = per.get(wname, 0) + 1

    reset_counts()
    records = []
    for dkey, where in distinct.items():
        rec = launch_entry(dkey)
        rec.update(entries=len(where), first=where[0])
        records.append(rec)
    launches = read_counts()
    for name in KERNELS:
        want = sum(1 for r in records if r["kernel"] == name)
        if launches[name] != want:
            fail(f"lowered: {name} launched {launches[name]} times for "
                 f"{want} distinct lowered launches")
        if name in LOWERED.values() and not launches[name]:
            fail(f"lowered: {name} was never launched")
    verified = dict(findings=findings, verify_s=verify_s)
    return records, entries, by_workload, launches, verified, samples, set(distinct)


def launch_key(layers, key: str, lk: dict) -> tuple:
    """(kernel, launch shape, blocks or chunk) of one lowered entry: what
    it launches, and what the lowered and serve phases dedupe on."""
    shape = lower.launch_shape(layers, key, lk)
    blocks = {k: v for k, v in lk.items() if k.startswith("block_") or k == "chunk"}
    return LOWERED[lk["kernel"]], tuple(shape.items()), tuple(sorted(blocks.items()))


def launch_entry(dkey: tuple, timed: bool = False) -> dict:
    """One lowered launch (a ``launch_key``) at the layer's true shapes with
    its blocks, held against its plain version; timed as ``kernels_phase``
    times a shape where ``timed``."""
    kern, shape, blocks = dkey
    s, blocks = dict(shape), dict(blocks)
    if kern == "fused_ibn":
        rec = ibn_case(s["m"], s["d"], s["f"], s["do"], blocks=blocks, timed=timed,
                       w_scale=(s["d"] ** -0.5, s["f"] ** -0.5))
    elif kern == "matmul_ln":
        rec = mln_case(s["m"], s["k"], s["n"], blocks=blocks, timed=timed)
    elif kern == "wkv_chunked":
        rec = wkv_case(s["bh"], s["t"], s["k"], s["v"], blocks["chunk"], timed=timed)
    else:
        rec = fa_case(1, s["bh"], s["q"], s["k"], s["d"], causal=False,
                      blocks=blocks, timed=timed)
    rec.update(kernel=kern, blocks=blocks)
    return rec


def refuse_case(kernel: str, shape: dict, blocks: dict):
    """Call the ``ops`` entry point of ``kernel`` on CUDA tensors at a
    lowered entry's launch shape with ``blocks``.  Returns the message it
    refused them with, or None where it ran; a refusal must leave the
    kernel's launch counter as it was."""
    before = read_counts()
    z = lambda *shape: torch.zeros(shape, device="cuda")  # noqa: E731
    try:
        if kernel == "fused_ibn":
            ops.fused_ibn(z(shape["m"], shape["d"]), z(shape["d"], shape["f"]),
                          z(shape["f"], shape["do"]), **blocks)
        elif kernel == "matmul_ln":
            n = shape["n"]
            ops.matmul_ln(z(shape["m"], shape["k"]), z(shape["k"], n), z(n),
                          z(n), z(n), **blocks)
        else:
            qkv = [z(1, shape["bh"], s, shape["d"])
                   for s in (shape["q"], shape["k"], shape["k"])]
            ops.flash_attention(*qkv, causal=False, **blocks)
    except ValueError as e:
        if read_counts() != before:
            fail(f"check: ops.{kernel} refused {blocks} after launching")
        return str(e)
    torch.cuda.synchronize()
    return None


def check_phase(samples: dict) -> dict:
    """The checker held to the kernels: the mutation corpus must catch all
    of its corruptions, and the lint and the ``ops`` entry points must
    agree on the corpus's off-menu blocks (see the module docstring,
    phase 6).  Fails on anything else.  Returns the corpus result, the
    agreement cases and the seconds the phase took on the host."""
    t0 = time.perf_counter()
    results, base = run_corpus()
    dirty = {w: [f.code for f in fs] for w, fs in base.items() if fs}
    if dirty:
        fail(f"check: corpus base artifacts not clean: {dirty}")
    missed = [r.mutation for r in results if not r.caught]
    if missed:
        fail(f"check: mutations not caught: {missed}")
    by_name = {m.name: m for m in MUTATIONS}
    cases = []
    for kernel in ("fused_ibn", "flash_attention", "matmul_ln"):
        wname, key, layers, groups, lk = samples[kernel]
        shape = lower.launch_shape(layers, key, lk)
        for mutation in ("oversize_block", "non_pow2_block"):
            doc = {"groups": [list(g) for g in groups],
                   "lowered": {key: json.loads(json.dumps(lk))}}
            if not by_name[mutation].apply(doc, layers):
                fail(f"check: {mutation} did not apply to {wname}:{key}")
            entry = doc["lowered"][key]
            codes = sorted({f.code for f in lint_doc(doc, layers)})
            blocks = {k: v for k, v in entry.items() if k.startswith("block_")}
            refused = refuse_case(kernel, shape, blocks)
            if "lint.block_menu" not in codes:
                fail(f"check: the lint passes {kernel} {blocks} at "
                     f"{wname}:{key} (codes {codes})")
            if refused is None:
                fail(f"check: disagreement: the lint flags {kernel} {blocks} "
                     f"at {wname}:{key} ({codes}), ops.{kernel} ran it")
            cases.append(dict(kernel=kernel, entry=f"{wname}:{key}",
                              mutation=mutation, blocks=blocks, lint=codes,
                              ops_refused=True, launches_unchanged=True))
    wname, key, layers, groups, lk = samples["rwkv_chunk"]
    off = dict(json.loads(json.dumps(lk)), chunk=2 * max(lk["chunk"], 1))
    doc = {"groups": [list(g) for g in groups], "lowered": {key: off}}
    codes = sorted({f.code for f in lint_doc(doc, layers)})
    if "lint.scan_chunk" not in codes:
        fail(f"check: the lint passes rwkv_chunk at chunk {off['chunk']} "
             f"at {wname}:{key} (codes {codes})")
    cases.append(dict(kernel="rwkv_chunk", entry=f"{wname}:{key}",
                      mutation="chunk", blocks={"chunk": off["chunk"]},
                      lint=codes, ops_refused=None,
                      note="ops.wkv_chunked runs any chunk"))
    return dict(corpus=dict(caught=sum(r.caught for r in results),
                            total=len(MUTATIONS)),
                agreement=cases, check_phase_s=time.perf_counter() - t0)


class RecordingStore(ServeStore):
    """A ``ServeStore`` that keeps every answer its ``request`` gives, so
    that each answer of a chaos session can be verified after it."""

    def __init__(self, *args, **kw) -> None:
        super().__init__(*args, **kw)
        self.answers = []

    def request(self, *args, **kw):
        res = super().request(*args, **kw)
        self.answers.append(res)
        return res


def host_ms(fn) -> tuple:
    """(fn(), host milliseconds it took)."""
    t0 = time.perf_counter()
    out = fn()
    return out, (time.perf_counter() - t0) * 1e3


def serve_phase(launched: set) -> tuple[dict, dict]:
    """The schedule store on the card's host (module docstring, phase 7).
    ``launched`` holds the ``launch_key``s the lowered phase ran.  Fails on
    any miss.  Returns the launch counts of step 3 and the phase's record."""
    root = ROOT / "build" / "serve_store"
    shutil.rmtree(root, ignore_errors=True)
    grid = [(w, b) for w in SERVE_WORKLOADS for b in BATCH_LEVELS]

    # 1. warm over a spawned pool while this process holds the card's context
    if not torch.cuda.is_initialized():
        fail("serve: the card's context should be live before the warm")
    store = ServeStore(root / "store", verify=True)
    with obs.tracing() as tr:
        rep, warm_ms = host_ms(lambda: store.warm(SERVE_WORKLOADS, batches=BATCH_LEVELS,
                                                  jobs=SERVE_JOBS))
    warm = dict(entries=len(rep.entries), searched=rep.searched,
                worker_failed=rep.worker_failed, jobs=SERVE_JOBS, seconds=warm_ms / 1e3,
                counters=dict(tr.counters))
    if (warm["entries"], warm["searched"], warm["worker_failed"]) != (len(grid), len(grid), 0):
        fail(f"serve: warm gave {warm['entries']} entries, {warm['searched']} searched, "
             f"{warm['worker_failed']} workers failed; want {len(grid)}, {len(grid)}, 0")

    # 2. a fresh store on the same directory answers every request from disk,
    # each answer verified; then the same request from memory, and the same
    # replay without the checker
    fresh, bare = ServeStore(root / "store", verify=True), ServeStore(root / "store")
    answers, disk_ms, mem_ms, bare_ms = {}, [], [], []
    for w, b in grid:
        with obs.tracing() as tr:
            res, ms = host_ms(lambda: fresh.request(w, b))
        layers = get_workload(res.workload)
        found = verify_schedule(layers, res.schedule, source="chip_smoke")
        hits = (tr.counters.get("cache.hit", 0), tr.counters.get("check.pass", 0),
                tr.counters.get("cache.miss", 0))
        if res.outcome != "disk" or res.degraded or hits != (1, 1, 0) or found:
            fail(f"serve: {res.workload} answered {res.outcome!r} (degraded "
                 f"{res.degraded}), cache.hit/check.pass/cache.miss {hits}, "
                 f"{len(found)} findings; want a verified disk hit")
        disk_ms.append(ms)
        again, ms = host_ms(lambda: fresh.request(w, b))
        if again.outcome != "mem":
            fail(f"serve: {res.workload} again answered {again.outcome!r}, not from memory")
        mem_ms.append(ms)
        plain, ms = host_ms(lambda: bare.request(w, b))
        if plain.outcome != "disk":
            fail(f"serve: {res.workload} answered {plain.outcome!r} without the checker")
        bare_ms.append(ms)
        answers[(w, b)] = (layers, res)
    disk = dict(requests=len(grid), disk_hits=len(disk_ms), findings=0,
                disk_hit_ms=statistics.median(disk_ms), disk_hit_ms_max=max(disk_ms),
                disk_hit_unverified_ms=statistics.median(bare_ms),
                mem_hit_ms=statistics.median(mem_ms), mem_hit_ms_max=max(mem_ms))

    # 3. the lowered entries of the EdgeNeXt-S answers (none degraded, step 2)
    # that the lowered phase did not run, each once against its plain
    # version; RWKV-6's answers are verified only
    new: dict = {}
    served_entries, seen = 0, set()
    for (w, b), (layers, res) in answers.items():
        if w != SERVE_LAUNCHED:
            continue
        for key, lk in res.schedule.lowered.items():
            served_entries += 1
            dkey = launch_key(layers, key, lk)
            seen.add(dkey)
            if dkey not in launched:
                new.setdefault(dkey, []).append((b, f"{res.workload}:{key}"))
    reset_counts()
    records = []
    for dkey, where in new.items():
        rec = launch_entry(dkey)
        rec.update(entries=len(where), batch=where[0][0], first=where[0][1])
        records.append(rec)
    launches = read_counts()
    for name in KERNELS:
        want = sum(1 for r in records if r["kernel"] == name)
        if launches[name] != want:
            fail(f"serve: {name} launched {launches[name]} times for {want} "
                 f"new served launches")
    if not records:
        fail("serve: the lowered phase ran every served launch already; "
             "batches 16 and 64 should bring new ones")
    for rec, dkey in zip(records, new):
        timed = launch_entry(dkey, timed=True)
        rec.update({k: v for k, v in timed.items() if k not in rec},
                   max_abs_err=max(rec["max_abs_err"], timed["max_abs_err"]))
    launch = dict(workload=SERVE_LAUNCHED, entries=served_entries, distinct=len(seen),
                  already_launched=len(seen) - len(new), new=len(new),
                  new_by_batch={b: sum(1 for r in records if r["batch"] == b)
                                for b in sorted({r["batch"] for r in records})},
                  records=records)

    # 4. a deterministic chaos session over a store of its own: every request
    # served, every answer verified (a degraded one with its marker), and not
    # one launch while it runs
    chaos_store = RecordingStore(root / "chaos", verify=True)
    chaos_store.warm([SERVE_LAUNCHED], batches=CHAOS_BATCHES)
    chaos_store.answers.clear()
    reset_counts()
    with obs.tracing() as tr:
        rep = chaos_session(chaos_store, SERVE_LAUNCHED, n_requests=CHAOS_REQUESTS,
                            plan=ChaosPlan.parse(CHAOS_PLAN, seed=SEED),
                            batches=CHAOS_BATCHES)
    chaos_launches = read_counts()
    if not rep.all_served or len(chaos_store.answers) != rep.requests:
        fail(f"serve: chaos served {rep.served} of {rep.requests}")
    for res in chaos_store.answers:
        marker = getattr(res.schedule, "degraded", None)
        if res.degraded != (marker is not None) or (res.degraded and marker != res.outcome):
            fail(f"serve: chaos answer {res.outcome!r} carries the marker {marker!r}")
        found = verify_schedule(get_workload(res.workload), res.schedule,
                                source="chip_smoke")
        if found:
            fail(f"serve: chaos answer {res.workload} ({res.outcome}) has "
                 f"{len(found)} findings, first {found[0].code}: {found[0].detail}")
    if any(chaos_launches.values()):
        fail(f"serve: the chaos session launched {chaos_launches}")
    chaos = dict(plan=CHAOS_PLAN, seed=SEED, requests=rep.requests, served=rep.served,
                 degraded=rep.degraded, outcomes=rep.outcomes, faults=rep.faults,
                 findings=0, launches=chaos_launches,
                 counters={k: v for k, v in tr.counters.items()
                           if k.startswith(("serve.", "cache."))})
    shutil.rmtree(root, ignore_errors=True)
    return launches, dict(warm=warm, disk=disk, launch=launch, chaos=chaos)


def per_forward_sum(shapes, key):
    """Sum of ``key`` over one forward's launches; None where a shape has
    no such number (WKV has no library call)."""
    if any(s[key] is None for s in shapes):
        return None
    return sum(s[key] * s["per_forward"] for s in shapes)


def summarise(per_kernel, launches):
    rows = []
    for name, info in KERNELS.items():
        shapes = per_kernel[name]["shapes"]
        total = lambda key: per_forward_sum(shapes, key)  # noqa: E731
        by = {"bytes": 0.0, "operations": 0.0}
        for s in shapes:
            by[s["bound_by"]] += s["bound_ms"] * s["per_forward"]
        f32_errs = [s["max_abs_err"] for s in shapes + per_kernel[name]["extra"]
                    if s["tol"] < 1e-2]
        path = MAIN_PATH[name]
        rows.append(dict(
            name=name, route="cuda", source=info["source"],
            replaces=info["replaces"], launches=launches[path][name],
            launches_by_path={p: n[name] for p, n in launches.items()},
            max_abs_err=max(f32_errs), ms=total("ms"), plain_ms=total("plain_ms"),
            bound_ms=total("bound_ms"),
            bound_by=max(by, key=by.get), library_ms=total("library_ms"),
            launches_per_forward=sum(s["per_forward"] for s in shapes),
            batch={"wkv_chunked": RWKV_REQUESTS[0][0],
                   "flash_attention_bwd": TRAIN_BATCH[0]}.get(name, BATCH),
            shapes=shapes, extra=per_kernel[name]["extra"]))
    return rows


# ---------------------------------------------------------------------------
# main path
# ---------------------------------------------------------------------------


def main_path():
    cfg = CONFIG
    params = init_params(SEED, edgenext.param_defs(cfg), perturb=0.05)
    model = edgenext.EdgeNeXt(cfg, params).eval()
    plain = edgenext.EdgeNeXt(cfg, params, kernels=ref.PLAIN).eval()
    rng = np.random.default_rng(SEED + 1)
    sizes = [BATCH] * 4 + [1] * 2
    batches = [torch.from_numpy(rng.standard_normal(
        (b, cfg.img_size, cfg.img_size, cfg.in_channels), dtype=np.float32)).cuda()
        for b in sizes]

    serve(model, [batches[0], batches[-1]])       # warm-up, one of each size
    reset_counts()
    logits, ms = serve(model, batches)
    launches = read_counts()

    want = edgenext.kernel_launches_per_forward(cfg)
    if want != {"fused_ibn": 18, "depthwise_conv2d": 21, "flash_attention": 3}:
        fail(f"EdgeNeXt-S should launch 18/21/3 a forward, model says {want}")
    for name, n in launches.items():
        if n != want.get(name, 0) * len(batches):
            fail(f"{name}: {n} launches over {len(batches)} requests, "
                 f"expected {want[name]} a forward")

    serve(plain, [batches[0], batches[-1]])
    plain_logits, plain_ms = serve(plain, batches)
    worst = 0.0
    for i, (got, ref_out) in enumerate(zip(logits, plain_logits)):
        if got.shape != (sizes[i], cfg.num_classes) or got.dtype != torch.float32:
            fail(f"request {i}: logits {tuple(got.shape)} {got.dtype}")
        if not torch.isfinite(got).all():
            fail(f"request {i}: logits not finite")
        worst = max(worst, (got - ref_out).abs().max().item())
    if worst > 2e-3:
        fail(f"logits differ from the plain versions on the card by {worst:.3e} "
             f"(limit 2e-3)")

    # one single-image request against the plain model on the CPU
    cpu_model = edgenext.EdgeNeXt(cfg, params, device="cpu").eval()
    with torch.inference_mode():
        cpu_logits = cpu_model(batches[-1].cpu())
    cpu_err = (logits[-1].cpu() - cpu_logits).abs().max().item()
    if cpu_err > 2e-3:
        fail(f"logits differ from the plain model on the CPU by {cpu_err:.3e} "
             f"(limit 2e-3)")

    # steadier request times: ten more of each size
    _, ms16 = serve(model, [batches[0]] * 10)
    _, ms1 = serve(model, [batches[-1]] * 10)
    _, pms16 = serve(plain, [batches[0]] * 5)
    _, pms1 = serve(plain, [batches[-1]] * 5)
    result = dict(
        requests=sizes, request_ms=ms, plain_request_ms=plain_ms,
        launches=launches, max_abs_err_vs_plain_on_card=worst,
        max_abs_err_vs_plain_on_cpu=cpu_err,
        logits_abs_max=max(x.abs().max().item() for x in logits),
        ms_per_request_b16=statistics.median(ms16),
        ms_per_request_b1=statistics.median(ms1),
        plain_ms_per_request_b16=statistics.median(pms16),
        plain_ms_per_request_b1=statistics.median(pms1),
        peak_memory_mib=torch.cuda.max_memory_allocated() / 2 ** 20)
    result["captured"] = edgenext_captured(cfg, model, plain, batches, logits,
                                           plain_logits, rng)
    return launches, result


def edgenext_captured(cfg, model, plain, batches, logits, plain_logits,
                      rng) -> dict:
    """EdgeNeXt-S as ``captured(model)``: each capture (B = 16, then B = 1,
    on images of its own) counts 18 / 21 / 3 launches for the capture and
    as many for each of the WARMUP eager runs before it; the replays of the
    six requests and one more single image (four fresh batches at B = 16,
    three at B = 1) count none and give the eager logits bit for bit;
    request ms eager and captured in turns, 10 rounds at each batch; peak
    memory of each form."""
    want = edgenext.kernel_launches_per_forward(cfg)
    per_capture = {k: (WARMUP + 1) * want.get(k, 0) for k in KERNELS}

    def images(b):
        return torch.from_numpy(rng.standard_normal(
            (b, cfg.img_size, cfg.img_size, cfg.in_channels),
            dtype=np.float32)).cuda()

    cap = captured(model)
    captures = {}
    for b in (BATCH, 1):
        x = images(b)
        _, n, reserved = capture_counted(lambda: cap(x))
        if n != per_capture:
            fail(f"EdgeNeXt-S capture at B={b}: launches {n}, expected "
                 f"{per_capture} ({WARMUP} warm-up forwards and the capture)")
        captures[b] = dict(launches=n, capture_s=cap.capture_s[-1],
                           reserved_mib=reserved)
    requests = batches + [images(1)]
    with torch.inference_mode():
        eager = logits + [model(requests[-1])]
        plain_all = plain_logits + [plain(requests[-1])]
    reset_counts()
    got, _ = serve(cap, requests)
    on_replay = read_counts()
    if any(on_replay.values()):
        fail(f"EdgeNeXt-S captured: launches {on_replay} counted over "
             f"{len(requests)} replays, expected none")
    diff = first_difference(got, eager)
    if diff:
        fail(f"EdgeNeXt-S captured: replayed logits differ from the eager "
             f"ones, request {diff}")
    err = max((g - w).abs().max().item() for g, w in zip(got, plain_all))
    if err > 2e-3:
        fail(f"EdgeNeXt-S captured: logits differ from the plain versions on "
             f"the card by {err:.3e} (limit 2e-3)")
    timing, peak = {}, {}
    for b, x in ((BATCH, batches[0]), (1, batches[-1])):
        forms = {"eager": lambda: model(x), "captured": lambda: cap(x)}
        timing[b] = alternate(forms, rounds=10)
        peak[b] = {name: peak_mib(fn) for name, fn in forms.items()}
    return dict(captures=captures, requests=[r.shape[0] for r in requests],
                launches_on_replay=on_replay, max_abs_err_vs_plain_on_card=err,
                timing=timing, peak_allocated_mib=peak)


def decode_inputs(tokens: torch.Tensor) -> torch.Tensor:
    """What a greedy run fed its decode steps: token 0, then its own
    tokens but the last."""
    return torch.cat([torch.zeros_like(tokens[:, :1]), tokens[:, :-1]], 1)


def forced_decode(decode, params, cache, inputs: torch.Tensor):
    """Decode steps fed ``inputs`` [B, n] (teacher forcing) -> (logits
    [B, n, Vp], cache)."""
    logits = []
    with torch.inference_mode():
        for i in range(inputs.shape[1]):
            _, lg, cache = decode(params, cache, {"tokens": inputs[:, i:i + 1]})
            logits.append(lg)
    return torch.stack(logits, 1), cache


def wkv_graph_edge() -> dict:
    """One ``ops.wkv_chunked`` call at the served prefill shape (bfloat16,
    chunk ``rwkv_chunk.CHUNK``) captured alone into a CUDA graph: the graph's
    kernel nodes and the types of its edges as the driver reports them
    (``cuGraphGetEdges_v2``: 1 = programmatic, the dependent launch of the
    outputs pass kept as such; 0 = a full dependency); a replay on new
    inputs against the eager call, bit for bit; the call's time eager and
    replayed (CUDA events, median of 20, in turns)."""
    BH, T, K = 128, 512, 64                    # 4 x 512 tokens, 32 heads of 64
    r, k, v = (randn(BH, T, K, dtype=torch.bfloat16) for _ in range(3))
    logw = -torch.exp(randn(BH, T, K, scale=0.5))
    u = randn(BH, K)

    def call():
        return ops.wkv_chunked(r, k, v, logw, u, chunk=wkv_mod.CHUNK)

    drv = ctypes.CDLL("libcuda.so.1")
    with torch.inference_mode():
        for _ in range(WARMUP):
            call()
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.graph(graph):
            out, state = call()
        raw = ctypes.c_void_p(graph.raw_cuda_graph())
        nodes, n = ctypes.c_size_t(0), ctypes.c_size_t(0)
        errs = [drv.cuGraphGetNodes(raw, None, ctypes.byref(nodes)),
                drv.cuGraphGetEdges_v2(raw, None, None, None, ctypes.byref(n))]
        frm, to = (ctypes.c_void_p * n.value)(), (ctypes.c_void_p * n.value)()
        data = (ctypes.c_uint8 * (8 * n.value))()   # CUgraphEdgeData: 8 bytes
        errs.append(drv.cuGraphGetEdges_v2(raw, frm, to, data, ctypes.byref(n)))
        if any(errs):
            fail(f"wkv_chunked graph: driver calls returned {errs}")
        edges = [data[8 * i + 2] for i in range(n.value)]
        r.copy_(randn(BH, T, K, dtype=torch.bfloat16))
        want = call()
        graph.replay()
        diff = first_difference([out, state], list(want))
        if diff:
            fail(f"wkv_chunked graph: a replay on new inputs differs from the "
                 f"eager call at {diff}")
        times = {"eager": [], "graph": []}
        for i in range(20):
            for name in (("eager", "graph") if i % 2 == 0 else ("graph", "eager")):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                if name == "eager":
                    call()
                else:
                    graph.replay()
                end.record()
                end.synchronize()
                times[name].append(start.elapsed_time(end))
    return dict(kernel_nodes=nodes.value, edge_types=edges,
                programmatic_edges=edges.count(1), replay_follows_inputs=True,
                eager_ms=statistics.median(times["eager"]),
                graph_ms=statistics.median(times["graph"]))


def lm_batch(cfg, rng, B: int, T: int) -> dict:
    """A request's prefill batch on the card, drawn as ``launch.serve``
    draws it: tokens [B, T]; for an encoder-decoder also the source frames
    [B, T, D] after them, and the tokens' first column as the decoder's
    prefix."""
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, T),
                                                     dtype=np.int32)).cuda()}
    if cfg.family == "audio":
        batch["inputs_embeds"] = torch.from_numpy(rng.standard_normal(
            (B, T, cfg.d_model)).astype(np.float32)).cuda()
        batch["tokens"] = batch["tokens"][:, :1].contiguous()
    return batch


def decode_len(cfg, T: int, gen: int):
    """The prefill's ``decode_len`` of a request, as ``launch.serve`` passes
    it: prompt + generated tokens for an encoder-decoder (its self cache's
    length), nothing for the others."""
    return T + gen if cfg.family == "audio" else None


def lm_prefill(prefill, batch: dict, dlen=None):
    """``launch.serve.run_prefill`` on a batch dict."""
    return lm_serve.run_prefill(prefill, batch["tokens"],
                                batch.get("inputs_embeds"), dlen)


def lm_captured(cfg, mod, params, batches, served, rng, requests,
                rounds) -> tuple[dict, list, tuple]:
    """An LM through ``launch.serve.captured_steps``: each prefill capture
    (one a distinct (B, T) of ``requests``, on prompts of its own) counts
    ``mod.kernel_launches_per_prefill`` for the capture and as many for each
    of the WARMUP eager runs, each decode capture none; the served requests
    (their prefill ``batches``) replayed count none and give the eager
    steps' last hidden, prefill cache, every step's tokens and logits and
    the last cache bit for bit; prefill ms and decode ms a token eager and
    captured in turns (``rounds`` of each) at the first and the last
    request's shape.  Returns the numbers, the replayed records and the
    captured steps."""
    per = mod.kernel_launches_per_prefill(cfg)
    per_capture = {k: (WARMUP + 1) * per.get(k, 0) for k in KERNELS}
    pre_c, dec_c = lm_serve.captured_steps(cfg, params)
    pre_e, dec_e = lm_serve.eager_steps(cfg, params)
    dev = torch.device("cuda")
    captures = {}
    for B, T, gen in {(b, t): (b, t, g) for b, t, g in requests}.values():
        p = lm_batch(cfg, rng, B, T)
        (_, cache, _), n_pre, res_pre = capture_counted(
            lambda: lm_prefill(pre_c, p, decode_len(cfg, T, gen)))
        _, n_dec, res_dec = capture_counted(
            lambda: lm_serve.run_decode(dec_c, cache, B, 1, dev))
        if n_pre != per_capture or any(n_dec.values()):
            fail(f"{cfg.name} capture at {B} x {T}: launches {n_pre} in the "
                 f"prefill and {n_dec} in decode, expected {per_capture} "
                 f"({WARMUP} warm-up runs and the capture) and none")
        captures[f"{B}x{T}"] = dict(
            prefill_launches=n_pre, decode_launches=n_dec,
            prefill_capture_s=pre_c.capture_s[-1],
            decode_capture_s=dec_c.capture_s[-1],
            prefill_reserved_mib=res_pre, decode_reserved_mib=res_dec)
        del cache

    reset_counts()
    records = []
    for i, (p, r, (B, T, gen)) in enumerate(zip(batches, served, requests)):
        last, cache, _ = lm_prefill(pre_c, p, decode_len(cfg, T, gen))
        toks, logits, cache_end, _ = lm_serve.run_decode(dec_c, cache, B, gen, dev)
        logits = torch.stack(logits, 1)
        # the last cache is the decode graph's buffer: compared before the
        # next request overwrites it
        diff = first_difference(
            [last, *pytree.tree_leaves(cache), toks, logits,
             *pytree.tree_leaves(cache_end)],
            [r["last"], *pytree.tree_leaves(r["cache"]), r["tokens"], r["logits"],
             *pytree.tree_leaves(r["cache_end"])])
        if diff:
            fail(f"{cfg.name} captured request {i}: differs from the eager steps "
                 f"(last hidden, prefill cache, tokens, logits, last cache) "
                 f"at {diff}")
        records.append(dict(prompt=r["prompt"], last=last, tokens=toks,
                            logits=logits))
        del cache, cache_end
    on_replay = read_counts()
    if any(on_replay.values()):
        fail(f"{cfg.name} captured: launches {on_replay} counted over the "
             f"replayed requests, expected none")

    timing = {}
    for i in (0, -1):
        B, T, gen = requests[i]
        batch, dlen = batches[i], decode_len(cfg, T, gen)
        timing[f"prefill_{B}x{T}"] = alternate(
            {"eager": lambda: lm_serve.call_prefill(pre_e, batch, dlen),
             "captured": lambda: lm_serve.call_prefill(pre_c, batch, dlen)},
            rounds=rounds[0])
        with torch.inference_mode():
            c_e = lm_serve.call_prefill(pre_e, batch, dlen)[1]
            c_c = lm_serve.call_prefill(pre_c, batch, dlen)[1]
        timing[f"decode_b{B}_{T}"] = alternate(
            {"eager": lambda: lm_serve.run_decode(dec_e, c_e, B, gen, dev),
             "captured": lambda: lm_serve.run_decode(dec_c, c_c, B, gen, dev)},
            rounds=rounds[1], per=gen)
        del c_e, c_c
    return (dict(captures=captures, launches_on_replay=on_replay,
                 bitwise_equal_requests=len(records), timing=timing),
            records, (pre_e, dec_e, pre_c, dec_c))


def rwkv6_captured(cfg, params, prompts, served, rng) -> tuple[dict, list]:
    """RWKV-6 through ``lm_captured`` (4 x 512 and 1 x 200), then the peak
    memory of a 4 x 512 request in each form and ``wkv_graph_edge``."""
    requests = [(b, t, RWKV_GEN) for b, t in RWKV_REQUESTS]
    cap, records, (pre_e, dec_e, pre_c, dec_c) = lm_captured(
        cfg, rwkv6, params, [{"tokens": p} for p in prompts], served, rng,
        requests, rounds=(10, 5))
    dev = torch.device("cuda")
    p = prompts[0]
    cap["peak_allocated_mib_b4_t512"] = {
        name: peak_mib(lambda: lm_serve.run_decode(
            dec, pre({"tokens": p})[1], p.shape[0], RWKV_GEN, dev))
        for name, pre, dec in (("eager", pre_e, dec_e), ("captured", pre_c, dec_c))}
    cap["wkv_graph"] = wkv_graph_edge()
    return cap, records


def rwkv6_path():
    """RWKV-6 1.6B served through ``launch.serve``'s prefill and greedy
    decode at full width, then held against its plain versions (see the
    module docstring, phase 5).  Returns the launch counts of the served
    requests and the numbers."""
    cfg = get_config("rwkv6-1.6b")
    defs = rwkv6.param_defs(cfg)
    if count_params(defs) != RWKV_PARAMS:
        fail(f"rwkv6: {count_params(defs)} parameters, expected {RWKV_PARAMS}")
    want = rwkv6.kernel_launches_per_prefill(cfg)
    if want != {"wkv_chunked": 24}:
        fail(f"RWKV-6 1.6B should launch wkv_chunked 24 times a prefill, "
             f"model says {want}")
    t0 = time.perf_counter()
    tree = init_params(SEED, defs)              # numpy float32, on the host
    init_s = time.perf_counter() - t0
    params = rwkv6.load_params(cfg, tree)       # as served: bfloat16 compute
    prefill, decode = lm_serve.eager_steps(cfg, params)
    rng = np.random.default_rng(SEED + 2)
    prompts = [torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, t),
                                             dtype=np.int32)).cuda()
               for b, t in RWKV_REQUESTS]

    for p in (prompts[0], prompts[-1]):        # warm-up, one of each size
        _, cache, _ = lm_serve.run_prefill(prefill, p)
        lm_serve.run_decode(decode, cache, p.shape[0], 2, p.device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    served = []
    launches = {name: 0 for name in KERNELS}
    for i, p in enumerate(prompts):
        B = p.shape[0]
        reset_counts()
        last, cache, prefill_ms = lm_serve.run_prefill(prefill, p)
        n_prefill = read_counts()
        reset_counts()
        toks, logits, cache_end, decode_ms = lm_serve.run_decode(
            decode, cache, B, RWKV_GEN, p.device)
        n_decode = read_counts()
        for name in KERNELS:
            expect = want.get(name, 0)
            if n_prefill[name] != expect or n_decode[name]:
                fail(f"rwkv6 request {i}: {name} launched {n_prefill[name]} "
                     f"times in prefill and {n_decode[name]} in decode, "
                     f"expected {expect} and 0")
            launches[name] += n_prefill[name] + n_decode[name]
        logits = torch.stack(logits, 1)
        if logits.shape != (B, RWKV_GEN, cfg.padded_vocab) \
                or not torch.isfinite(logits).all():
            fail(f"rwkv6 request {i}: logits {tuple(logits.shape)}, finite "
                 f"{bool(torch.isfinite(logits).all())}")
        if toks.shape != (B, RWKV_GEN) or not bool(
                ((toks >= 0) & (toks < cfg.vocab_size)).all()):
            fail(f"rwkv6 request {i}: tokens {tuple(toks.shape)} out of range")
        served.append(dict(prompt=p, last=last, cache=cache,
                           cache_end=cache_end, tokens=toks, logits=logits,
                           prefill_ms=prefill_ms, decode_ms=decode_ms))
    peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20

    # the same requests through the captured steps
    cap, cap_records = rwkv6_captured(cfg, params, prompts, served, rng)

    # the served bfloat16 run against the plain bfloat16 model
    plain_prefill = build_prefill_step(cfg, kernels=ref.PLAIN)
    plain_decode = build_decode_step(cfg, kernels=ref.PLAIN)
    # the eager and the captured records, each against the plain model
    # teacher-forced with its own tokens (run once where the two agree)
    V = cfg.vocab_size
    bf16, forced = {}, {}
    for form, recs in (("eager", served), ("captured", cap_records)):
        bf16_err, bf16_hidden_err, agree, steps = 0.0, 0.0, 0, 0
        for i in (0, len(recs) - 1):
            r = recs[i]
            if i not in forced or not torch.equal(forced[i][0], r["tokens"]):
                with torch.inference_mode():
                    last_p, cache_p = plain_prefill(params, {"tokens": r["prompt"]})
                logits_p, _ = forced_decode(plain_decode, params, cache_p,
                                            decode_inputs(r["tokens"]))
                forced[i] = (r["tokens"], last_p, logits_p)
            _, last_p, logits_p = forced[i]
            bf16_err = max(bf16_err, (r["logits"][..., :V] - logits_p[..., :V])
                           .abs().max().item())
            bf16_hidden_err = max(bf16_hidden_err, (r["last"].float()
                                                    - last_p.float()).abs().max().item())
            agree += int((logits_p[..., :V].argmax(-1) == r["tokens"]).sum())
            steps += r["tokens"].numel()
        if bf16_err > BF16_LOGITS_TOL or agree < BF16_AGREEMENT * steps:
            fail(f"rwkv6 bfloat16 {form}: logits differ from the plain model by "
                 f"{bf16_err:.3e} (limit {BF16_LOGITS_TOL}), greedy tokens agree "
                 f"{agree}/{steps} (at least {BF16_AGREEMENT:.0%})")
        bf16[form] = (bf16_err, bf16_hidden_err, agree / steps)
    bf16_err, bf16_hidden_err, agreement = bf16["eager"]
    cap["bf16_vs_plain"] = dict(zip(("max_logits_err", "max_last_hidden_err",
                                     "greedy_agreement"), bf16["captured"]))
    del cap_records, forced
    del params, plain_prefill, plain_decode
    torch.cuda.empty_cache()

    # float32: the kernel model against the plain model on the card
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params32 = rwkv6.load_params(cfg32, tree)
    pre32, dec32 = lm_serve.eager_steps(cfg32, params32)
    p = prompts[0]
    last_k, cache_k, _ = lm_serve.run_prefill(pre32, p)
    toks_k, logits_k, _, _ = lm_serve.run_decode(dec32, cache_k, p.shape[0], 8,
                                                 p.device)
    with torch.inference_mode():
        last_p, cache_p = build_prefill_step(cfg32, kernels=ref.PLAIN)(
            params32, {"tokens": p})
    logits_p, _ = forced_decode(build_decode_step(cfg32, kernels=ref.PLAIN),
                                params32, cache_p, decode_inputs(toks_k))
    f32_err = max(
        compare("rwkv6 float32 last hidden", last_k, last_p, 2e-3),
        compare("rwkv6 float32 WKV states", cache_k.state, cache_p.state, 2e-3),
        compare("rwkv6 float32 time-mix shifts", cache_k.shift_tm,
                cache_p.shift_tm, 2e-3),
        compare("rwkv6 float32 logits", torch.stack(logits_k, 1), logits_p, 2e-3))
    # the same through the float32 model's captured steps: the eager bits,
    # and so the same distance from the plain model
    pre32c, dec32c = lm_serve.captured_steps(cfg32, params32)
    last_c, cache_c, _ = lm_serve.run_prefill(pre32c, p)
    toks_c, logits_c, _, _ = lm_serve.run_decode(dec32c, cache_c, p.shape[0], 8,
                                                 p.device)
    diff = first_difference([last_c, *cache_c, toks_c, *logits_c],
                            [last_k, *cache_k, toks_k, *logits_k])
    if diff:
        fail(f"rwkv6 float32 captured: differs from the eager steps at {diff}")
    cap["f32_max_err_vs_plain_on_card"] = max(
        compare("rwkv6 float32 captured last hidden", last_c, last_p, 2e-3),
        compare("rwkv6 float32 captured WKV states", cache_c.state,
                cache_p.state, 2e-3),
        compare("rwkv6 float32 captured logits", torch.stack(logits_c, 1),
                logits_p, 2e-3))
    del pre32c, dec32c, cache_c

    # one 1 x 64 float32 request against the plain model on the CPU
    p64 = prompts[-1][:, :64]
    last_k, cache_k, _ = lm_serve.run_prefill(pre32, p64)
    toks_k, logits_k, _, _ = lm_serve.run_decode(dec32, cache_k, 1, 4,
                                                 p64.device)
    logits_k = torch.stack(logits_k, 1).cpu()
    del params32, cache_k, cache_p
    torch.cuda.empty_cache()
    params_cpu = rwkv6.load_params(cfg32, tree, device="cpu")
    del tree
    pre_cpu, dec_cpu = build_prefill_step(cfg32), build_decode_step(cfg32)
    with torch.inference_mode():
        last_c, cache_c = pre_cpu(params_cpu, {"tokens": p64.cpu()})
    logits_c, _ = forced_decode(dec_cpu, params_cpu, cache_c,
                                decode_inputs(toks_k).cpu())
    cpu_err = max((last_k.cpu() - last_c).abs().max().item(),
                  (logits_k - logits_c).abs().max().item())
    bound_c = 2e-3 * (1 + max(last_c.abs().max().item(), logits_c.abs().max().item()))
    if not (torch.allclose(last_k.cpu(), last_c, rtol=2e-3, atol=2e-3)
            and torch.allclose(logits_k, logits_c, rtol=2e-3, atol=2e-3)):
        fail(f"rwkv6 float32: the card differs from the plain model on the CPU "
             f"by {cpu_err:.3e} (limit 2e-3 (1 + |b|), at most {bound_c:.3e})")

    b4 = served[:-1]
    result = dict(
        requests=RWKV_REQUESTS, gen=RWKV_GEN, parameters=RWKV_PARAMS,
        init_params_s=init_s, launches=launches,
        prefill_ms=[r["prefill_ms"] for r in served],
        decode_ms=[r["decode_ms"] for r in served],
        prefill_ms_b4_t512=statistics.median(r["prefill_ms"] for r in b4),
        prefill_ms_b1_t200=served[-1]["prefill_ms"],
        decode_ms_per_token_b4=statistics.median(r["decode_ms"] / RWKV_GEN for r in b4),
        decode_ms_per_token_b1=served[-1]["decode_ms"] / RWKV_GEN,
        peak_memory_mib=peak_mib,
        logits_abs_max=max(r["logits"].abs().max().item() for r in served),
        bf16_max_logits_err_vs_plain=bf16_err,
        bf16_max_last_hidden_err_vs_plain=bf16_hidden_err,
        bf16_greedy_agreement=agreement,
        f32_max_err_vs_plain_on_card=f32_err, f32_max_err_vs_plain_on_cpu=cpu_err,
        first_tokens=served[0]["tokens"][0, :16].tolist(), captured=cap)
    return launches, result


def dense_path():
    """``h2o-danube-1.8b`` uncut served through ``launch.serve``'s prefill
    and greedy decode, eager then captured, held to its plain model
    (``lm_phase``; module docstring, phase 5b).  Returns the launch counts
    of the served requests, the numbers and the weights (numpy, float32),
    which the training phase takes up."""
    t0 = time.perf_counter()
    cfg = get_config(DENSE_ARCH)
    defs = transformer.param_defs(cfg)
    if count_params(defs) != DENSE_PARAMS:
        fail(f"dense: {count_params(defs)} parameters, expected {DENSE_PARAMS}")
    want = transformer.kernel_launches_per_prefill(cfg)
    if want != {"flash_attention": 24}:
        fail(f"{DENSE_ARCH} should launch flash_attention 24 times a prefill, "
             f"model says {want}")
    t1 = time.perf_counter()
    tree = init_params(SEED, defs)              # numpy float32, on the host
    init_s = time.perf_counter() - t1
    params = transformer.load_params(cfg, tree)  # as served: bfloat16 compute
    rng = np.random.default_rng(SEED + 3)
    launches, result = lm_phase("dense", cfg, transformer, params, DENSE_REQUESTS, rng)
    del params
    torch.cuda.empty_cache()
    result.update(arch=DENSE_ARCH, parameters=DENSE_PARAMS, init_params_s=init_s,
                  wall_s=time.perf_counter() - t0)
    return launches, result, tree


def refusals() -> list:
    """Each ``ops`` entry without a backward, on CUDA inputs one of which
    (a weight) requires grad, under grad mode: a RuntimeError naming the
    kernel before any launch, its counter unchanged."""
    def ones(*shape):
        return torch.full(shape, 0.5, device="cuda")

    cases = {
        "fused_ibn": (ops.fused_ibn, [ones(64, 48), ones(48, 160), ones(160, 48)]),
        "matmul_ln": (ops.matmul_ln, [ones(64, 96), ones(96, 96), ones(96),
                                      ones(96), ones(96)]),
        "depthwise_conv2d": (ops.depthwise_conv2d,
                             [ones(1, 8, 8, 16), ones(3, 3, 16), ones(16)]),
        "wkv_chunked": (lambda *a: ops.wkv_chunked(*a, chunk=16),
                        [ones(4, 32, 16), ones(4, 32, 16), ones(4, 32, 16),
                         -ones(4, 32, 16), ones(4, 16)]),
    }
    out = []
    for name, (fn, args) in cases.items():
        args[1].requires_grad_()
        before = read_counts()
        try:
            fn(*args)
        except RuntimeError as e:
            if name not in str(e):
                fail(f"refusal: {name} raised without naming its kernel: {e}")
        else:
            fail(f"refusal: {name} took a CUDA input that requires grad")
        if read_counts() != before:
            fail(f"refusal: {name} launched before it refused")
        out.append(name)
    return out


def digest(tree) -> list:
    """Each leaf's bits summed as integers and its values summed in float64:
    equal digests of two runs' states mean the same bits, for a check that
    keeps only one state on the card."""
    def one(t):
        bits = t.detach().view(torch.int32) if t.dtype == torch.float32 else t
        return (int(bits.to(torch.int64).sum()), float(t.detach().double().sum()))
    return [one(t) for t in tree_leaves(tree)]


def leaf_names(tree) -> list:
    names = []
    tree_map(lambda leaf, path: names.append(path), tree)
    return names


def train_path(cfg, tree) -> tuple:
    """Training ``h2o-danube-1.8b`` uncut on the card (module docstring,
    phase 5f): float32 masters from ``tree`` (the dense phase's weights),
    bfloat16 compute with remat, ``build_train_step`` as ``launch.train``
    builds it.  Returns the launch counts of the timed run and the numbers."""
    t0 = time.perf_counter()
    B, T = TRAIN_BATCH
    ds = make_dataset(cfg, ShapeConfig("train", "train", T, B), seed=SEED)
    batches = [{k: torch.from_numpy(v).cuda() for k, v in ds.batch(s).items()}
               for s in range(TRAIN_STEPS)]

    def masters(src):
        return tree_map(lambda a, path: torch.from_numpy(a).cuda().requires_grad_(),
                        src)

    res = dict(arch=DENSE_ARCH, parameters=DENSE_PARAMS, steps=TRAIN_STEPS,
               batch=TRAIN_BATCH, lr=TRAIN_LR, warmup=TRAIN_WARMUP, clip=TRAIN_CLIP,
               refused=refusals())
    params = masters(tree)
    names = leaf_names(params)

    # the first step's gradients through the kernels and the plain versions
    grad_k, grad_p = build_grad_fn(cfg), build_grad_fn(cfg, kernels=ref.PLAIN)
    reset_counts()
    loss_k, _, gk = grad_k(params, batches[0])
    first = read_counts()
    per_layer = transformer.kernel_launches_per_prefill(cfg)["flash_attention"]
    want_first = {n: 0 for n in KERNELS}
    want_first.update(flash_attention=2 * per_layer, flash_attention_bwd=per_layer)
    if first != want_first:
        fail(f"train: one step launched {first}, expected {want_first} (the "
             f"forward, remat's recompute, the backward)")
    loss_p, _, gp = grad_p(params, batches[0])
    rel = {}
    for n, a, b in zip(names, tree_leaves(gk), tree_leaves(gp)):
        rel[n] = ((a - b).norm() / b.norm().clamp_min(1e-30)).item()
    norm_k = torch.sqrt(sum(torch.sum(g.square()) for g in tree_leaves(gk))).item()
    norm_p = torch.sqrt(sum(torch.sum(g.square()) for g in tree_leaves(gp))).item()
    del gp
    worst = max(rel, key=rel.get)
    if not (abs(loss_k.item() - loss_p.item()) <= TRAIN_LOSS_TOL
            and rel[worst] <= TRAIN_GRAD_REL
            and abs(norm_k - norm_p) <= TRAIN_NORM_REL * norm_p):
        fail(f"train: the first step against the plain step: loss {loss_k.item():.5f} "
             f"vs {loss_p.item():.5f}, worst leaf {worst} rel L2 {rel[worst]:.3e}, "
             f"grad norm {norm_k:.5f} vs {norm_p:.5f}")
    res.update(first_step_launches=first, loss_first=loss_k.item(),
               loss_first_plain=loss_p.item(), grad_rel_l2_vs_plain=rel,
               grad_rel_l2_worst=[worst, rel[worst]], grad_norm_first=norm_k,
               grad_norm_first_plain=norm_p)

    # the first step again: the same bits
    loss_k2, _, gk2 = grad_k(params, batches[0])
    same = torch.equal(loss_k, loss_k2) and all(
        torch.equal(a, b) for a, b in zip(tree_leaves(gk), tree_leaves(gk2)))
    if not same:
        fail("train: two runs of the first step differ")
    del gk, gk2

    # float32 on the first layers of the same weights, kernels against plain
    L32 = TRAIN_F32_LAYERS
    cfg32 = dataclasses.replace(cfg, num_layers=L32, dtype="float32")
    p32 = masters(dict(tree, blocks=tree_map(lambda a, path: a[:L32], tree["blocks"])))
    _, _, g32k = build_grad_fn(cfg32)(p32, batches[0])
    _, _, g32p = build_grad_fn(cfg32, kernels=ref.PLAIN)(p32, batches[0])
    res["f32_max_grad_err_vs_plain"] = max(
        compare(f"train float32 {L32} layers grad {n}", a, b, 2e-3)
        for n, a, b in zip(leaf_names(p32), tree_leaves(g32k), tree_leaves(g32p)))
    del p32, g32k, g32p

    # the run: TRAIN_STEPS steps; a checkpoint after TRAIN_CKPT of them
    step_fn = build_train_step(cfg, lr_schedule=warmup_cosine(TRAIN_LR, TRAIN_WARMUP,
                                                              TRAIN_STEPS),
                               clip_norm=TRAIN_CLIP)
    opt = adamw_init(params)
    ckpt_dir = Path(tempfile.mkdtemp(prefix="chip_smoke_train_"))
    losses, gnorms, ev_ms, wall_ms = [], [], [], []
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    try:
        reset_counts()
        for s in range(TRAIN_STEPS):
            if s == TRAIN_CKPT:
                t1 = time.perf_counter()
                save_checkpoint(ckpt_dir, s, {"params": params, "opt": opt})
                res["checkpoint_save_s"] = time.perf_counter() - t1
            (params, opt, m), ev, wall = both_clocks(
                lambda: step_fn(params, opt, batches[s]))
            losses.append(m["loss"].item())
            gnorms.append(m["grad_norm"].item())
            ev_ms.append(ev)
            wall_ms.append(wall)
        launches = read_counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 20
        want = {n: 0 for n in KERNELS}
        want.update(flash_attention=2 * per_layer * TRAIN_STEPS,
                    flash_attention_bwd=per_layer * TRAIN_STEPS)
        if launches != want:
            fail(f"train: {TRAIN_STEPS} steps launched {launches}, expected {want}")
        if not (np.isfinite(losses).all() and np.isfinite(gnorms).all()):
            fail(f"train: losses {losses} grad norms {gnorms}")
        if not np.mean(losses[-5:]) < np.mean(losses[:5]):
            fail(f"train: the loss did not fall: {losses}")
        final = digest({"params": params, "m": opt.m, "v": opt.v})
        del params, opt, m
        torch.cuda.empty_cache()

        # resume: the checkpoint into fresh tensors, the rest of the run again
        fresh = masters(tree)
        t1 = time.perf_counter()
        step0, restored = restore(ckpt_dir, {"params": fresh, "opt": adamw_init(fresh)},
                                  "cuda")
        res["checkpoint_restore_s"] = time.perf_counter() - t1
        del fresh
        params, opt = restored["params"], restored["opt"]
        del restored
        resumed = []
        for s in range(step0, TRAIN_STEPS):
            params, opt, m = step_fn(params, opt, batches[s])
            resumed.append((m["loss"].item(), m["grad_norm"].item()))
        again = digest({"params": params, "m": opt.m, "v": opt.v})
        first = list(zip(losses[step0:], gnorms[step0:]))
        if step0 != TRAIN_CKPT or resumed != first or again != final:
            moved = [n for n, a, b in zip(leaf_names({"params": params, "m": opt.m,
                                                      "v": opt.v}), again, final)
                     if a != b]
            step = next((step0 + i for i, (a, b) in enumerate(zip(resumed, first))
                         if a != b), None)
            fail(f"train: resumed at step {step0}, steps {step0}-{TRAIN_STEPS - 1} "
                 f"do not repeat the run bit for bit: first differing step {step} "
                 f"(loss, grad norm {resumed[step - step0] if step is not None else '-'} "
                 f"against {first[step - step0] if step is not None else '-'}), "
                 f"{len(moved)} leaves differ at the end, first {moved[:3]}")
        # where a step's time goes: two more steps traced
        res["trace_steps"] = trace(lambda b: step_fn(params, opt, b), batches[0], 2,
                                   inference=False)
        del params, opt, m
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    tail = ev_ms[-10:]
    step_ms = statistics.median(tail)
    res.update(
        launches=launches, losses=losses, grad_norms=gnorms, step_event_ms=ev_ms,
        step_wall_ms=wall_ms, step_ms=step_ms, step_wall_ms_median=statistics.median(
            wall_ms[-10:]), tokens_per_s=B * T / step_ms * 1e3, peak_memory_mib=peak,
        resumed_from=TRAIN_CKPT, resumed_bitwise=True, wall_s=time.perf_counter() - t0)
    return launches, res


def print_train(res: dict) -> None:
    """The lines of the training phase."""
    B, T = res["batch"]
    print(f"train {res['arch']} uncut, {res['parameters']} parameters, float32 "
          f"masters, bfloat16 compute, remat; {res['steps']} steps of {B}x{T} "
          f"tokens, lr {res['lr']} warmup {res['warmup']} clip {res['clip']}; "
          f"launches {res['launches']} = (24 + 24 remat) flash_attention + 24 "
          f"flash_attention_bwd a step; first step {res['first_step_launches']}")
    w, r = res["grad_rel_l2_worst"]
    print(f"train first step vs plain: loss {res['loss_first']:.5f} vs "
          f"{res['loss_first_plain']:.5f} (limit {TRAIN_LOSS_TOL}), grad norm "
          f"{res['grad_norm_first']:.5f} vs {res['grad_norm_first_plain']:.5f} "
          f"(limit {100 * TRAIN_NORM_REL:.0f} %), worst leaf {w} rel L2 {r:.3e} "
          f"(limit {TRAIN_GRAD_REL}); twice, same bits; float32 "
          f"{TRAIN_F32_LAYERS} layers every grad within "
          f"{res['f32_max_grad_err_vs_plain']:.2e} (limit 2e-3 (1+|b|))")
    ls = res["losses"]
    print(f"train losses {ls[0]:.4f} -> {ls[-1]:.4f} (mean of the first 5 "
          f"{np.mean(ls[:5]):.4f}, last 5 {np.mean(ls[-5:]):.4f}), grad norms "
          f"{res['grad_norms'][0]:.3f} -> {res['grad_norms'][-1]:.3f}, all finite")
    print(f"train step ms (median of the last 10) events {res['step_ms']:.2f} wall "
          f"{res['step_wall_ms_median']:.2f}; {res['tokens_per_s']:.0f} tokens/s; "
          f"peak memory {res['peak_memory_mib']:.0f} MiB; checkpoint at step "
          f"{res['resumed_from']} saved in {res['checkpoint_save_s']:.1f} s, restored "
          f"in {res['checkpoint_restore_s']:.1f} s, steps {res['resumed_from']}-"
          f"{res['steps'] - 1} again bit for bit; refusals {res['refused']}; phase "
          f"wall {res['wall_s']:.1f} s")
    tr = res["trace_steps"]
    busy = tr["device_busy_share"]
    top = ", ".join(f"{k['name'][:40]} {k['ms']:.1f}" for k in tr["top"][:6])
    print(f"train traced x{tr['traced_requests']} steps: window {tr['window_ms']:.1f} "
          f"ms, device busy {tr['device_busy_ms']:.1f} ms "
          f"({'not measured' if busy is None else f'{100 * busy:.1f} %'}), own kernels "
          f"{tr['own_kernels_ms']:.2f} ms, {tr['device_kernel_launches']} device "
          f"kernels; top: {top}", flush=True)


@contextlib.contextmanager
def recording_routes():
    """Every expert choice ``layers.moe_route`` makes while open, in call
    order: a list of [N, k] index tensors."""
    got, route = [], lm_layers.moe_route

    def rec(*args, **kw):
        out = route(*args, **kw)
        got.append(out[2])
        return out

    lm_layers.moe_route = rec
    try:
        yield got
    finally:
        lm_layers.moe_route = route


def serve_lm(tag: str, cfg, mod, params, requests, rng) -> tuple:
    """An LM's eager requests through ``launch.serve``'s steps (prefill,
    then greedy decode from token 0), after a warm-up at the first and the
    last request's shape.  Around each prefill and each decode loop the
    counters are set to 0 and read: ``mod.kernel_launches_per_prefill`` in
    a prefill, nothing in decode.  Logits of their shape, finite over the
    vocabulary and -inf over its padding (the decode step masks it before
    the argmax), tokens in the vocabulary.  Returns (the prefill batches, the served records,
    the launches, the peak allocated MiB)."""
    prefill, decode = lm_serve.eager_steps(cfg, params)
    batches = [lm_batch(cfg, rng, b, t) for b, t, _ in requests]
    want = mod.kernel_launches_per_prefill(cfg)
    for i in (0, -1):
        B, T, gen = requests[i]
        _, cache, _ = lm_prefill(prefill, batches[i], decode_len(cfg, T, gen))
        lm_serve.run_decode(decode, cache, B, 2, batches[i]["tokens"].device)
    del cache
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    served, launches = [], {name: 0 for name in KERNELS}
    for i, (batch, (B, T, gen)) in enumerate(zip(batches, requests)):
        reset_counts()
        last, cache, prefill_ms = lm_prefill(prefill, batch, decode_len(cfg, T, gen))
        n_prefill = read_counts()
        reset_counts()
        toks, logits, cache_end, decode_ms = lm_serve.run_decode(
            decode, cache, B, gen, last.device)
        n_decode = read_counts()
        for name in KERNELS:
            expect = want.get(name, 0)
            if n_prefill[name] != expect or n_decode[name]:
                fail(f"{tag} request {i}: {name} launched {n_prefill[name]} "
                     f"times in prefill and {n_decode[name]} in decode, "
                     f"expected {expect} and 0")
            launches[name] += n_prefill[name] + n_decode[name]
        logits = torch.stack(logits, 1)
        V = cfg.vocab_size
        finite = bool(torch.isfinite(logits[..., :V]).all())
        masked = bool((logits[..., V:] == float("-inf")).all())
        if logits.shape != (B, gen, cfg.padded_vocab) or not (finite and masked) \
                or last.shape != (B, cfg.d_model):
            fail(f"{tag} request {i}: logits {tuple(logits.shape)}, finite over "
                 f"the vocabulary {finite}, padding -inf {masked}, last hidden "
                 f"{tuple(last.shape)}")
        if toks.shape != (B, gen) or not bool(
                ((toks >= 0) & (toks < cfg.vocab_size)).all()):
            fail(f"{tag} request {i}: tokens {tuple(toks.shape)} out of range")
        # the (self) K cache: [L, B, Hkv, S, D], S the decode budget of an
        # encoder-decoder, else the prompt (a ring of the window past it)
        S = decode_len(cfg, T, gen) or mod.cache_len(cfg, T)
        want_k = (cfg.block_pattern.count("attention") if cfg.block_pattern
                  else cfg.num_layers, B, cfg.num_kv_heads, S, cfg.head_dim)
        if k_cache_shape(cache) != want_k:
            fail(f"{tag} request {i}: K cache {k_cache_shape(cache)}, expected {want_k}")
        if cfg.family == "hybrid":
            n_rec = cfg.block_pattern.count("recurrent")
            got = {(tuple(h.shape), h.dtype) for h in cache.rec_h} | {
                (tuple(c.shape), c.dtype) for c in cache.conv_state}
            states = {((B, cfg.lru_width), torch.float32),
                      ((B, cfg.conv1d_width - 1, cfg.lru_width), cfg.compute_dtype)}
            if got != states or len(cache.rec_h) != n_rec or len(cache.conv_state) != n_rec:
                fail(f"{tag} request {i}: recurrent states {sorted(map(str, got))} x "
                     f"{len(cache.rec_h)}, expected {sorted(map(str, states))} x {n_rec}")
        served.append(dict(prompt=batch, last=last, cache=cache, cache_end=cache_end,
                           tokens=toks, logits=logits, prefill_ms=prefill_ms,
                           decode_ms=decode_ms))
    return batches, served, launches, torch.cuda.max_memory_allocated() / 2 ** 20


def k_cache_shape(cache) -> tuple:
    """[layers, B, Hkv, S, D] of a request's (self) K cache: the hybrid's
    list of attention layers, else the stacked first field."""
    if isinstance(cache, recurrentgemma.RGCache):
        return (len(cache.attn_k), *cache.attn_k[0].shape)
    return tuple(cache[0].shape)


def forced_run(cfg, params, batch: dict, dlen, tokens, kernels) -> tuple:
    """A request's prefill, then its decode steps fed the served tokens
    (teacher forcing), through ``kernels`` -> (last hidden, logits [B, n, Vp],
    the expert choices made on the way, the prefill's cache)."""
    with recording_routes() as routes:
        with torch.inference_mode():
            last, cache = build_prefill_step(cfg, decode_len=dlen, kernels=kernels)(
                params, batch)
        logits, _ = forced_decode(build_decode_step(cfg, kernels=kernels), params,
                                  cache, decode_inputs(tokens))
    return last, logits, routes, cache


def routing_agreement(got: list, want: list) -> tuple[int, int]:
    """(claims of ``got`` that the same token's choices in ``want`` hold,
    claims), over two runs' ``recording_routes``."""
    same = sum(int((a[:, :, None] == b[:, None, :]).any(-1).sum())
               for a, b in zip(got, want, strict=True))
    return same, sum(a.numel() for a in got)


def hold_to_plain(tag: str, cfg, params, served, requests) -> dict:
    """The first and the last served request against the plain model
    (``kernels=ref.PLAIN``), teacher-forced with the served tokens:
    ``BF16_LOGITS_TOL`` on the logits, ``BF16_AGREEMENT`` on the greedy
    tokens.  For an MoE model, also the share of (token, choice) routings
    of the kernel model (the same requests forced through ``ops``) that the
    plain model's choices for that token hold."""
    V = cfg.vocab_size
    err, hidden_err, agree, steps, same, claims = 0.0, 0.0, 0, 0, 0, 0
    for i in (0, len(served) - 1):
        r, (_, T, gen) = served[i], requests[i]
        dlen = decode_len(cfg, T, gen)
        last_p, logits_p, routes_p, _ = forced_run(cfg, params, r["prompt"], dlen,
                                                   r["tokens"], ref.PLAIN)
        err = max(err, (r["logits"][..., :V] - logits_p[..., :V]).abs().max().item())
        hidden_err = max(hidden_err, (r["last"].float() - last_p.float())
                         .abs().max().item())
        agree += int((logits_p[..., :V].argmax(-1) == r["tokens"]).sum())
        steps += r["tokens"].numel()
        if cfg.moe.enabled:
            routes_k = forced_run(cfg, params, r["prompt"], dlen, r["tokens"], ops)[2]
            n_same, n = routing_agreement(routes_k, routes_p)
            same, claims = same + n_same, claims + n
        del logits_p, routes_p
    if err > BF16_LOGITS_TOL or agree < BF16_AGREEMENT * steps:
        fail(f"{tag} bfloat16: logits differ from the plain model by {err:.3e} "
             f"(limit {BF16_LOGITS_TOL}), greedy tokens agree {agree}/{steps} "
             f"(at least {BF16_AGREEMENT:.0%})")
    out = dict(bf16_max_logits_err_vs_plain=err,
               bf16_max_last_hidden_err_vs_plain=hidden_err,
               bf16_greedy_agreement=agree / steps)
    if claims:
        out["bf16_routing_agreement"] = same / claims
        out["routing_claims"] = claims
    return out


def lm_result(served, requests, launches, peak, cap, vocab: int) -> dict:
    """The phase's numbers: each request's prefill and decode ms (eager),
    the medians at the first request's shape and the last request's, peak
    memory, |logits|, first tokens and the captured form's numbers."""
    first = [r for r, q in zip(served, requests) if q[:2] == requests[0][:2]]
    return dict(
        requests=requests, launches=launches,
        prefill_ms=[r["prefill_ms"] for r in served],
        decode_ms_per_token=[r["decode_ms"] / r["tokens"].shape[1] for r in served],
        prefill_ms_first=statistics.median(r["prefill_ms"] for r in first),
        decode_ms_per_token_first=statistics.median(
            r["decode_ms"] / r["tokens"].shape[1] for r in first),
        prefill_ms_last=served[-1]["prefill_ms"],
        decode_ms_per_token_last=served[-1]["decode_ms"] / served[-1]["tokens"].shape[1],
        peak_memory_mib=peak,
        logits_abs_max=max(r["logits"][..., :vocab].abs().max().item() for r in served),
        first_tokens=served[0]["tokens"][0, :16].tolist(), captured=cap)


def lm_phase(tag: str, cfg, mod, params, requests, rng) -> tuple:
    """Serve ``requests`` eager (``serve_lm``), then captured
    (``lm_captured``, 6 / 4 rounds, and a trace of three captured prefills
    at the first request's shape), then hold the eager records to the
    plain model (``hold_to_plain``).  Returns (launches, numbers)."""
    batches, served, launches, peak = serve_lm(tag, cfg, mod, params, requests, rng)
    cap, records, (_, _, pre_c, _) = lm_captured(cfg, mod, params, batches, served,
                                                 rng, requests, rounds=(6, 4))
    B, T, gen = requests[0]
    dlen = decode_len(cfg, T, gen)
    cap["trace_prefill_first"] = trace(
        lambda b: lm_serve.call_prefill(pre_c, b, dlen), batches[0], 3)
    if len(pre_c.graphs) != len({(b, t) for b, t, _ in requests}):
        fail(f"{tag}: the captured prefill holds {len(pre_c.graphs)} graphs, "
             f"one a request shape expected")
    del records, pre_c
    result = lm_result(served, requests, launches, peak, cap, cfg.vocab_size)
    result.update(hold_to_plain(tag, cfg, params, served, requests))
    return launches, result


def moe_f32_check(cfg, tree, rng) -> tuple[float, float]:
    """``qwen2-moe-a2.7b`` at full width in float32 on the first
    MOE_F32_LAYERS layers of the served weights: a 2 x 256 prefill and 4
    greedy steps through the kernels, held to the plain model fed the same
    tokens (last hidden, cache, logits within 2e-3 (1 + |b|)); also the
    share of routings the two agree on."""
    n, B, T, steps = MOE_F32
    cfg32 = dataclasses.replace(cfg, num_layers=n, dtype="float32")
    sub = dict(tree, blocks=tree_map(lambda a, path: a[:n], tree["blocks"]))
    params = transformer.load_params(cfg32, sub)
    batch = lm_batch(cfg32, rng, B, T)
    pre, dec = lm_serve.eager_steps(cfg32, params)
    with recording_routes() as routes_k:
        last_k, cache_k, _ = lm_prefill(pre, batch)
        toks, logits_k, _, _ = lm_serve.run_decode(dec, cache_k, B, steps, last_k.device)
    last_p, logits_p, routes_p, cache_p = forced_run(cfg32, params, batch, None,
                                                     toks, ref.PLAIN)
    # the greedy run's prefill routes come first in both lists
    same, claims = routing_agreement(routes_k, routes_p)
    err = max(compare("moe float32 last hidden", last_k, last_p, 2e-3),
              compare("moe float32 cache k", cache_k.k, cache_p.k, 2e-3),
              compare("moe float32 cache v", cache_k.v, cache_p.v, 2e-3),
              compare("moe float32 logits", torch.stack(logits_k, 1), logits_p, 2e-3))
    return err, same / claims


def moe_path():
    """``qwen2-moe-a2.7b`` at full width and 8 of its 24 layers served
    through ``launch.serve``'s steps, eager then captured, held to its
    plain model (module docstring, phase 5c).  Returns (launches, numbers)."""
    t0 = time.perf_counter()
    full = get_config(MOE_ARCH)
    cfg = dataclasses.replace(full, num_layers=MOE_LAYERS)
    print(f"moe {MOE_ARCH} reduced: num_layers {full.num_layers} -> "
          f"{cfg.num_layers} (every layer has the same shapes; the uncut "
          f"{count_params(transformer.param_defs(full))} parameters would be "
          f"{4 * count_params(transformer.param_defs(full)) / 1e9:.1f} GB of "
          f"float32 on the host)", flush=True)
    defs = transformer.param_defs(cfg)
    if count_params(defs) != MOE_PARAMS:
        fail(f"moe: {count_params(defs)} parameters, expected {MOE_PARAMS}")
    want = transformer.kernel_launches_per_prefill(cfg)
    if want != {"flash_attention": MOE_LAYERS}:
        fail(f"moe: should launch flash_attention {MOE_LAYERS} times a prefill, "
             f"model says {want}")
    t1 = time.perf_counter()
    tree = init_params(SEED, defs)              # numpy float32, on the host
    init_s = time.perf_counter() - t1
    params = transformer.load_params(cfg, tree)  # as served: bfloat16 compute
    rng = np.random.default_rng(SEED + 4)
    launches, result = lm_phase("moe", cfg, transformer, params, MOE_REQUESTS, rng)
    del params
    torch.cuda.empty_cache()
    f32_err, f32_routing = moe_f32_check(cfg, tree, rng)
    del tree
    torch.cuda.empty_cache()
    result.update(arch=MOE_ARCH, layers=MOE_LAYERS, parameters=MOE_PARAMS,
                  init_params_s=init_s, f32_max_err_vs_plain_on_card=f32_err,
                  f32_routing_agreement=f32_routing,
                  wall_s=time.perf_counter() - t0)
    return launches, result


def audio_path():
    """``seamless-m4t-large-v2`` uncut served through ``launch.serve``'s
    steps, eager then captured, held to its plain model (module docstring,
    phase 5d).  Returns (launches, numbers)."""
    t0 = time.perf_counter()
    cfg = get_config(AUDIO_ARCH)
    defs = seamless.param_defs(cfg)
    if count_params(defs) != AUDIO_PARAMS:
        fail(f"audio: {count_params(defs)} parameters, expected {AUDIO_PARAMS}")
    want = seamless.kernel_launches_per_prefill(cfg)
    if want != {"flash_attention": 72}:
        fail(f"audio: should launch flash_attention 72 times a prefill, model "
             f"says {want}")
    t1 = time.perf_counter()
    tree = init_params(SEED, defs)
    init_s = time.perf_counter() - t1
    params = seamless.load_params(cfg, tree)
    del tree
    rng = np.random.default_rng(SEED + 5)
    launches, result = lm_phase("audio", cfg, seamless, params, AUDIO_REQUESTS, rng)
    del params
    torch.cuda.empty_cache()
    result.update(arch=AUDIO_ARCH, parameters=AUDIO_PARAMS, init_params_s=init_s,
                  wall_s=time.perf_counter() - t0)
    return launches, result


def hybrid_f32_check(cfg, tree, rng) -> float:
    """``recurrentgemma-2b`` at full width in float32 on the first
    HYBRID_F32 layers (recurrent, recurrent, attention) of the served
    weights: a prefill and greedy steps through the kernels (the attention
    in float32, D 256 in two chunks over the grid), held to the plain model
    fed the same tokens: last hidden, every cache leaf (the scan's states,
    the convolution's, K / V), logits within 2e-3 (1 + |b|)."""
    n, B, T, steps = HYBRID_F32
    cfg32 = dataclasses.replace(cfg, num_layers=n, block_pattern=cfg.block_pattern[:n],
                                dtype="float32")
    params = recurrentgemma.load_params(cfg32, dict(tree, blocks=tree["blocks"][:n]))
    batch = lm_batch(cfg32, rng, B, T)
    pre, dec = lm_serve.eager_steps(cfg32, params)
    reset_counts()
    last_k, cache_k, _ = lm_prefill(pre, batch)
    if read_counts()["flash_attention"] != cfg32.block_pattern.count("attention"):
        fail(f"hybrid float32: {read_counts()} launches in its prefill")
    toks, logits_k, _, _ = lm_serve.run_decode(dec, cache_k, B, steps, last_k.device)
    last_p, logits_p, _, cache_p = forced_run(cfg32, params, batch, None, toks, ref.PLAIN)
    errs = [compare("hybrid float32 last hidden", last_k, last_p, 2e-3),
            compare("hybrid float32 logits", torch.stack(logits_k, 1), logits_p, 2e-3)]
    for i, (a, b) in enumerate(zip(pytree.tree_leaves(cache_k),
                                   pytree.tree_leaves(cache_p), strict=True)):
        errs.append(compare(f"hybrid float32 cache leaf {i}", a, b, 2e-3))
    return max(errs)


def hybrid_path():
    """``recurrentgemma-2b`` uncut served through ``launch.serve``'s steps,
    eager then captured, held to its plain model, then the float32 check on
    its first three layers (module docstring, phase 5e).  Returns
    (launches, numbers)."""
    t0 = time.perf_counter()
    cfg = get_config(HYBRID_ARCH)
    defs = recurrentgemma.param_defs(cfg)
    if count_params(defs) != HYBRID_PARAMS:
        fail(f"hybrid: {count_params(defs)} parameters, expected {HYBRID_PARAMS}")
    want = recurrentgemma.kernel_launches_per_prefill(cfg)
    if want != {"flash_attention": 8}:
        fail(f"hybrid: should launch flash_attention 8 times a prefill, model "
             f"says {want}")
    t1 = time.perf_counter()
    tree = init_params(SEED, defs)              # numpy float32, on the host
    init_s = time.perf_counter() - t1
    params = recurrentgemma.load_params(cfg, tree)  # as served: bfloat16 compute
    rng = np.random.default_rng(SEED + 6)
    launches, result = lm_phase("hybrid", cfg, recurrentgemma, params,
                                HYBRID_REQUESTS, rng)
    del params
    torch.cuda.empty_cache()
    f32_err = hybrid_f32_check(cfg, tree, rng)
    del tree
    torch.cuda.empty_cache()
    result.update(arch=HYBRID_ARCH, parameters=HYBRID_PARAMS, init_params_s=init_s,
                  f32_max_err_vs_plain_on_card=f32_err,
                  wall_s=time.perf_counter() - t0)
    return launches, result


def print_lm(tag: str, res: dict, per_prefill: int) -> None:
    """The lines of an LM phase (``lm_phase``'s numbers)."""
    (B0, T0, g0), (B1, T1, g1) = res["requests"][0], res["requests"][-1]
    print(f"{tag} {res['arch']} requests {res['requests']} (batch, prompt, greedy "
          f"tokens), {res['parameters']} parameters (init on the host "
          f"{res['init_params_s']:.1f} s), launches {res['launches']} = "
          f"{per_prefill} flash_attention a prefill, 0 in decode")
    print(f"{tag} prefill ms {B0}x{T0} {res['prefill_ms_first']:.3f} {B1}x{T1} "
          f"{res['prefill_ms_last']:.3f}; decode ms/token B={B0} "
          f"{res['decode_ms_per_token_first']:.3f} B={B1} "
          f"{res['decode_ms_per_token_last']:.3f} (eager); peak memory "
          f"{res['peak_memory_mib']:.0f} MiB")
    routing = (f", expert routings agree {res['bf16_routing_agreement']:.4f} of "
               f"{res['routing_claims']}" if "bf16_routing_agreement" in res else "")
    print(f"{tag} bfloat16 vs plain: max |dlogits| "
          f"{res['bf16_max_logits_err_vs_plain']:.3e} (limit {BF16_LOGITS_TOL}), "
          f"last hidden {res['bf16_max_last_hidden_err_vs_plain']:.3e}, greedy "
          f"agreement {res['bf16_greedy_agreement']:.3f} (at least "
          f"{BF16_AGREEMENT}){routing}; |logits| <= {res['logits_abs_max']:.3f}")
    cap = res["captured"]
    for shape, c in cap["captures"].items():
        print(f"{tag} captured {shape}: capture prefill {c['prefill_capture_s']:.2f} s "
              f"decode {c['decode_capture_s']:.2f} s (host clock, {WARMUP} warm-up "
              f"runs included), launches prefill "
              f"{c['prefill_launches']['flash_attention']} flash_attention = "
              f"(1 + {WARMUP}) x {per_prefill}, decode "
              f"{sum(c['decode_launches'].values())}; graph reserved "
              f"{c['prefill_reserved_mib']:.0f} + {c['decode_reserved_mib']:.0f} MiB")
    print(f"{tag} captured: {cap['bitwise_equal_requests']} requests replayed equal "
          f"the eager steps bit for bit (last hidden, prefill cache, tokens, "
          f"logits, last cache), launches on replay "
          f"{sum(cap['launches_on_replay'].values())}")
    for key, t in cap["timing"].items():
        unit = "ms/token" if key.startswith("decode") else "ms"
        print(f"{tag} {key} {unit} eager|captured (median, in turns): events "
              f"{t['eager']['event_ms']:.3f}|{t['captured']['event_ms']:.3f} wall "
              f"{t['eager']['wall_ms']:.3f}|{t['captured']['wall_ms']:.3f}")
    tr = cap["trace_prefill_first"]
    busy = tr["device_busy_share"]
    print(f"{tag} captured prefill {B0}x{T0} traced x{tr['traced_requests']}: window "
          f"{tr['window_ms']:.2f} ms, device busy {tr['device_busy_ms']:.2f} ms "
          f"({'not measured' if busy is None else f'{100 * busy:.1f} %'}), own "
          f"kernels {tr['own_kernels_ms']:.2f} ms, {tr['device_kernel_launches']} "
          f"device kernels; phase wall {res['wall_s']:.1f} s", flush=True)


def split_text(rec: dict) -> str:
    """`` [regime R] splits S ctas N`` from a record's plan, the depthwise
    tile ``tile THxTWxCB cv CV ctas N smem S``, or the WKV plan ``wv W
    warps N rows R ctas N | states ctas N``, if it has one."""
    if "states_ctas" in rec:
        return (f" wv {rec['wv']} warps {rec['warps']} rows {rec['rows']} ctas "
                f"{rec['ctas']} | states ctas {rec['states_ctas']}")
    if "cb" in rec:
        return (f" tile {rec['th']}x{rec['tw']}x{rec['cb']} cv {rec['cv']} "
                f"ctas {rec['ctas']} smem {rec['smem']}")
    if "splits" not in rec:
        return ""
    regime = f" regime {rec['regime']}" if "regime" in rec else ""
    return f"{regime} splits {rec['splits']} ctas {rec['ctas']}"


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write every number to this JSON file")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "runs on a CUDA device only", file=sys.stderr)
        sys.exit(2)
    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. device
    smi = run_text(["nvidia-smi", "--query-gpu=name,power.limit",
                    "--format=csv,noheader"]).splitlines()[0]
    nvcc = run_text([_build._nvcc(), "--version"]).splitlines()[-2:]
    print(f"device {smi}")
    print(f"versions python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} | {' | '.join(nvcc)}", flush=True)

    # 2. build
    want_sources = sorted(ROOT / info["source"] for info in KERNELS.values())
    if _build.sources() != want_sources:
        fail(f"build: sources {[str(p) for p in _build.sources()]}, expected "
             f"the {len(want_sources)} of KERNELS")
    _build.library()
    built = _build.build_seconds
    print(f"build {len(_build.sources())} sources -> {_build.build_dir()} in "
          f"{'(reused)' if built is None else f'{built:.1f} s'} (set-up)")
    for line in _build.ptxas_log().splitlines():
        if "spill" in line and "0 bytes spill stores, 0 bytes spill loads" not in line:
            print(f"ptxas {line.strip()}")
    regs = [int(tok) for line in _build.ptxas_log().splitlines() if "Used" in line
            for tok in [line.split("Used")[1].split()[0]]]
    print(f"ptxas {len(regs)} kernels, registers {min(regs)}..{max(regs)} a thread",
          flush=True)
    for inst, (n_regs, stores, loads) in online_ptxas(_build.ptxas_log()).items():
        print(f"ptxas online_kernel<{inst}>: {n_regs} registers a thread, spill "
              f"stores {stores} loads {loads} bytes")

    # 3. kernels against their plain versions
    per_kernel = kernels_phase()
    for name, rec in per_kernel.items():
        for s in rec["shapes"]:
            lib = "none" if s["library_ms"] is None else f"{s['library_ms']:.4f}"
            split = split_text(s)
            pre = f" ({s['per_prefill']} a prefill)" if "per_prefill" in s else ""
            fwd = (f" | forward ms {s['fwd_ms']:.4f}, with lse {s['fwd_lse_ms']:.4f}"
                   if "fwd_ms" in s else "")
            print(f"kernel {s['case']} x{s['per_forward']}{pre}: err "
                  f"{s['max_abs_err']:.2e} ms {s['ms']:.4f} plain {s['plain_ms']:.4f} "
                  f"library {lib} bound {s['bound_ms']:.4f} ({s['bound_by']}){split}{fwd}")
        for s in rec["extra"]:
            split = split_text(s)
            print(f"kernel {s['case']}: err {s['max_abs_err']:.2e} (tol {s['tol']}){split}")
    sys.stdout.flush()

    # 4. main path, EdgeNeXt-S
    launches, served = main_path()
    print(f"main_path EdgeNeXt-S requests {served['requests']} launches {launches} "
          f"err_vs_plain {served['max_abs_err_vs_plain_on_card']:.2e} "
          f"err_vs_cpu {served['max_abs_err_vs_plain_on_cpu']:.2e} "
          f"|logits| <= {served['logits_abs_max']:.3f}")
    print(f"main_path ms/request B=16 {served['ms_per_request_b16']:.3f} "
          f"(plain {served['plain_ms_per_request_b16']:.3f}) "
          f"B=1 {served['ms_per_request_b1']:.3f} "
          f"(plain {served['plain_ms_per_request_b1']:.3f}) "
          f"peak memory {served['peak_memory_mib']:.0f} MiB", flush=True)
    cap = served["captured"]
    c16, c1 = cap["captures"][BATCH], cap["captures"][1]
    print(f"main_path captured EdgeNeXt-S: capture B=16 {c16['capture_s']:.2f} s "
          f"B=1 {c1['capture_s']:.2f} s (host clock, {WARMUP} warm-up forwards "
          f"included), launches at each capture {c16['launches']} = "
          f"(1 + {WARMUP} warm-up) x 18/21/3, over {len(cap['requests'])} "
          f"replays {cap['launches_on_replay']}; logits equal the eager ones "
          f"bit for bit on requests {cap['requests']}, err vs plain "
          f"{cap['max_abs_err_vs_plain_on_card']:.2e}")
    for b in (BATCH, 1):
        t, m = cap["timing"][b], cap["peak_allocated_mib"][b]
        print(f"main_path B={b} ms/request eager|captured (median of 10, in "
              f"turns): events {t['eager']['event_ms']:.3f}|"
              f"{t['captured']['event_ms']:.3f} wall "
              f"{t['eager']['wall_ms']:.3f}|{t['captured']['wall_ms']:.3f}; "
              f"peak allocated {m['eager']:.0f}|{m['captured']:.0f} MiB, graph "
              f"reserved {cap['captures'][b]['reserved_mib']:.0f} MiB", flush=True)

    # 5. main path, RWKV-6 1.6B
    rwkv_launches, rwkv = rwkv6_path()
    print(f"rwkv6 requests {rwkv['requests']} x {rwkv['gen']} tokens, "
          f"{rwkv['parameters']} parameters (init on the host "
          f"{rwkv['init_params_s']:.1f} s), launches {rwkv_launches} = "
          f"24 wkv_chunked a prefill, 0 in decode")
    print(f"rwkv6 prefill ms B=4 T=512 {rwkv['prefill_ms_b4_t512']:.3f} "
          f"B=1 T=200 {rwkv['prefill_ms_b1_t200']:.3f}; decode ms/token B=4 "
          f"{rwkv['decode_ms_per_token_b4']:.3f} B=1 "
          f"{rwkv['decode_ms_per_token_b1']:.3f}; peak memory "
          f"{rwkv['peak_memory_mib']:.0f} MiB")
    print(f"rwkv6 bfloat16 vs plain: max |dlogits| "
          f"{rwkv['bf16_max_logits_err_vs_plain']:.3e} (limit {BF16_LOGITS_TOL}), "
          f"last hidden {rwkv['bf16_max_last_hidden_err_vs_plain']:.3e}, greedy "
          f"agreement {rwkv['bf16_greedy_agreement']:.3f} (at least "
          f"{BF16_AGREEMENT}); |logits| <= {rwkv['logits_abs_max']:.3f}")
    print(f"rwkv6 float32 err vs plain on card {rwkv['f32_max_err_vs_plain_on_card']:.2e}, "
          f"vs CPU {rwkv['f32_max_err_vs_plain_on_cpu']:.2e} (limit 2e-3 (1+|b|))",
          flush=True)
    cap = rwkv["captured"]
    for shape, c in cap["captures"].items():
        print(f"rwkv6 captured {shape}: capture prefill {c['prefill_capture_s']:.2f} s "
              f"decode {c['decode_capture_s']:.2f} s (host clock, {WARMUP} warm-up "
              f"runs included), launches prefill {c['prefill_launches']['wkv_chunked']} "
              f"wkv_chunked = (1 + {WARMUP}) x 24, decode "
              f"{sum(c['decode_launches'].values())}; graph reserved "
              f"{c['prefill_reserved_mib']:.0f} + {c['decode_reserved_mib']:.0f} MiB")
    bf = cap["bf16_vs_plain"]
    print(f"rwkv6 captured: {cap['bitwise_equal_requests']} requests replayed equal "
          f"the eager steps bit for bit (last hidden, prefill cache, {RWKV_GEN} "
          f"steps of tokens and logits, last cache), launches on replay "
          f"{sum(cap['launches_on_replay'].values())}; bfloat16 vs plain "
          f"{bf['max_logits_err']:.3e}, agreement {bf['greedy_agreement']:.3f}; "
          f"float32 (bit for bit the eager) vs plain "
          f"{cap['f32_max_err_vs_plain_on_card']:.2e}")
    for key, t in cap["timing"].items():
        unit = "ms/token" if key.startswith("decode") else "ms"
        print(f"rwkv6 {key} {unit} eager|captured (median, in turns): events "
              f"{t['eager']['event_ms']:.3f}|{t['captured']['event_ms']:.3f} wall "
              f"{t['eager']['wall_ms']:.3f}|{t['captured']['wall_ms']:.3f}")
    m, w = cap["peak_allocated_mib_b4_t512"], cap["wkv_graph"]
    print(f"rwkv6 4x512 request peak allocated eager|captured {m['eager']:.0f}|"
          f"{m['captured']:.0f} MiB; wkv_chunked alone in a graph: "
          f"{w['kernel_nodes']} kernel nodes, edge types {w['edge_types']} "
          f"(1 = programmatic), replay follows new inputs bit for bit, ms eager "
          f"{w['eager_ms']:.4f} graph {w['graph_ms']:.4f}", flush=True)

    # 5b. the dense path, h2o-danube-1.8b uncut
    dense_launches, dense, dense_tree = dense_path()
    print_lm("dense", dense, 24)

    # 5f. training on the dense path's weights (run here, while they are
    # on the host)
    train_launches, train = train_path(get_config(DENSE_ARCH), dense_tree)
    del dense_tree
    print_train(train)

    # 5c. the MoE path, qwen2-moe-a2.7b at 8 of its 24 layers
    moe_launches, moe = moe_path()
    print_lm("moe", moe, MOE_LAYERS)
    print(f"moe float32 ({MOE_F32[0]} layers, {MOE_F32[1]}x{MOE_F32[2]}, "
          f"{MOE_F32[3]} steps) err vs plain on card "
          f"{moe['f32_max_err_vs_plain_on_card']:.2e} (limit 2e-3 (1+|b|)), expert "
          f"routings agree {moe['f32_routing_agreement']:.4f}", flush=True)

    # 5d. the encoder-decoder, seamless-m4t-large-v2 uncut
    audio_launches, audio = audio_path()
    print_lm("audio", audio, 72)

    # 5e. the hybrid, recurrentgemma-2b uncut
    hybrid_launches, hybrid = hybrid_path()
    print_lm("hybrid", hybrid, 8)
    print(f"hybrid float32 ({HYBRID_F32[0]} layers {'/'.join(get_config(HYBRID_ARCH).block_pattern[:HYBRID_F32[0]])}, "
          f"{HYBRID_F32[1]}x{HYBRID_F32[2]}, {HYBRID_F32[3]} steps) err vs plain on "
          f"card {hybrid['f32_max_err_vs_plain_on_card']:.2e} (limit 2e-3 (1+|b|))",
          flush=True)

    # 6. the scheduler's path: every lowered entry onto its kernel
    lowered, entries, by_workload, lowered_launches, verified, samples, launched = \
        lowered_phase()
    for name, kern in LOWERED.items():
        recs = [r for r in lowered if r["kernel"] == kern]
        print(f"lowered {name}: {entries[name]} entries over {len(WORKLOADS)} "
              f"workloads, {len(recs)} distinct launches, all passed, max err "
              f"{max(r['max_abs_err'] for r in recs):.2e} (tol {recs[0]['tol']})")
    print(f"lowered rwkv_chunk entries by workload: {by_workload['rwkv_chunk']}; "
          f"0 waiting", flush=True)
    check = dict(verified, **check_phase(samples))
    found = check["findings"]
    print(f"check: {len(found)} workloads verified, {sum(found.values())} "
          f"findings ({check['verify_s']:.2f} s on the host); mutation corpus "
          f"{check['corpus']['caught']}/{check['corpus']['total']} caught; "
          f"{sum(1 for c in check['agreement'] if c['ops_refused'])} "
          f"lint-flagged blocks refused by ops with no launch "
          f"({check['check_phase_s']:.2f} s)", flush=True)

    # 7. the schedule store: warm, disk hits, its new launches, chaos
    serve_launches, store = serve_phase(launched)
    w, d, ln, ch = store["warm"], store["disk"], store["launch"], store["chaos"]
    print(f"serve warm: {w['entries']} entries ({', '.join(SERVE_WORKLOADS)} at "
          f"batches {list(BATCH_LEVELS)}), {w['searched']} searched, "
          f"{w['worker_failed']} workers failed; a spawned pool of {w['jobs']} "
          f"with the card's context live, {w['seconds']:.2f} s on the host")
    print(f"serve disk: a fresh store answered {d['disk_hits']}/{d['requests']} "
          f"requests from disk, each a cache.hit verified with 0 findings; host ms "
          f"a disk hit verified {d['disk_hit_ms']:.3f} (median, max "
          f"{d['disk_hit_ms_max']:.3f}), unverified {d['disk_hit_unverified_ms']:.3f}, "
          f"a memory hit {d['mem_hit_ms']:.4f} (max {d['mem_hit_ms_max']:.4f})")
    print(f"serve launch: {ln['workload']} answers carry {ln['entries']} lowered "
          f"entries, {ln['distinct']} distinct, {ln['already_launched']} run by the "
          f"lowered phase, {ln['new']} new by batch {ln['new_by_batch']} all passed, "
          f"max err {max(r['max_abs_err'] for r in ln['records']):.2e}; launches "
          f"{serve_launches}")
    for r in ln["records"]:
        lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        print(f"serve kernel {r['case']} B={r['batch']}: err {r['max_abs_err']:.2e} "
              f"(tol {r['tol']}) ms {r['ms']:.4f} plain {r['plain_ms']:.4f} library "
              f"{lib} bound {r['bound_ms']:.4f} ({r['bound_by']}){split_text(r)}")
    print(f"serve chaos: {ch['served']}/{ch['requests']} served ({ch['plan']}, seed "
          f"{ch['seed']}), {ch['degraded']} degraded, outcomes {ch['outcomes']}, "
          f"faults {ch['faults']}; every answer verified with 0 findings (a degraded "
          f"one with its marker); launches during the session {ch['launches']}",
          flush=True)

    # 8. results
    rows = summarise(per_kernel, {"edgenext_serve": launches,
                                  "rwkv6_serve": rwkv_launches,
                                  "dense_serve": dense_launches,
                                  "dense_train": train_launches,
                                  "moe_serve": moe_launches,
                                  "audio_serve": audio_launches,
                                  "hybrid_serve": hybrid_launches,
                                  "lowered": lowered_launches,
                                  "serve_store": serve_launches})
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(dict(
            device=device, nvidia_smi=smi, torch=torch.__version__,
            cuda=torch.version.cuda, nvcc=nvcc, build_seconds=built,
            kernels=rows, main_path=served, rwkv6=rwkv, dense=dense, train=train,
            moe=moe,
            audio=audio, hybrid=hybrid, check=check,
            serve=store,
            lowered=dict(records=lowered, entries=entries,
                         by_workload=by_workload)), indent=1))
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"check": check}))
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": device}), flush=True)


if __name__ == "__main__":
    main()
