#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU (written for H100).

    python3 chip_smoke.py            # everything; needs one CUDA device

What it does, in order, failing (non-zero exit) as soon as a phase fails:

  1. prints the device (torch's name, and nvidia-smi's name + power limit);
  2. builds the CUDA kernels of ``src/repro_torch/kernels/csrc`` with nvcc;
  3. holds each kernel against its plain PyTorch version on the card, at the
     shapes the serving and training paths give it and at ragged ones, and
     checks that the same inputs twice give the same bits (the k-quantile
     codec kernels (both routes of ``codec_route``, views off a 16-byte
     boundary, more than 2^31 elements, the paged pool read) must equal
     their plain versions to the bit, and so must
     the on-chip draw of ``uniq_noise_fwd_onchip``, read back through its
     debug entry point, against the plain Philox; both bodies of the
     ``uniq_noise`` forwards, and a mode given by value, to the bit; the
     fused KV append's statistics at most one bf16 ulp from the plain
     version's, its codes bit-equal where they agree, every other pool
     byte untouched; the MoE expert matmuls ``qmatmul_experts`` /
     ``qmatmul_lut_experts`` at kimi_k2's and llama4's expert widths (C =
     8, and 16 and 32 as the engine's coalesced prefill gives them) and
     ragged shapes, with idle experts' rows NaN on the way in and the
     output and scratch allocated as NaN, the idle rows exactly zero on the
     way out);
  4. serves a request stream through ``repro_torch``'s engine at the full
     width of granite_3_8b (bf16, kv8 pool), random weights made from
     ``--seed`` on the card, in three engines one after another: W4
     (``qmatmul``), W4A8 (int8 activations, ``qmatmul_a8``) and W4 with
     empirical codebooks (``--w-dist empirical``, ``qmatmul_lut``); counts
     the kernel launches of each run (``kv_append`` codes and writes the KV
     rows, one launch per layer and call; ``kquantile_dequantize_paged``
     gathers and decodes the coded pool for each prefill chunk, one launch
     for K and one for V per layer; ``kquantile_dequantize`` decodes the
     embedding rows of the Gaussian engines; ``kquantile_quantize`` codes
     the weights at load and runs no more in the stream);
     checks that the dense bf16 LM head gives f32 logits; writes the W4
     engine's metrics snapshot and Chrome trace as the serving CLI's
     ``--metrics-out`` / ``--trace-out`` do (a temporary directory) and
     runs ``analysis/traceview`` over them (no problem allowed; its cost
     attribution printed);
  4L. long context, right after the W4 engine and on its coded weights
     (the library's default ``ModelOpts``: chunked attention from 8,192
     rows in KV chunks of 1,024): an engine with the prefix cache off (so
     admission is the whole prompt's ``forward_prefill``), one prompt a
     prefill and ``max_len`` 32,832, serving prompts of 8,192, 16,000 and
     32,000 tokens (buckets 8,192, 16,384 and 32,768 rows) 32 greedy tokens
     each, every launch counted exactly (``qmatmul`` 7 x L a call and a
     step, ``paged_quant_attention`` and ``kv_append`` L a step over up to
     513 pages a sequence, ``kquantile_quantize`` / ``_dequantize`` L a
     prefill for its K/V, ``kquantile_dequantize`` once a call for the
     embedding rows); the prefill time by bucket, TTFT, ITL, the peak
     memory beside the reckoning, a decode step profiled, traceview over
     its artifacts; the 16,000-token request again with the plain versions
     (greedy tokens equal or a near-tie, logits within ``TOL_LOGITS_REL``,
     a wrong-code control outside it); chunked against whole attention on
     an 8,192-row prefill of granite_3_8b, then (after the three engines)
     of gemma2_9b and zamba2_2_7b at full width and depth (the first
     attention's K/V bit-equal, the next layer's within
     ``TOL_CHUNKED_KV1_REL``; last logits within ``TOL_CHUNKED_LOGITS_REL``,
     the greedy token equal or a near-tie, every layer's K/V within
     ``TOL_CHUNKED_KV_REL``; gemma2's stack grows a bf16 difference past
     those, so its whole stack is held in f32 with the plain versions and
     dense K/V, within ``TOL_CHUNKED_F32_REL``); after phase 6's trainer,
     one f32 step of
     granite_3_8b (2 layers, batch 1 x 8,192, all NOISE) chunked against
     whole on the same noise, then an AdamW step, ``uniq_noise`` launches
     counted; and one step under ``UniqConfig(dist="empirical")`` (7 + 7
     ``uniq_noise`` launches for the stacked layer weights; the embedding
     and head, empirical, get a zero loss gradient and move by weight
     decay alone);
  4M. the analysis subsystem, after 4L and on phase 4's coded weights:
     the model checker over every universe, the mutants' too, on the
     sound scheduler (exhausted, zero findings);
     every trace of ``tests/data/mc_corpus`` and a healthy forward trace
     replayed on the engine at granite_3_8b's full width and depth (W4,
     bf16, the universe's kv_bits, pages of 4): each mutant trace trips
     its invariant with no action skipped, the regression trace runs
     clean, two healthy replays (kv16, and a kv8 twin of 6 new tokens a
     request whose decode takes ``paged_quant_attention``'s CUDA-core
     body, read from the launch records) give bit-identical streams, the
     kv8 replay with the plain versions forced and fed the kernel side's
     tokens gives logits within ``TOL_LOGITS_REL`` at every sampling call
     (prefill chunks and decode steps; a flip a near-tie) and the same
     replay with every coded matmul weight one level off lands above
     that limit, every replay's launches exact; then the check CLI's
     four passes (lint, the
     kernel audit, the compile audit with granite_3_8b's and kimi_k2's
     published widths, the model checker) against
     ``analysis_baseline_torch.json`` (exit 0, no finding), the audit's
     shared memory / registers / occupancy printed per kernel and added
     to each kernel's entry of the ``kernels`` line; then each example of
     ``examples/*_torch.py`` as a subprocess on the card (exit 0);
  4c. (run after 5e) the MoE family at full width, depth ``--moe-layers``
     (default 4):
     kimi_k2_1t_a32b, then llama4_maverick_400b_a17b, W4 (Gaussian) + kv8,
     bf16, each drawn and coded a layer slice at a time: phase 4's stream
     through the paged engine with every launch counted (``qmatmul`` 4 x L
     + 1 a call, ``qmatmul_experts`` 3 x L a call, the attention, the KV
     append and the codec as in phase 4; the forwards printed by tokens
     routed), one decode step profiled, a prefill of 16 x 64 tokens and a
     decode step against the plain versions (the plain
     prefill on the kernel run's expert ids; the decode rows whose expert
     sets agree), and kimi_k2's closed batch (``serve.generate``); then
     each again at W4 empirical (``--w-dist empirical``: every slice's
     codebook fitted on its subsample and its codes written an expert
     block at a time, the coding timed at load): the stream with
     ``qmatmul_lut`` 4 x L + 1 and ``qmatmul_lut_experts`` 3 x L a call
     counted exactly, the plain check with a wrong-code control (every
     coded weight one level off must land above the logit limit); each
     model freed before the next;
  5. repeats a prefill + one decode step with the plain versions forced and
     compares logits, for each engine; replays each engine's stream with
     the kernels and with the plain versions and prints greedy agreement;
     every argmax that differs must be a near-tie (the plain logits' top-2
     margin at most the measured kernel-vs-plain logit error); compares a
     tiny f32 model on the card with the CPU;
  5b. the closed batch and the slot cache: runs the serving CLI without
     ``--engine`` (``serve.generate`` over the slot cache) at the full width
     and depth of granite_3_8b, bf16, dense weights from ``--seed`` and
     their W4 copy, three times (W4, W4 empirical, W4 with ``--a-bits 8``
     fake-quant), counting each run's launches (``qmatmul`` or
     ``qmatmul_lut`` 7 per layer a step, the embedding rows'
     ``kquantile_dequantize`` once a step) and printing tok/s and the
     greedy agreement with the dense model; then phase 4's stream at W4 +
     kv16 through a slot-mode engine and a paged kv16 engine (pages of 64):
     greedy tokens equal, or a near-tie where an argmax differs; each
     engine's tok/s, TTFT, ITL and launches (no ``paged_quant_attention``,
     no ``kv_append``); the slot engine again, and a paged engine with the
     prefix cache, with ``checkify`` and the profiler ranges under
     ``torch.profiler`` (the ranges present, the tokens unchanged); the
     slot cache's plain decode attention timed;
  5d. the state-space families on the closed batch: mamba2_1_3b, then
     zamba2_2_7b, at full width and depth, bf16, each freed before the
     next: the serving CLI without ``--engine`` (dense weights and their W4
     copy, W4 and W4 empirical), every run's launches counted exactly
     (``qmatmul`` or ``qmatmul_lut`` 2 x L + 1 a step at mamba2, 2 x L +
     7 x 9 + 1 at zamba2: in_proj, out_proj, the shared block, the head;
     ``kquantile_dequantize`` once a step; no paged kernel, no
     ``qmatmul_a8``); then a W4 model drawn and coded a layer at a time: a
     prefill of 4 x 256 tokens (two SSD chunks of 128: the chunked scan
     with its state carried across chunks) and a decode step from its
     cache with the kernels and with the plain versions forced (logits
     within ``TOL_SSM_LOGITS_REL``, launches exact; the plain prefill again
     with every coded matmul weight one level off must land outside it),
     and one decode step under ``torch.profiler``;
  5e. the audio and vlm families on the closed batch: whisper_base, then
     pixtral_12b, at full width and depth, bf16, each freed before the
     next: the serving CLI without ``--engine`` (dense weights and their W4
     copy, W4 and W4 empirical), every run's launches counted exactly
     (``qmatmul`` or ``qmatmul_lut`` 8 x 6 = 48 a step at whisper, whose
     W4 head (odd vocab) stays dense, 7 x 40 + 1 = 281 at pixtral;
     ``kquantile_dequantize`` once a step; no paged kernel, no
     ``qmatmul_a8``); then a W4 model drawn and coded a layer at a time: a
     prefill (whisper: 4 x 1500 frames through the encoder and 4 x 64
     tokens through the decoder, its cross K/V of the encoder output;
     pixtral: 4 x 256 patch embeddings ahead of 4 x 64 tokens, padded by a
     row) and a decode step from its cache with the kernels and with the
     plain versions forced (logits within ``TOL_ENCDEC_VLM_LOGITS_REL``,
     launches exact; the wrong-code control of 5d), and one decode step
     under ``torch.profiler``;
  6. trains granite_3_8b at full width (depth ``--train-layers``, default 8)
     through the trainer's entry points for ``--train-steps`` steps (UNIQ
     noise, gradual freezing, AdamW), counting the ``uniq_noise`` launches
     of each step and checking that FROZEN slices stay put; before it, one
     step's loss and gradients with the plain versions forced, and the same
     step with the UNIQ transform per layer inside the layer loop
     (``uniq_in_scan``, remat on) against the whole-tree transform fed the
     same noise (loss and gradients within the same bounds; both peaks
     printed; each side's ``uniq_noise`` launches counted from 0 and exact:
     in scan a forward per layer weight and layer, again in remat's
     recompute, whole-tree one per leaf; both join the kernels line's
     counts); after it,
     one all-FROZEN eval step and a profile of one more step; then a tiny
     f32 train step on the card against the CPU; then the paper's CNN
     trainer (``repro_torch.cnn.train``): ResNet-18 at its published widths
     (21 quantized leaves, 11,164,352 weights), batch 128, W4 A8, AdamW,
     ``CNN_STEPS`` QAT steps (42, one per gradual stage), counting
     21 ``uniq_noise_fwd_onchip`` + 21 ``uniq_noise_bwd`` launches and no
     host-noise forward per step, FROZEN leaves bit-unchanged; before it one
     step with the plain versions forced (same key, same noise); after it
     the all-FROZEN eval with its accuracy, a profile of one more step, and
     MobileNet (width 16) for a few steps; then a tiny f32 ResNet-18 step on
     the card against the CPU (same params, batch and key);
  6b. trains the state-space, audio and vlm families through the trainer's
     entry points with its defaults (f32, AdamW, batch 8 x seq 64, W4, a
     gradual block per layer), ``FAMILY_TRAIN_STEPS`` (6) steps each, each
     model freed before the next: mamba2_1_3b, zamba2_2_7b and whisper_base
     at full width and depth, pixtral_12b at full width and depth
     ``--train-vlm-layers`` (default 4 of 40; 256 zero patch embeddings
     ahead of the 64 tokens); per family one step with the plain versions
     forced (loss and gradients within phase 6's bounds), the steps with
     every ``uniq_noise_fwd`` / ``_bwd`` launch counted (one of each per
     quantized leaf), the loss and every parameter finite after each step
     (so every gradient element was), FROZEN slices bit-unchanged and a
     NOISE slice moved by more than weight decay wherever the gradient norm
     is finite; whisper's gradient norm overflows on the trainer's zero
     frames (the clip then zeroes the update, as in the reference), so it
     takes one more counted step on frames drawn from ``--seed``, whose
     norm must be finite and whose update must move its first encoder
     layer's norm scale by more than weight decay; then the all-FROZEN
     eval, a profiled step (busy share, median step, peak memory) and the
     tiny f32 step of its smoke config on the card against the CPU; phase
     3 holds the ``uniq_noise`` kernels at these trainers' leaf shapes
     (mamba2's and zamba2's stacked ``in_proj``, zamba2's shared ``w_up``,
     whisper's unstacked encoder stack with one statistic, pixtral's
     ``w_up`` stack and embedding, and phase 6c's expert stacks);
  6c. trains the MoE family through the trainer's entry points with the
     CLI's settings but ``--optim sgd`` (f32, batch 8 x seq 64, W4):
     kimi_k2_1t_a32b and llama4_maverick_400b_a17b at their published
     widths, depth 1 and the expert count cut to the largest multiple of 8
     whose reckoned peak stays under 70 GB (16 and 8; the reckoning
     printed before the run, the peak after), each freed before the next:
     one step with the plain versions forced, the schedule's 4 steps (the
     layer NOISE) and 2 past its end (everything FROZEN) with every
     ``uniq_noise_fwd`` / ``_bwd`` launch counted (one of each per
     quantized leaf), the loss and every parameter finite, FROZEN slices of
     the (L, E, d, f) stacks, the embedding and the head bit-unchanged at
     the first FROZEN step (their host copies move ~15 GB at kimi_k2: the
     later FROZEN steps do not repeat it), a NOISE expert slice and (top-k
     > 1) the router moved by their gradient, the copies each step drops
     printed; one more step whose first six rows repeat one token must
     drop copies; the all-FROZEN eval, a profiled step and the tiny f32
     step of its smoke config on the card against the CPU;
  7. times each kernel (CUDA events) beside its bound, its plain version and
     one library call (``qmatmul`` also at the state-space models' decode
     shapes whose N is no multiple of the 128-column tile, beside the
     whole-tile N just below, and at whisper's and pixtral's shapes, the
     odd N of whisper's W8 head among them; ``uniq_noise_fwd`` / ``_bwd``
     also at mamba2's and zamba2's ``in_proj`` stacks and phase 6c's
     expert stacks; ``qmatmul_lut_experts`` at kimi_k2's ``eg`` decode and
     256-token shapes; ``qmatmul`` at a 16,384-row prefill and
     ``paged_quant_attention`` over 16,384 and 32,768 rows, phase 4L's),
     and prints the ``kernels`` JSON line;
  8. prints ``{"ok": true, "device": {...}}`` as the last line.

``--layers N`` cuts the serving depth (never the width; the closed batch
runs the CLI at its full depth), ``--moe-layers N`` the MoE models';
``--quick`` stops after
phase 3 on a reduced shape list (for bringing a kernel up); ``--sweep``
times the kernels' tuning axes (block rows, K splits; the attention
body's splits, beside the CUDA-core body) at the
serving shapes, holds ``qmatmul_a8`` and its plain version against the
exact sum, and stops (``--sweep attention``: the attention part alone;
``--sweep codec``: phase 7's codec rows alone);
``--long`` runs phase 4L alone (on a fresh granite load) and stops;
``--profile`` profiles an engine run (host by cProfile, device by
torch.profiler), counts the device operations of one decode step with the
fused KV append and with the eager append it replaced, of one prefill-chunk
call and of one layer's pool read with the paged read and with the eager
read it replaced, and stops.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import functools
import gc
import io
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.stderr.write("chip_smoke: torch.cuda.is_available() is False; this "
                     "script needs one CUDA device\n")
    sys.exit(2)

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

from repro_torch import convert                               # noqa: E402
from repro_torch.analysis import check as check_cli           # noqa: E402
from repro_torch.analysis import kernel_audit                 # noqa: E402
from repro_torch.analysis.kernel_audit import (              # noqa: E402
    TOL_ATT_BF16, TOL_ATT_F32, TOL_QMM_A8, TOL_QMM_BF16_REL, TOL_QMM_F32,
    TOL_QMM_LUT, TOL_UNIQ_BWD_REL, TOL_UNIQ_NOISE_SIGMA)
from repro_torch.analysis import modelcheck                   # noqa: E402
from repro_torch.analysis import traceview                    # noqa: E402
from repro_torch import tree as tree_lib                       # noqa: E402
from repro_torch.cnn import cnn as cnn_lib                    # noqa: E402
from repro_torch.cnn.train import CNNTrainer                  # noqa: E402
from repro_torch.configs import base as cb                    # noqa: E402
from repro_torch.core import activations as act              # noqa: E402
from repro_torch.core import packing                          # noqa: E402
from repro_torch.core.uniq import (FROZEN, NOISE,            # noqa: E402
                                   UniqConfig, default_quant_filter,
                                   layer_noise, leaf_noise, lm_mode_fn,
                                   onchip_noise)
from repro_torch.data.synthetic import (LMStreamConfig,       # noqa: E402
                                        image_batch, lm_batch)
from repro_torch.kernels import kquantile as kq               # noqa: E402
from repro_torch.kernels import loader, ops as kops           # noqa: E402
from repro_torch.kernels import paged_attn as pa              # noqa: E402
from repro_torch.kernels import qmatmul as qmm                # noqa: E402
from repro_torch.kernels import ref as kref                   # noqa: E402
from repro_torch.kernels import uniq_noise as un              # noqa: E402
from repro_torch.launch import train as train_cli             # noqa: E402
from repro_torch.models import attention as attn_lib         # noqa: E402
from repro_torch.models import kv_cache as kvc               # noqa: E402
from repro_torch.models import hybrid, lm, model              # noqa: E402
from repro_torch.models import moe as moe_lib                 # noqa: E402
from repro_torch.optim.optim import OptimConfig               # noqa: E402
from repro_torch.serve import engine as engine_lib           # noqa: E402
from repro_torch.serve import serve as serve_lib              # noqa: E402
from repro_torch.serve import telemetry as tele_lib           # noqa: E402
from repro_torch.serve.engine import (Engine, EngineConfig,   # noqa: E402
                                      Request, SamplingParams)
from repro_torch.train import steps as train_steps            # noqa: E402

DEV = torch.device("cuda")
# the card's name and power limit (nvidia-smi), printed beside the times
CARD = ""

# Published peaks of one H100 SXM (dense): what the bounds are stated against.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}

# Tolerances of the kernel-vs-plain comparisons, with their reasons; those
# of qmatmul (f32 and bf16 results), qmatmul_a8, qmatmul_lut, the attention
# (f32 and bf16 queries, absolute) and uniq_noise (NOISE, backward) are
# ``analysis/kernel_audit.py``'s, which holds the same kernels to them.
# attention, bf16 queries, relative: max |out - plain| over a sequence's
#   heads and dims, over max |plain| of that sequence.  A long context's
#   outputs are small (V averages out: ~0.08 at most over 2048 rows), so
#   the absolute limit TOL_ATT_BF16 cannot see a lost chunk of rows.  Both bodies
#   read up to about 2^-7 (one bf16 step of the result near its largest
#   value); a chunk of 16 rows dropped reads 0.09 and more (``PERF.md``
#   §6).  This limit sits between them, and phase 3 requires the
#   dropped-chunk control of its first geometry above it.  The f32 K/V
#   control reads like the sound bodies and is printed only.
TOL_ATT_BF16_REL = 2.0 ** -5
# full-width bf16 logits, kernels vs plain versions: 40 layers of bf16
#   residual updates whose matmul outputs may differ by one bf16 ulp each
#   and whose decode attention differs as above; stated relative to the
#   largest logit of the reference.
TOL_LOGITS_REL = 0.08
# mamba2 / zamba2 at full width, bf16 logits, kernels vs plain versions: the
#   same one-ulp freedom of each coded matmul's bf16 output (2 a layer, 7 at
#   each shared block, the head f32), fed through 48 / 54 bf16 residual
#   updates and the SSM recurrence, whose state is f32 on both sides and
#   sees the same bf16 inputs up to those ulps; stated, as above, relative
#   to the largest logit of the plain side.  Sound kernels read 4.5-5.1 %
#   of it (PERF.md, PR 24): the limit sits 1.6x above that.  It must see a
#   kernel that decodes its codes wrongly: phase 5d reruns the plain
#   prefill with every coded matmul weight one level off (code c read as
#   c ^ 1, the other level of its pair; it read 132 and 144 %) and fails
#   unless that control lands above the limit.
TOL_SSM_LOGITS_REL = 0.08
# whisper_base / pixtral_12b at full width, bf16 logits, kernels vs plain
#   versions: the one-ulp freedom of each coded matmul's bf16 output
#   through 6 + 6 (whisper: its encoder's output feeds every decoder layer's
#   cross K/V) and 40 (pixtral) bf16 residual updates; stated relative to
#   the largest logit of the plain side, as above.  Sound kernels read 0.74
#   % (whisper) and 1.85 % (pixtral) of it (PERF.md §6): the limit sits
#   2.2x above the larger.  It must see a kernel that decodes its codes
#   wrongly: phase 5e's control (every coded matmul weight one level off;
#   it read 100 and 130 %) must land above it.
TOL_ENCDEC_VLM_LOGITS_REL = 0.04
# tiny f32 model, card (kernels) vs CPU (plain): f32 everywhere, different
#   summation orders and transcendental implementations through 2 layers.
TOL_SMALL_F32 = 2e-3
# uniq_noise FROZEN: both sides compute z and u with the same correctly
#   rounded f32 operations in the same order and take the level from one
#   table, so an output can differ only where CUDA's erff and torch's erf
#   differ in the last ulp next to a bin edge: a code flips there.  Bound on
#   the share of FROZEN outputs that may differ.
TOL_UNIQ_FROZEN_FLIPS = 1e-6
# uniq_noise_fwd_onchip: its draw must equal the plain Philox to the bit (no
#   tolerance), and given it the forward runs the body of uniq_noise_fwd, so
#   FROZEN and NOISE are held to TOL_UNIQ_FROZEN_FLIPS / TOL_UNIQ_NOISE_SIGMA
#   and to uniq_noise_fwd on the same bits to the bit.  A NOISE output lies
#   within half a bin (1 / 2k) of its weight in u; Phi of the output
#   recomputes u + e to a few f32 ulps of u (the erf / erfinv round trip).
TOL_ONCHIP_BIN_U = 1e-5
# kquantile_quantize / kquantile_dequantize / kquantile_dequantize_paged:
#   none.  Both sides run the same correctly rounded f32 operations in the
#   same order (z / sqrt2 taken as z * (1 / sqrt2) on both), CUDA's erff
#   serves both, and the levels come from one table: codes and values must
#   be equal to the bit.
# kv_append (the fused KV append): the mean and deviation of a (row, head)
#   are reduced in another order than torch.mean / torch.std, so a bf16
#   statistic may land one ulp from the plain version's when the f32 value
#   sits next to a rounding boundary.  Held: never more than one ulp apart;
#   codes bit-equal wherever both statistics are, and everywhere equal to
#   the plain codes of the kernel's own statistics; at most this share of
#   (row, head, K or V) statistics pairs one ulp apart.  Read on the H100:
#   0 of 113,240 pairs (all cases of KV_APPEND_CASES); the limit allows
#   about 11 of them.
TOL_KV_STATS_ULP = 1e-4
# LM head, bf16 activations x dense bf16 head with f32 logits: the products
#   are exact in f32 and both sides sum them in f32 over K = 4096 in their
#   own order; stated relative to the largest logit.  A bf16 rounding of
#   the logits would be 2^-9 relative, far above this.
TOL_HEAD_F32_REL = 1e-5
# full-width train step, kernels vs plain versions forced: the transform's
#   kernels agree with their plain versions to the bit (the kernel phase
#   checks it), and every other operation is the same torch call; what may
#   remain is the order of reductions that cuBLAS or the embedding backward
#   choose.  Loss relative; gradients relative to each leaf's largest.
TOL_TRAIN_PLAIN_LOSS_REL = 1e-6
TOL_TRAIN_PLAIN_GRAD_REL = 1e-5
# tiny f32 train step, card vs CPU, one SGD step on the same state, batch
#   and noise: the loss through 2 layers as TOL_SMALL_F32 says; the update
#   is lr x gradient, whose NOISE factor pdf(z) / pdf(z_hat) is steep next
#   to the u clamp, where one ulp of u between CUDA's and the CPU's erf
#   moves z_hat by up to 1e-2 and the factor by up to ~5%: stated relative
#   to the leaf's largest update.  The update is read as p' - p, each p'
#   rounded to f32 on its side: a leaf whose whole update is a few ulps of
#   p (the norm scales at 1 of the MoE smoke configs: 6 ulps) differs by
#   that rounding alone, so one ulp of p' is allowed beside it.  The MoE
#   configs' CPU step replays the card's expert ids (a top-k set can differ
#   where two router probabilities nearly tie, and with it a token's whole
#   expert output, as in phase 4c's plain check).
TOL_SMALL_TRAIN_LOSS_REL = 1e-5
TOL_SMALL_TRAIN_UPDATE_REL = 5e-2


def say(msg: str) -> None:
    print(msg, flush=True)


def sync() -> None:
    torch.cuda.synchronize()


def time_ms(fns, warmup: int = 3, iters: int = 20) -> float:
    """Mean milliseconds of one call on the card; ``fns`` are equivalent
    closures over different copies of the inputs, cycled so a call does not
    find its operands in the L2 cache left by the previous one.

    The launches are queued behind a spinning kernel, so the card runs them
    back to back and the two events bracket device time only: a wrapper's
    host cost per launch (tens of microseconds in eager PyTorch) would
    otherwise be what is measured for a short kernel."""
    n = len(fns)
    for i in range(warmup):
        fns[i % n]()
    sync()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(40_000_000)          # ~20 ms: the queue fills meanwhile
    start.record()
    for i in range(iters):
        fns[i % n]()
    end.record()
    sync()
    return start.elapsed_time(end) / iters


def host_us(fn, iters: int = 200) -> float:
    """Host microseconds to enqueue one call (the card is not waited for
    inside the loop)."""
    sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    dt = time.perf_counter() - t0
    sync()
    return dt / iters * 1e6


# --------------------------------------------------------------------------
# Inputs
# --------------------------------------------------------------------------

def make_qmm_inputs(gen, M, K, N, bits, a_dtype):
    a = torch.randn((M, K), generator=gen, device=DEV).to(a_dtype)
    if bits == 4:
        codes = torch.randint(0, 16, (K, N), generator=gen, device=DEV)
        w = packing.pack_int4(codes)
    else:
        w = torch.randint(-128, 128, (K, N), generator=gen,
                          device=DEV).to(torch.int8)
    mu = torch.randn((1, N), generator=gen, device=DEV) * 0.002
    sigma = 0.02 * (0.5 + torch.rand((1, N), generator=gen, device=DEV))
    return a, w.contiguous(), mu.contiguous(), sigma.contiguous()


def make_attn_inputs(gen, B, H, KV, D, page, n_pages, kv_bits, q_dtype,
                     q_pos=None, sink_tail=False):
    """Random coded pool, tables and queries.  ``sink_tail``: ragged
    ``q_pos`` with every table entry past a sequence's last page pointing
    at the sink page, as the engine's tables do."""
    P = 1 + B * n_pages
    Dc = D // 2 if kv_bits == 4 else D

    def codes():
        if kv_bits == 4:
            c = torch.randint(0, 256, (P, page, KV, Dc), generator=gen,
                              device=DEV).to(torch.uint8)
        else:
            c = torch.randint(-128, 128, (P, page, KV, Dc), generator=gen,
                              device=DEV).to(torch.int8)
        c[0] = 0                                  # the sink page
        return c

    def stats(scale, offset):
        s = (offset + scale * torch.randn((P, page, KV), generator=gen,
                                          device=DEV)).to(torch.bfloat16)
        s[0] = 0
        return s

    k_codes, v_codes = codes(), codes()
    k_mu, v_mu = stats(0.1, 0.0), stats(0.1, 0.0)
    k_sigma = stats(0.1, 1.0).abs()
    v_sigma = stats(0.1, 0.5).abs()
    perm = torch.randperm(P - 1, generator=gen, device=DEV) + 1
    bt = perm.reshape(B, n_pages).to(torch.int32)
    S = n_pages * page
    if q_pos is None:
        qp = torch.randint(0, S, (B,), generator=gen, device=DEV)
        qp[0] = 0
        qp[-1] = S - 1
        if B > 2:
            bt[1] = 0                             # a row whose pages are sink
            qp[1] = S // 2
    else:
        qp = torch.tensor(q_pos, device=DEV)
    if sink_tail:
        used = (qp.clamp(min=0) // page + 1)[:, None]
        bt[torch.arange(n_pages, device=DEV)[None] >= used] = 0
    q = torch.randn((B, 1, H, D), generator=gen, device=DEV).to(q_dtype)
    return dict(q=q, k_codes=k_codes, k_mu=k_mu, k_sigma=k_sigma,
                v_codes=v_codes, v_mu=v_mu, v_sigma=v_sigma,
                block_tables=bt.contiguous(), q_pos=qp.to(torch.int32))


def attn_call(fn, t, **kw):
    return fn(t["q"], t["k_codes"], t["k_mu"], t["k_sigma"], t["v_codes"],
              t["v_mu"], t["v_sigma"], t["block_tables"], t["q_pos"], **kw)


# --------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# --------------------------------------------------------------------------

# the coded matmuls of mamba2_1_3b and zamba2_2_7b, (K, N): in_proj,
# out_proj, the LM head; zamba2's shared wq / wk / wv / wo, w_gate / w_up,
# w_down.  N = 8512, 10448 and 50280 are no multiple of the 128-column tile;
# W4 rows of 5224 B (zamba2 in_proj) and 25140 B (the mamba2 head; 50280 B
# at W8) are no multiple of 16 bytes.  Held at the closed batch's decode
# (M = 4) and at phase 5d's prefill (4 x 256 tokens: M = 1024).
SSM_QMM_KN = ((2048, 8512), (4096, 2048), (2048, 50280),
              (2560, 10448), (5120, 2560), (2560, 32000),
              (2560, 2560), (2560, 10240), (10240, 2560))
SSM_QMM_SHAPES = [(M, K, N) for (K, N) in SSM_QMM_KN for M in (4, 1024)]
SSM_QMM_QUICK = [(4, 2560, 10448), (4, 2048, 50280)]
# the coded matmuls of whisper_base and pixtral_12b (phase 5e), (M, K, N):
# whisper's projections (d 512, d_ff 2048) at the closed batch's decode
# (M = 4) and at the encoder's prefill rows (4 x 1500 frames: M = 6000);
# whisper's LM head at W8 (N = 51865 is odd: W8 only, whose rows of
# 51865 B are no multiple of 16; W4 cannot pack it and leaves it dense);
# pixtral's FFN and LM head at decode, its FFN at the prefill rows (4 x
# (256 patches + 64 tokens): M = 1280).
ENCDEC_VLM_QMM_SHAPES = [(M, K, N) for M in (4, 6000) for (K, N) in (
    (512, 512), (512, 2048), (2048, 512))] + [
    (4, 512, 51865), (4, 5120, 14336), (4, 5120, 131072),
    (1280, 5120, 14336), (1280, 14336, 5120)]


def check_qmatmul(gen, quick: bool) -> float:
    worst = 0.0
    main_kn = [(4096, 4096), (4096, 1024), (4096, 12800), (12800, 4096)]
    # M = 4: the closed batch's decode steps (four rows, one token each)
    shapes = [(M, K, N) for (K, N) in main_kn for M in (4, 8, 16, 32, 256)]
    shapes += [(5, 200, 130), (33, 520, 96), (70, 77, 258), (1, 64, 2)]
    # more rows than the tallest tile (128) and the 256 above, and an N
    # that is no multiple of the wgmma's 64-column warpgroup tile
    shapes += [(300, 4096, 4096), (300, 1000, 200)]
    shapes += SSM_QMM_SHAPES + ENCDEC_VLM_QMM_SHAPES
    if quick:
        shapes = [(16, 4096, 4096), (256, 4096, 1024), (5, 200, 130),
                  (33, 520, 96), (300, 1000, 200)] + SSM_QMM_QUICK \
            + [(4, 512, 51865)]
    for (M, K, N) in shapes:
        # an odd N cannot be int4-packed: W8 only
        for bits in ((8,) if N % 2 else (4, 8)):
            for a_dtype in (torch.bfloat16, torch.float32):
                a, w, mu, sigma = make_qmm_inputs(gen, M, K, N, bits, a_dtype)
                out = qmm.qmatmul(a, w, mu, sigma, bits=bits)
                again = qmm.qmatmul(a, w, mu, sigma, bits=bits)
                sync()
                want = qmm.qmatmul_plain(a, w, mu, sigma, bits=bits)
                err = (out - want).abs().max().item()
                worst = max(worst, err)
                if not torch.isfinite(out).all() or err > TOL_QMM_F32:
                    raise SystemExit(
                        f"qmatmul disagrees with its plain version: M={M} "
                        f"K={K} N={N} bits={bits} a={a_dtype} err={err:.3e} "
                        f"> {TOL_QMM_F32}")
                if not torch.equal(out, again):
                    raise SystemExit(
                        f"qmatmul is not deterministic: M={M} K={K} N={N} "
                        f"bits={bits} a={a_dtype}")
                del a, w, mu, sigma, out, again, want
        say(f"[kernels] qmatmul M={M} K={K} N={N}: "
            f"{'W8' if N % 2 else 'W4/W8'} x bf16/f32 ok")
    # what the model asks for: bf16 in, bf16 out, through the ops wrapper
    for bits in (4, 8):
        a, w, mu, sigma = make_qmm_inputs(gen, 16, 4096, 12800, bits,
                                          torch.bfloat16)
        out = kops.qmatmul(a.reshape(2, 8, 4096), w, mu, sigma, bits=bits,
                           out_dtype=torch.bfloat16)
        want = kops.qmatmul(a.reshape(2, 8, 4096), w, mu, sigma, bits=bits,
                            out_dtype=torch.bfloat16, use_kernel=False)
        sync()
        err = (out.float() - want.float()).abs().max().item()
        tol = TOL_QMM_BF16_REL * want.float().abs().max().item()
        if err > tol:
            raise SystemExit(f"qmatmul bf16 output: err {err:.3e} > {tol:.3e}")
    # row invariance: a row's bits do not depend on the rows beside it
    for bits in (4, 8):
        a, w, mu, sigma = make_qmm_inputs(gen, 300, 4096, 4096, bits,
                                          torch.bfloat16)
        rows_independent(f"qmatmul W{bits}", lambda x: qmm.qmatmul(
            x, w, mu, sigma, bits=bits), a)
    say("[kernels] qmatmul bf16 output ok; rows are independent of M")
    return worst


# Row counts whose results are held against the first rows of a 300-row
# call: every tile height (8 takes the 16-row tile; from 64 rows on a block
# sums the splits itself), and the 256 of the earlier check.
ROW_INVARIANCE_M = (8, 16, 32, 64, 128, 256)


def rows_independent(name, call, a):
    """``call`` on the first m rows of ``a`` gives the first m rows of
    ``call(a)`` to the bit, for each m of ``ROW_INVARIANCE_M``: each picks
    another tile height, and preempt / resume re-prefills decoded tokens."""
    full = call(a)
    for m in ROW_INVARIANCE_M:
        part = call(a[:m].contiguous())
        if not torch.equal(part, full[:m]):
            raise SystemExit(f"{name} rows depend on M (M={m} vs "
                             f"{a.shape[0]})")


def make_a8_inputs(gen, M, K):
    """Per-token int8 codes and (M, 1) scales of N(0, 1) activations, as
    ``lm.mm_a`` makes them (``core/activations.py``)."""
    x = torch.randn((M, K), generator=gen, device=DEV)
    scale = act.act_scale(x, 8, axis=-1)
    codes, _ = act.quant_act(x, 8, scale)
    return codes.contiguous(), scale.contiguous()


def make_lut(gen, N, bits, per_col):
    """Sorted levels: a (k,) codebook for every column, or (k, N)."""
    k = 2 ** bits
    shape = (k, N) if per_col else (k,)
    lut = torch.randn(shape, generator=gen, device=DEV) * 0.02
    return torch.sort(lut, dim=0).values.contiguous()


def _matmul_checked(name, out, again, want, tol, where):
    err = (out.float() - want.float()).abs().max().item()
    if not torch.isfinite(out).all() or err > tol:
        raise SystemExit(f"{name} disagrees with its plain version: {where} "
                         f"err={err:.3e} > {tol}")
    if not torch.equal(out, again):
        raise SystemExit(f"{name} is not deterministic: {where}")
    return err


def check_qmatmul_variants(gen, quick: bool):
    """qmatmul_a8 (per-row and scalar scales) and qmatmul_lut ((k,) and
    (k, N) codebooks, bf16 and f32 activations) against their plain
    versions, at the serving shapes and ragged ones.  Returns the worst
    abs errors."""
    worst = {"qmatmul_a8": 0.0, "qmatmul_lut": 0.0}
    main_kn = [(4096, 4096), (4096, 1024), (4096, 12800), (12800, 4096)]
    # M = 4: the closed batch's decode steps (four rows, one token each)
    shapes = [(M, K, N) for (K, N) in main_kn for M in (4, 8, 16, 32, 256)]
    shapes += [(5, 200, 130), (33, 520, 96), (70, 77, 258), (1, 64, 2)]
    shapes += [(300, 4096, 4096), (300, 1000, 200)]
    shapes += SSM_QMM_SHAPES
    if quick:
        shapes = [(16, 4096, 12800), (256, 4096, 1024), (5, 200, 130),
                  (33, 520, 96), (300, 1000, 200)] + SSM_QMM_QUICK
    for (M, K, N) in shapes:
        for bits in (4, 8):
            _, w, mu, sigma = make_qmm_inputs(gen, 1, K, N, bits,
                                              torch.float32)
            codes, scale = make_a8_inputs(gen, M, K)
            for sc in (scale, scale[:1, :1].reshape(1)):
                out = qmm.qmatmul_a8(codes, sc, w, mu, sigma, bits=bits)
                again = qmm.qmatmul_a8(codes, sc, w, mu, sigma, bits=bits)
                sync()
                want = qmm.qmatmul_a8_plain(codes, sc, w, mu, sigma,
                                            bits=bits)
                worst["qmatmul_a8"] = max(worst["qmatmul_a8"], _matmul_checked(
                    "qmatmul_a8", out, again, want, TOL_QMM_A8,
                    f"M={M} K={K} N={N} W{bits} scale {tuple(sc.shape)}"))
            for a_dtype in (torch.bfloat16, torch.float32):
                a = torch.randn((M, K), generator=gen, device=DEV).to(a_dtype)
                for per_col in ((False, True) if M <= 32 or K * N < 1 << 24
                                else (False,)):
                    lut = make_lut(gen, N, bits, per_col)
                    out = qmm.qmatmul_lut(a, w, lut, bits=bits)
                    again = qmm.qmatmul_lut(a, w, lut, bits=bits)
                    sync()
                    want = qmm.qmatmul_lut_plain(a, w, lut, bits=bits)
                    worst["qmatmul_lut"] = max(
                        worst["qmatmul_lut"], _matmul_checked(
                            "qmatmul_lut", out, again, want, TOL_QMM_LUT,
                            f"M={M} K={K} N={N} W{bits} {a_dtype} lut "
                            f"{tuple(lut.shape)}"))
            del w, mu, sigma, codes, scale
        say(f"[kernels] qmatmul_a8 + qmatmul_lut M={M} K={K} N={N}: W4/W8, "
            f"per-row/scalar scales, (k,)/(k, N) codebooks x bf16/f32 ok")
    # what the engine asks for: bf16 in, bf16 out through the ops wrappers
    for bits in (4, 8):
        x = torch.randn((2, 8, 4096), generator=gen,
                        device=DEV).to(torch.bfloat16)
        _, w, mu, sigma = make_qmm_inputs(gen, 1, 4096, 12800, bits,
                                          torch.bfloat16)
        codes, scale = act.quant_act(x, 8, act.act_scale(x, 8, axis=-1))
        lut = make_lut(gen, 12800, bits, False)
        for name, fn in (
                ("qmatmul_a8", lambda uk: kops.qmatmul_a8(
                    codes, scale, w, mu, sigma, bits=bits,
                    out_dtype=torch.bfloat16, use_kernel=uk)),
                ("qmatmul_lut", lambda uk: kops.qmatmul_lut(
                    x, w, lut, bits=bits, out_dtype=torch.bfloat16,
                    use_kernel=uk))):
            out, want = fn(True), fn(False)
            sync()
            err = (out.float() - want.float()).abs().max().item()
            tol = TOL_QMM_BF16_REL * want.float().abs().max().item()
            if out.dtype != torch.bfloat16 or err > tol:
                raise SystemExit(f"{name} bf16 output: err {err:.3e} > "
                                 f"{tol:.3e}")
    # row invariance: a row's bits do not depend on the rows beside it
    _, w, mu, sigma = make_qmm_inputs(gen, 1, 4096, 4096, 4, torch.float32)
    codes, scale = make_a8_inputs(gen, 256, 4096)
    full = qmm.qmatmul_a8(codes, scale, w, mu, sigma, bits=4)
    for m in (8, 16, 32):
        part = qmm.qmatmul_a8(codes[:m].contiguous(), scale[:m].contiguous(),
                              w, mu, sigma, bits=4)
        if not torch.equal(part, full[:m]):
            raise SystemExit(f"qmatmul_a8 rows depend on M (M={m} vs 256)")
    for bits in (4, 8):
        _, w, _, _ = make_qmm_inputs(gen, 1, 4096, 4096, bits, torch.float32)
        a = torch.randn((300, 4096), generator=gen,
                        device=DEV).to(torch.bfloat16)
        for per_col in (False, True):
            lut = make_lut(gen, 4096, bits, per_col)
            rows_independent(
                f"qmatmul_lut W{bits} lut {tuple(lut.shape)}",
                lambda x: qmm.qmatmul_lut(x, w, lut, bits=bits), a)
    say("[kernels] qmatmul_a8 / qmatmul_lut bf16 outputs ok; qmatmul_a8 "
        "and qmatmul_lut rows are independent of M")
    return worst


# the expert stacks of the two MoE configs at full width: (E, K, N) of
# eg / eu and of ed
EXPERT_WIDTHS = {
    "kimi_k2_1t_a32b": ((384, 7168, 2048), (384, 2048, 7168)),
    "llama4_maverick_400b_a17b": ((128, 5120, 8192), (128, 8192, 5120)),
}


def moe_capacity(arch, T):
    """The capacity C of a call of T tokens at ``arch`` (the engine's)."""
    c = cb.get(arch)
    return moe_lib.capacity(T, moe_lib.MoEConfig(c.n_experts, c.top_k,
                                                 c.capacity_factor))


def make_expert_rows(gen, E, C, used):
    """(E,) int32 rows: ``used`` experts in use at random, each with 1 to C
    rows (some with exactly C), the rest empty."""
    rows = torch.zeros(E, dtype=torch.int32, device=DEV)
    pick = torch.randperm(E, generator=gen, device=DEV)[:used]
    rows[pick] = torch.randint(1, C + 1, (used,), generator=gen, device=DEV,
                               dtype=torch.int32)
    rows[pick[:max(1, used // 4)]] = C
    return rows


def make_expert_inputs(gen, E, C, K, N, bits, a_dtype, rows):
    """Activations (E, C, K) with NaN in every row past rows[e] (the kernel
    must not read them), coded weights (E, K, N), per-column statistics, a
    (k,) codebook and the rows."""
    a = torch.randn((E, C, K), generator=gen, device=DEV).to(a_dtype)
    idle = torch.arange(C, device=DEV)[None, :] >= rows[:, None]
    a[idle] = float("nan")
    if bits == 4:
        w = torch.randint(0, 256, (E, K, N // 2), generator=gen, device=DEV,
                          dtype=torch.uint8)
    else:
        w = torch.randint(-128, 128, (E, K, N), generator=gen, device=DEV,
                          dtype=torch.int8)
    mu = torch.randn((1, N), generator=gen, device=DEV) * 0.002
    sigma = 0.02 * (0.5 + torch.rand((1, N), generator=gen, device=DEV))
    lut = make_lut(gen, N, bits, False)
    return dict(a=a, w=w, mu=mu, sigma=sigma, lut=lut, rows=rows, idle=idle)


@contextlib.contextmanager
def nan_filled_empty():
    """Inside, ``torch.empty`` hands out floating-point memory filled with
    NaN (PyTorch's fill of uninitialized memory under its deterministic
    mode), so what a kernel leaves unwritten in its output or its split-K
    scratch shows; checked on a probe first."""
    det = torch.are_deterministic_algorithms_enabled()
    warn = torch.is_deterministic_algorithms_warn_only_enabled()
    fill = torch.utils.deterministic.fill_uninitialized_memory
    torch.use_deterministic_algorithms(True)
    torch.utils.deterministic.fill_uninitialized_memory = True
    try:
        if not bool(torch.empty(8, device=DEV).isnan().all()):
            raise SystemExit("torch.empty did not fill with NaN")
        yield
    finally:
        torch.use_deterministic_algorithms(det, warn_only=warn)
        torch.utils.deterministic.fill_uninitialized_memory = fill


def _experts_checked(name, t, call, plain, tol_abs, tol_rel, where):
    """One expert call twice (the second with its output and scratch
    allocated as NaN) against its plain version: finite, exact zeros in
    every idle row, within tolerance, the same bits both times."""
    out = call()
    with nan_filled_empty():
        again = call()
        sync()
    want = plain()
    tol = tol_abs if tol_rel is None \
        else tol_rel * want.float().abs().max().item()
    err = _matmul_checked(name, out, again, want, tol, where)
    if out[t["idle"]].any():
        raise SystemExit(f"{name}: a row past rows[e] is not zero ({where})")
    return err


# the engine's calls at full width, by tokens T routed in one call: a
# decode bucket of 16, and the coalesced prefill of 4, 8 or 16 slots of one
# 64-token page each (C = 8, 16, 32 at kimi_k2; 8, 8, 16 at llama4), and
# 2560 tokens at llama4 for its C = 32 (a longer prefill chunk)
EXPERT_CALL_TOKENS = {"kimi_k2_1t_a32b": (512, 1024),
                      "llama4_maverick_400b_a17b": (1024, 2560)}


def check_qmatmul_experts(gen, quick: bool):
    """qmatmul_experts / qmatmul_lut_experts against their plain versions
    (the 2-D plain matmul expert by expert): W4 / W8, Gaussian levels and
    a (k,) codebook, bf16 / f32 activations (f32 out; the model's bf16 out
    for bf16), at kimi_k2's and llama4's expert widths (C = 8 rows with a
    third or most of the experts in use, and the rows of the engine's
    coalesced prefill, T tokens routed top-k at C = capacity(T): 16 and 32)
    and ragged shapes with taller tiles (C up to 128, rows 0 to C).  Every
    activation row past rows[e] holds NaN and the second call's output and
    scratch are allocated as NaN: the idle rows must come out exactly
    zero."""
    worst = {"qmatmul_experts": 0.0, "qmatmul_lut_experts": 0.0}
    cases = []        # (arch, E, C, K, N, (E,) rows maker)
    for arch, shapes in EXPERT_WIDTHS.items():
        k = cb.get(arch).top_k
        for (E, K, N) in shapes:
            for used in (E // 3, E - E // 8):             # C = 8
                cases.append((arch, E, 8, K, N, functools.partial(
                    make_expert_rows, gen, E, 8, used)))
            for T in EXPERT_CALL_TOKENS[arch]:            # C = 16, 32
                C = moe_capacity(arch, T)
                cases.append((arch, E, C, K, N, functools.partial(
                    routed_rows, gen, T, E, k, C)))
    for E, C, K, N, used in ((5, 24, 200, 130, 4), (3, 33, 520, 96, 3),
                             (6, 70, 256, 258, 5), (4, 128, 512, 384, 3),
                             (2, 1, 64, 2, 1), (16, 64, 2048, 1024, 12)):
        cases.append(("ragged", E, C, K, N, functools.partial(
            make_expert_rows, gen, E, C, used)))
    # the edges of the expert body's walk: no expert in use (at kimi_k2's
    # width: every row zero, no weight byte read), every expert in use,
    # one expert
    E, K, N = EXPERT_WIDTHS["kimi_k2_1t_a32b"][0]
    cases += [("no expert in use", E, 8, K, N, functools.partial(
                  make_expert_rows, gen, E, 8, 0)),
              ("every expert in use", 12, 8, 2048, 1024, functools.partial(
                  make_expert_rows, gen, 12, 8, 12)),
              ("one expert", 1, 16, 2048, 1024, functools.partial(
                  make_expert_rows, gen, 1, 16, 1))]
    if quick:      # kimi_k2 eg at C = 8 and 32, llama4 eg at C = 16, ragged,
        # the three edges
        cases = [cases[0], cases[3], cases[10]] + cases[-9:-6] + cases[-3:]
    for arch, E, C, K, N, make_rows in cases:
        rows = make_rows()
        used = int((rows > 0).sum())
        for bits in (4, 8):
            for a_dtype in (torch.bfloat16, torch.float32):
                if a_dtype == torch.float32 and E * K * N > 1 << 31 \
                        and used < E // 2:
                    continue     # f32 at full width: most experts in use
                t = make_expert_inputs(gen, E, C, K, N, bits, a_dtype, rows)
                where = (f"{arch} E={E} C={C} K={K} N={N} W{bits} {a_dtype} "
                         f"{used} experts in use, {int(rows.sum())} rows")
                outs = [torch.float32]
                if a_dtype == torch.bfloat16:
                    outs.append(torch.bfloat16)
                # the worst errors reported are the f32 outputs' (as row
                # 1's); bf16 outputs are held to one bf16 step relative
                for od in outs:
                    rel = None if od == torch.float32 else TOL_QMM_BF16_REL
                    errs = (_experts_checked(
                        "qmatmul_experts", t,
                        lambda: qmm.qmatmul_experts(
                            t["a"], t["w"], t["mu"], t["sigma"], t["rows"],
                            bits=bits, out_dtype=od),
                        lambda: qmm.qmatmul_experts_plain(
                            t["a"], t["w"], t["mu"], t["sigma"], t["rows"],
                            bits=bits, out_dtype=od),
                        TOL_QMM_F32, rel, f"{where} out {od}"),
                        _experts_checked(
                        "qmatmul_lut_experts", t,
                        lambda: qmm.qmatmul_lut_experts(
                            t["a"], t["w"], t["lut"], t["rows"], bits=bits,
                            out_dtype=od),
                        lambda: qmm.qmatmul_lut_experts_plain(
                            t["a"], t["w"], t["lut"], t["rows"], bits=bits,
                            out_dtype=od),
                        TOL_QMM_LUT, rel, f"{where} out {od}"))
                    if od == torch.float32:
                        for name, err in zip(worst, errs):
                            worst[name] = max(worst[name], err)
                del t
        say(f"[kernels] qmatmul_experts + qmatmul_lut_experts {arch} E={E} "
            f"C={C} K={K} N={N}, {used} experts in use, {int(rows.sum())} "
            f"rows: W4/W8 x bf16/f32, idle rows NaN in and zero out, output "
            f"and scratch allocated as NaN: ok")
        torch.cuda.empty_cache()
    # an expert's rows do not depend on the other experts of the call:
    # expert e alone gives the same bits (the expert body at W4, which takes
    # no split; qmatmul's body at W8, at the full call's split count)
    for bits in (4, 8):
        t = make_expert_inputs(gen, 8, 16, 1024, 512, bits, torch.bfloat16,
                               make_expert_rows(gen, 8, 16, 8))
        full = qmm.qmatmul_experts(t["a"], t["w"], t["mu"], t["sigma"],
                                   t["rows"], bits=bits)
        nsplit = None if bits == 4 else qmm.default_splitk(1024, 512, 8)
        for e in (0, 5):
            one = qmm.qmatmul_experts(
                t["a"][e:e + 1].contiguous(), t["w"][e:e + 1].contiguous(),
                t["mu"], t["sigma"], t["rows"][e:e + 1].contiguous(),
                bits=bits, splitk=nsplit)
            if not torch.equal(one[0], full[e]):
                raise SystemExit(f"qmatmul_experts W{bits}: an expert's rows "
                                 f"depend on the other experts of the call")
    say("[kernels] qmatmul_experts: an expert's bits do not depend on the "
        "other experts of the call (W4 and W8)")
    # no idle expert's weight byte is read: with no expert in use, a call
    # at kimi_k2's width takes a tenth of the time its whole stack's codes
    # would take at the card's peak rate, or less
    E, K, N = EXPERT_WIDTHS["kimi_k2_1t_a32b"][0]
    t = make_expert_inputs(gen, E, 8, K, N, 4, torch.bfloat16,
                           make_expert_rows(gen, E, 8, 0))
    ms = time_ms([lambda: qmm.qmatmul_experts(
        t["a"], t["w"], t["mu"], t["sigma"], t["rows"], bits=4,
        out_dtype=torch.bfloat16)])
    read_ms = t["w"].numel() / PEAK_BYTES_PER_S * 1e3
    say(f"[kernels] qmatmul_experts with no expert in use (E={E} C=8 K={K} "
        f"N={N}): {ms:.4f} ms; reading the stack's {t['w'].numel() / 1e9:.2f}"
        f" GB of codes would take {read_ms:.4f} ms at the peak rate; {CARD}")
    if ms > 0.1 * read_ms:
        raise SystemExit("qmatmul_experts: a call with no expert in use "
                         "takes as long as reading weights")
    del t
    torch.cuda.empty_cache()
    return worst


def _codec_stats(w, per_col):
    """Per-column or per-group statistics of (G, R, C) values, as the
    callers make them (the KV rows' per-group statistics bf16-rounded)."""
    dims = (1,) if per_col else (1, 2)
    wf = w.float()
    mu = wf.mean(dim=dims, keepdim=True).contiguous()
    sigma = wf.std(dim=dims, correction=0, keepdim=True).clamp_min(1e-8)
    if not per_col:
        mu = mu.to(torch.bfloat16).float()
        sigma = sigma.to(torch.bfloat16).float()
    return mu, sigma.contiguous()


def _offset_view(t, shift_bytes):
    """A contiguous copy of ``t`` whose data pointer sits ``shift_bytes``
    past a 16-byte boundary (a view into a larger buffer)."""
    n = t.numel()
    pad = shift_bytes // t.element_size()
    buf = torch.empty(n + pad, dtype=t.dtype, device=t.device)
    v = buf[pad:].view(t.shape)
    v.copy_(t)
    assert v.data_ptr() % 16 == shift_bytes and v.is_contiguous()
    return v


def _same(name, got, again, want, where):
    if not torch.equal(got, again):
        raise SystemExit(f"{name} is not deterministic: {where}")
    if not torch.equal(got, want):
        n = int((got != want).sum().item())
        err = (got.float() - want.float()).abs().max().item()
        raise SystemExit(f"{name} differs from its plain version in {n} of "
                         f"{got.numel()} values (max abs {err:.3e}): {where}")


def _codec_one(gen, G, R, C, k, per_col, w_dtype, shift=0):
    """One quantize + dequantize case: kernel and plain version must agree
    to the bit, and the same inputs twice give the same bits; at k = 16
    with an even C the packed output too.  ``shift``: the values and codes
    are views that many bytes off a 16-byte boundary.  Returns the number
    of elements checked and the routes taken."""
    scale = 0.01 + 0.04 * torch.rand((G, 1, 1), generator=gen, device=DEV)
    w = (torch.randn((G, R, C), generator=gen, device=DEV) * scale
         + 0.1 * scale).to(w_dtype)
    mu, sigma = _codec_stats(w, per_col)
    if shift:
        w = _offset_view(w, shift)
    routes = set()
    packs = (False, True) if k == 16 and C % 2 == 0 else (False,)
    for packed in packs:
        where = (f"G={G} R={R} C={C} k={k} per_col={per_col} {w_dtype} "
                 f"packed={packed} shift={shift}")
        routes.add(kq.codec_route(kq.QUANTIZE, (G, R, C), per_col, w_dtype,
                                  packed, (w.data_ptr(), 0)))
        codes = kq.kquantile_quantize(w, mu, sigma, k=k, packed=packed)
        again = kq.kquantile_quantize(w, mu, sigma, k=k, packed=packed)
        sync()
        want = kq.kquantile_quantize_plain(w, mu, sigma, k=k, packed=packed)
        _same("kquantile_quantize", codes, again, want, where)
    stored = codes if not shift else _offset_view(codes, shift)
    for out_dtype in (torch.float32, torch.bfloat16):
        routes.add(kq.codec_route(kq.DEQUANTIZE, (G, R, C), per_col,
                                  out_dtype, stored.dtype == torch.uint8,
                                  (0, stored.data_ptr())))
        out = kq.kquantile_dequantize(stored, mu, sigma, k=k,
                                      out_dtype=out_dtype)
        again = kq.kquantile_dequantize(stored, mu, sigma, k=k,
                                        out_dtype=out_dtype)
        sync()
        want = kq.kquantile_dequantize_plain(stored, mu, sigma, k=k,
                                             out_dtype=out_dtype)
        _same("kquantile_dequantize", out, again, want,
              f"G={G} R={R} C={C} k={k} per_col={per_col} {out_dtype} "
              f"packed={stored.dtype == torch.uint8} shift={shift}")
    del w, mu, sigma, codes, again, want, stored, out
    return G * R * C, routes


# (G, R, C), per-column statistics, in the --quick list: the KV rows of an
# append and a prefill chunk, the embedding rows of the closed batch's decode
# step (four tokens), every distinct weight shape of granite_3_8b and its
# embedding, then ragged ones: C not a multiple of 4 or 16, C < 4, odd C,
# R = 1 with many groups
CODEC_CASES = (
    ((2 * 16 * 8, 1, 128), False, True), ((2 * 4 * 64 * 8, 1, 128), False,
                                          False),
    ((1, 4, 4096), True, True),
    ((1, 4096, 12800), True, True), ((1, 12800, 4096), True, False),
    ((1, 4096, 4096), True, False), ((1, 4096, 1024), True, False),
    ((1, 49155, 4096), True, False), ((1, 256, 4096), True, False),
    ((3, 37, 131), True, True), ((3, 37, 131), False, False),
    ((2, 5, 7), True, True), ((1, 1, 3), False, False),
    ((5, 129, 1001), True, False), ((2, 9, 6), True, True),
    ((2, 9, 6), False, False), ((3, 17, 20), True, False),
    ((4, 3, 2), True, False), ((1, 3, 2), False, False),
    ((4096, 1, 128), False, False), ((777, 1, 36), False, True),
    ((300, 1, 64), True, False), ((1000, 1, 10), False, False))
# (G, R, C, per_col, dtype, shift): data pointers 4 (and 8) bytes off a
# 16-byte boundary
CODEC_SHIFTED = ((1, 64, 128, True, torch.float32, 4),
                 (3, 16, 96, False, torch.bfloat16, 8),
                 (2, 33, 64, True, torch.bfloat16, 4))
# the same kernels over more than 2^31 elements (G * R * C), groups below
BIG_CODEC = (3, 32768, 24576)


def _codec_big(gen):
    """Dequantize (int8 -> bf16) and quantize (bf16 -> int8) at
    ``BIG_CODEC``, G * R * C > 2^31, per-column statistics; compared with
    the plain versions slice by slice (4096 rows of one group at a
    time)."""
    G, R, C = BIG_CODEC
    codes = torch.randint(-128, 128, (G, R, C), generator=gen, device=DEV,
                          dtype=torch.int8)
    mu = (0.01 * torch.randn((G, 1, C), generator=gen, device=DEV))
    sigma = 0.02 + 0.01 * torch.rand((G, 1, C), generator=gen, device=DEV)
    out = kq.kquantile_dequantize(codes, mu, sigma, k=256)
    sync()
    step = 4096
    for g in range(G):
        for r in range(0, R, step):
            sl = (slice(g, g + 1), slice(r, r + step))
            want = kq.kquantile_dequantize_plain(
                codes[sl], mu[g:g + 1], sigma[g:g + 1], k=256)
            _same("kquantile_dequantize", out[sl], out[sl], want,
                  f"{BIG_CODEC} int8 -> bf16, group {g} rows {r}+")
    del want
    again = kq.kquantile_quantize(out, mu, sigma, k=256)
    sync()
    for g in range(G):
        for r in range(0, R, step):
            sl = (slice(g, g + 1), slice(r, r + step))
            want = kq.kquantile_quantize_plain(out[sl], mu[g:g + 1],
                                               sigma[g:g + 1], k=256)
            _same("kquantile_quantize", again[sl], again[sl], want,
                  f"{BIG_CODEC} bf16 -> int8, group {g} rows {r}+")
    del codes, out, again, want, mu, sigma
    torch.cuda.empty_cache()
    return 2 * G * R * C


def check_kquantile(gen, quick: bool) -> float:
    """kquantile_quantize / _dequantize against their plain versions, to
    the bit, over ``CODEC_CASES`` (both routes of ``codec_route``), views
    off a 16-byte boundary and one case over 2^31 elements; W4 / kv4
    (k = 16, packed output and input) and W8 / kv8 (k = 256)."""
    cases = [c for c in CODEC_CASES if c[2]] if quick else CODEC_CASES
    n = 0
    routes = set()
    for (G, R, C), per_col, _ in cases:
        for k in (16, 256):
            for w_dtype in ((torch.float32, torch.bfloat16) if R * C < 1 << 24
                            else (torch.float32,)):
                m, r = _codec_one(gen, G, R, C, k, per_col, w_dtype)
                n += m
                routes |= r
        say(f"[kernels] kquantile_quantize / _dequantize G={G} R={R} C={C} "
            f"per-{'column' if per_col else 'group'} stats: k=16 (int8"
            f"{', packed' if C % 2 == 0 else ''}) / 256 x f32/bf16 in and "
            f"out, bit-equal to the plain versions")
    for G, R, C, per_col, dtype, shift in CODEC_SHIFTED[:1 if quick else 3]:
        for k in (16, 256):
            m, r = _codec_one(gen, G, R, C, k, per_col, dtype, shift)
            n += m
            routes |= r
        say(f"[kernels] kquantile G={G} R={R} C={C} {dtype}, values and codes "
            f"{shift} bytes off a 16-byte boundary: bit-equal")
    if routes != {kq.VECTOR, kq.SCALAR}:
        raise SystemExit(f"the codec checks took only {routes}")
    if not quick:
        n += _codec_big(gen)
        say(f"[kernels] kquantile {BIG_CODEC} ({math.prod(BIG_CODEC)} "
            f"elements > 2^31): int8 -> bf16 and back, bit-equal slice by "
            f"slice")
    say(f"[kernels] kquantile: {n} values coded and decoded through both "
        f"routes, every code and every value equal to the plain versions'")
    return 0.0


def make_paged_pool(gen, B, n_pages, page, KV, hd, kv_bits, shift=0):
    """One layer of a coded pool (codes, mu, sigma) of 1 + B * n_pages
    pages of random bytes and statistics, and a (B, n_pages) int32 table:
    sequence b holds a random number of real pages (at least one), the
    rest of its row repeats the sink page 0; sequence 1 shares sequence
    0's first pages (a prefix hit).  ``shift``: the codes are a view that
    many bytes off a 16-byte boundary."""
    P = 1 + B * n_pages
    hdc = hd // 2 if kv_bits == 4 else hd
    c = torch.randint(0, 256, (P, page, KV, hdc), generator=gen, device=DEV)
    codes = c.to(torch.uint8) if kv_bits == 4 else (c - 128).to(torch.int8)
    if shift:
        codes = _offset_view(codes, shift)
    mu = (0.2 * torch.randn((P, page, KV), generator=gen, device=DEV)
          ).to(torch.bfloat16)
    sigma = (0.5 + torch.rand((P, page, KV), generator=gen, device=DEV)
             ).to(torch.bfloat16)
    ids = (1 + torch.randperm(P - 1, generator=gen, device=DEV)).to(
        torch.int32)
    tables = ids[:B * n_pages].reshape(B, n_pages).clone()
    used = torch.randint(1, n_pages + 1, (B,), generator=gen, device=DEV)
    used[0] = n_pages if B > 1 else max(1, n_pages - 3)
    cols = torch.arange(n_pages, device=DEV)[None]
    tables = torch.where(cols < used[:, None], tables, 0).to(torch.int32)
    if B > 1:
        shared = min(2, int(used[1]))
        tables[1, :shared] = tables[0, :shared]
    return codes, mu, sigma, tables.contiguous()


# (B, n_pages, page, KV, hd, shift, in the --quick list): the engine's
# prefill pool read (32 pages of 64, 8 heads of 128) at B = 1 and 8, then
# the small models' head_dim 16, a head_dim that is not whole chunks
# (the scalar route), codes off a 16-byte boundary, and odd head dims
# (kv8 only: kv4 packs two codes a byte)
PAGED_CASES = ((1, 32, 64, 8, 128, 0, True), (8, 32, 64, 8, 128, 0, False),
               (3, 5, 4, 2, 16, 0, True), (2, 3, 8, 2, 24, 0, False),
               (2, 4, 8, 3, 32, 8, False), (2, 4, 64, 2, 7, 0, True),
               (2, 4, 64, 8, 129, 0, False))


def check_paged_dequant(gen, quick: bool) -> float:
    """``kquantile_dequantize_paged`` against its plain version (the
    gathers, casts and dequantize it replaced), to the bit, kv8 and kv4,
    bf16 and f32 out, int32 and int64 tables with sink-page repeats; the
    same inputs twice give the same bits."""
    n = 0
    routes = set()
    for B, n_pages, page, KV, hd, shift, in_quick in PAGED_CASES:
        if quick and not in_quick:
            continue
        for kv_bits in (8, 4) if hd % 2 == 0 else (8,):
            codes, mu, sigma, tables = make_paged_pool(
                gen, B, n_pages, page, KV, hd, kv_bits, shift)
            for bt in (tables, tables.to(torch.int64)):
                for out_dtype in (torch.bfloat16, torch.float32):
                    where = (f"B={B} n_pages={n_pages} page={page} KV={KV} "
                             f"hd={hd} kv{kv_bits} {bt.dtype} {out_dtype} "
                             f"shift={shift}")
                    args = (codes, mu, sigma, bt)
                    kw = dict(kv_bits=kv_bits, out_dtype=out_dtype)
                    got = kq.kquantile_dequantize_paged(*args, **kw)
                    again = kq.kquantile_dequantize_paged(*args, **kw)
                    sync()
                    want = kq.kquantile_dequantize_paged_plain(*args, **kw)
                    _same("kquantile_dequantize_paged", got, again, want,
                          where)
                    routes.add(kq.codec_route(
                        kq.DEQUANTIZE, (got.numel() // hd, 1, hd), False,
                        out_dtype, kv_bits == 4,
                        (got.data_ptr(), codes.data_ptr())))
                    n += got.numel()
            del codes, mu, sigma, tables, got, again, want
        say(f"[kernels] kquantile_dequantize_paged B={B} n_pages={n_pages} "
            f"page={page} KV={KV} hd={hd} shift={shift}: "
            f"{'kv8 + kv4' if hd % 2 == 0 else 'kv8'}, bf16 + "
            f"f32 out, int32 + int64 tables with sink repeats, bit-equal to "
            f"the plain version")
    if not quick and routes != {kq.VECTOR, kq.SCALAR}:
        raise SystemExit(f"the paged checks took only {routes}")
    say(f"[kernels] kquantile_dequantize_paged: {n} values read through "
        f"{sorted(routes)}, every one equal to the plain version's")
    return 0.0


def make_kv_pool(gen, P, page, KV, hd, kv_bits):
    """One layer of a coded pool (``kq.KV_LEAVES``) filled with random
    bytes, so that a byte the append must not touch is recognisable."""
    hdc = hd // 2 if kv_bits == 4 else hd
    pool = {}
    for name in kq.KV_LEAVES:
        if name.endswith("codes"):
            c = torch.randint(0, 256, (P, page, KV, hdc), generator=gen,
                              device=DEV)
            pool[name] = c.to(torch.uint8) if kv_bits == 4 \
                else (c - 128).to(torch.int8)
        else:
            pool[name] = (torch.rand((P, page, KV), generator=gen,
                                     device=DEV) + 0.1).to(torch.bfloat16)
    return pool


def make_kv_rows(gen, N, KV, hd, page, dtype):
    """K and V rows (N, KV, hd) with per-row offsets and scales, and their
    destinations in a pool of ``1 + ceil(N / page) + 1`` pages: real rows
    on distinct slots of pages >= 1 (the pool's very last row among them),
    every fifth row a pad row on the sink page 0, rows 0 and 1 repeated (as
    the engine's padding does)."""
    def rows():
        scale = 0.5 + torch.rand((N, KV, 1), generator=gen, device=DEV)
        off = 0.2 * torch.randn((N, KV, 1), generator=gen, device=DEV)
        return (torch.randn((N, KV, hd), generator=gen, device=DEV) * scale
                + off).to(dtype)
    P = 2 + -(-N // page)
    n_slots = (P - 1) * page
    slots = torch.randperm(n_slots, generator=gen, device=DEV)[:N] + page
    last = P * page - 1
    j = (slots == last).nonzero().flatten()
    if len(j):
        slots[j] = slots[0].clone()
    slots[0] = last
    pages, rws = slots // page, slots % page
    pad = torch.arange(N, device=DEV)
    pad = pad[(pad % 5 == 4)]
    pages[pad] = 0
    rws[pad] = pad % 2
    return rows(), rows(), pages.contiguous(), rws.contiguous(), P


def eager_append(pool, pages, rows, k, v, kv_bits):
    """The KV append as the engine ran it before the fused kernel:
    ``quantize_kv`` (eager statistics around the flat ``kquantile_quantize``
    kernel, and int4 packing) and one index write per leaf."""
    st, mu, sig = kvc.quantize_kv(torch.stack([k, v]), kv_bits)
    vals = {"k_codes": st[0], "k_mu": mu[0], "k_sigma": sig[0],
            "v_codes": st[1], "v_mu": mu[1], "v_sigma": sig[1]}
    for name, val in vals.items():
        pool[name][pages, rows] = val.to(pool[name].dtype)


def eager_write_rows(kc, layer, pages, rows, k, v, kv_bits, use_kernels=True):
    """``lm._write_rows`` as it was before the fused append (coded pools):
    the comparison of the profile phase."""
    view = {name: leaf[layer] for name, leaf in kc.items()}
    KV, hd = k.shape[-2:]
    eager_append(view, pages.reshape(-1), rows.reshape(-1),
                 k.reshape(-1, KV, hd), v.reshape(-1, KV, hd), kv_bits)
    return view


def _ordered_bf16(t):
    """bf16 values as integers whose differences count ulps (-0 and +0
    are one value)."""
    b = t.view(torch.int16).int()
    return torch.where(b < 0, -(b & 0x7FFF), b)


def _kv_append_one(gen, N, KV, hd, kv_bits, dtype, page=64):
    """One fused append against its plain version on one pool layer.
    Returns the max abs error of the dequantized rows, the (row, head,
    K or V) statistics pairs one bf16 ulp apart and checked, and the load
    and store routes (``kq.append_route``) the call took."""
    where = f"N={N} KV={KV} hd={hd} kv{kv_bits} {dtype}"
    k, v, pages, rows, P = make_kv_rows(gen, N, KV, hd, page, dtype)
    pool0 = make_kv_pool(gen, P, page, KV, hd, kv_bits)
    got = {n: t.clone() for n, t in pool0.items()}
    again = {n: t.clone() for n, t in pool0.items()}
    want = {n: t.clone() for n, t in pool0.items()}
    kq.kv_append(got, pages, rows, k, v, kv_bits=kv_bits)
    kq.kv_append(again, pages, rows, k, v, kv_bits=kv_bits)
    sync()
    kq.kv_append_plain(want, pages, rows, k, v, kv_bits=kv_bits)
    target = torch.zeros((P, page), dtype=torch.bool, device=DEV)
    target[pages, rows] = True
    for name in kq.KV_LEAVES:
        # the sink page's repeated rows land in no set order: pages >= 1
        if not torch.equal(got[name][1:], again[name][1:]):
            raise SystemExit(f"kv_append is not deterministic ({name}): "
                             f"{where}")
        if not torch.equal(got[name][~target], pool0[name][~target]):
            raise SystemExit(f"kv_append changed pool bytes outside its "
                             f"destinations ({name}): {where}")
    real = pages != 0
    pr, rr = pages[real], rows[real]
    x = torch.stack([k[real], v[real]]).float()         # (2, n, KV, hd)
    n_pairs = n_ulp = 0
    err = 0.0
    for i, side in enumerate(("k", "v")):
        g = {f: got[f"{side}_{f}"][pr, rr] for f in ("codes", "mu", "sigma")}
        w = {f: want[f"{side}_{f}"][pr, rr] for f in ("codes", "mu", "sigma")}
        same = (g["mu"] == w["mu"]) & (g["sigma"] == w["sigma"])
        for f in ("mu", "sigma"):
            gap = (_ordered_bf16(g[f]) - _ordered_bf16(w[f])).abs()
            if int(gap.max()) > 1:
                raise SystemExit(f"kv_append {side}_{f} more than one bf16 "
                                 f"ulp from the plain version: {where}")
        if not torch.equal(g["codes"][same], w["codes"][same]):
            raise SystemExit(f"kv_append {side} codes differ from the plain "
                             f"version's where the statistics agree: "
                             f"{where}")
        own = kref.kquantile_codes_ref(x[i], g["mu"].float()[..., None],
                                       g["sigma"].float()[..., None],
                                       2 ** kv_bits)
        if kv_bits == 4:
            own = packing.pack_int4(own)
        if not torch.equal(g["codes"], own.to(g["codes"].dtype)):
            raise SystemExit(f"kv_append {side} codes are not the plain codes "
                             f"of its own statistics: {where}")
        n_pairs += same.numel()
        n_ulp += int((~same).sum())

        def dq(t):
            c = packing.unpack_int4(t["codes"]) if kv_bits == 4 \
                else t["codes"]
            return kref.kquantile_dequant_ref(
                c, t["mu"].float()[..., None], t["sigma"].float()[..., None],
                2 ** kv_bits, dtype=torch.float32)
        err = max(err, (dq(g) - dq(w)).abs().max().item())
    load, store = kq.append_route(
        hd, k.element_size(), kv_bits, (k.data_ptr(), v.data_ptr()),
        (pool0["k_codes"].data_ptr(), pool0["v_codes"].data_ptr()))
    del got, again, want, pool0, target
    return err, n_ulp, n_pairs, {("load", load), ("store", store)}


# (N, KV, hd, dtype): decode and one prefill chunk of granite_3_8b's
# engine, a long prefill for the statistics' share, gemma2's head_dim 256,
# the tiny f32 models (head_dim 16) and ragged counts; then the head dims
# that are not a power of two (stablelm_12b 160 and its smoke 20, kimi_k2
# 112) at the engine's decode and prefill-chunk shapes, bf16 and f32, and
# layouts of 2 and 3 chunks a lane (130, 132) and VPL 2 (6); then odd head
# dims (kv8 only, VPL 1: 1, 4 and 5 chunks a lane), decode and a 256-row
# chunk, bf16 and f32
KV_APPEND_CASES = (
    (16, 8, 128, torch.bfloat16), (256, 8, 128, torch.bfloat16),
    (4096, 8, 128, torch.bfloat16), (16, 8, 256, torch.bfloat16),
    (2, 2, 16, torch.float32), (5, 2, 16, torch.float32),
    (3, 4, 32, torch.float32), (7, 1, 64, torch.bfloat16),
    (33, 8, 128, torch.float32)) + tuple(
    (N, 8, hd, dtype) for hd in (20, 112, 160) for N in (16, 256)
    for dtype in (torch.bfloat16, torch.float32)) + (
    (9, 3, 130, torch.bfloat16), (9, 3, 132, torch.float32),
    (5, 2, 6, torch.bfloat16)) + tuple(
    (N, 8, hd, dtype) for hd in (7, 129) for N in (16, 256)
    for dtype in (torch.bfloat16, torch.float32)) + (
    (3, 2, 1, torch.float32), (5, 3, 155, torch.bfloat16))
# the --quick subset: decode and a chunk at hd 128, the small f32 model,
# and one decode case of each new head dim
KV_APPEND_QUICK = KV_APPEND_CASES[:2] + KV_APPEND_CASES[4:6] + tuple(
    c for c in KV_APPEND_CASES[9:] if c[0] == 16 and c[3] == torch.bfloat16)


def check_kv_append(gen, quick: bool) -> float:
    """The fused KV append (``kv_append``) against ``kv_append_plain`` at
    the engine's decode and prefill shapes and small ones, kv8 and kv4:
    statistics at most one bf16 ulp apart (and that in at most
    ``TOL_KV_STATS_ULP`` of the pairs), codes bit-equal where they agree,
    every other pool byte untouched.  Returns the max abs error of the
    dequantized rows."""
    cases = KV_APPEND_QUICK if quick else KV_APPEND_CASES
    worst = 0.0
    n_ulp = n_pairs = 0
    routes = set()
    for (N, KV, hd, dtype) in cases:
        bits = (8, 4) if hd % 2 == 0 else (8,)     # kv4: two codes a byte
        for kv_bits in bits:
            err, u, n, r = _kv_append_one(gen, N, KV, hd, kv_bits, dtype)
            worst = max(worst, err)
            n_ulp += u
            n_pairs += n
            routes.update(r)
        say(f"[kernels] kv_append N={N} KV={KV} hd={hd} {dtype} (layout "
            f"VPL x lanes {kq.append_layout(hd)}): "
            f"{' + '.join(f'kv{b}' for b in bits)} against the plain "
            f"version, untouched bytes unchanged")
    if routes != {("load", kq.VECTOR), ("load", kq.SCALAR),
                  ("store", kq.VECTOR), ("store", kq.SCALAR)}:
        raise SystemExit(f"kv_append: the cases did not take every load and "
                         f"store route: {sorted(routes)}")
    frac = n_ulp / n_pairs
    say(f"[kernels] kv_append: {n_ulp} of {n_pairs} (row, head, K or V) "
        f"statistics pairs one bf16 ulp from the plain version ({frac:.3e}; "
        f"limit {TOL_KV_STATS_ULP}); codes bit-equal wherever the statistics "
        f"agree; max abs err of the dequantized rows {worst:.3e}")
    if frac > TOL_KV_STATS_ULP:
        raise SystemExit("kv_append: too many statistics one ulp apart")
    return worst


# (geometry, extra inputs, in the --quick list): the four earlier shapes,
# then the tensor-core body's edges (G = 8 and 1, D = 64 and 256, pages of
# 16 in a 40-page table, one sequence over 2048 rows, the most splits;
# ragged q_pos over sink-padded tables), bf16 shapes that attn_route
# gives the CUDA-core body (D not a multiple of 16, a page of 4), and odd
# head dims over 256 rows (kv8 only: kv4 packs two codes a byte)
ATTN_GEOMS = (
    (dict(B=16, H=32, KV=8, D=128, page=64, n_pages=32), {}, True),
    (dict(B=3, H=4, KV=2, D=16, page=8, n_pages=3), {}, True),
    (dict(B=2, H=16, KV=8, D=256, page=16, n_pages=5), {}, False),
    (dict(B=2, H=32, KV=4, D=128, page=64, n_pages=9), {}, False),
    (dict(B=4, H=64, KV=8, D=128, page=64, n_pages=8), {}, True),
    (dict(B=4, H=8, KV=8, D=128, page=64, n_pages=8), {}, False),
    (dict(B=4, H=32, KV=8, D=64, page=64, n_pages=8), {}, False),
    (dict(B=2, H=32, KV=8, D=256, page=64, n_pages=8), {}, False),
    (dict(B=4, H=32, KV=8, D=128, page=16, n_pages=40), {}, True),
    (dict(B=1, H=32, KV=8, D=128, page=64, n_pages=32),
     dict(q_pos=[2047]), False),
    (dict(B=8, H=32, KV=8, D=128, page=64, n_pages=16),
     dict(sink_tail=True), True),
    (dict(B=2, H=4, KV=2, D=24, page=8, n_pages=3), {}, False),
    (dict(B=2, H=4, KV=2, D=32, page=4, n_pages=6), {}, False),
    (dict(B=4, H=8, KV=2, D=7, page=64, n_pages=4), {}, True),
    (dict(B=4, H=16, KV=4, D=129, page=64, n_pages=4), {}, False),
)


def attn_rel_err(out, want) -> float:
    """Max over sequences of max |out - want| / max |want| within the
    sequence (0 where both are exact zeros)."""
    B = want.shape[0]
    d = (out.float() - want.float()).abs().reshape(B, -1).amax(dim=1)
    m = want.float().abs().reshape(B, -1).amax(dim=1)
    return torch.where(d == 0, torch.zeros_like(d),
                       d / m.clamp_min(1e-30)).max().item()


def attn_controls(t, kv_bits, want) -> dict:
    """Faulty versions of a bf16-query output, read by ``attn_rel_err``
    against the sound plain version ``want`` (no window, no cap):
    ``dropped chunk`` loses the first 16 rows (one chunk of the tensor-core
    body) of every sequence whose context is the table's full width, by a
    window of S - 16; ``f32 K/V`` leaves K, V and P unrounded (the plain
    version on f32 queries), which is what the CUDA-core body computes."""
    S = t["block_tables"].shape[1] * t["k_mu"].shape[1]
    drop = attn_call(pa.paged_quant_attention_plain, t, kv_bits=kv_bits,
                     window=S - 16)
    f32 = attn_call(pa.paged_quant_attention_plain, dict(t, q=t["q"].float()),
                    kv_bits=kv_bits).to(torch.bfloat16)
    return {"dropped chunk": attn_rel_err(drop, want),
            "f32 K/V": attn_rel_err(f32, want)}


def check_attention(gen, quick: bool) -> float:
    """Both bodies against the plain version: every geometry, kv8 / kv4,
    f32 queries (the CUDA-core body) and bf16 ones (the body
    ``attn_route`` names), window x cap x splits; bf16 outputs also within
    ``TOL_ATT_BF16_REL`` of each sequence's largest output, a limit the
    dropped-chunk control of the first geometry must exceed;
    deterministic; an all-masked query gives exact zeros on either body."""
    worst = 0.0
    worst_rel = {}
    for g, extra, in_quick in ATTN_GEOMS:
        if quick and not in_quick:
            continue
        routes = []
        for kv_bits in (8, 4) if g["D"] % 2 == 0 else (8,):
            for q_dtype in (torch.float32, torch.bfloat16):
                t = make_attn_inputs(gen, kv_bits=kv_bits, q_dtype=q_dtype,
                                     **g, **extra)
                route = pa.attn_route(q_dtype, g["D"], g["KV"], g["page"],
                                      kv_bits)
                routes.append(f"kv{kv_bits} {str(q_dtype)[6:]} -> {route}")
                bf16 = q_dtype == torch.bfloat16
                tol = TOL_ATT_BF16 if bf16 else TOL_ATT_F32
                for window, cap in ((None, None), (100, None), (None, 30.0),
                                    (7, 30.0)):
                    want = attn_call(pa.paged_quant_attention_plain, t,
                                     kv_bits=kv_bits, window=window,
                                     logit_cap=cap)
                    if bf16 and g is ATTN_GEOMS[0][0] and window is None \
                            and cap is None:
                        ctl = attn_controls(t, kv_bits, want)
                        say(f"[kernels] paged_quant_attention controls, "
                            f"kv{kv_bits} {g}: relative error of a dropped "
                            f"chunk {ctl['dropped chunk']:.3e}, of f32 K/V "
                            f"{ctl['f32 K/V']:.3e} (limit "
                            f"{TOL_ATT_BF16_REL:.3e})")
                        if ctl["dropped chunk"] <= TOL_ATT_BF16_REL:
                            raise SystemExit(
                                f"TOL_ATT_BF16_REL {TOL_ATT_BF16_REL} cannot "
                                f"see a dropped chunk (relative error "
                                f"{ctl['dropped chunk']:.3e})")
                    for splits in (1, 4, None):
                        out = attn_call(pa.paged_quant_attention, t,
                                        kv_bits=kv_bits, window=window,
                                        logit_cap=cap, splits=splits)
                        again = attn_call(pa.paged_quant_attention, t,
                                          kv_bits=kv_bits, window=window,
                                          logit_cap=cap, splits=splits)
                        sync()
                        err = (out.float() - want.float()).abs().max().item()
                        worst = max(worst, err)
                        rel = attn_rel_err(out, want) if bf16 else 0.0
                        if bf16:
                            worst_rel[route] = max(worst_rel.get(route, 0.0),
                                                   rel)
                        if not torch.isfinite(out).all() or err > tol \
                                or rel > TOL_ATT_BF16_REL:
                            raise SystemExit(
                                f"paged_quant_attention ({route}) disagrees "
                                f"with its plain version: {g} {extra} "
                                f"kv{kv_bits} {q_dtype} window={window} "
                                f"cap={cap} splits={splits} "
                                f"err={err:.3e} (limit {tol}), relative "
                                f"{rel:.3e} (limit {TOL_ATT_BF16_REL})")
                        if not torch.equal(out, again):
                            raise SystemExit(
                                f"paged_quant_attention ({route}) is not "
                                f"deterministic: {g} kv{kv_bits}")
        say(f"[kernels] paged_quant_attention {g} {extra}: window x cap x "
            f"splits ok; " + ", ".join(routes))
    say("[kernels] paged_quant_attention bf16 queries, largest relative "
        "error per sequence: " + ", ".join(
            f"{r} body {v:.3e}" for r, v in sorted(worst_rel.items()))
        + f" (limit {TOL_ATT_BF16_REL:.3e})")
    # a query with no valid row combines to exact zeros, on both bodies
    for g, q_pos in ((dict(B=3, H=4, KV=2, D=16, page=8, n_pages=3),
                      [-1, 5, 23]),
                     (dict(B=4, H=32, KV=8, D=128, page=64, n_pages=8),
                      [-1, 100, 511, 300])):
        for q_dtype in (torch.float32, torch.bfloat16):
            t = make_attn_inputs(gen, kv_bits=8, q_dtype=q_dtype,
                                 q_pos=q_pos, **g)
            out = attn_call(pa.paged_quant_attention, t, kv_bits=8, splits=2)
            sync()
            route = pa.attn_route(q_dtype, g["D"], g["KV"], g["page"], 8)
            if out[0].abs().max().item() != 0.0:
                raise SystemExit(f"an all-masked query must give exact "
                                 f"zeros ({route} body, {g})")
            say(f"[kernels] paged_quant_attention all-masked query gives "
                f"zeros ({route} body, D={g['D']})")
    return worst


def make_uniq_inputs(gen, G, R, C, dtype, per_col, modes,
                     one_stat=False):
    """Gaussian weights with per-group offsets and scales, their statistics
    as ``fit_gaussian`` takes them (per column or per group; with
    ``one_stat`` one over the whole tensor, in every group's place, as
    ``grouped_stats`` lays out an unstacked 3-D leaf's), U[0,1) noise and a
    (G,) mode vector."""
    scale = 0.01 + 0.04 * torch.rand((G, 1, 1), generator=gen, device=DEV)
    w = (torch.randn((G, R, C), generator=gen, device=DEV) * scale
         + 0.1 * scale).to(dtype)
    wf = w.float()
    dims = (0, 1, 2) if one_stat else (1,) if per_col else (1, 2)
    mu = wf.mean(dim=dims, keepdim=True).expand(G, 1, -1)
    sigma = wf.std(dim=dims, correction=0, keepdim=True).clamp_min(
        1e-8).expand(G, 1, -1)
    del wf
    e01 = torch.rand((G, R, C), generator=gen, device=DEV)
    mode = torch.tensor(modes, dtype=torch.int32, device=DEV)
    return w, mu.contiguous(), sigma.contiguous(), mode, e01


# the trainer's new leaf shapes of phase 6b, (G, R, C), one statistic over
# the whole tensor, what: mamba2's and zamba2's stacked in_proj (zamba2's
# 10448 columns no multiple of 128), zamba2's unstacked shared w_up,
# whisper's unstacked encoder w_up stack (6 layers, one mode, one
# statistic), pixtral's stacked w_up at phase 6b's depth and its embedding
FAMILY_UNIQ_SHAPES = (
    ((48, 2048, 8512), False, "mamba2 layers/in_proj"),
    ((54, 2560, 10448), False, "zamba2 layers/in_proj"),
    ((1, 2560, 10240), False, "zamba2 shared/w_up"),
    ((6, 512, 2048), True, "whisper enc_layers/w_up"),
    ((4, 5120, 14336), False, "pixtral layers/w_up (4 layers)"),
    ((1, 131072, 5120), False, "pixtral embed")) + tuple(
    # phase 6c's expert stacks (1 layer; kimi_k2 cut to 16 experts, llama4
    # to 8), (L, E, d, f) grouped as (L, E * d, f): one group of 235 M / 336
    # M elements; and a layer's (E, d, f) slice as the per-layer transform
    # inside the layer loop gives it, E groups with one statistic
    (shape, one_stat, f"{arch} {what}")
    for arch, n_exp in (("kimi_k2_1t_a32b", 16),
                        ("llama4_maverick_400b_a17b", 8))
    for shape, one_stat, what in (
        ((1, n_exp * cb.get(arch).d_model, cb.get(arch).d_ff), False,
         f"layers/eg ({n_exp} experts)"),
        ((1, n_exp * cb.get(arch).d_ff, cb.get(arch).d_model), False,
         f"layers/ed ({n_exp} experts)"))) + (
    ((16, 7168, 2048), True,
     "kimi_k2_1t_a32b eg, one layer's slice in the layer loop"),)


def check_uniq(gen, quick: bool, layers: int):
    """uniq_noise_fwd / _bwd against their plain versions at the training
    path's leaf shapes (granite_3_8b, ``layers`` stacked) and ragged ones,
    f32 and bf16, per-group and per-column statistics, every mode mixed
    across G.  Returns the forward's and the backward's max abs error."""
    L = 2 if quick else layers
    shapes = [(L, 4096, 4096), (L, 4096, 1024), (L, 4096, 12800),
              (L, 12800, 4096), (1, 49155, 4096), (1, 4096, 49155),
              (3, 37, 131), (2, 5, 7), (1, 1, 3), (5, 129, 1001)]
    if quick:
        shapes = [(L, 4096, 12800), (1, 4096, 49155), (3, 37, 131),
                  (2, 5, 7)]
    worst_f = worst_b = 0.0
    flips = n_frozen = 0
    noise_sigma = {torch.float32: 0.0, torch.bfloat16: 0.0}
    bwd_rel = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for (G, R, C) in shapes:
        mode_sets = ([[m] for m in (1, 2, 0)] if G == 1
                     else [[(g + s) % 3 for g in range(G)] for s in (0, 1)])
        for dtype in (torch.float32, torch.bfloat16):
            for per_col in (False, True):
                for modes in mode_sets:
                    for k in ((16,) if R * C > 1 << 20 else (4, 16, 256)):
                        res = _check_uniq_one(gen, G, R, C, dtype, per_col,
                                              modes, k)
                        worst_f = max(worst_f, res["fwd_err"])
                        worst_b = max(worst_b, res["bwd_err"])
                        flips += res["flips"]
                        n_frozen += res["n_frozen"]
                        noise_sigma[dtype] = max(noise_sigma[dtype],
                                                 res["noise_sigma"])
                        bwd_rel[dtype] = max(bwd_rel[dtype], res["bwd_rel"])
        say(f"[kernels] uniq_noise G={G} R={R} C={C}: fwd + bwd x f32/bf16 "
            f"x per-group/per-column stats x modes {mode_sets} ok")
    for (G, R, C), one_stat, what in ([] if quick else FAMILY_UNIQ_SHAPES):
        # the trainer's leaves as phase 6b gives them: f32, W4, the
        # statistics transform_tree fits (per layer, or one), the modes of
        # the schedule (mixed across the layers of a stacked leaf; one for
        # an unstacked leaf)
        mode_sets = ([[m] * G for m in (1, 2, 0)] if G == 1 or one_stat
                     else [[(g + s) % 3 for g in range(G)] for s in (0, 1)])
        route = un.onchip_route(G, R, C, False)
        for modes in mode_sets:
            res = _check_uniq_one(gen, G, R, C, torch.float32, False, modes,
                                  16, one_stat)
            worst_f = max(worst_f, res["fwd_err"])
            worst_b = max(worst_b, res["bwd_err"])
            flips += res["flips"]
            n_frozen += res["n_frozen"]
            noise_sigma[torch.float32] = max(noise_sigma[torch.float32],
                                             res["noise_sigma"])
            bwd_rel[torch.float32] = max(bwd_rel[torch.float32],
                                         res["bwd_rel"])
            torch.cuda.empty_cache()
        say(f"[kernels] uniq_noise {what} G={G} R={R} C={C} ({route} body, "
            f"held against the plain version and the flat body to the "
            f"bit): fwd + bwd f32, "
            f"{'one statistic' if one_stat else 'per-layer statistics'}, "
            f"modes {[sorted(set(m)) for m in mode_sets]} ok")
    say(f"[kernels] uniq_noise: FROZEN outputs differing from the plain "
        f"version {flips} of {n_frozen}; NOISE max |diff| / sigma: f32 "
        f"{noise_sigma[torch.float32]:.3e}, bf16 (beyond one bf16 ulp) "
        f"{noise_sigma[torch.bfloat16]:.3e}; bwd max rel diff f32 "
        f"{bwd_rel[torch.float32]:.3e}, bf16 {bwd_rel[torch.bfloat16]:.3e}")
    if flips > TOL_UNIQ_FROZEN_FLIPS * max(n_frozen, 1):
        raise SystemExit(f"uniq_noise FROZEN: {flips} of {n_frozen} outputs "
                         f"differ from the plain version (bound "
                         f"{TOL_UNIQ_FROZEN_FLIPS} of them)")
    return worst_f, worst_b


def _check_uniq_one(gen, G, R, C, dtype, per_col, modes, k, one_stat=False):
    w, mu, sigma, mode, e01 = make_uniq_inputs(gen, G, R, C, dtype, per_col,
                                               modes, one_stat)
    out = un.uniq_noise_fwd(w, mu, sigma, mode, e01, k=k)
    again = un.uniq_noise_fwd(w, mu, sigma, mode, e01, k=k)
    sync()
    want = un.uniq_noise_fwd_plain(w, mu, sigma, mode, e01, k=k)
    where = (f"G={G} R={R} C={C} {dtype} per_col={per_col} "
             f"one_stat={one_stat} modes={modes} k={k}")
    if not torch.equal(out, again):
        raise SystemExit(f"uniq_noise_fwd is not deterministic: {where}")
    if not torch.isfinite(out).all():
        raise SystemExit(f"uniq_noise_fwd gives non-finite values: {where}")
    _same_bodies("uniq_noise_fwd", out, w, mu, sigma, mode, modes, k,
                 where, e01=e01)
    m = mode.reshape(-1, 1, 1)
    diff = (out.float() - want.float()).abs()
    fwd_err = diff.max().item()
    clean = (m == 0).expand_as(w)
    if not torch.equal(out[clean], w[clean]):
        raise SystemExit(f"uniq_noise_fwd CLEAN is not the identity: {where}")
    frozen = (m == 2).expand_as(w)
    flips = int((out[frozen] != want[frozen]).sum().item())
    n_frozen = int(frozen.sum().item())
    noise_sigma = 0.0
    noisy = (m == 1).expand_as(w)
    if noisy.any():
        rel = diff / sigma
        if dtype == torch.bfloat16:
            # one bf16 rounding step of the result is allowed: subtract it
            ulp = want.float().abs() * 2.0 ** -8
            rel = (diff - ulp).clamp_min(0.0) / sigma
        noise_sigma = rel[noisy].max().item()
        if noise_sigma > TOL_UNIQ_NOISE_SIGMA:
            raise SystemExit(f"uniq_noise_fwd NOISE disagrees with its plain "
                             f"version by {noise_sigma:.3e} sigma > "
                             f"{TOL_UNIQ_NOISE_SIGMA}: {where}")
    del again, diff, clean
    # backward, on the kernel's own w_hat so both sides see one input
    g = torch.randn((G, R, C), generator=gen, device=DEV).to(dtype)
    dw = un.uniq_noise_bwd(g, w, out, mu, sigma, mode)
    dw2 = un.uniq_noise_bwd(g, w, out, mu, sigma, mode)
    sync()
    dw_want = un.uniq_noise_bwd_plain(g, w, out, mu, sigma, mode)
    if not torch.equal(dw, dw2):
        raise SystemExit(f"uniq_noise_bwd is not deterministic: {where}")
    if len(set(modes)) == 1 and not torch.equal(
            dw, un.uniq_noise_bwd(g, w, out, mu, sigma, modes[0])):
        raise SystemExit(f"uniq_noise_bwd with its mode by value differs: "
                         f"{where}")
    bdiff = (dw.float() - dw_want.float()).abs()
    bwd_err = bdiff.max().item()
    step = 2.0 ** -7 if dtype == torch.bfloat16 else 0.0
    bwd_rel = ((bdiff - step * dw_want.float().abs()).clamp_min(0.0)
               / dw_want.float().abs().clamp_min(1e-30)).max().item()
    if not torch.isfinite(dw).all() or bwd_rel > TOL_UNIQ_BWD_REL:
        raise SystemExit(f"uniq_noise_bwd disagrees with its plain version: "
                         f"rel {bwd_rel:.3e} > {TOL_UNIQ_BWD_REL}: {where}")
    if (dw[frozen] != 0).any():
        raise SystemExit(f"uniq_noise_bwd FROZEN gradient is not zero: "
                         f"{where}")
    res = dict(fwd_err=fwd_err if dtype == torch.float32 else 0.0,
               bwd_err=bwd_err if dtype == torch.float32 else 0.0,
               flips=flips, n_frozen=n_frozen, noise_sigma=noise_sigma,
               bwd_rel=bwd_rel)
    del w, mu, sigma, mode, e01, out, want, g, dw, dw2, dw_want, bdiff
    del frozen, noisy
    return res


# the CNN trainer's leaves in the kernel layout (kops._grouped): the largest
# ResNet-18 conv (3, 3, 512, 512), a MobileNet depthwise (3, 3, 1, 128) and
# the fc (512, 10)
CNN_LEAF_SHAPES = ((3, 3 * 512, 512), (3, 3, 128), (1, 512, 10))


def _moments_ok(e01) -> str:
    """Mean and variance of a U[0, 1) draw against 1/2 and 1/12, within six
    standard errors of each; '' when they hold, else what failed."""
    n = e01.numel()
    e = e01.double()
    mean, var = e.mean().item(), e.var(correction=0).item()
    tol_m = 6.0 * math.sqrt(1.0 / 12.0 / n)
    tol_v = 6.0 * math.sqrt(1.0 / 80.0 - 1.0 / 144.0) / math.sqrt(n) + tol_m
    if abs(mean - 0.5) > tol_m or abs(var - 1.0 / 12.0) > tol_v:
        return (f"mean {mean:.6f} (|d| > {tol_m:.2e}) or var {var:.6f} "
                f"(|d| > {tol_v:.2e})")
    return ""


def check_uniq_onchip(gen, quick: bool, layers: int):
    """uniq_noise_fwd_onchip against its plain version at the granite leaf
    shapes of check_uniq, the CNN trainer's leaf shapes and ragged ones.
    Returns the forward's max abs error (f32)."""
    L = 2 if quick else layers
    shapes = [(L, 4096, 4096), (L, 4096, 1024), (L, 4096, 12800),
              (L, 12800, 4096), (1, 49155, 4096), (1, 4096, 49155),
              *CNN_LEAF_SHAPES, (3, 37, 131), (2, 5, 7), (1, 1, 3),
              (5, 129, 1001)]
    if quick:
        shapes = [(L, 4096, 12800), *CNN_LEAF_SHAPES, (3, 37, 131),
                  (2, 5, 7), (1, 1, 3)]
    # small: the CPU's plain draw too, so the bits are shown independent of
    # the device
    cpu_n = 1 << 16
    worst = 0.0
    flips = n_frozen = n_bits = 0
    noise_sigma = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for si, (G, R, C) in enumerate(shapes):
        n = G * R * C
        key = (0x9E3779B97F4A7C15 * (si + 1)) & ((1 << 63) - 1)
        # the raw draw, read back by the debug entry point: bit for bit
        got = un.onchip_e01(key, n, DEV)
        again = un.onchip_e01(key, n, DEV)
        sync()
        want = kref.onchip_e01(key, n, DEV)
        where = f"G={G} R={R} C={C} key={key:#x}"
        if not torch.equal(got, again):
            raise SystemExit(f"onchip e01 is not deterministic: {where}")
        if not torch.equal(got, want):
            bad = int((got != want).sum().item())
            raise SystemExit(f"onchip e01 differs from its plain version in "
                             f"{bad} of {n} draws: {where}")
        if n <= cpu_n and not torch.equal(
                got.cpu(), kref.onchip_e01(key, n, "cpu")):
            raise SystemExit(f"onchip e01 differs from the CPU's plain "
                             f"draw: {where}")
        if n >= 4:
            other = un.onchip_e01(key ^ 1, n, DEV)
            same = (other == got).double().mean().item()
            if same > 0.01:
                raise SystemExit(f"onchip e01 under another key shares "
                                 f"{same:.3f} of its draws: {where}")
            del other
        if n >= 1 << 14:
            bad = _moments_ok(got)
            if bad:
                raise SystemExit(f"onchip e01 moments: {bad}: {where}")
        n_bits += n
        del again, want
        mode_sets = ([[m] for m in (1, 2, 0)] if G == 1
                     else [[(g + s) % 3 for g in range(G)] for s in (0, 1)])
        if G > 1 and n <= 1 << 24:
            # one mode for every group, as the CNN trainer's leaves have
            mode_sets += [[m] * G for m in (1, 2, 0)]
        for dtype in (torch.float32, torch.bfloat16):
            for modes in mode_sets:
                for k in ((16,) if n > 1 << 20 else (4, 16, 256)):
                    res = _check_onchip_one(gen, G, R, C, dtype, modes, k,
                                            key, got)
                    if dtype == torch.float32:
                        worst = max(worst, res["fwd_err"])
                    flips += res["flips"]
                    n_frozen += res["n_frozen"]
                    noise_sigma[dtype] = max(noise_sigma[dtype],
                                             res["noise_sigma"])
        del got
        torch.cuda.empty_cache()
        say(f"[kernels] uniq_noise_fwd_onchip G={G} R={R} C={C} "
            f"({un.onchip_route(G, R, C, False)} body): raw draw bit-equal "
            f"to the plain Philox, repeatable, key-dependent; fwd x f32/bf16 "
            f"x modes {mode_sets} ok (the flat body where both bodies take "
            f"the shape, and modes by value, to the bit)")
    say(f"[kernels] uniq_noise_fwd_onchip: {n_bits} draws equal to the plain "
        f"version's; FROZEN outputs differing {flips} of {n_frozen}; NOISE "
        f"max |diff| / sigma: f32 {noise_sigma[torch.float32]:.3e}, bf16 "
        f"(beyond one bf16 ulp) {noise_sigma[torch.bfloat16]:.3e}")
    if flips > TOL_UNIQ_FROZEN_FLIPS * max(n_frozen, 1):
        raise SystemExit(f"uniq_noise_fwd_onchip FROZEN: {flips} of "
                         f"{n_frozen} outputs differ from the plain version "
                         f"(bound {TOL_UNIQ_FROZEN_FLIPS} of them)")
    return worst


def _same_bodies(name, out, w, mu, sigma, mode, modes, k, where, **noise):
    """The forward's output ``out`` (from the body ``onchip_route`` picks)
    against the other body where both take the shape, and against the
    mode given by value where every group has one: to the bit (the same
    operations in the same order, the same draw)."""
    G, R, C = w.shape
    if un.onchip_route(G, R, C, mu.shape[-1] != 1) == un.GROUP:
        flat = un._launch_fwd(un.FLAT, w, mu, sigma, mode, k=k, **noise)
        if not torch.equal(out, flat):
            raise SystemExit(f"{name}: the per-group body differs from the "
                             f"flat body: {where}")
        del flat
    if len(set(modes)) == 1:
        fn = un.uniq_noise_fwd if "e01" in noise else un.uniq_noise_fwd_onchip
        by_value = fn(w, mu, sigma, modes[0], *noise.values(), k=k)
        if not torch.equal(out, by_value):
            raise SystemExit(f"{name} with its mode by value differs: "
                             f"{where}")
        del by_value


def _check_onchip_one(gen, G, R, C, dtype, modes, k, key, e01_flat):
    w, mu, sigma, mode, _ = make_uniq_inputs(gen, G, R, C, dtype, False,
                                             modes)
    where = f"G={G} R={R} C={C} {dtype} modes={modes} k={k}"
    out = un.uniq_noise_fwd_onchip(w, mu, sigma, mode, key, k=k)
    again = un.uniq_noise_fwd_onchip(w, mu, sigma, mode, key, k=k)
    # the host-noise kernel on the same bits: one body, so to the bit
    host = un.uniq_noise_fwd(w, mu, sigma, mode, e01_flat.view(G, R, C), k=k)
    sync()
    want = un.uniq_noise_fwd_onchip_plain(w, mu, sigma, mode, key, k=k)
    if not torch.equal(out, again):
        raise SystemExit(f"uniq_noise_fwd_onchip is not deterministic: "
                         f"{where}")
    if not torch.equal(out, host):
        raise SystemExit(f"uniq_noise_fwd_onchip differs from uniq_noise_fwd "
                         f"on the same draw: {where}")
    _same_bodies("uniq_noise_fwd_onchip", out, w, mu, sigma, mode, modes, k,
                 where, key=key)
    if not torch.isfinite(out).all():
        raise SystemExit(f"uniq_noise_fwd_onchip gives non-finite values: "
                         f"{where}")
    m = mode.reshape(-1, 1, 1)
    diff = (out.float() - want.float()).abs()
    clean = (m == 0).expand_as(w)
    if not torch.equal(out[clean], w[clean]):
        raise SystemExit(f"uniq_noise_fwd_onchip CLEAN is not the identity: "
                         f"{where}")
    frozen = (m == 2).expand_as(w)
    flips = int((out[frozen] != want[frozen]).sum().item())
    noisy = (m == 1).expand_as(w)
    noise_sigma = 0.0
    if noisy.any():
        rel = diff / sigma
        if dtype == torch.bfloat16:
            ulp = want.float().abs() * 2.0 ** -8
            rel = (diff - ulp).clamp_min(0.0) / sigma
        noise_sigma = rel[noisy].max().item()
        if noise_sigma > TOL_UNIQ_NOISE_SIGMA:
            raise SystemExit(f"uniq_noise_fwd_onchip NOISE disagrees with its "
                             f"plain version by {noise_sigma:.3e} sigma > "
                             f"{TOL_UNIQ_NOISE_SIGMA}: {where}")
        if dtype == torch.float32:
            # every NOISE output lies within half a bin of its weight in u
            u_w = kref.phi((w.float() - mu) / sigma)
            u_o = kref.phi((out.float() - mu) / sigma)
            du = (u_o - u_w).abs()[noisy].max().item()
            if du > 0.5 / k + TOL_ONCHIP_BIN_U:
                raise SystemExit(f"uniq_noise_fwd_onchip NOISE moved a weight "
                                 f"{du:.3e} in u, beyond half a bin "
                                 f"{0.5 / k}: {where}")
            del u_w, u_o, du
    res = dict(fwd_err=diff.max().item(), flips=flips,
               n_frozen=int(frozen.sum().item()), noise_sigma=noise_sigma)
    del w, mu, sigma, mode, out, again, host, want, diff, clean, frozen, noisy
    return res


# --------------------------------------------------------------------------
# Phase 4/5: the engine at full width
# --------------------------------------------------------------------------

def make_stream(cfg, seed: int, new_tokens: int):
    """Two waves of greedy requests (one sampled) over a shared prefix.
    Wave 2 repeats wave 1's first prompt twice (prefix-cache hits whose
    partial tail page must be copied on write) and extends the shared
    prefix twice more."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, cfg.vocab, size=100).astype(np.int32)

    def prompt(n_tail):
        tail = rng.integers(0, cfg.vocab, size=n_tail).astype(np.int32)
        return np.concatenate([prefix, tail])

    tails = [100, 28, 412, 164, 300, 64, 230, 350]
    wave1 = [prompt(n) for n in tails]
    wave1[5] = rng.integers(0, cfg.vocab, size=64).astype(np.int32)
    wave2 = [wave1[0].copy(), wave1[0].copy(), prompt(90), prompt(200)]

    def req(uid, p):
        return Request(uid=uid, prompt=p, sampling=SamplingParams(
            temperature=0.8 if uid == 3 else 0.0, top_k=50 if uid == 3 else 0,
            max_new_tokens=new_tokens, seed=1000 + uid))

    return ([req(i, p) for i, p in enumerate(wave1)],
            [req(len(wave1) + i, p) for i, p in enumerate(wave2)])


def run_stream(params, cfg, opts, seed: int, new_tokens: int,
               a_bits: int = 32, ec=None):
    """The stream of ``make_stream`` through one engine (phase 4's kv8
    pool with the prefix cache unless ``ec`` says otherwise)."""
    ec = ec or EngineConfig(max_slots=16, max_len=2048, prefill_batch=4,
                            page_size=64, kv_bits=8, prefix_cache=True,
                            a_bits=a_bits)
    eng = Engine(params, cfg, opts, ec, device=DEV)
    wave1, wave2 = make_stream(cfg, seed, new_tokens)
    outs = []
    t0 = time.perf_counter()
    for r in wave1:
        eng.submit(r)
    # wave 2 arrives once wave 1's prompts are registered with the cache
    while eng.has_work and (eng._prefilling or not eng._slots):
        outs.extend(eng.step())
    for r in wave2:
        eng.submit(r)
    while eng.has_work:
        outs.extend(eng.step())
    sync()
    wall = time.perf_counter() - t0
    outs.sort(key=lambda o: o.uid)
    return eng, outs, wall, len(wave1) + len(wave2)


# The engine's serving modes, each run at full width in its own engine: the
# weights' levels, the activation bits, and the matmul kernel that carries
# every layer projection (7 per layer: wq, wk, wv, wo, w_gate, w_up,
# w_down).  The LM head (49155 columns cannot be int4-packed) stays dense.
ENGINE_MODES = (
    dict(name="W4 + kv8", w_dist="gaussian", a_bits=32, matmul="qmatmul"),
    dict(name="W4A8 + kv8", w_dist="gaussian", a_bits=8,
         matmul="qmatmul_a8"),
    dict(name="W4 empirical + kv8", w_dist="empirical", a_bits=32,
         matmul="qmatmul_lut"),
)
MATMULS = ("qmatmul", "qmatmul_a8", "qmatmul_lut")
CODECS = ("kquantile_quantize", "kquantile_dequantize",
          "kquantile_dequantize_paged", "kv_append")


def engine_phase(cfg, seed: int, new_tokens: int, mode: dict,
                 art_dir=None):
    say(f"[engine] {mode['name']}: granite_3_8b at full width, depth "
        f"{cfg.n_layers} layers (d_model {cfg.d_model}, {cfg.n_heads} heads, "
        f"{cfg.n_kv_heads} KV heads, head_dim {cfg.head_dim}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab}), w_dist {mode['w_dist']}, a_bits "
        f"{mode['a_bits']}, bf16")
    t0 = time.perf_counter()
    kops.reset_launch_counts()
    params = model.init(seed, cfg, device=DEV, w_bits=4,
                        dense_dtype=torch.bfloat16, w_dist=mode["w_dist"])
    sync()
    load = kops.launch_counts()
    say(f"[engine] weights drawn and coded layer by layer on the card in "
        f"{time.perf_counter() - t0:.1f}s "
        f"({load['kquantile_quantize']} kquantile_quantize launches); "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    opts = lm.ModelOpts(compute_dtype=torch.bfloat16)

    # warm-up outside the counted run (first launches, allocator)
    warm = Engine(params, cfg, opts, EngineConfig(
        max_slots=16, max_len=2048, page_size=64, kv_bits=8,
        prefix_cache=True, a_bits=mode["a_bits"]), device=DEV)
    warm.generate([Request(uid=-1, prompt=np.arange(70, dtype=np.int32),
                           sampling=SamplingParams(max_new_tokens=2))])
    del warm
    sync()

    kops.reset_launch_counts()
    eng, outs, wall, n_req = run_stream(params, cfg, opts, seed, new_tokens,
                                        mode["a_bits"])
    counts = kops.launch_counts()

    if len(outs) != n_req:
        raise SystemExit(f"lost requests: {n_req} submitted, {len(outs)} "
                         f"completed")
    for o in outs:
        if o.finish_reason != "length" or len(o.token_ids) != new_tokens:
            raise SystemExit(f"request {o.uid} did not complete: "
                             f"{o.finish_reason}, {len(o.token_ids)} tokens")
        if not all(0 <= t < cfg.vocab for t in o.token_ids):
            raise SystemExit(f"request {o.uid} produced tokens outside the "
                             f"vocabulary")
    st = eng.stats()
    steps, calls = eng.n_decode_steps, eng.n_prefill_calls
    L = cfg.n_layers
    want_mm = 7 * L * (steps + calls)
    want_att = L * steps
    want_app = L * (steps + calls)
    want_read = 2 * L * calls
    say(f"[engine] {n_req} requests completed; {steps} decode steps, "
        f"{calls} prefill-chunk calls; cache hits {st['cache_hits']}, "
        f"hit pages {st['cache_hit_pages']}, copy-on-writes "
        f"{st['cow_copies']}, preemptions {st['preemptions']}")
    say(f"[engine] kernel launches on this run: {mode['matmul']} "
        f"{counts[mode['matmul']]} (7 x {L} layers x {steps + calls} calls = "
        f"{want_mm}; {want_mm // (steps + calls)} per forward call), "
        f"paged_quant_attention {counts['paged_quant_attention']} ({L} "
        f"layers x {steps} decode steps = {want_att}), kv_append "
        f"{counts['kv_append']} ({L} layers x {steps + calls} calls = "
        f"{want_app}), kquantile_dequantize_paged "
        f"{counts['kquantile_dequantize_paged']} (K and V x {L} layers x "
        f"{calls} chunk calls = {want_read}), kquantile_quantize "
        f"{counts['kquantile_quantize']}, kquantile_dequantize "
        f"{counts['kquantile_dequantize']} (the embedding rows); other "
        f"matmul kernels " + ", ".join(
            f"{m} {counts[m]}" for m in MATMULS if m != mode["matmul"]))
    # the Gaussian engines decode their embedding rows through the dense
    # dequantize kernel; the empirical engine's codebook rows are a gather
    gaussian = mode["w_dist"] == "gaussian"
    if counts[mode["matmul"]] != want_mm \
            or counts["paged_quant_attention"] != want_att \
            or counts["kv_append"] != want_app \
            or counts["kquantile_dequantize_paged"] != want_read \
            or min(want_mm, want_att, want_read) <= 0 \
            or any(counts[m] for m in MATMULS if m != mode["matmul"]) \
            or counts["kquantile_quantize"] \
            or (counts["kquantile_dequantize"] > 0) != gaussian:
        raise SystemExit("the main path did not go through the kernels as "
                         "expected")
    # the weights' coding at load is the quantize kernel's part of the path
    # (the empirical engine codes its codebooks without it)
    if gaussian and load["kquantile_quantize"] <= 0:
        raise SystemExit("coding the weights at load launched no "
                         "kquantile_quantize")
    counts["kquantile_quantize"] = load["kquantile_quantize"]
    if st["cache_hits"] < 1 or st["cow_copies"] < 1:
        raise SystemExit("the stream was built to hit the prefix cache and "
                         "copy on write, and did not")
    new = sum(len(o.token_ids) for o in outs)
    reg = eng.telemetry.registry
    ttft = tele_lib.percentile_summary(reg["ttft_s"], scale=1e3)
    itl = tele_lib.percentile_summary(reg["itl_s"], scale=1e3)
    say(f"[engine] {mode['name']}: {new} new tokens in {wall:.2f}s -> "
        f"{new / wall:.1f} tok/s; TTFT p50 {ttft['p50']:.0f} ms p95 "
        f"{ttft['p95']:.0f} ms; ITL p50 {itl['p50']:.1f} ms p95 "
        f"{itl['p95']:.1f} ms")
    if art_dir:
        write_artifacts(eng, art_dir, "phase4", {
            "w_bits": 4, "a_bits": mode["a_bits"], "dist": mode["w_dist"],
            "smoke": False})
    if mode["matmul"] == "qmatmul":
        check_head_logits(params, cfg, opts)
    return params, opts, outs, counts


def plain_phase(params, cfg, opts, outs, seed: int, new_tokens: int,
                mode: dict):
    """Prefill + one decode step, kernels vs plain versions forced; then the
    whole stream again with the kernels and with the plain versions.  Every
    argmax that differs must be a near-tie (``check_near_tie``)."""
    a_bits = mode["a_bits"]
    plain = lm.ModelOpts(compute_dtype=opts.compute_dtype,
                         use_kernels=False)
    rng = np.random.default_rng(seed + 1)
    B, S, page = 4, 192, 64
    toks = torch.tensor(rng.integers(0, cfg.vocab, size=(B, S)), device=DEV)
    n_pages = S // page + 1
    tables = torch.arange(1, 1 + B * n_pages, device=DEV,
                          dtype=torch.int32).reshape(B, n_pages)
    res = {}
    for name, o in (("kernels", lm.ModelOpts(compute_dtype=opts.compute_dtype,
                                             kv_bits=8, serve_a_bits=a_bits)),
                    ("plain", lm.ModelOpts(compute_dtype=opts.compute_dtype,
                                           kv_bits=8, serve_a_bits=a_bits,
                                           use_kernels=False))):
        before = kops.launch_counts()
        logits_p, kv = model.prefill(params, cfg, o, {"tokens": toks})
        cache = model.init_paged_cache(cfg, 1 + B * n_pages, page,
                                       torch.bfloat16, kv_bits=8, device=DEV)
        model.cache_insert_paged(cache, kv, tables[:, :S // page])
        nxt = logits_p.argmax(-1) if name == "kernels" else res["next"]
        res.setdefault("next", nxt)
        pos = torch.full((B,), S, device=DEV)
        logits_d, _ = model.decode(params, cfg, o, cache, nxt[:, None], pos,
                                   block_tables=tables)
        sync()
        if name == "plain" and kops.launch_counts() != before:
            raise SystemExit("use_kernels=False launched a kernel")
        res[name] = (logits_p.float(), logits_d.float())
        del cache, kv
    for i, what in enumerate(("prefill", "decode")):
        k, p = res["kernels"][i], res["plain"][i]
        if k.shape != (B, cfg.vocab) or not torch.isfinite(k).all():
            raise SystemExit(f"{what} logits: wrong shape or not finite")
        err = (k - p).abs().max().item()
        tol = TOL_LOGITS_REL * p.abs().max().item()
        agree = (k.argmax(-1) == p.argmax(-1)).float().mean().item()
        say(f"[plain] {mode['name']} {what} last-position logits, kernels "
            f"vs plain versions: max abs err {err:.4f} (tolerance {tol:.4f} "
            f"= {TOL_LOGITS_REL} x max |logit|), argmax agreement "
            f"{agree * 100:.0f}%")
        if err > tol:
            raise SystemExit(f"{what} logits disagree with the plain "
                             f"versions")
        for r in (k.argmax(-1) != p.argmax(-1)).nonzero().flatten().tolist():
            check_near_tie(f"{mode['name']} {what} row {r}", k[r], p[r], err)
    # the same stream with the kernels again and with the plain versions
    # forced, each greedy request's logits recorded: greedy agreement, and
    # every request's first differing token a near-tie
    rows_k, rows_p = {}, {}
    with recording_logits(rows_k):
        _, outs_k, _, _ = run_stream(params, cfg, opts, seed, new_tokens,
                                     a_bits)
    if [o.token_ids for o in outs_k] != [o.token_ids for o in outs]:
        raise SystemExit("the same stream through the kernels twice gave "
                         "different tokens")
    before = kops.launch_counts()
    with recording_logits(rows_p):
        _, outs_p, wall, _ = run_stream(params, cfg, plain, seed, new_tokens,
                                        a_bits)
    if kops.launch_counts() != before:
        raise SystemExit("use_kernels=False launched a kernel")
    same = tot = first = 0
    flips, err, big = [], 0.0, 0.0
    for a, b in zip(outs_k, outs_p):
        if a.uid == 3:
            continue                    # the sampled request
        first += a.token_ids[0] == b.token_ids[0]
        same += sum(x == y for x, y in zip(a.token_ids, b.token_ids))
        tot += len(a.token_ids)
        # rows with the same history on both sides: up to the first
        # differing token; a token j is chosen at position len(prompt)-1+j
        diff = [j for j, (x, y) in enumerate(zip(a.token_ids, b.token_ids))
                if x != y]
        last = diff[0] if diff else len(a.token_ids) - 1
        for j in range(last + 1):
            key = (1000 + a.uid, len(a.prompt) - 1 + j)
            if key not in rows_k or key not in rows_p:
                raise SystemExit(f"no logits recorded for request {a.uid} "
                                 f"token {j}")
            err = max(err, (rows_k[key] - rows_p[key]).abs().max().item())
            big = max(big, rows_p[key].abs().max().item())
        if diff:
            flips.append((a.uid, diff[0], key))
    say(f"[plain] stream replayed with the plain versions in {wall:.1f}s: "
        f"greedy tokens agree {same}/{tot} ({100 * same / tot:.1f}%), first "
        f"tokens {first}/{len(outs) - 1} (random weights: near-ties flip a "
        f"stream and it then stays apart); max abs logit err kernels vs "
        f"plain up to each request's first differing token {err:.4f} "
        f"(tolerance {TOL_LOGITS_REL * big:.4f} = {TOL_LOGITS_REL} x max "
        f"|logit|)")
    # the near-tie limit below is this error: hold it to the tolerance first
    if err > TOL_LOGITS_REL * big:
        raise SystemExit("replayed stream's logits disagree with the plain "
                         "versions")
    for uid, j, key in flips:
        check_near_tie(f"{mode['name']} stream request {uid} token {j}",
                       rows_k[key], rows_p[key], err)


@contextlib.contextmanager
def recording_logits(store):
    """Records the logits row of every greedy request at every sampling
    (prefill, chunk and decode steps) into ``store`` by (request seed,
    position), by wrapping the engine's sampler."""
    orig = engine_lib._sample_batch

    def sample(logits, temps, top_ks, seeds, positions):
        for i, (sd, pos) in enumerate(zip(seeds, positions)):
            if sd >= 1000 and temps[i] == 0.0:
                store[(int(sd), int(pos))] = logits[i].float().clone()
        return orig(logits, temps, top_ks, seeds, positions)

    engine_lib._sample_batch = sample
    try:
        yield
    finally:
        engine_lib._sample_batch = orig


def check_near_tie(where, k_row, p_row, err, names=("kernels", "plain")):
    """A greedy flip between kernels and plain versions (or the two sides
    ``names``) must be a near-tie: the plain (second) logits' top-2 margin
    at most the phase's measured max abs logit error between the sides (a
    flip needs margin <= 2 x that row's error, so a margin above it would
    mean more than rounding)."""
    top = p_row.topk(2).values
    margin = (top[0] - top[1]).item()
    a, b = names
    say(f"[near-tie] argmax flip at {where}: {a} {k_row.argmax().item()}, "
        f"{b} {p_row.argmax().item()}; {b} top-2 margin {margin:.4f}, this "
        f"row's max abs err {(k_row - p_row).abs().max().item():.4f}, the "
        f"phase's {err:.4f}")
    if margin > err:
        raise SystemExit(f"argmax flip at {where} is not a near-tie: margin "
                         f"{margin:.4f} > max abs logit err {err:.4f}")


def small_reference_phase(seed: int):
    """Tiny f32 model: card (kernels) vs CPU (plain versions)."""
    for arch in ("granite_3_8b", "gemma2_9b"):
        cfg = cb.get_smoke(arch)
        p_cpu = model.init(seed, cfg, device="cpu", w_bits=4)
        p_gpu = lm.quantize_params_for_serving(p_cpu, 4, device=DEV)
        opts = lm.ModelOpts(compute_dtype=torch.float32, kv_bits=8)
        toks = torch.tensor(np.random.default_rng(seed).integers(
            0, cfg.vocab, size=(2, 16)))
        tables = torch.tensor([[1, 2, 3], [4, 5, 6]], dtype=torch.int32)
        res = []
        for params, dev in ((p_cpu, "cpu"), (p_gpu, DEV)):
            lg, kv = model.prefill(params, cfg, opts,
                                   {"tokens": toks.to(dev)})
            cache = model.init_paged_cache(cfg, 7, 8, torch.float32,
                                           kv_bits=8, device=dev)
            model.cache_insert_paged(cache, kv, tables[:, :2].to(dev))
            ld, _ = model.decode(params, cfg, opts, cache,
                                 toks[:, :1].to(dev),
                                 torch.tensor([16, 16], device=dev),
                                 block_tables=tables.to(dev))
            res.append((lg.cpu(), ld.cpu()))
        for i, what in enumerate(("prefill", "decode")):
            err = (res[0][i] - res[1][i]).abs().max().item()
            say(f"[small] {cfg.name} f32 {what} logits, card vs CPU: max "
                f"abs err {err:.2e} (tolerance {TOL_SMALL_F32})")
            if err > TOL_SMALL_F32:
                raise SystemExit(f"{cfg.name} {what}: card disagrees with "
                                 f"the CPU reference")


def check_head_logits(params, cfg, opts):
    """The dense bf16 LM head (49155 columns cannot be int4-packed, so it
    stays dense) gives f32 logits: bf16 x bf16 products summed in f32, not
    rounded to bf16 afterwards."""
    g = torch.Generator(device=DEV)
    g.manual_seed(7)
    x = torch.randn((16, cfg.d_model), generator=g,
                    device=DEV).to(torch.bfloat16)
    logits = lm._logits(x, params, cfg, opts)
    w = params["lm_head"]
    if lm.is_qweight(w) or w.dtype != torch.bfloat16:
        raise SystemExit("the full-width LM head was expected dense bf16")
    want = x.float() @ w.float()
    sync()
    err = (logits - want).abs().max().item()
    rounding = (want.to(torch.bfloat16).float() - want).abs().max().item()
    tol = TOL_HEAD_F32_REL * want.abs().max().item()
    say(f"[engine] LM head logits {tuple(logits.shape)} {logits.dtype}: max "
        f"abs err vs f32 products {err:.2e} (tolerance {tol:.2e}); a bf16 "
        f"rounding of them would be {rounding:.2e} off")
    if logits.dtype != torch.float32 or err > tol:
        raise SystemExit("the LM head's logits are not the f32 sums")


# --------------------------------------------------------------------------
# Phase 4L: long context (chunked attention from 8,192 rows)
# --------------------------------------------------------------------------

# prompt lengths: the engine pads each to its power-of-two bucket, 8,192,
# 16,384 and 32,768 rows (prefill_32k's length, at batch 1); every
# admission is one whole-prompt forward_prefill, chunked from
# ModelOpts.attn_chunked_min_len (8,192) on in KV chunks of kv_chunk (1,024)
LONG_PROMPTS = (8192, 16000, 32000)
LONG_PAGE = 64
# a 32,768-row bucket and the new tokens in whole pages: 513 pages a slot
LONG_MAX_LEN = 32768 + LONG_PAGE
# chunked against whole attention at 8,192 rows, bf16 serving: the whole
# path rounds its softmax probabilities to bf16 before P.V, the chunked one
# keeps them f32 to the end (the reference's math on both sides); that
# rounding through the stack moves the last logits as the kernels-vs-plain
# rounding does, so the same limit applies (of the largest logit)
TOL_CHUNKED_LOGITS_REL = TOL_LOGITS_REL
# the K/V past the first attention (whose own K/V precede any attention and
# must be bit-equal): their inputs carry that rounding too, so their codes
# move by whole bins wherever it moves a value (kv8 bins are ~0.01 sigma
# wide near the mean, ~0.35 sigma at the tails); held by value instead,
# dequantized, as a layer's ||diff|| / ||value|| (a tail bin's flip alone
# would be ~12 % of the largest |value|), to the logits' limit
TOL_CHUNKED_KV_REL = TOL_LOGITS_REL
# the layer after the first attention: its K/V differ by one attention's
# bf16 rounding of the probabilities (2.5e-3 of the attention's output by
# norm on random inputs of gemma2's shape) carried through one layer, and
# by the kv8 codes that moves across bin edges (1.1-1.2 % by norm at the
# smoke configs)
TOL_CHUNKED_KV1_REL = 0.03
# f32 with the plain versions: the two paths sum the same f32 terms in
# another order (3.5e-7 of one attention's output by norm); the stack may
# amplify that a hundredfold and stay far below this
TOL_CHUNKED_F32_REL = 1e-3
# training at 8,192 rows, f32: chunked vs whole attention on the same
# noise; the online softmax sums the same terms in another order
TOL_LONG_TRAIN_LOSS_REL = 1e-5
TOL_LONG_TRAIN_GRAD_REL = 1e-4
LONG_TRAIN_LAYERS = 2
LONG_TRAIN_ROWS = 8192


def long_reckoning(cfg, S, kv_chunk, pool_bytes):
    """The memory the chunked path should need at S rows, B = 1 (GB): one
    chunk's f32 scores (and as much again for its exponentials), the f32
    accumulator, the whole path's scores at 8,192 rows, the pool."""
    H, D = cfg.n_heads, cfg.head_dim
    return {"chunk_scores": H * S * kv_chunk * 4 / 1e9,
            "accumulator": H * S * D * 4 / 1e9,
            "whole_scores_8192": H * 8192 * 8192 * 4 / 1e9,
            "pool": pool_bytes / 1e9}


def long_requests(cfg, seed: int, new_tokens: int):
    rng = np.random.default_rng(seed + 40)
    return [Request(uid=i, prompt=rng.integers(0, cfg.vocab, size=n).astype(
        np.int32), sampling=SamplingParams(max_new_tokens=new_tokens,
                                           seed=2000 + i))
            for i, n in enumerate(LONG_PROMPTS)]


def long_engine(params, cfg, opts):
    """The long-context engine: prefix cache off (admission is the whole
    prompt's forward_prefill), one prompt a prefill, a slot per request."""
    return Engine(params, cfg, opts, EngineConfig(
        max_slots=len(LONG_PROMPTS), max_len=LONG_MAX_LEN, prefill_batch=1,
        page_size=LONG_PAGE, kv_bits=8, prefix_cache=False), device=DEV)


def long_context_phase(params, cfg, seed: int, new_tokens: int,
                       art_dir: str):
    """Phase 4L on phase 4's coded granite weights: the three long prompts
    through the engine with every launch counted, TTFT / ITL / peak memory
    beside the reckoning, a decode step profiled, the 16,000-token request
    against the plain versions (with a wrong-code control), the engine's
    artifacts through traceview, then chunked against whole attention at
    8,192 rows.  Returns the launch counts of the counted run."""
    t_phase = time.perf_counter()
    opts = lm.ModelOpts(compute_dtype=torch.bfloat16)
    L = cfg.n_layers
    say(f"[long] granite_3_8b at full width, {L} layers, W4 + kv8, bf16, "
        f"the library's default ModelOpts (chunked attention from "
        f"{opts.attn_chunked_min_len} rows, kv_chunk {opts.kv_chunk}); "
        f"prompts {LONG_PROMPTS} tokens, {new_tokens} greedy new tokens "
        f"each; max_len {LONG_MAX_LEN} ({LONG_MAX_LEN // LONG_PAGE} pages "
        f"of {LONG_PAGE}), prefix cache off")
    # warm-up outside the counted run (first launches, allocator)
    warm = long_engine(params, cfg, opts)
    warm.generate([Request(uid=-1, prompt=np.arange(70, dtype=np.int32),
                           sampling=SamplingParams(max_new_tokens=2))])
    del warm
    gc.collect()
    torch.cuda.empty_cache()
    eng = long_engine(params, cfg, opts)
    sync()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reqs = long_requests(cfg, seed, new_tokens)
    rows_k = {}
    kops.reset_launch_counts()
    t0 = time.perf_counter()
    with recording_logits(rows_k):
        outs = eng.generate(reqs)
    sync()
    wall = time.perf_counter() - t0
    counts = kops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    steps, calls = eng.n_decode_steps, eng.n_prefill_calls
    for o in outs:
        if o.finish_reason != "length" or len(o.token_ids) != new_tokens \
                or not all(0 <= t < cfg.vocab for t in o.token_ids):
            raise SystemExit(f"long request {o.uid} did not complete: "
                             f"{o.finish_reason}, {len(o.token_ids)} tokens")
    want = {"qmatmul": 7 * L * (steps + calls),
            "paged_quant_attention": L * steps, "kv_append": L * steps,
            "kquantile_quantize": L * calls,
            "kquantile_dequantize": L * calls + steps + calls}
    say(f"[long] {len(outs)} requests, {calls} prefill calls, {steps} decode "
        f"steps in {wall:.1f}s; launches: " + ", ".join(
            f"{k} {counts[k]} (want {v})" for k, v in want.items())
        + f"; the K/V of each prefill coded by kquantile_quantize and read "
        f"back by kquantile_dequantize once a layer, the embedding rows "
        f"by kquantile_dequantize once a call; kv_append and "
        f"paged_quant_attention once a layer a decode step")
    if calls != len(LONG_PROMPTS) or any(
            counts[k] != want.get(k, 0) for k in counts):
        raise SystemExit(f"the long-context path did not go through the "
                         f"kernels as expected: {counts}")
    spans = sorted((s.args["bucket"], s.dur) for s in
                   eng.telemetry.tracer.spans()
                   if s.name == "prefill" and "bucket" in (s.args or {}))
    reg = eng.telemetry.registry
    itl = tele_lib.percentile_summary(reg["itl_s"], scale=1e3)
    pool = eng.page_bytes * eng.scheduler.total_pages
    rk = long_reckoning(cfg, 32768, opts.kv_chunk, pool)
    say("[long] prefill call by bucket (host clock to the first token): "
        + ", ".join(f"{b} rows {d:.2f} s" for b, d in spans)
        + "; TTFT by prompt (arrival to first token, the later prompts "
        "queued behind the earlier prefills): " + ", ".join(
            f"{len(o.prompt)} tokens {o.ttft_s:.2f} s" for o in outs)
        + f"; ITL p50 {itl['p50']:.1f} ms p95 {itl['p95']:.1f} ms over "
        f"{steps} decode steps; {CARD}")
    say(f"[long] memory: {base / 2**30:.2f} GiB allocated before the run "
        f"(the coded weights and the {pool / 1e9:.2f} GB kv8 pool, "
        f"{eng.page_bytes / LONG_PAGE / 1e3:.1f} KB a row), peak "
        f"{peak / 2**30:.2f} GiB, {(peak - base) / 1e9:.2f} GB above it; "
        f"reckoned at 32,768 rows: one chunk's f32 scores "
        f"{rk['chunk_scores']:.2f} GB and as much again for their "
        f"exponentials, the accumulator {rk['accumulator']:.2f} GB (whole "
        f"attention at 8,192 rows would hold {rk['whole_scores_8192']:.2f} "
        f"GB of scores)")
    # one decode step at the three requests' lengths, from the engine's pool
    n_pages = LONG_MAX_LEN // LONG_PAGE
    tables = torch.arange(1, 1 + len(outs) * n_pages, device=DEV,
                          dtype=torch.int32).reshape(len(outs), n_pages)
    pos = torch.tensor([len(o.prompt) + new_tokens - 1 for o in outs],
                       device=DEV)
    toks = torch.tensor([[o.token_ids[-1]] for o in outs], device=DEV)
    o8 = dataclasses.replace(opts, kv_bits=8)
    profile_step(lambda: model.decode(params, cfg, o8, eng._cache, toks, pos,
                                      block_tables=tables),
                 f"one decode step (B={len(outs)}, rows "
                 f"{pos.tolist()}, {(pos // LONG_PAGE + 1).tolist()} pages a "
                 f"sequence, {L} layers)", "long")
    write_artifacts(eng, art_dir, "long", {"w_bits": 4, "a_bits": 32,
                                           "dist": "gaussian",
                                           "smoke": False})
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    long_plain_check(params, cfg, outs, rows_k, new_tokens)
    chunked_vs_whole(params, cfg, "granite_3_8b")
    say(f"[long] phase 4L engine and checks took "
        f"{time.perf_counter() - t_phase:.0f}s")
    return counts


def long_plain_check(params, cfg, outs, rows_k, new_tokens):
    """The 16,000-token request again through an engine with the plain
    versions forced: its greedy tokens equal the kernel run's (a differing
    token must be a near-tie), its logits within TOL_LOGITS_REL of the
    largest; the control: the plain prefill with every coded matmul weight
    one level off lands outside that limit."""
    got = next(o for o in outs if len(o.prompt) == LONG_PROMPTS[1])
    req = Request(uid=got.uid, prompt=got.prompt,
                  sampling=SamplingParams(max_new_tokens=new_tokens,
                                          seed=2000 + got.uid))
    plain = lm.ModelOpts(compute_dtype=torch.bfloat16, use_kernels=False)
    rows_p = {}
    before = kops.launch_counts()
    t0 = time.perf_counter()
    with recording_logits(rows_p):
        (out_p,) = long_engine(params, cfg, plain).generate([req])
    sync()
    wall = time.perf_counter() - t0
    if kops.launch_counts() != before:
        raise SystemExit("use_kernels=False launched a kernel")
    diff = [j for j, (a, b) in enumerate(zip(got.token_ids, out_p.token_ids))
            if a != b]
    last = diff[0] if diff else new_tokens - 1
    err = big = 0.0
    for j in range(last + 1):
        key = (req.sampling.seed, len(req.prompt) - 1 + j)
        err = max(err, (rows_k[key] - rows_p[key]).abs().max().item())
        big = max(big, rows_p[key].abs().max().item())
    tol = TOL_LOGITS_REL * big
    first_key = (req.sampling.seed, len(req.prompt) - 1)
    first_err = (rows_k[first_key] - rows_p[first_key]).abs().max().item()
    say(f"[long] {len(req.prompt)}-token request, kernels vs plain versions "
        f"(plain run {wall:.1f}s): greedy tokens equal "
        f"{new_tokens - len(diff)}/{new_tokens}"
        + (f" (first difference at token {diff[0]})" if diff else "")
        + f"; last-position logits at the prefill max abs err "
        f"{first_err:.4f}, up to the first differing token {err:.4f} "
        f"({err / big * 100:.2f} % of max |logit|; limit {tol:.4f} = "
        f"{TOL_LOGITS_REL} x max |logit|)")
    if err > tol:
        raise SystemExit("the long request's logits disagree with the plain "
                         "versions")
    if diff:
        key = (req.sampling.seed, len(req.prompt) - 1 + diff[0])
        check_near_tie(f"{len(req.prompt)}-token request token {diff[0]}",
                       rows_k[key], rows_p[key], err)
    # the control as the engine ran it: the prompt right-padded to its
    # bucket (16,384 rows; 16,000 is no multiple of kv_chunk, and the
    # single-chunk fallback would hold 33 GB of scores), the last real row
    coded = _coded_matmul_weights(params)
    n = len(req.prompt)
    toks = torch.zeros((1, 1 << (n - 1).bit_length()), dtype=torch.int64,
                       device=DEV)
    toks[0, :n] = torch.from_numpy(req.prompt.astype(np.int64))
    for w in coded:
        w["q_codes"].bitwise_xor_(0x11)
    try:
        wrong, _ = model.prefill(
            params, cfg, dataclasses.replace(plain, kv_bits=8),
            {"tokens": toks}, last_idx=torch.tensor([n - 1], device=DEV))
    finally:
        for w in coded:
            w["q_codes"].bitwise_xor_(0x11)
    wrong_err = (wrong[0].float() - rows_p[first_key]).abs().max().item()
    big0 = rows_p[first_key].abs().max().item()
    say(f"[long] control: the plain prefill of that prompt with all "
        f"{len(coded)} coded matmul leaves one level off moves its logits by "
        f"{wrong_err:.4f} ({wrong_err / big0 * 100:.2f} % of max |logit|; "
        f"the limit {TOL_LOGITS_REL * big0:.4f} must sit below it)")
    if wrong_err <= TOL_LOGITS_REL * big0:
        raise SystemExit("the long request's logit limit cannot see a kernel "
                         "that decodes its codes one level off")


def chunked_vs_whole(params, cfg, arch: str, S: int = 8192,
                     f32: bool = False, gate_end: bool = True):
    """``model.prefill`` of one S-row prompt (B = 1) with chunked attention
    (the library's default ModelOpts) and with whole attention
    (``attn_chunked_min_len`` past S): bf16 with the kernels and the kv8
    codes, or (``f32``) f32 with the plain versions and dense K/V, where
    the two differ by the order of f32 sums alone (a kv8 code that this
    moves across a bin edge would move its key by up to 0.35 sigma).  The first attention's K/V must be bit-equal and the next
    layer's (one attention's rounding apart) within TOL_CHUNKED_KV1_REL;
    with ``gate_end`` the last logits within TOL_CHUNKED_LOGITS_REL (f32:
    TOL_CHUNKED_F32_REL), every layer's K/V as close, the greedy token
    equal or a near-tie.  Prints each layer's K/V distance and both
    peaks."""
    toks = torch.tensor(np.random.default_rng(7).integers(
        0, cfg.vocab, size=(1, S)), device=DEV)
    kv_bits = 8 if cfg.family in ("dense", "moe", "vlm") and not f32 \
        else 16
    chunked = lm.ModelOpts(compute_dtype=torch.float32 if f32
                           else torch.bfloat16, kv_bits=kv_bits,
                           use_kernels=not f32)
    whole = dataclasses.replace(chunked, attn_chunked_min_len=1 << 30)
    res = {}
    for name, o in (("chunked", chunked), ("whole", whole)):
        gc.collect()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        logits, cache = model.prefill(params, cfg, o, {"tokens": toks})
        sync()
        res[name] = (logits[0].float(), cache,
                     (torch.cuda.max_memory_allocated() - base) / 2**30,
                     time.perf_counter() - t0)
    (lc, cc, pc, tc), (lw, cw, pw, tw) = res["chunked"], res["whole"]
    err = (lc - lw).abs().max().item()
    big = lw.abs().max().item()
    tol_rel = TOL_CHUNKED_F32_REL if f32 else TOL_CHUNKED_LOGITS_REL
    kv_tol = TOL_CHUNKED_F32_REL if f32 else TOL_CHUNKED_KV_REL
    coded = kv_bits < 16
    same0 = all(torch.equal(cc[k][0], cw[k][0]) for k in cc)
    n_l = cc["k_codes" if coded else "k"].shape[0]
    by_layer, flips = [], []
    for l in range(n_l):
        rel = 0.0
        for n in ("k", "v"):
            if coded:
                a, b = (kvc.dequantize_kv(c[f"{n}_codes"][l], c[f"{n}_mu"][l],
                                          c[f"{n}_sigma"][l], kv_bits)
                        for c in (cc, cw))
                if l:
                    flips.append((cc[f"{n}_codes"][l] != cw[f"{n}_codes"][l])
                                 .float().mean().item())
            else:
                a, b = cc[n][l].float(), cw[n][l].float()
            rel = max(rel, ((a - b).norm() / b.norm()).item())
            del a, b
        by_layer.append(rel)
    first = ("layer 0's K/V codes and statistics" if coded
             else "the first shared block's K/V" if cfg.family == "hybrid"
             else "layer 0's K/V")
    where = "f32, plain versions" if f32 else "bf16, kernels"
    say(f"[long] {arch} prefill of {S} rows ({where}), chunked vs whole "
        f"attention: last logits max abs err {err:.4f} ({err / big * 100:.2f}"
        f" % of max |logit|; limit {tol_rel * 100:g} %"
        + ("" if gate_end else ", not held here: the f32 run holds the stack")
        + f"), greedy "
        f"{lc.argmax().item()} / {lw.argmax().item()}; {first} bit-equal: "
        f"{same0}; each layer's K/V ||diff|| / ||value|| in %: "
        + " ".join(f"{r * 100:.2g}" for r in by_layer)
        + f" (limit {kv_tol * 100:g} %"
        + ("" if gate_end else f" for all, {TOL_CHUNKED_KV1_REL * 100:g} % "
           f"for the layer after the first attention") + ")"
        + (f"; codes differing in {min(flips) * 100:.2f}-"
           f"{max(flips) * 100:.2f} % a layer past layer 0" if flips else "")
        + f"; {tc:.2f} s / {tw:.2f} s, peak above the weights {pc:.2f} / "
        f"{pw:.2f} GiB; {CARD}")
    ok = same0 and torch.isfinite(lc).all() and (
        by_layer[min(1, n_l - 1)] <= TOL_CHUNKED_KV1_REL if not f32 else True)
    if gate_end:
        ok = ok and err <= tol_rel * big and max(by_layer) <= kv_tol
    if not ok:
        raise SystemExit(f"{arch}: chunked and whole attention disagree")
    if gate_end and lc.argmax() != lw.argmax():
        check_near_tie(f"{arch} {S}-row prefill", lc, lw, err,
                       ("chunked", "whole"))
    del res, cc, cw


def long_family_checks(seed: int):
    """Chunked against whole attention at 8,192 rows in gemma2_9b (its
    4,096-row sliding window crosses chunk edges, its logit cap of 50 acts
    inside each chunk) and in zamba2_2_7b's shared block, each at full
    width and depth, W4, drawn and coded on the card, freed before the
    next.  gemma2's random-weight stack carries a difference of its first
    layers on and grows it layer by layer (PR 28's run: its K/V 1.2 % apart
    after the first attention, 24 % after 42 layers, the last logits 23.6
    % of the largest, from the whole path's bf16 probabilities and the kv8
    codes they move), so its bf16 run holds the first attention's
    consequences and an f32 run with dense K/V (the plain versions) holds
    the whole stack."""
    for arch in ("gemma2_9b", "zamba2_2_7b"):
        cfg = cb.get(arch)
        t0 = time.perf_counter()
        params = model.init(seed, cfg, device=DEV, w_bits=4,
                            dense_dtype=torch.bfloat16)
        sync()
        say(f"[long] {arch} at full width and depth ({cfg.n_layers} layers, "
            f"d_model {cfg.d_model}, {cfg.n_heads} heads, window "
            f"{cfg.sliding_window}, logit cap {cfg.attn_logit_cap}) drawn "
            f"and coded W4 in {time.perf_counter() - t0:.1f}s")
        if arch == "gemma2_9b":
            chunked_vs_whole(params, cfg, arch, gate_end=False)
            chunked_vs_whole(params, cfg, arch, f32=True)
        else:
            chunked_vs_whole(params, cfg, arch)
        del params
        gc.collect()
        torch.cuda.empty_cache()


def long_train_check(seed: int):
    """granite_3_8b at full width, LONG_TRAIN_LAYERS layers, f32, batch 1 x
    8,192, AdamW, W4, every layer NOISE, the library's default ModelOpts
    (chunked attention from 8,192 rows, each layer recomputed in the
    backward; the trainer CLI, as the reference's, never chunks): one
    step's loss and gradients with chunked attention and with whole
    attention on the same noise (within TOL_LONG_TRAIN_*), each side's
    uniq_noise launches exact, both peaks; then the chunked step through
    the trainer (AdamW), counted.  Returns the launch counts."""
    cfg, _, tc, data = train_setup(
        LONG_TRAIN_LAYERS, 1, seed,
        extra=["--batch", "1", "--seq-len", str(LONG_TRAIN_ROWS),
               "--n-blocks", "1"])
    opts = lm.ModelOpts(compute_dtype=torch.float32)
    state = train_steps.init_state(seed, cfg, tc, device=DEV)
    batch = train_cli.train_batch(cfg, data, 0, DEV)
    modes = torch.full((cfg.n_layers,), NOISE, dtype=torch.int32)
    whole = dataclasses.replace(opts, attn_chunked_min_len=1 << 30)
    total = {"uniq_noise_fwd": 0, "uniq_noise_bwd": 0}
    launches = {}

    def side(name, o):
        def fn():
            kops.reset_launch_counts()
            out = train_steps.loss_and_grads(
                state["params"], batch, modes, leaf_noise(seed, 0), cfg, o,
                tc)
            sync()
            c = kops.launch_counts()
            launches[name] = (c["uniq_noise_fwd"], c["uniq_noise_bwd"])
            for k in total:
                total[k] += c[k]
            return out
        return fn

    t0 = time.perf_counter()
    la, lb, worst, path, peaks = compare_loss_grads(
        state, (("chunked", side("chunked", opts)),
                ("whole", side("whole", whole))))
    loss_rel = abs(la - lb) / abs(lb)
    say(f"[long] training step, granite_3_8b full width, {cfg.n_layers} "
        f"layers, f32, batch {data.global_batch} x {data.seq_len}, W4 all "
        f"NOISE, chunked vs whole attention on the same noise: loss "
        f"{la:.6f} vs {lb:.6f} (rel {loss_rel:.1e}, limit "
        f"{TOL_LONG_TRAIN_LOSS_REL}); worst gradient leaf ({path}) max "
        f"|diff| / max |grad| {worst:.1e} (limit {TOL_LONG_TRAIN_GRAD_REL}); "
        f"uniq_noise_fwd / _bwd launches {launches} (want "
        f"{TRAIN_LEAVES} / {TRAIN_LEAVES} each); peak {peaks['chunked']:.2f}"
        f" / {peaks['whole']:.2f} GiB ({time.perf_counter() - t0:.1f}s)")
    if loss_rel > TOL_LONG_TRAIN_LOSS_REL or worst > TOL_LONG_TRAIN_GRAD_REL \
            or not math.isfinite(la) or any(
                v != (TRAIN_LEAVES, TRAIN_LEAVES) for v in launches.values()):
        raise SystemExit("training at 8,192 rows: chunked and whole "
                         "attention disagree")
    step_fn, _ = train_steps.make_train_step(cfg, opts, tc)
    kops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, m = step_fn(state, batch, seed)
    sync()
    c = kops.launch_counts()
    say(f"[long] one AdamW train step at {data.seq_len} rows, chunked: loss "
        f"{m['loss'].item():.6f}, {time.perf_counter() - t0:.2f}s, peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, uniq_noise "
        f"launches {c['uniq_noise_fwd']} / {c['uniq_noise_bwd']}; {CARD}")
    if (c["uniq_noise_fwd"], c["uniq_noise_bwd"]) != (TRAIN_LEAVES,
                                                     TRAIN_LEAVES) \
            or not _all_finite(state["params"]):
        raise SystemExit("the chunked train step went wrong")
    for k in total:
        total[k] += c[k]
    del state
    gc.collect()
    torch.cuda.empty_cache()
    return total


def empirical_train_check(seed: int):
    """One step of granite_3_8b at full width, 2 layers, f32, every block
    NOISE, ``UniqConfig(dist="empirical", per_channel=False)``: the stacked
    layer weights stay Gaussian (7 ``uniq_noise_fwd`` and 7 ``_bwd``), the
    embedding and the head go empirical (no kernel: a searchsorted CDF),
    so their loss gradient is zero and the step moves them by weight decay
    alone; the loss finite.  Returns the launch counts."""
    cfg, opts, tc, data = train_setup(2, 1, seed, extra=["--n-blocks", "1"])
    tc = dataclasses.replace(tc, uniq=dataclasses.replace(
        tc.uniq, dist="empirical", per_channel=False))
    state = train_steps.init_state(seed, cfg, tc, device=DEV)
    batch = train_cli.train_batch(cfg, data, 0, DEV)
    modes = torch.full((cfg.n_layers,), NOISE, dtype=torch.int32)
    kops.reset_launch_counts()
    loss, grads = train_steps.loss_and_grads(
        state["params"], batch, modes, leaf_noise(seed, 0), cfg, opts, tc)
    sync()
    c1 = kops.launch_counts()
    zero = {p: float(grads[p].abs().max()) for p in ("embed", "lm_head")}
    layer = float(_at(grads, "layers/wq").abs().max())
    del grads
    probes = {p: state["params"][p].clone() for p in ("embed", "lm_head")}
    step_fn, _ = train_steps.make_train_step(cfg, opts, tc)
    kops.reset_launch_counts()
    state, m = step_fn(state, batch, seed)
    sync()
    c2 = kops.launch_counts()
    lr, wd = float(m["lr"]), tc.optim.weight_decay
    beyond = {p: float((state["params"][p] - (o - lr * wd * o)).abs().max())
              for p, o in probes.items()}
    moved = {p: float((state["params"][p] - o).abs().max())
             for p, o in probes.items()}
    want = TRAIN_LEAVES - 2
    say(f"[train] empirical step: granite_3_8b full width, {cfg.n_layers} "
        f"layers, f32, batch {data.global_batch} x {data.seq_len}, every "
        f"block NOISE, dist empirical, per-tensor statistics: loss "
        f"{loss.item():.6f}; uniq_noise_fwd / _bwd launches "
        f"{c1['uniq_noise_fwd']} / {c1['uniq_noise_bwd']} (gradient), {c2['uniq_noise_fwd']} / "
        f"{c2['uniq_noise_bwd']} (the step; want {want} / {want} each: the "
        f"stacked layer weights); max |loss gradient| embedding "
        f"{zero['embed']:.1e}, head {zero['lm_head']:.1e} (want 0), a layer "
        f"weight's {layer:.1e}; the step moved them by "
        f"{moved['embed']:.2e} / {moved['lm_head']:.2e}, of which beyond "
        f"weight decay {beyond['embed']:.1e} / {beyond['lm_head']:.1e}")
    if not math.isfinite(loss.item()) or any(zero.values()) \
            or layer <= 0.0 or any(
                (c["uniq_noise_fwd"], c["uniq_noise_bwd"]) != (want, want)
                for c in (c1, c2)) \
            or any(v > 1e-6 * float(probes[p].abs().max())
                   for p, v in beyond.items()):
        raise SystemExit("the empirical train step went wrong")
    del state, probes
    gc.collect()
    torch.cuda.empty_cache()
    return {k: c1[k] + c2[k] for k in ("uniq_noise_fwd", "uniq_noise_bwd")}


def write_artifacts(eng, art_dir: str, tag: str, meta: dict):
    """The engine's metrics snapshot and Chrome trace as the serving CLI's
    --metrics-out / --trace-out write them, then traceview over both: no
    problem allowed; its attribution printed."""
    m = os.path.join(art_dir, f"{tag}_metrics.json")
    t = os.path.join(art_dir, f"{tag}_trace.json")
    with open(m, "w") as fh:
        json.dump(eng.metrics_snapshot(meta), fh, indent=2, sort_keys=True)
    with open(t, "w") as fh:
        json.dump(eng.chrome_trace(), fh)
    with open(m) as fm, open(t) as ft:
        metrics, trace = json.load(fm), json.load(ft)
    problems = traceview.validate_chrome_trace(trace) + \
        traceview.require_nonzero(metrics, TRACEVIEW_NONZERO)
    att = traceview.attribution(metrics)
    s = traceview.trace_summary(trace)
    say(f"[traceview] {tag}: {s['spans']} spans, {s['instants']} instants, "
        f"{s['lanes']} lanes, {s['dropped']} dropped; problems: "
        f"{problems or 'none'}")
    for line in traceview.format_attribution(att).splitlines():
        say(f"[traceview] {tag} {line}")
    if problems:
        raise SystemExit(f"traceview found problems in the {tag} engine's "
                         f"artifacts")


TRACEVIEW_NONZERO = ["decode_steps", "tokens_decoded", "prefill_tokens",
                     "ttft_s", "itl_s", "e2e_latency_s"]


# --------------------------------------------------------------------------
# Phase 4M: the analysis subsystem on the card
# --------------------------------------------------------------------------

ROOT = os.path.dirname(os.path.abspath(__file__))
MC_CORPUS = os.path.join(ROOT, "tests", "data", "mc_corpus")
MC_HEALTHY_REQUESTS = 2
# new tokens a request of the kv8 healthy replay: its decode steps cross a
# page boundary at pages of 4 (6-token prompts, 11 positions)
MC_KV8_NEW_TOKENS = 6
# the port's examples, each run as a user would (a subprocess), on the card;
# the CNN trainer at fewer steps than its default 400
EXAMPLES = (("quickstart_torch.py", ()),
            ("serve_quantized_lm_torch.py", ()),
            ("train_cnn_uniq_torch.py", ("--steps", "40")))


def mc_forward_trace(u, n_requests: int, cap: int = 64):
    """Normal engine progress as an action trace: always the first enabled
    action among submit < schedule < chunk < decode (the model checker's
    own order), until ``n_requests`` requests finish."""
    w = modelcheck.World(u)
    actions = []
    forward = ("submit", "schedule", "chunk", "decode")
    while w.n_finished < n_requests and len(actions) < cap:
        act = next(a for a in w.enabled_actions()
                   if a[0] in forward
                   and not (a[0] == "submit" and w.uid >= n_requests))
        w.apply(act)
        actions.append(act)
    if w.n_finished != n_requests:
        raise SystemExit(f"forward trace of {u.name} finished "
                         f"{w.n_finished} of {n_requests} requests")
    return actions


def replay_launches(rep, L: int, kv_bits: int) -> dict:
    """What a replay's model calls launch at granite_3_8b W4 (Gaussian,
    bf16, pages of 4): per prefill-chunk call and decode step 7 x L
    ``qmatmul`` and one ``kquantile_dequantize`` (the embedding rows); with
    a coded pool also L ``kv_append`` each, L ``paged_quant_attention`` a
    decode step and 2 x L ``kquantile_dequantize_paged`` a chunk call (its
    K and V read); nothing else."""
    calls, steps = rep.prefill_calls, rep.decode_steps
    want = {name: 0 for name in kops.launch_counts()}
    want["qmatmul"] = 7 * L * (calls + steps)
    want["kquantile_dequantize"] = calls + steps
    if kv_bits < 16:
        want["kv_append"] = L * (calls + steps)
        want["paged_quant_attention"] = L * steps
        want["kquantile_dequantize_paged"] = 2 * L * calls
    return want


@contextlib.contextmanager
def recording_calls(store, forced=None):
    """Records every sampling call's logits (f32 copies) and the tokens it
    returns into ``store`` in order, by wrapping the engine's sampler.  With
    ``forced`` (another replay's store) each call returns that replay's
    tokens of the same call instead of its own, so that both replays feed
    the model the same tokens and every call's logits compare at equal
    inputs."""
    orig = engine_lib._sample_batch

    def sample(logits, temps, top_ks, seeds, positions):
        toks = orig(logits, temps, top_ks, seeds, positions)
        if forced is not None:
            i = len(store)
            if i >= len(forced) or forced[i][1].shape != toks.shape:
                raise SystemExit(f"sampling call {i} has no counterpart of "
                                 f"its shape in the replay it follows")
            toks = forced[i][1].copy()
        store.append((logits.float().clone(), toks.copy()))
        return toks
    engine_lib._sample_batch = sample
    try:
        yield
    finally:
        engine_lib._sample_batch = orig


def logit_err(rows_a, rows_b, what: str) -> tuple:
    """Max abs difference of two replays' logits over every sampling call
    and the largest |logit| of the second; both must be finite."""
    err = big = 0.0
    for i, ((a, _), (b, _)) in enumerate(zip(rows_a, rows_b)):
        if a.shape != b.shape or not (torch.isfinite(a).all()
                                      and torch.isfinite(b).all()):
            raise SystemExit(f"{what}: sampling call {i}'s logits differ in "
                             f"shape or are not finite")
        err = max(err, (a - b).abs().max().item())
        big = max(big, b.abs().max().item())
    return err, big


def mc_replays(params, cfg, opts) -> dict:
    """Every corpus trace and a healthy forward trace (u2p6 at kv16, and
    its twin at kv8 with ``MC_KV8_NEW_TOKENS`` new tokens a request, whose
    decode runs ``paged_quant_attention``'s CUDA-core body at pages of 4)
    replayed on the engine at full width, then the kv8 twin against the
    plain versions; returns the launches of the healthy kernel replays, by
    kernel."""
    L = cfg.n_layers
    total = collections.Counter()

    def replay(u, actions, mutant=None, use_kernels=True, what=""):
        o = opts if use_kernels else dataclasses.replace(opts,
                                                         use_kernels=False)
        kops.reset_launch_counts()
        t0 = time.perf_counter()
        rep = modelcheck.replay_on_engine(u, actions, mutant=mutant,
                                          device=DEV, params=params,
                                          cfg=cfg, opts=o)
        sync()
        got = kops.launch_counts()
        want = replay_launches(rep, L, u.kv_bits) if use_kernels \
            else {n: 0 for n in got}
        say(f"[4M] replay {what} ({u.name}, kv{u.kv_bits}, page "
            f"{u.page_size}{', ' + mutant if mutant else ''}"
            f"{'' if use_kernels else ', plain versions'}): "
            f"{rep.n_applied} actions applied, {rep.n_skipped} skipped, "
            f"{rep.prefill_calls} prefill-chunk calls, {rep.decode_steps} "
            f"decode steps, violation {rep.violation_key}; launches "
            + ", ".join(f"{n} {c}" for n, c in got.items() if c)
            + f"; {time.perf_counter() - t0:.2f}s")
        if got != want:
            raise SystemExit(f"replay {what}: launches {got} != the calls' "
                             f"{want}")
        if rep.n_skipped:
            raise SystemExit(f"replay {what}: {rep.n_skipped} actions were "
                             f"not enabled on the engine")
        return rep, got

    for path in sorted(os.listdir(MC_CORPUS)):
        doc = modelcheck.load_trace(os.path.join(MC_CORPUS, path))
        rep, _ = replay(doc["universe"], doc["actions"], doc["mutant"],
                        what=path)
        want = None if doc.get("expect_clean") else doc["invariant"]
        if rep.violation_key != want:
            raise SystemExit(f"{path} tripped {rep.violation_key} on the "
                             f"engine at full width; the corpus says {want}")

    u16 = next(u for u in modelcheck.UNIVERSES if u.name == "u2p6")
    u8 = dataclasses.replace(u16, name="u2p6-kv8", kv_bits=8,
                             max_new=MC_KV8_NEW_TOKENS)
    route = pa.attn_route(torch.bfloat16, cfg.head_dim, cfg.n_kv_heads,
                          u8.page_size, u8.kv_bits)
    if route != pa.CUDA_CORE:
        raise SystemExit(f"pages of {u8.page_size} were to take the "
                         f"CUDA-core attention body, attn_route says {route}")
    traces = {u.name: mc_forward_trace(u, MC_HEALTHY_REQUESTS)
              for u in (u16, u8)}
    for u in (u16, u8):
        actions = traces[u.name]
        with kernel_audit.launch_records(DEV) as recs:
            a, got = replay(u, actions, what=f"healthy {len(actions)} "
                            f"actions")
        b, _ = replay(u, actions, what="healthy again")
        total.update(got)
        if a.violation_key or b.violation_key or not a.streams \
                or len(a.streams) != MC_HEALTHY_REQUESTS:
            raise SystemExit(f"healthy replay of {u.name} tripped "
                             f"{a.violation_key or b.violation_key} or "
                             f"finished {len(a.streams)} requests")
        if a.streams != b.streams:
            raise SystemExit(f"healthy replays of {u.name} differ: "
                             f"{a.streams} vs {b.streams}")
        bodies = sorted({r["name"] for r in recs
                         if r["library"] == "paged_attn"})
        say(f"[4M] {u.name}: streams {a.streams} bit-identical over two "
            f"replays; attention bodies launched: {bodies or 'none'}")
        if u.kv_bits < 16 and (
                not any(n.startswith("paged_attn_kernel<") for n in bodies)
                or any(n.startswith("paged_attn_tc_kernel<")
                       for n in bodies)):
            raise SystemExit(f"the kv8 replay did not take the CUDA-core "
                             f"attention body alone: {bodies}")
    # the kv8 twin with the plain versions forced, fed the kernel side's
    # tokens at every sampling call (so a near-tie flip does not end the
    # comparison): every call's logits, prefill chunks and each page-4
    # decode step, within TOL_LOGITS_REL of the largest plain logit; an
    # argmax flip a near-tie (phase 4's rule).  The control: the same plain
    # replay with every coded matmul weight's W4 codes one level off (what
    # a kernel that reads each code as its neighbour would give) must land
    # above that limit
    trace = traces[u8.name]
    k_rows, p_rows, w_rows = [], [], []
    with recording_calls(k_rows):
        k, _ = replay(u8, trace, what="kernels, logits recorded")
    with recording_calls(p_rows, forced=k_rows):
        p, _ = replay(u8, trace, use_kernels=False,
                      what="plain, fed the kernel side's tokens")
    if len(k_rows) != len(p_rows) or p.streams != k.streams:
        raise SystemExit("the plain replay sampled a different number of "
                         "times or did not follow the kernel side's tokens")
    err, big = logit_err(k_rows, p_rows, "kv8 replay, kernels vs plain")
    tol = TOL_LOGITS_REL * big
    flips = [(i, int(r)) for i, ((kr, _), (pr, _)) in enumerate(
        zip(k_rows, p_rows))
        for r in (kr.argmax(-1) != pr.argmax(-1)).nonzero().flatten()]
    say(f"[4M] kv8 replay, kernels vs plain versions fed the same tokens: "
        f"{len(k_rows)} sampling calls ({k.prefill_calls} prefill-chunk, "
        f"{k.decode_steps} decode at pages of {u8.page_size}), max abs "
        f"logit err {err:.4f} ({err / big * 100:.2f} % of max |logit|; "
        f"tolerance {tol:.4f} = {TOL_LOGITS_REL} x max |logit|), argmax "
        f"flips {len(flips)} of {sum(kr.shape[0] for kr, _ in k_rows)} "
        f"rows; streams {k.streams}")
    if err > tol:
        raise SystemExit("kv8 replay: the kernels' logits disagree with the "
                         "plain versions'")
    for i, r in flips:
        check_near_tie(f"4M kv8 replay call {i} row {r}", k_rows[i][0][r],
                       p_rows[i][0][r], err)
    coded = _coded_matmul_weights(params)
    if not coded or any(w["q_codes"].dtype != torch.uint8 for w in coded):
        raise SystemExit("4M: the control wants packed W4 codes")
    for w in coded:
        w["q_codes"].bitwise_xor_(0x11)
    try:
        with recording_calls(w_rows, forced=k_rows):
            replay(u8, trace, use_kernels=False,
                   what="control, codes one level off")
    finally:
        for w in coded:
            w["q_codes"].bitwise_xor_(0x11)
    wrong_err, _ = logit_err(w_rows, p_rows, "kv8 replay control")
    say(f"[4M] control: the plain replay with the codes of all "
        f"{len(coded)} coded matmul leaves one level off moves the logits "
        f"by {wrong_err:.4f} ({wrong_err / big * 100:.2f} % of max |logit|; "
        f"the limit {tol:.4f} must sit below it)")
    if wrong_err <= tol:
        raise SystemExit("4M: the logit limit cannot see a kernel that "
                         "decodes its codes one level off")
    return dict(total)


def analysis_check():
    """The check CLI's four passes on the card against the checked-in
    baseline; returns its JSON (the kernel table and the byte cells)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = check_cli.main(["--only", "lint,kernel,compile,mc",
                             "--baseline", os.path.join(
                                 ROOT, "analysis_baseline_torch.json"),
                             "--format", "json"])
    out = json.loads(buf.getvalue())
    for f in out["findings"]:
        say(f"[4M] finding {f['rule']} {f['path']} {f['detail']}: "
            f"{f['message']}")
    if rc != 0 or out["findings"]:
        raise SystemExit(f"the analysis check exited {rc} with "
                         f"{len(out['findings'])} findings")
    info = out["info"]
    for st in info["mc"]:
        say(f"[4M] mc {st['universe']}: depth {st['depth']}, states "
            f"{st['states']}, transitions {st['transitions']}, exhausted "
            f"{st['exhausted']}")
    for c in info["step_shapes"]:
        say(f"[4M] step shapes kv{c['kv_bits']}: decode "
            f"{c['decode_signatures']}, prefill {c['prefill_signatures']} "
            f"({c['buckets']} buckets)")
    for c in info["byte_cells"]:
        if ":full" in c["cell"]:
            say(f"[4M] byte cell {c['cell']}: pool {c['pool_bytes']} B, "
                f"{c['page_bytes']} B a page (= page_kv_bytes)")
    table = kernel_audit.kernel_table(info)
    for name, row in sorted(table.items()):
        say(f"[4M] audit {name}: {len(row['cases'])} cases, "
            f"{len(row['instantiations'])} instantiations, shared memory "
            f"static <= {row['static_smem']} B, dynamic <= "
            f"{row['dynamic_smem']} B, registers <= {row['regs']}, local "
            f"<= {row['local_bytes']} B, blocks an SM >= "
            f"{row['blocks_per_sm']}; {CARD}")
    for k in info["kernels"]:
        for e in k["instantiations"]:
            say(f"[4M] audit {k['kernel']}: {e['name']} static "
                f"{e['static_smem']} B, dynamic {e['dynamic_smem']} B, "
                f"{e['regs']} registers, {e['local_bytes']} B local, "
                f"{e['threads']} threads, {e['blocks_per_sm']} blocks an SM")
    return table


def run_examples():
    """Each example as a subprocess on the card, as a user runs it; its
    lines echoed."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    for name, extra in EXAMPLES:
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable,
                              os.path.join(ROOT, "examples", name),
                              "--device", "cuda", *extra],
                             capture_output=True, text=True, timeout=300,
                             env=env, cwd=ROOT)
        for line in res.stdout.strip().splitlines():
            say(f"[4M] {name}: {line}")
        if res.returncode != 0:
            say(res.stderr[-4000:])
            raise SystemExit(f"example {name} exited {res.returncode}")
        say(f"[4M] {name} {' '.join(extra)}: exit 0 in "
            f"{time.perf_counter() - t0:.1f}s")


def analysis_phase(params, cfg) -> tuple:
    """Phase 4M on phase 4's coded weights: the model checker (every
    universe, zero findings), the replays on the engine at full width, the
    check CLI's four passes, the examples.  Returns (launches of the
    healthy replays by kernel, the kernel audit's table)."""
    t0 = time.perf_counter()
    # the committed universes and the mutants' own, on the sound scheduler
    universes = modelcheck.UNIVERSES + tuple(
        u for _, u in modelcheck.MUTANTS.values())
    universes = tuple({u.name: u for u in universes}.values())
    findings, stats = modelcheck.run_mc(budget_s=120.0, universes=universes)
    if findings or not all(st["exhausted"] for st in stats):
        raise SystemExit(f"the model checker found {findings} or did not "
                         f"exhaust its universes")
    say(f"[4M] run_mc: {len(stats)} universes exhausted, zero findings ("
        + ", ".join(f"{st['universe']} {st['states']}" for st in stats)
        + f" states) in {time.perf_counter() - t0:.1f}s")
    opts = lm.ModelOpts(compute_dtype=torch.bfloat16)
    counts = mc_replays(params, cfg, opts)
    say(f"[time] phase 4M replays done in {time.perf_counter() - t0:.0f}s")
    table = analysis_check()
    say(f"[time] phase 4M check done in {time.perf_counter() - t0:.0f}s")
    run_examples()
    say(f"[time] phase 4M done in {time.perf_counter() - t0:.0f}s")
    return counts, table


# --------------------------------------------------------------------------
# Phase 4c: the MoE family at full width
# --------------------------------------------------------------------------

MOE_ARCHS = ("kimi_k2_1t_a32b", "llama4_maverick_400b_a17b")


@contextlib.contextmanager
def routing(store, replay=None):
    """Records, in call order, the tokens routed by each ``moe.router_topk``
    call into ``store["tokens"]`` (where present) and their expert ids into
    ``store["ids"]`` (where present); with ``replay`` (an earlier run's ids)
    each call returns those ids instead, gated by this run's own router
    probabilities at them, and ``store["differ"]`` gets, per call, which
    tokens' own top-k expert sets differ from the replayed ones."""
    orig = moe_lib.router_topk
    forced = iter(replay) if replay is not None else None

    def topk(x, router_w, cfg):
        w, ids = orig(x, router_w, cfg)
        if "tokens" in store:
            store["tokens"].append(x.shape[0])
        if "ids" in store:
            store["ids"].append(ids.clone())
        if forced is None:
            return w, ids
        want = next(forced)
        store["differ"].append((ids.sort(-1).values
                                != want.sort(-1).values).any(-1))
        probs = torch.softmax(x.float() @ router_w.float(), dim=-1)
        g = probs.gather(-1, want)
        return g / g.sum(-1, keepdim=True).clamp(min=1e-9), want

    moe_lib.router_topk = topk
    try:
        yield
    finally:
        moe_lib.router_topk = orig


def moe_plain_check(params, cfg, name, control: bool = False):
    """Kernels vs plain versions on one prefill and one decode step (B = 8)
    of the full-width MoE model.  The prefill is the engine's largest
    coalesced prefill call: 16 slots of one 64-token page each, whose 1024
    tokens route at the capacity the engine's steady prefill meets (C = 32
    at kimi_k2, 16 at llama4).  A kernel / plain rounding difference can
    move a token's top-k expert set where two router probabilities nearly
    tie, and then its whole expert output.  So the plain prefill replays
    the kernel run's expert ids (gated by its own router) and the logits
    are held to TOL_LOGITS_REL; the decode step
    runs both sides' own routing from the kernel prefill's pool, and the
    logits of the rows whose expert sets agree in every layer are held to
    it.  The count of tokens whose expert sets differ is printed.  With
    ``control``, the plain prefill again with every coded matmul weight's
    W4 codes one level off (c ^ 1, the experts' too; on the same expert
    ids) must land above that limit."""
    B, S, page, Bd = 16, 64, 64, 8
    C = moe_capacity(name, B * S)
    rng = np.random.default_rng(1)
    toks = torch.tensor(rng.integers(0, cfg.vocab, size=(B, S)), device=DEV)
    kern = lm.ModelOpts(compute_dtype=torch.bfloat16, kv_bits=8)
    plain = dataclasses.replace(kern, use_kernels=False)
    rec_k, rec_p = {"ids": []}, {"ids": [], "differ": []}
    t0 = time.perf_counter()
    with routing(rec_k):
        lk, kv = model.prefill(params, cfg, kern, {"tokens": toks})
    sync()
    before = kops.launch_counts()
    with routing(rec_p, replay=rec_k["ids"]):
        lp, _ = model.prefill(params, cfg, plain, {"tokens": toks})
    sync()
    if kops.launch_counts() != before:
        raise SystemExit("use_kernels=False launched a kernel")
    differ = torch.stack(rec_p["differ"])                  # (L, B * S)
    err = (lk.float() - lp.float()).abs().max().item()
    tol = TOL_LOGITS_REL * lp.float().abs().max().item()
    say(f"[moe-plain] {name} prefill {B} x {S} tokens (expert capacity C = "
        f"{C}), kernels vs plain versions (the plain run on the kernel "
        f"run's expert ids): last-"
        f"position logits max abs err {err:.4f} (tolerance {tol:.4f} = "
        f"{TOL_LOGITS_REL} x max |logit|); token-layers whose own top-"
        f"{cfg.top_k} expert set differs: {int(differ.sum())} of "
        f"{differ.numel()}; {time.perf_counter() - t0:.1f}s")
    if not torch.isfinite(lk).all() or err > tol:
        raise SystemExit(f"{name} prefill logits disagree with the plain "
                         f"versions")
    if control:
        coded = _coded_matmul_weights(params)
        if any(w["q_codes"].dtype != torch.uint8 for w in coded):
            raise SystemExit(f"{name}: the control wants packed W4 codes")
        for w in coded:
            w["q_codes"].bitwise_xor_(0x11)
        try:
            with routing({"differ": []}, replay=rec_k["ids"]):
                wrong, _ = model.prefill(params, cfg, plain,
                                         {"tokens": toks})
        finally:
            for w in coded:
                w["q_codes"].bitwise_xor_(0x11)
        wrong_err = (wrong.float() - lp.float()).abs().max().item()
        say(f"[moe-plain] {name} control: the plain prefill with the codes "
            f"of all {len(coded)} coded matmul leaves one level off moves "
            f"the logits by {wrong_err:.4f} (the limit {tol:.4f} must sit "
            f"below it)")
        if wrong_err <= tol:
            raise SystemExit(f"{name}: the logit limit cannot see a kernel "
                             f"that decodes its codes one level off")
        del wrong
    # the decode step: Bd rows on the first Bd prefilled prompts
    n_pages = S // page + 1
    cache = model.init_paged_cache(cfg, 1 + Bd * n_pages, page,
                                   torch.bfloat16, kv_bits=8, device=DEV)
    tables = torch.arange(1, 1 + Bd * n_pages, device=DEV,
                          dtype=torch.int32).reshape(Bd, n_pages)
    kv2 = {k: v[:, :Bd].contiguous() for k, v in kv.items()}
    model.cache_insert_paged(cache, kv2, tables[:, :S // page])
    nxt = lk[:Bd].argmax(-1)
    pos = torch.full((Bd,), S, device=DEV)
    res = {}
    for side, o in (("kernels", kern), ("plain", plain)):
        rec = {"ids": []}
        with routing(rec):
            logits, _ = model.decode(params, cfg, o, cache, nxt[:, None], pos,
                                     block_tables=tables)
        res[side] = (logits.float(), torch.stack(
            [r.sort(-1).values for r in rec["ids"]]))
    sync()
    (dk, ik), (dp, ip) = res["kernels"], res["plain"]
    same = (ik == ip).all(-1).all(0)                       # (Bd,)
    if not bool(same.any()):
        raise SystemExit(f"{name} decode: no row kept its expert sets")
    err = (dk[same] - dp[same]).abs().max().item()
    tol = TOL_LOGITS_REL * dp[same].abs().max().item()
    say(f"[moe-plain] {name} decode step B={Bd}: rows whose expert sets "
        f"differ in some layer {int((~same).sum())} of {Bd}; the other "
        f"rows' logits max abs err {err:.4f} (tolerance {tol:.4f})")
    if not torch.isfinite(dk).all() or err > tol:
        raise SystemExit(f"{name} decode logits disagree with the plain "
                         f"versions")
    del cache, kv, kv2


def moe_phase(arch: str, seed: int, new_tokens: int, layers: int,
              closed: bool, w_dist: str = "gaussian"):
    """One MoE model at full width, depth cut to ``layers``: W4 weights
    (Gaussian, or ``w_dist`` "empirical": a codebook a leaf slice, fitted
    on the slice and coded an expert block at a time) drawn and coded a
    layer slice at a time, phase 4's stream through the paged kv8 engine
    with every launch counted, the plain check (empirical: with the
    wrong-code control), and (``closed``) the closed batch
    (``serve.generate``)."""
    cfg = dataclasses.replace(cb.get(arch), n_layers=layers)
    L = cfg.n_layers
    emp = w_dist == "empirical"
    say(f"[moe] {arch} at full width (d_model {cfg.d_model}, "
        f"{cfg.n_experts} experts top-{cfg.top_k}, d_ff {cfg.d_ff}, "
        f"{cfg.n_heads} heads, {cfg.n_kv_heads} KV heads, head_dim "
        f"{cfg.head_dim}, vocab {cfg.vocab}), depth {L} of "
        f"{cb.get(arch).n_layers} layers, W4 {w_dist} + kv8, bf16")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    kops.reset_launch_counts()
    params = model.init(seed, cfg, device=DEV, w_bits=4,
                        dense_dtype=torch.bfloat16, w_dist=w_dist)
    sync()
    load = kops.launch_counts()
    say(f"[moe] weights drawn and coded a layer slice at a time in "
        f"{time.perf_counter() - t0:.1f}s ("
        + (f"the streamed empirical fit: each slice's codebook from its "
           f"65,536-value subsample, its codes in blocks of at most "
           f"{lm.EMPIRICAL_BLOCK_ELEMS} elements" if emp else
           f"{load['kquantile_quantize']} kquantile_quantize launches")
        + f"); {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated, "
        f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; {CARD}")
    if (load["kquantile_quantize"] <= 0) != emp:
        raise SystemExit(f"coding the weights launched "
                         f"{load['kquantile_quantize']} kquantile_quantize")
    opts = lm.ModelOpts(compute_dtype=torch.bfloat16)
    warm = Engine(params, cfg, opts, EngineConfig(
        max_slots=16, max_len=2048, page_size=64, kv_bits=8,
        prefix_cache=True), device=DEV)
    warm.generate([Request(uid=-1, prompt=np.arange(70, dtype=np.int32),
                           sampling=SamplingParams(max_new_tokens=2))])
    del warm
    sync()

    kops.reset_launch_counts()
    routed = {"tokens": []}
    with routing(routed):
        eng, outs, wall, n_req = run_stream(params, cfg, opts, seed,
                                            new_tokens)
    counts = kops.launch_counts()
    if len(outs) != n_req or any(
            o.finish_reason != "length" or len(o.token_ids) != new_tokens
            or not all(0 <= t < cfg.vocab for t in o.token_ids)
            for o in outs):
        raise SystemExit(f"{arch}: the stream did not complete as expected")
    steps, calls = eng.n_decode_steps, eng.n_prefill_calls
    fwd = steps + calls
    # 4 attention projections a layer and the coded LM head a call; the
    # embedding rows decoded by kquantile_dequantize (Gaussian) or gathered
    # from their codebook (empirical)
    mm, ex = ("qmatmul_lut", "qmatmul_lut_experts") if emp \
        else ("qmatmul", "qmatmul_experts")
    want = {mm: (4 * L + 1) * fwd, ex: 3 * L * fwd,
            "paged_quant_attention": L * steps, "kv_append": L * fwd,
            "kquantile_dequantize_paged": 2 * L * calls}
    if not emp:
        want["kquantile_dequantize"] = fwd
    say(f"[moe] {arch}: {n_req} requests, {steps} decode steps, {calls} "
        f"prefill-chunk calls; launches: " + ", ".join(
            f"{k} {counts[k]} (want {v})" for k, v in want.items())
        + "; " + ", ".join(f"{k} {counts[k]}" for k in counts
                           if k not in want))
    if any(counts[k] != v for k, v in want.items()) \
            or min(want.values()) <= 0 \
            or any(counts[k] for k in counts if k not in want):
        raise SystemExit(f"{arch}: the main path did not go through the "
                         f"kernels as expected")
    # the expert calls' shapes: tokens routed per call (every layer's call
    # of a forward routes the same rows) and the capacity C they give
    per_call = collections.Counter(routed["tokens"][::L])
    say(f"[moe] {arch}: the stream's forwards by tokens routed: " + ", ".join(
        f"T={T} x {n} (C={moe_capacity(arch, T)})"
        for T, n in sorted(per_call.items())))
    st = eng.stats()
    new = sum(len(o.token_ids) for o in outs)
    reg = eng.telemetry.registry
    ttft = tele_lib.percentile_summary(reg["ttft_s"], scale=1e3)
    itl = tele_lib.percentile_summary(reg["itl_s"], scale=1e3)
    say(f"[moe] {arch}: {new} new tokens in {wall:.2f}s -> "
        f"{new / wall:.1f} tok/s; TTFT p50 {ttft['p50']:.0f} ms p95 "
        f"{ttft['p95']:.0f} ms; ITL p50 {itl['p50']:.1f} ms p95 "
        f"{itl['p95']:.1f} ms; cache hits {st['cache_hits']}; peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; {CARD}")
    # the telemetry registry's gauges close over the engine (and its
    # params): both go before the model is freed
    del eng, reg
    if not emp:
        moe_decode_profile(params, cfg, opts)
    moe_plain_check(params, cfg, arch, control=emp)
    if closed:
        c = CLOSED_BATCH
        steps = c["prompt_len"] + c["new_tokens"] - 1
        sc = serve_lib.ServeConfig(w_bits=4)
        prompts = torch.tensor(np.random.default_rng(seed).integers(
            0, cfg.vocab, size=(c["batch"], c["prompt_len"])), device=DEV)
        kops.reset_launch_counts()
        t0 = time.perf_counter()
        toks = serve_lib.generate(params, cfg, opts, sc, prompts,
                                  c["new_tokens"])
        sync()
        dt = time.perf_counter() - t0
        cc = kops.launch_counts()
        want_c = {"qmatmul": (4 * L + 1) * steps,
                  "qmatmul_experts": 3 * L * steps,
                  "kquantile_dequantize": steps}
        say(f"[moe] {arch} closed batch (serve.generate, B={c['batch']}, "
            f"{c['prompt_len']} + {c['new_tokens']} tokens, {steps} decode "
            f"steps): {c['batch'] * c['new_tokens'] / dt:.1f} tok/s; "
            f"launches " + ", ".join(f"{k} {cc[k]} (want {v})"
                                     for k, v in want_c.items()))
        if tuple(toks.shape) != (c["batch"], c["new_tokens"]) \
                or int(toks.min()) < 0 or int(toks.max()) >= cfg.vocab \
                or any(cc[k] != v for k, v in want_c.items()) \
                or any(cc[k] for k in cc if k not in want_c):
            raise SystemExit(f"{arch} closed batch: wrong tokens or "
                             f"launches")
        for k, v in cc.items():
            counts[k] += v
    return counts


def moe_phases(seed: int, new_tokens: int, layers: int):
    """Phase 4c: each MoE model in turn, W4 Gaussian (kimi_k2 with its
    closed batch) and then W4 empirical, each freed before the next;
    returns the launch counts summed over their counted runs."""
    total = {}
    for arch, w_dist in ((a, d) for a in MOE_ARCHS
                         for d in ("gaussian", "empirical")):
        before = torch.cuda.memory_allocated() / 2**30
        counts = moe_phase(arch, seed, new_tokens, layers,
                           closed=(arch, w_dist) == (MOE_ARCHS[0],
                                                     "gaussian"),
                           w_dist=w_dist)
        gc.collect()            # an engine holds reference cycles
        torch.cuda.empty_cache()
        left = torch.cuda.memory_allocated() / 2**30
        say(f"[moe] {arch} ({w_dist}) freed: {left:.2f} GiB allocated "
            f"({before:.2f} before it)")
        if left > before + 1.0:
            raise SystemExit(f"{arch}: the model was not freed")
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
    return total


def profile_step(step, what: str, tag: str):
    """Device busy share and kernel time by name of one call of ``step``
    under ``torch.profiler``, beside an unprofiled call's wall (the median
    of three after two warm-ups: the profiler adds host time).  Returns
    (device ms, unprofiled wall ms, the four kernels of most device time)."""
    walls = []
    for _ in range(5):
        sync()
        t0 = time.perf_counter()
        step()
        sync()
        walls.append(time.perf_counter() - t0)
    bare = sorted(walls[2:])[1] * 1e3
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        step()
        sync()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    n_launch = sum(e.count for e in kernels)
    top = sorted(((e.key, e.self_device_time_total / 1e3) for e in kernels),
                 key=lambda kv: -kv[1])[:4]
    say(f"[{tag}] {what}: device busy {dev_ms:.2f} ms of {wall * 1e3:.2f} ms "
        f"wall under the profiler ({100 * dev_ms / (wall * 1e3):.1f}%), of "
        f"{bare:.2f} ms without it (median of 3: {100 * dev_ms / bare:.1f}%); "
        f"{n_launch} device kernels; by kernel: " + "; ".join(
            f"{n[:48]} {t:.3f} ms" for n, t in top) + f"; {CARD}")
    return dev_ms, bare, top


def moe_decode_profile(params, cfg, opts, B: int = 16, ctx: int = 300):
    """Device busy share and kernel time by name of one decode step (B
    rows, ``ctx`` rows of context each) under ``torch.profiler``."""
    page = 64
    n_pages = ctx // page + 2
    cache = model.init_paged_cache(cfg, 1 + B * n_pages, page,
                                   torch.bfloat16, kv_bits=8, device=DEV)
    tables = torch.arange(1, 1 + B * n_pages, device=DEV,
                          dtype=torch.int32).reshape(B, n_pages)
    toks = torch.randint(0, cfg.vocab, (B, 1), device=DEV)
    pos = torch.full((B,), ctx, device=DEV)
    o = dataclasses.replace(opts, kv_bits=8)
    profile_step(lambda: model.decode(params, cfg, o, cache, toks, pos,
                                      block_tables=tables),
                 f"one decode step (B={B}, {ctx} rows of context, "
                 f"{cfg.n_layers} layers)", "moe")
    del cache


# --------------------------------------------------------------------------
# Phase 5b: the closed batch and the slot cache at full width
# --------------------------------------------------------------------------

# the closed batch's runs of the serving CLI (no --engine): the arguments
# beyond the batch, and the matmul kernel that carries every projection of
# the coded model's 7 per layer (--a-bits fake-quantizes layer outputs, so
# it stays on qmatmul, not qmatmul_a8)
CLOSED_BATCH_RUNS = (
    ("W4", [], "qmatmul"),
    ("W4 empirical", ["--w-dist", "empirical"], "qmatmul_lut"),
    ("W4, a_bits 8", ["--a-bits", "8"], "qmatmul"))
CLOSED_BATCH = dict(batch=4, prompt_len=16, new_tokens=32)


def coded_matmuls_per_step(cfg) -> int:
    """The coded matmuls of one decode step at W4 (``qmatmul`` or
    ``qmatmul_lut`` launches): each layer's projections, the shared block's
    seven at each application (zamba2), the eight of each decoder layer
    (whisper: self q / k / v / o, cross q / o, the MLP's two) and the LM
    head where it is coded (an odd vocab cannot be int4-packed:
    granite_3_8b's 49155 and whisper_base's 51865 stay dense)."""
    L = cfg.n_layers
    head = int(not cfg.tie_embeddings and cfg.vocab % 2 == 0)
    if cfg.family == "audio":
        return 8 * cfg.dec_layers + head
    if cfg.family == "ssm":
        return 2 * L + head                       # in_proj, out_proj
    if cfg.family == "hybrid":
        return 2 * L + 7 * (L // cfg.attn_every) + head
    return 7 * L + head


def closed_batch_phase(seed: int, arch: str = "granite_3_8b",
                       runs=CLOSED_BATCH_RUNS, tag: str = "closed"):
    """``python -m repro_torch.launch.serve`` without --engine at the full
    width and depth of ``arch`` (bf16): dense weights from --seed, greedy
    generation with them and with their coded copy, counted."""
    from repro_torch.launch import serve as serve_cli
    cfg = cb.get(arch)
    c = CLOSED_BATCH
    steps = c["prompt_len"] + c["new_tokens"] - 1
    per_step = coded_matmuls_per_step(cfg)
    out = {}
    for name, extra, matmul in runs:
        argv = ["--arch", arch, "--w-bits", "4", "--batch",
                str(c["batch"]), "--prompt-len", str(c["prompt_len"]),
                "--new-tokens", str(c["new_tokens"]), "--seed", str(seed)
                ] + extra
        say(f"[{tag}] {name}: python -m repro_torch.launch.serve "
            + " ".join(argv))
        kops.reset_launch_counts()
        res = serve_cli.main(argv)
        sync()
        counts = kops.launch_counts()
        toks = res["tokens"]
        if tuple(toks.shape) != (c["batch"], c["new_tokens"]) \
                or int(toks.min()) < 0 or int(toks.max()) >= cfg.vocab:
            raise SystemExit(f"closed batch {arch} {name}: tokens of the "
                             f"wrong shape or outside the vocabulary")
        want_mm = per_step * steps
        gaussian = "empirical" not in extra
        say(f"[{tag}] {name}: kernel launches (the dense run's and the "
            f"coded run's): {matmul} {counts[matmul]} ({per_step} a step x "
            f"{steps} decode steps = {want_mm}; the dense run launches "
            f"none), kquantile_dequantize {counts['kquantile_dequantize']} "
            f"(the embedding rows, one a step), kquantile_quantize "
            f"{counts['kquantile_quantize']} (coding the weights), "
            + ", ".join(f"{n} {counts[n]}" for n in (
                "qmatmul", "qmatmul_a8", "qmatmul_lut",
                "paged_quant_attention", "kv_append",
                "kquantile_dequantize_paged") if n != matmul))
        if counts[matmul] != want_mm \
                or any(counts[m] for m in MATMULS if m != matmul) \
                or counts["paged_quant_attention"] or counts["kv_append"] \
                or counts["kquantile_dequantize_paged"] \
                or counts["kquantile_dequantize"] != (steps if gaussian
                                                       else 0) \
                or (counts["kquantile_quantize"] > 0) != gaussian:
            raise SystemExit(f"closed batch {arch} {name}: the main path "
                             f"did not go through the kernels as expected")
        say(f"[{tag}] {name}: {res['tok_per_s']:.1f} tok/s host loop "
            f"(dense {res['dense_tok_per_s']:.1f}); greedy agreement with "
            f"the dense {res['compute_dtype']} model "
            f"{res['agreement'] * 100:.1f}%; weights coded in "
            f"{res['prepare_s']:.2f}s; {CARD}")
        out[name] = (counts, res)
        del res
        gc.collect()
        torch.cuda.empty_cache()
    return out


SLOT_RANGES = {"engine.decode", "engine.prefill", "engine.cache_insert"}
PAGED_RANGES = {"engine.decode", "engine.prefill_chunk", "engine.cow"}


def slot_phase(cfg, seed: int, new_tokens: int):
    """Phase 4's 12-request stream at W4 (kv16) through the slot engine and
    through the paged kv16 engine with pages of 64 (2048 = 32 x 64 rows:
    the attended lengths match): greedy tokens equal, or a near-tie where
    an argmax differs; then the slot engine again with checkify and the
    profiler ranges under torch.profiler (the tokens unchanged), and the
    paged engine with the prefix cache likewise, for the chunked-prefill
    and copy-on-write ranges."""
    say(f"[slot] W4 + kv16: granite_3_8b at full width, depth "
        f"{cfg.n_layers}, bf16; slot engine (16 slots x 2048 rows) vs paged "
        f"kv16 engine (pages of 64)")
    params = model.init(seed, cfg, device=DEV, w_bits=4,
                        dense_dtype=torch.bfloat16)
    opts = lm.ModelOpts(compute_dtype=torch.bfloat16)
    common = dict(max_slots=16, max_len=2048, prefill_batch=4)
    slot_ec = EngineConfig(cache_mode="slot", **common)
    paged_ec = EngineConfig(page_size=64, **common)
    for ec in (slot_ec, paged_ec):          # warm-up outside the counted runs
        Engine(params, cfg, opts, ec, device=DEV).generate([Request(
            uid=-1, prompt=np.arange(70, dtype=np.int32),
            sampling=SamplingParams(max_new_tokens=2))])
    sync()
    runs = {}
    for name, ec in (("slot", slot_ec), ("paged", paged_ec)):
        rows = {}
        kops.reset_launch_counts()
        with recording_logits(rows):
            eng, outs, wall, n_req = run_stream(params, cfg, opts, seed,
                                                new_tokens, ec=ec)
        counts = kops.launch_counts()
        steps, calls = eng.n_decode_steps, eng.n_prefill_calls
        reg = eng.telemetry.registry
        ttft = tele_lib.percentile_summary(reg["ttft_s"], scale=1e3)
        itl = tele_lib.percentile_summary(reg["itl_s"], scale=1e3)
        new = sum(len(o.token_ids) for o in outs)
        want_mm = 7 * cfg.n_layers * (steps + calls)
        say(f"[slot] {name} engine: {n_req} requests, {new} new tokens in "
            f"{wall:.2f}s -> {new / wall:.1f} tok/s; TTFT p50 "
            f"{ttft['p50']:.0f} ms p95 {ttft['p95']:.0f} ms; ITL p50 "
            f"{itl['p50']:.1f} ms p95 {itl['p95']:.1f} ms; {steps} decode "
            f"steps, {calls} prefill calls; launches qmatmul "
            f"{counts['qmatmul']} (7 x {cfg.n_layers} x {steps + calls} = "
            f"{want_mm}), paged_quant_attention "
            f"{counts['paged_quant_attention']}, kv_append "
            f"{counts['kv_append']}, kquantile_dequantize "
            f"{counts['kquantile_dequantize']}; {CARD}")
        if len(outs) != n_req or any(
                o.finish_reason != "length" or len(o.token_ids) != new_tokens
                for o in outs):
            raise SystemExit(f"{name} engine: a request did not complete")
        if counts["qmatmul"] != want_mm or counts["paged_quant_attention"] \
                or counts["kv_append"] or counts["kquantile_dequantize"] \
                != steps + calls:
            raise SystemExit(f"{name} engine: the main path did not go "
                             f"through the kernels as expected")
        runs[name] = (outs, rows, counts,
                      dict(tok_per_s=new / wall, ttft=ttft, itl=itl))
        del eng
    # greedy streams: equal, or a near-tie at each request's first
    # differing token (the decode batches differ: the paged engine buckets
    # its active rows, the slot engine always steps all 16 slots)
    (outs_s, rows_s, _, _), (outs_p, rows_p, _, _) = runs["slot"], \
        runs["paged"]
    flips, err, big, same, tot = [], 0.0, 0.0, 0, 0
    for a, b in zip(outs_s, outs_p):
        if a.uid == 3:
            continue                    # the sampled request
        same += sum(x == y for x, y in zip(a.token_ids, b.token_ids))
        tot += len(a.token_ids)
        diff = [j for j, (x, y) in enumerate(zip(a.token_ids, b.token_ids))
                if x != y]
        for j in range(diff[0] + 1 if diff else len(a.token_ids)):
            key = (1000 + a.uid, len(a.prompt) - 1 + j)
            err = max(err, (rows_s[key] - rows_p[key]).abs().max().item())
            big = max(big, rows_p[key].abs().max().item())
        if diff:
            flips.append((a.uid, diff[0], key))
    sampled = [o.token_ids for o in outs_s if o.uid == 3] == \
        [o.token_ids for o in outs_p if o.uid == 3]
    say(f"[slot] greedy tokens, slot vs paged kv16: {same}/{tot} equal, "
        f"{len(flips)} request(s) apart; max abs logit difference up to each "
        f"request's first differing token {err:.4f} (tolerance "
        f"{TOL_LOGITS_REL * big:.4f} = {TOL_LOGITS_REL} x max |logit|); the "
        f"sampled request {'equal' if sampled else 'apart'}")
    if err > TOL_LOGITS_REL * big:
        raise SystemExit("slot and paged engines' logits disagree")
    for uid, j, key in flips:
        check_near_tie(f"request {uid} token {j}", rows_s[key], rows_p[key],
                       err, names=("slot", "paged"))
    # the debug aids leave the tokens as they were; the ranges name the steps
    paged_prefix = dataclasses.replace(paged_ec, prefix_cache=True)
    _, plain_prefix, _, _ = run_stream(params, cfg, opts, seed, new_tokens,
                                       ec=paged_prefix)
    for name, ec, want_outs, want_names in (
            ("slot", slot_ec, outs_s, SLOT_RANGES),
            ("paged + prefix cache", paged_prefix, plain_prefix,
             PAGED_RANGES)):
        ec = dataclasses.replace(ec, checkify=True, profile_annotations=True)
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU]) as prof:
            _, outs, wall, _ = run_stream(params, cfg, opts, seed,
                                          new_tokens, ec=ec)
        # the raw events: key_averages() would first build a tree of the
        # run's ~10^5 operations in Python (about a minute)
        names = {e.name() for e in prof.profiler.kineto_results.events()
                 if e.name().startswith("engine.")}
        say(f"[slot] {name} engine with checkify and profiler ranges, under "
            f"torch.profiler: {wall:.2f}s; ranges {sorted(names)}; tokens "
            f"{'unchanged' if _toks(outs) == _toks(want_outs) else 'CHANGED'}")
        if names != want_names or _toks(outs) != _toks(want_outs):
            raise SystemExit(f"{name} engine: checkify / profile "
                             f"annotations changed the tokens or lost a "
                             f"range")
    # the slot engine's decode attention: plain torch over each slot's whole
    # region (16 x 2048 rows, KV 8, hd 128, bf16), beside the paged kernel
    g = torch.Generator(device=DEV)
    g.manual_seed(seed)
    q = torch.randn((16, 1, cfg.n_heads, cfg.head_dim), generator=g,
                    device=DEV).to(torch.bfloat16)
    kvs = [tuple(torch.randn((16, 2048, cfg.n_kv_heads, cfg.head_dim),
                             generator=g, device=DEV).to(torch.bfloat16)
                 for _ in range(2)) for _ in range(3)]
    pos = torch.full((16,), 2047, device=DEV)
    p = attn_lib.AttnParams()
    ms = time_ms([lambda kv=kv: attn_lib.decode_attention(q, *kv, pos, p)
                  for kv in kvs])
    nbytes = 2 * 16 * 2048 * cfg.n_kv_heads * cfg.head_dim * 2
    say(f"[slot] decode attention over the slot cache (plain torch, B=16, "
        f"2048 rows, KV {cfg.n_kv_heads}, hd {cfg.head_dim}, bf16): "
        f"{ms:.4f} ms a layer (bound {nbytes / PEAK_BYTES_PER_S * 1e3:.4f} "
        f"ms, {nbytes / 1e6:.1f} MB of K and V); {CARD}")
    del kvs, params
    gc.collect()
    torch.cuda.empty_cache()
    return {name: r[2:] for name, r in runs.items()}, ms


def _toks(outs):
    return [o.token_ids for o in outs]


# --------------------------------------------------------------------------
# Phase 5d: the state-space families on the closed batch at full width
# --------------------------------------------------------------------------

SSM_ARCHS = ("mamba2_1_3b", "zamba2_2_7b")
# their closed-batch runs: every in_proj / out_proj, shared-block matrix and
# LM head of the coded model on one matmul kernel (--a-bits 8 leaves these
# families' decode unchanged, as in the reference, so it is not run)
SSM_CLOSED_RUNS = CLOSED_BATCH_RUNS[:2]


def _grown(cfg, cache, B: int, max_len: int):
    """A zeroed decode cache of ``max_len`` rows holding ``cache`` (a
    prefill's: zamba2's K/V rows go to the front)."""
    full = model.init_cache(cfg, B, max_len, torch.bfloat16, device=DEV)
    for name, leaf in cache.items():
        full[name][tuple(slice(0, n) for n in leaf.shape)] = leaf
    return full


def _coded_matmul_weights(params):
    """The coded leaves that ``qmatmul`` reads (every one but the
    embedding's, whose rows ``kquantile_dequantize`` decodes)."""
    out = []

    def walk(t):
        if isinstance(t, dict) and "q_codes" in t:
            out.append(t)
        elif isinstance(t, dict):
            for v in t.values():
                walk(v)
    walk({k: v for k, v in params.items() if k != "embed"})
    return out


def kernels_vs_plain(params, cfg, arch: str, tag: str, prefill, decode,
                     want: dict, what: str, tol_rel: float):
    """``prefill(opts)`` -> (logits, a cache with a row free for the next
    token) and one ``decode(opts, cache, tokens)`` step from that cache
    (the prefill's greedy tokens), with the
    kernels and with the plain versions forced (bf16): the kernel side
    launches exactly ``want``, the plain side nothing; logits within
    ``tol_rel`` of the largest plain logit, and a differing argmax a
    near-tie.  The control: the plain prefill with every coded matmul
    weight's W4 codes one level off (c ^ 1) lands above that limit.  Then
    the kernel side's decode step under the profiler."""
    res = {}
    for name, uk in (("kernels", True), ("plain", False)):
        o = lm.ModelOpts(compute_dtype=torch.bfloat16, use_kernels=uk)
        kops.reset_launch_counts()
        logits_p, cache = prefill(o)
        nxt = res.setdefault("next", logits_p.argmax(-1))
        logits_d, cache = decode(o, cache, nxt[:, None])
        sync()
        counts = kops.launch_counts()
        w = want if uk else {}
        if any(counts[k] != w.get(k, 0) for k in counts):
            raise SystemExit(f"{arch} {name} prefill + decode: launches "
                             f"{counts}, want {w}")
        res[name] = (logits_p.float(), logits_d.float(), cache, o)
    B = res["next"].shape[0]
    for i, which in enumerate((f"prefill ({what})", "decode step")):
        k, p = res["kernels"][i], res["plain"][i]
        if k.shape != (B, cfg.vocab) or not torch.isfinite(k).all():
            raise SystemExit(f"{arch} {which} logits: wrong shape or not "
                             f"finite")
        err = (k - p).abs().max().item()
        big = p.abs().max().item()
        tol = tol_rel * big
        agree = (k.argmax(-1) == p.argmax(-1)).float().mean().item()
        say(f"[{tag}] {arch} {which} logits, kernels vs plain versions: max "
            f"abs err {err:.4f} ({err / big * 100:.2f} % of max |logit|; "
            f"tolerance {tol:.4f} = {tol_rel} x max |logit|), argmax "
            f"agreement {agree * 100:.0f}%; launches exact (kernels: "
            + ", ".join(f"{n} {c}" for n, c in want.items())
            + "; plain: none)")
        if err > tol:
            raise SystemExit(f"{arch} {which} logits disagree with the plain "
                             f"versions")
        for r in (k.argmax(-1) != p.argmax(-1)).nonzero().flatten().tolist():
            check_near_tie(f"{arch} {which} row {r}", k[r], p[r], err)
    # the control: what a kernel that reads each code as its neighbour would
    # give (packed int4: c ^ 1 in both nibbles), flipped in place and back
    coded = _coded_matmul_weights(params)
    if not coded or any(w["q_codes"].dtype != torch.uint8 for w in coded):
        raise SystemExit(f"{arch}: the control wants packed W4 codes")
    for w in coded:
        w["q_codes"].bitwise_xor_(0x11)
    try:
        wrong, _ = prefill(res["plain"][3])
    finally:
        for w in coded:
            w["q_codes"].bitwise_xor_(0x11)
    p = res["plain"][0]
    wrong_err = (wrong.float() - p).abs().max().item()
    big = p.abs().max().item()
    tol = tol_rel * big
    say(f"[{tag}] {arch} control: the plain prefill with the codes of all "
        f"{len(coded)} coded matmul leaves one level off moves the logits "
        f"by {wrong_err:.4f} ({wrong_err / big * 100:.2f} % of max |logit|; "
        f"the limit {tol:.4f} must sit below it)")
    if wrong_err <= tol:
        raise SystemExit(f"{arch}: the logit limit cannot see a kernel that "
                         f"decodes its codes one level off")
    _, _, cache, o = res.pop("kernels")
    nxt = res.pop("next")[:, None]
    del res
    profile_step(lambda: decode(o, cache, nxt),
                 f"{arch} one decode step (B={B}, W4, bf16, "
                 f"{cfg.n_layers} layers)", tag)


def ssm_plain_check(params, cfg, arch: str, B: int = 4, S: int = 256):
    """``kernels_vs_plain`` on a prefill of B x S tokens (S = 256: two SSD
    chunks, the state carried from the first into the second) and one
    decode step from its cache: the coded matmuls of two steps and two
    embedding-row decodes, within ``TOL_SSM_LOGITS_REL``."""
    per_step = coded_matmuls_per_step(cfg)
    toks = torch.tensor(np.random.default_rng(1).integers(
        0, cfg.vocab, size=(B, S)), device=DEV)
    pos = torch.full((B,), S, device=DEV)
    def prefill(o):
        logits, cache = model.prefill(params, cfg, o, {"tokens": toks})
        return logits, _grown(cfg, cache, B, S + 1)

    kernels_vs_plain(
        params, cfg, arch, "ssm", prefill,
        lambda o, cache, nxt: model.decode(params, cfg, o, cache, nxt, pos),
        {"qmatmul": 2 * per_step, "kquantile_dequantize": 2},
        f"{B} x {S} tokens", TOL_SSM_LOGITS_REL)


def ssm_phase(arch: str, seed: int):
    """The CLI's closed batch at ``arch``'s full width and depth (W4, W4
    empirical), then a W4 model drawn and coded a layer at a time for the
    kernels-vs-plain check and the profiled decode step.  Returns the
    counted runs' launches, summed."""
    cfg = cb.get(arch)
    dims = hybrid.ssm_dims(cfg)
    shared = (f"; a shared attention + MLP block ({cfg.n_heads} heads x "
              f"{cfg.head_dim}, d_ff {cfg.d_ff}) after every "
              f"{cfg.attn_every} layers" if cfg.family == "hybrid" else "")
    say(f"[ssm] {arch}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"d_inner {dims.d_inner}, {dims.n_heads} SSD heads of "
        f"{dims.headdim}, state {dims.state}, vocab {cfg.vocab}{shared}; "
        f"{coded_matmuls_per_step(cfg)} coded matmuls a decode step")
    total = collections.Counter()
    for counts, _ in closed_batch_phase(seed, arch, SSM_CLOSED_RUNS,
                                        tag="ssm").values():
        total.update(counts)
    t0 = time.perf_counter()
    params = model.init(seed, cfg, device=DEV, w_bits=4,
                        dense_dtype=torch.bfloat16)
    sync()
    say(f"[ssm] {arch}: W4 model drawn and coded a layer slice at a time "
        f"in {time.perf_counter() - t0:.2f}s; "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    ssm_plain_check(params, cfg, arch)
    del params
    return total


def ssm_phases(seed: int):
    """Phase 5d: mamba2_1_3b, then zamba2_2_7b, each freed before the
    next; returns the launches of their counted runs, summed."""
    total = collections.Counter()
    for arch in SSM_ARCHS:
        before = torch.cuda.memory_allocated() / 2**30
        total.update(ssm_phase(arch, seed))
        gc.collect()
        torch.cuda.empty_cache()
        left = torch.cuda.memory_allocated() / 2**30
        if left > before + 1.0:
            raise SystemExit(f"{arch}: the model was not freed ({left:.2f} "
                             f"GiB allocated, {before:.2f} before it)")
    return total


# --------------------------------------------------------------------------
# Phase 5e: the audio and vlm families on the closed batch at full width
# --------------------------------------------------------------------------

ENCDEC_VLM_ARCHS = ("whisper_base", "pixtral_12b")
# phase 5e's W4 prefill: whisper's encoder over its 30-second window of
# 1500 frames and a 64-token decoder prompt; pixtral's 256 patches ahead of
# 64 tokens.  The stub frontends' embeddings are drawn at the token
# embeddings' scale (embed_init: 0.02).
ENCDEC_FRAMES = 1500
PREFILL_TOKENS = 64
FRONTEND_STD = 0.02


def encdec_vlm_plain_check(params, cfg, arch: str, B: int = 4):
    """``kernels_vs_plain`` on a W4 prefill and one decode step from its
    cache.  whisper: frames (B, 1500, d) and B x 64 tokens through
    ``model.prefill`` (the encoder's 6 coded matmuls a layer, the
    decoder's 10: its cross K/V of the encoder output), the self K/V grown
    by a row, one ``model.decode`` step (the 8 a decoder layer);
    pixtral: patch embeddings (B, 256, d) ahead of B x 64 tokens through
    ``lm.forward_prefill(pad_to=...)``, one ``lm.decode_step``.  Each side
    decodes the embedding rows once a call."""
    gen = torch.Generator(device=DEV)
    gen.manual_seed(2)
    toks = torch.randint(0, cfg.vocab, (B, PREFILL_TOKENS), generator=gen,
                         device=DEV)
    per_step = coded_matmuls_per_step(cfg)
    if cfg.family == "audio":
        frames = torch.randn((B, ENCDEC_FRAMES, cfg.d_model), generator=gen,
                             device=DEV).mul_(FRONTEND_STD)
        batch = {"frames": frames, "tokens": toks}
        S = PREFILL_TOKENS
        head = per_step - 8 * cfg.dec_layers          # 1 where coded
        n_prefill = 6 * cfg.enc_layers + 10 * cfg.dec_layers + head

        def prefill(o):
            logits, cache = model.prefill(params, cfg, o, batch)
            for name in ("k", "v"):
                c = cache[name]
                cache[name] = torch.cat([c, c.new_zeros(c[:, :, :1].shape)],
                                        dim=2)
            return logits, cache

        what = (f"{B} x {ENCDEC_FRAMES} frames, {B} x {S} tokens")
    else:
        patches = torch.randn((B, cfg.n_patches, cfg.d_model), generator=gen,
                              device=DEV).mul_(FRONTEND_STD)
        batch = {"patch_embeds": patches, "tokens": toks}
        S = cfg.n_patches + PREFILL_TOKENS
        n_prefill = per_step

        def prefill(o):
            return lm.forward_prefill(params, cfg, o, batch, pad_to=S + 1)

        what = (f"{B} x ({cfg.n_patches} patches + {PREFILL_TOKENS} "
                f"tokens)")
    pos = torch.full((B,), S, device=DEV)
    kernels_vs_plain(
        params, cfg, arch, "5e", prefill,
        lambda o, cache, nxt: model.decode(params, cfg, o, cache, nxt, pos),
        {"qmatmul": n_prefill + per_step, "kquantile_dequantize": 2},
        what, TOL_ENCDEC_VLM_LOGITS_REL)


def encdec_vlm_phase(arch: str, seed: int):
    """The CLI's closed batch at ``arch``'s full width and depth (W4, W4
    empirical), then a W4 model drawn and coded a layer at a time for the
    kernels-vs-plain check and the profiled decode step.  Returns the
    counted runs' launches, summed."""
    cfg = cb.get(arch)
    if cfg.family == "audio":
        shape = (f"{cfg.enc_layers} encoder + {cfg.dec_layers} decoder "
                 f"layers")
    else:
        shape = f"{cfg.n_layers} layers, {cfg.n_patches} patches"
    say(f"[5e] {arch} ({cfg.family}): {shape}, d_model {cfg.d_model}, "
        f"{cfg.n_heads} / {cfg.n_kv_heads} heads of {cfg.head_dim}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab}; {coded_matmuls_per_step(cfg)} "
        f"coded matmuls a decode step")
    total = collections.Counter()
    for counts, _ in closed_batch_phase(seed, arch, SSM_CLOSED_RUNS,
                                        tag="5e").values():
        total.update(counts)
    t0 = time.perf_counter()
    params = model.init(seed, cfg, device=DEV, w_bits=4,
                        dense_dtype=torch.bfloat16)
    sync()
    say(f"[5e] {arch}: W4 model drawn and coded a layer slice at a time "
        f"in {time.perf_counter() - t0:.2f}s; "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    encdec_vlm_plain_check(params, cfg, arch)
    del params
    return total


def encdec_vlm_phases(seed: int):
    """Phase 5e: whisper_base, then pixtral_12b, each freed before the
    next; returns the launches of their counted runs, summed."""
    total = collections.Counter()
    for arch in ENCDEC_VLM_ARCHS:
        before = torch.cuda.memory_allocated() / 2**30
        total.update(encdec_vlm_phase(arch, seed))
        gc.collect()
        torch.cuda.empty_cache()
        left = torch.cuda.memory_allocated() / 2**30
        if left > before + 1.0:
            raise SystemExit(f"{arch}: the model was not freed ({left:.2f} "
                             f"GiB allocated, {before:.2f} before it)")
    return total


# --------------------------------------------------------------------------
# The trainer at full width
# --------------------------------------------------------------------------

# quantized leaves of the dense decoder: the embedding, the 7 stacked
# matmul leaves (wq, wk, wv, wo, w_gate, w_up, w_down) and the LM head
TRAIN_LEAVES = 9


def train_setup(layers, steps: int, seed: int, smoke: bool = False,
                arch: str = "granite_3_8b", extra=()):
    """The trainer CLI's own configuration (``launch/train.py`` defaults:
    f32, AdamW lr 1e-3, batch 8 x seq 64, W4, one gradual block per
    layer; ``extra``: more of its arguments) of ``arch``, its depth cut to
    ``layers`` (None: the full depth)."""
    argv = ["--arch", arch, "--steps", str(steps), "--seed",
            str(seed)] + (["--smoke"] if smoke else []) + list(extra)
    args = train_cli.parse_args(argv)
    cfg, opts, tc = train_cli.setup(args)
    if layers and not smoke:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    data = LMStreamConfig(vocab=cfg.vocab, seq_len=args.seq_len,
                          global_batch=args.batch, seed=seed)
    return cfg, opts, tc, data


def compare_loss_grads(state, sides):
    """Loss and gradients of one step's loss computed two ways from
    ``state`` (``sides``: two (name, fn), each fn() giving (loss, grads)).
    The optimizer's moments and then the first side's gradients wait in
    host memory meanwhile (at zamba2 or pixtral, two gradient trees and the
    plain transform's intermediates beside the whole state do not fit the
    card).  Every gradient must be finite.  Returns the two losses, the
    worst leaf's max |diff| / max |grad|, and each side's peak GiB."""
    t0 = time.perf_counter()
    marks = []
    devices = {p: t.device for p, t in tree_lib.leaves_with_paths(
        state["opt"])}
    state["opt"] = tree_lib.map_with_path(lambda _p, t: t.cpu(), state["opt"])
    marks.append(("moments to the host", time.perf_counter()))
    res, peaks = {}, {}
    for i, (name, fn) in enumerate(sides):
        torch.cuda.reset_peak_memory_stats()
        loss, grads = fn()
        sync()
        marks.append((f"{name} side", time.perf_counter()))
        peaks[name] = torch.cuda.max_memory_allocated() / 2**30
        if i == 0:
            grads = tree_lib.map_with_path(lambda _p, t: t.cpu(), grads)
            marks.append((f"{name} gradients to the host",
                          time.perf_counter()))
        res[name] = (loss, grads)
        del grads
    (la, ga), (lb, gb) = (res[name] for name, _ in sides)
    worst, worst_path = 0.0, ""
    for (path, a), (_, b) in zip(tree_lib.leaves_with_paths(ga),
                                 tree_lib.leaves_with_paths(gb)):
        a = a.to(DEV)
        rel = ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()
        finite = bool(torch.isfinite(a).all() and torch.isfinite(b).all())
        del a
        if not finite:
            raise SystemExit(f"gradient of {path} is not finite")
        if rel >= worst:
            worst, worst_path = rel, path
    del res, ga, gb
    marks.append(("comparison", time.perf_counter()))
    state["opt"] = tree_lib.map_with_path(lambda p, t: t.to(devices[p]),
                                          state["opt"])
    marks.append(("moments back", time.perf_counter()))
    say("[time] loss and gradients two ways: " + ", ".join(
        f"{what} {t - t_prev:.1f}s" for (what, t), t_prev in zip(
            marks, [t0] + [t for _, t in marks[:-1]])))
    return la.item(), lb.item(), worst, worst_path, peaks


def _checked(what, la, lb, worst, worst_path, names):
    """Raise unless two sides' loss and gradients agree within phase 6's
    bounds (TOL_TRAIN_PLAIN_*); return the loss's relative difference."""
    loss_rel = abs(la - lb) / abs(lb)
    say(f"[train] {what}, {names[0]} vs {names[1]}: loss {la:.6f} vs "
        f"{lb:.6f} (rel {loss_rel:.1e}, tolerance "
        f"{TOL_TRAIN_PLAIN_LOSS_REL}); worst gradient leaf ({worst_path}) "
        f"max |diff| / max |grad| {worst:.1e} (tolerance "
        f"{TOL_TRAIN_PLAIN_GRAD_REL})")
    if loss_rel > TOL_TRAIN_PLAIN_LOSS_REL \
            or worst > TOL_TRAIN_PLAIN_GRAD_REL:
        raise SystemExit(f"{what}: {names[0]} and {names[1]} disagree")
    return loss_rel


def train_plain_check(state, cfg, opts, tc, data, sched, seed, step):
    """Loss and gradients of one step from ``state``, kernels vs plain
    versions forced, on the same batch and noise (``compare_loss_grads``).
    Returns the two sides' peak GiB."""
    modes = sched.modes_at(step)
    batch = train_cli.train_batch(cfg, data, step, DEV)

    def side(use):
        def fn():
            before = kops.launch_counts()
            out = train_steps.loss_and_grads(
                state["params"], batch, modes, leaf_noise(seed, step), cfg,
                dataclasses.replace(opts, use_kernels=use), tc)
            sync()
            if not use and kops.launch_counts() != before:
                raise SystemExit("use_kernels=False launched a kernel")
            return out
        return fn

    la, lb, worst, path, peaks = compare_loss_grads(
        state, (("kernels", side(True)), ("plain", side(False))))
    _checked(f"{cfg.name} step {step} (modes {modes.tolist()}) loss and "
             f"gradients", la, lb, worst, path,
             ("kernels", "plain versions forced"))
    return peaks


def in_scan_check(state, cfg, opts, tc, data, sched, seed, step):
    """One step's loss and gradients with the UNIQ transform per layer
    inside the layer loop (``uniq_in_scan``, remat on: one layer's
    transformed copy live, recomputed in the backward) against the
    whole-tree transform under the same remat, fed the same noise: the
    embedding's and head's per leaf, each layer's per (weight, layer)
    (``layer_noise``; the whole tree takes the stack of a leaf's layer
    draws).  Within phase 6's bounds; prints both sides' peaks.  Each
    side's ``uniq_noise`` launches are counted from 0 and must be exact: in
    scan one forward per tree-level leaf and per layer weight and layer,
    again in the recompute, and one backward each; whole-tree one of each
    per leaf.  Returns the peaks and the two sides' launches summed."""
    modes = sched.modes_at(step)
    batch = train_cli.train_batch(cfg, data, step, DEV)
    scan_noise = layer_noise(seed, step)
    tree_noise = leaf_noise(seed, step)
    quant = _quantized(state["params"])
    n_layer = sum(p.startswith("layers/") for p, _ in quant)
    n_tree, L = len(quant) - n_layer, cfg.n_layers
    want = {"in scan": (n_tree + 2 * L * n_layer, n_tree + L * n_layer),
            "whole tree": (n_tree + n_layer, n_tree + n_layer)}

    def stacked_noise(path, leaf):
        if path.startswith("layers/"):
            name = path.split("/", 1)[1]
            return torch.stack([scan_noise(name, l, leaf[l])
                                for l in range(leaf.shape[0])])
        return tree_noise(path, leaf)

    o = dataclasses.replace(opts, remat=True)
    got = {}

    def side(name, t):
        def fn():
            kops.reset_launch_counts()
            out = train_steps.loss_and_grads(
                state["params"], batch, modes, stacked_noise, cfg, o, t,
                scan_noise=scan_noise)
            sync()
            c = kops.launch_counts()
            got[name] = (c["uniq_noise_fwd"], c["uniq_noise_bwd"])
            return out
        return name, fn

    la, lb, worst, path, peaks = compare_loss_grads(state, [
        side(name, dataclasses.replace(tc, uniq_in_scan=scan))
        for name, scan in (("in scan", True), ("whole tree", False))])
    _checked(f"{cfg.name} step {step} (modes {modes.tolist()}, remat on) "
             f"loss and gradients", la, lb, worst, path,
             ("the per-layer transform in the layer loop", "the whole-tree "
              "transform"))
    say(f"[train] {cfg.name} uniq_in_scan: peak {peaks['in scan']:.2f} GiB "
        f"allocated in scan, {peaks['whole tree']:.2f} GiB whole-tree "
        f"({peaks['whole tree'] - peaks['in scan']:.2f} GiB less in scan; "
        f"the optimizer's moments parked on the host); {CARD}")
    say(f"[train] {cfg.name} uniq_noise launches (fwd, bwd): in scan "
        f"{got['in scan']} (want {want['in scan']}: {n_tree} tree-level "
        f"leaves + {L} layers x {n_layer} weights, the forward again in "
        f"remat's recompute), whole tree {got['whole tree']} (want "
        f"{want['whole tree']})")
    if got != want:
        raise SystemExit(f"{cfg.name} uniq_in_scan: uniq_noise launches "
                         f"{got}, want {want}")
    return peaks, {k: sum(got[n][i] for n in got)
                   for i, k in enumerate(("uniq_noise_fwd",
                                          "uniq_noise_bwd"))}


def _at(tree, path: str):
    """The leaf (or subtree) of a nested dict at a '/'-joined path."""
    for key in path.split("/"):
        tree = tree[key]
    return tree


def _quantized(params):
    """(path, leaf) of every leaf the UNIQ transform quantizes."""
    return [(p, t) for p, t in tree_lib.leaves_with_paths(params)
            if default_quant_filter(p, t)]


def _frozen_snapshot(state, modes, keep="cuda"):
    """Copies (on ``keep``: the host where the card has no room for them)
    of what one step must leave untouched under ``modes``: of every
    quantized leaf, the slice of the first FROZEN layer of a stacked
    (``layers/*``) leaf, with its momentum, or the whole unstacked leaf
    (the embedding, the head, zamba2's ``shared/*``, whisper's two stacks)
    when its mode (``lm_mode_fn``) is FROZEN.  ``_unchanged`` counts the
    copies a state still equals."""
    mode_for = lm_mode_fn(modes)
    frozen = [l for l, m in enumerate(modes.tolist()) if m == FROZEN]
    snap = {}
    for p, t in _quantized(state["params"]):
        if p.startswith("layers"):
            if not frozen:
                continue
            l = frozen[0]
            for root, sub in (("params", p), ("opt", f"mu/{p}/m")):
                snap[f"{root}/{sub}[{l}]"] = (
                    lambda st, r=root, q=sub, l=l: _at(st[r], q)[l],
                    _at(state[root], sub)[l].to(keep, copy=True))
        elif int(mode_for(p)) == FROZEN:
            snap[p] = (lambda st, q=p: _at(st["params"], q),
                       t.to(keep, copy=True))
    return snap


def _unchanged(snap, state) -> int:
    return sum(torch.equal(get(state).to(old.device), old)
               for get, old in snap.values())


def _noise_probe(state, modes):
    """(path, getter, copy) of the first quantized slice under NOISE this
    step (a stacked leaf's first NOISE layer, or an unstacked leaf whose
    mode is NOISE), which the step must move; None where there is none."""
    mode_for = lm_mode_fn(modes)
    noisy = [l for l, m in enumerate(modes.tolist()) if m == NOISE]
    for p, t in _quantized(state["params"]):
        if p.startswith("layers") and noisy:
            l = noisy[0]
            return (f"{p}[{l}]", lambda st, q=p, l=l: _at(st["params"], q)[l],
                    t[l].clone())
        if not p.startswith("layers") and int(mode_for(p)) == NOISE:
            return p, lambda st, q=p: _at(st["params"], q), t.clone()
    return None


def train_phase(seed: int, layers: int, steps: int):
    """The main path of training: ``steps`` steps of the trainer at full
    width, then one all-FROZEN ``eval_step``.  Returns the launch counts of
    the steps and the step times."""
    cfg, opts, tc, data = train_setup(layers, steps, seed)
    step_fn, sched = train_steps.make_train_step(cfg, opts, tc)
    say(f"[train] granite_3_8b at full width (d_model {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab}), depth cut to {cfg.n_layers} of 40 layers (f32 AdamW "
        f"state for 40 layers, ~8.4 B params x 16 B, exceeds 80 GB); f32, "
        f"{tc.optim.kind} lr {tc.optim.lr}, batch {data.global_batch} x seq "
        f"{data.seq_len}, W{tc.uniq.w_bits}, {sched.n_stages} gradual stages "
        f"of {sched.steps_per_stage} step(s), {steps} steps")
    t0 = time.perf_counter()
    state = train_steps.init_state(seed, cfg, tc, device=DEV)
    sync()
    n_params = sum(t.numel() for t in tree_lib.leaves(state["params"]))
    say(f"[train] state drawn on the card in {time.perf_counter() - t0:.1f}s:"
        f" {n_params / 1e9:.3f} B parameters; "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated")
    # all three modes at once: layers < 3 FROZEN, 3 NOISE, > 3 CLEAN
    train_plain_check(state, cfg, opts, tc, data, sched, seed,
                      min(3, steps - 1))
    _, scan_counts = in_scan_check(state, cfg, opts, tc, data, sched, seed,
                                   min(3, steps - 1))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    kops.reset_launch_counts()
    times = []
    for step in range(steps):
        modes = sched.modes_at(step)
        snap = _frozen_snapshot(state, modes)
        probe = _noise_probe(state, modes)
        before = kops.launch_counts()
        t0 = time.perf_counter()
        batch = lm_batch(data, step, device=DEV)
        state, m = step_fn(state, batch, seed)
        loss = float(m["loss"])
        sync()
        dt = time.perf_counter() - t0
        times.append(dt)
        after = kops.launch_counts()
        nf = after["uniq_noise_fwd"] - before["uniq_noise_fwd"]
        nb = after["uniq_noise_bwd"] - before["uniq_noise_bwd"]
        kept = _unchanged(snap, state)
        say(f"[train] step {step} modes {modes.tolist()}: loss {loss:.4f}, "
            f"grad norm {float(m['grad_norm']):.4f}, lr "
            f"{float(m['lr']):.3e}, {dt * 1e3:.0f} ms; uniq_noise launches "
            f"fwd {nf} bwd {nb}; FROZEN tensors unchanged {kept}/"
            f"{len(snap)}")
        if not math.isfinite(loss):
            raise SystemExit(f"train step {step}: loss is not finite")
        if nf != TRAIN_LEAVES or nb != TRAIN_LEAVES:
            raise SystemExit(f"train step {step}: expected {TRAIN_LEAVES} "
                             f"uniq_noise launches forward and backward")
        if kept != len(snap):
            raise SystemExit(f"train step {step}: a FROZEN slice changed")
        if probe is not None and torch.equal(probe[1](state), probe[2]):
            raise SystemExit(f"train step {step}: the NOISE slice "
                             f"{probe[0]} did not move")
        del snap, probe
    counts = kops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    med = float(np.median(times[1:]))
    say(f"[train] {steps} steps: median step {med * 1e3:.0f} ms after the "
        f"first ({times[0] * 1e3:.0f} ms); peak {peak:.1f} GiB allocated; "
        f"launches uniq_noise_fwd {counts['uniq_noise_fwd']}, "
        f"uniq_noise_bwd {counts['uniq_noise_bwd']}")
    before = kops.launch_counts()
    ev = train_steps.eval_step(cfg, opts)(state["params"],
                                          lm_batch(data, steps, device=DEV),
                                          tc.uniq.w_bits)
    ev = float(ev)
    n_ev = kops.launch_counts()["uniq_noise_fwd"] - before["uniq_noise_fwd"]
    say(f"[train] eval_step (every quantized weight FROZEN, W4): loss "
        f"{ev:.4f}; uniq_noise_fwd launches {n_ev}")
    if not math.isfinite(ev) or n_ev != TRAIN_LEAVES:
        raise SystemExit("eval_step failed")
    train_profile(state, step_fn, cfg, data, steps, seed)
    # the in-scan check's two counted steps join the kernels line's
    return {k: v + scan_counts.get(k, 0) for k, v in counts.items()}, times


def train_profile(state, step_fn, cfg, data, step, seed, rows: int = 14):
    """Device time of one more step by kernel (torch.profiler), and the
    device's busy share of the step's wall time: returns (device ms, wall
    ms)."""
    from torch.profiler import ProfilerActivity, profile
    batch = train_cli.train_batch(cfg, data, step, DEV)
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as tp:
        t0 = time.perf_counter()
        step_fn(state, batch, seed)
        sync()
        wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    events = tp.key_averages()
    t_avg = time.perf_counter() - t0
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in kernels)
    groups = {}
    for e in kernels:
        n = e.key.lower()
        g = ("uniq_noise_fwd" if "uniq_fwd" in n else
             "uniq_noise_bwd" if "uniq_bwd" in n else
             "matmul (cuBLAS)" if "gemm" in n or "xmma" in n
             or "cutlass" in n else
             "random (noise draw)" if "philox" in n or "random" in n
             or "uniform" in n else "other (elementwise, reductions)")
        groups[g] = groups.get(g, 0.0) + e.self_device_time_total
    say(f"[profile] one {cfg.name} train step: device busy "
        f"{dev_us / 1e3:.1f} ms of "
        f"{wall * 1e3:.1f} ms wall ({100 * dev_us / 1e3 / (wall * 1e3):.1f}"
        f"%); by kind: " + ", ".join(
            f"{g} {us / 1e3:.1f} ms" for g, us in
            sorted(groups.items(), key=lambda kv: -kv[1])))
    say(events.table(sort_by="self_device_time_total", row_limit=rows,
                     max_name_column_width=60))
    say(f"[time] profile of {cfg.name}: key_averages {t_avg:.1f}s, the "
        f"whole read-out {time.perf_counter() - t0:.1f}s")
    return dev_us / 1e3, wall * 1e3


def small_train_phase(seed: int, arch: str = "granite_3_8b"):
    """A tiny f32 train step of ``arch``'s smoke config on the card
    (kernels) against the same step on the CPU (plain versions): one SGD
    step from one state, on one batch and one noise draw (made on the CPU
    and copied); at the MoE configs the CPU step on the card's expert
    ids."""
    cfg, opts, tc, data = train_setup(None, 8, seed, smoke=True, arch=arch)
    tc = dataclasses.replace(tc, optim=dataclasses.replace(tc.optim,
                                                           kind="sgd"))
    step_fn, sched = train_steps.make_train_step(cfg, opts, tc)
    st_cpu = train_steps.init_state(seed, cfg, tc, device="cpu")
    st_gpu = convert.train_state_from_numpy(
        convert.train_state_to_numpy(st_cpu), device=DEV)
    start = {p: t.clone() for p, t in
             tree_lib.leaves_with_paths(st_cpu["params"])}
    draw = leaf_noise(seed, 0)

    def noise(path, leaf):
        return draw(path, torch.empty(leaf.shape)).to(leaf.device)

    batch = train_cli.train_batch(cfg, data, 0, "cpu")
    card_ids, replayed = {"ids": []}, {"differ": []}
    res = {}
    for st, dev, rec in ((st_gpu, DEV, lambda: routing(card_ids)),
                         (st_cpu, "cpu", lambda: routing(replayed, replay=[
                             i.cpu() for i in card_ids["ids"]]))):
        with rec():
            st, m = step_fn(st, {k: v.to(dev) for k, v in batch.items()},
                            seed, noise=noise)
        res[str(dev)] = (float(m["loss"]), {p: t.cpu() for p, t in
                                            tree_lib.leaves_with_paths(
                                                st["params"])})
    (l_cpu, p_cpu), (l_gpu, p_gpu) = res["cpu"], res[str(DEV)]
    loss_rel = abs(l_cpu - l_gpu) / abs(l_cpu)
    worst, worst_path = 0.0, ""
    for p, t0 in start.items():
        u_cpu, u_gpu = p_cpu[p] - t0, p_gpu[p] - t0
        scale = u_cpu.abs().max().clamp_min(1e-30)
        ulp = torch.ldexp(torch.ones_like(p_cpu[p]),
                          torch.frexp(p_cpu[p]).exponent - 24)
        rel = (((u_gpu - u_cpu).abs() - ulp).clamp_min(0.0).max()
               / scale).item()
        if rel >= worst:
            worst, worst_path = rel, p
    differ = int(torch.stack(replayed["differ"]).sum()) \
        if replayed["differ"] else 0
    say(f"[small] {cfg.name} f32 SGD train step (modes "
        f"{sched.modes_at(0).tolist()}), card vs CPU"
        + (f" (the CPU on the card's expert ids; token-layers whose own "
           f"top-{cfg.top_k} set differs: {differ})" if cfg.is_moe else "")
        + f": loss rel diff {loss_rel:.1e} (tolerance "
        f"{TOL_SMALL_TRAIN_LOSS_REL}); worst leaf ({worst_path}) update max "
        f"|diff| beyond one ulp of p' / max |update| {worst:.1e} (tolerance "
        f"{TOL_SMALL_TRAIN_UPDATE_REL})")
    if loss_rel > TOL_SMALL_TRAIN_LOSS_REL \
            or worst > TOL_SMALL_TRAIN_UPDATE_REL:
        raise SystemExit("the tiny train step on the card disagrees with "
                         "the CPU")


# --------------------------------------------------------------------------
# Phase 6b: UNIQ training of the state-space, audio and vlm families
# --------------------------------------------------------------------------

FAMILY_TRAIN_ARCHS = ("mamba2_1_3b", "zamba2_2_7b", "whisper_base",
                      "pixtral_12b")
FAMILY_TRAIN_STEPS = 6
# the least change of a trained slice beyond AdamW's weight decay, max
# |p' - p (1 - lr wd)|, as a share of the step's lr: AdamW moves an element
# with a gradient by ~lr (m / sqrt(v) ~ 1), weight decay alone by lr wd |p|
# (~1e-6 lr here), f32 rounding by ~1e-7 |p|
TRAIN_MOVE_MIN_LR = 0.1
# whisper's witness that its backward reaches the encoder: the first
# encoder layer's LayerNorm scale (never frozen; its gradient is exactly 0
# on zero frames, whose normalized rows are all 0)
WHISPER_ENC_PROBE = "enc_layers/attn_norm/scale"
_ATTN = ("wq", "wk", "wv", "wo")
# each family's quantized leaves: one uniq_noise_fwd and one uniq_noise_bwd
# launch a step each (whisper's stacks and zamba2's shared block are not
# under ``layers``: one mode, one statistic over the whole tensor)
FAMILY_TRAIN_LEAVES = {
    "mamba2_1_3b": ("embed", "layers/in_proj", "layers/out_proj",
                    "lm_head"),
    "zamba2_2_7b": ("embed", "layers/in_proj", "layers/out_proj", "lm_head")
    + tuple(f"shared/{n}" for n in _ATTN + ("w_gate", "w_up", "w_down")),
    "whisper_base": ("embed", "lm_head")
    + tuple(f"enc_layers/{n}" for n in _ATTN + ("w_up", "w_down"))
    + tuple(f"dec_layers/{n}" for n in _ATTN + tuple(
        f"cross_{a}" for a in _ATTN) + ("w_up", "w_down")),
    "pixtral_12b": ("embed", "lm_head") + tuple(
        f"layers/{n}" for n in _ATTN + ("w_gate", "w_up", "w_down")),
}


def _beyond_decay(probe, state, lr: float, wd: float) -> float:
    """max |p' - p (1 - lr wd)| of a probed slice: the part of its change
    in one step that AdamW's weight decay does not explain."""
    _, get, old = probe
    return float((get(state) - (old - lr * wd * old)).abs().max())


def _all_finite(tree) -> bool:
    return bool(torch.stack([torch.isfinite(t).all()
                             for t in tree_lib.leaves(tree)]).all())


def family_train_phase(arch: str, seed: int, steps: int, layers=None):
    """The trainer's main path for one family at full width (depth
    ``layers``; None: the published depth): one step's loss and gradients
    with the plain versions forced, ``steps`` steps (every launch of
    ``uniq_noise_fwd`` / ``_bwd`` counted, the loss and every parameter
    finite after each step, FROZEN slices bit-unchanged, a NOISE slice
    moved by more than weight decay where the gradient norm is finite;
    whisper: one more step on drawn frames, see below), the all-FROZEN
    eval, one profiled step, then the tiny f32 step of its smoke config on
    the card against the CPU.  Returns the steps' launch counts and
    readings."""
    t_phase = time.perf_counter()
    cfg, opts, tc, data = train_setup(layers, steps, seed, arch=arch)
    step_fn, sched = train_steps.make_train_step(cfg, opts, tc)
    full = cb.get(arch).n_layers
    depth = (f"{cfg.n_layers} of {full} layers" if cfg.n_layers != full
             else f"full depth, {cfg.n_layers} layers")
    if cfg.family == "audio":
        depth = f"full depth, {cfg.enc_layers} + {cfg.dec_layers} layers"
    say(f"[train6b] {arch} ({cfg.family}) at full width (d_model "
        f"{cfg.d_model}, vocab {cfg.vocab}), {depth}; the trainer's "
        f"defaults: f32, {tc.optim.kind} lr {tc.optim.lr}, batch "
        f"{data.global_batch} x seq {data.seq_len}"
        + (f" after {cfg.n_patches} zero patch embeddings"
           if cfg.family == "vlm" else "")
        + (f", {data.seq_len} zero frames through the encoder"
           if cfg.family == "audio" else "")
        + f", W{tc.uniq.w_bits}, ssd_chunk {opts.ssd_chunk}, "
        f"{sched.n_stages} gradual stages of {sched.steps_per_stage} "
        f"step(s), {steps} steps")
    t0 = time.perf_counter()
    state = train_steps.init_state(seed, cfg, tc, device=DEV)
    sync()
    leaves = sorted(p for p, _ in _quantized(state["params"]))
    n_leaves = len(leaves)
    if leaves != sorted(FAMILY_TRAIN_LEAVES[arch]):
        raise SystemExit(f"{arch}: quantized leaves {leaves}, expected "
                         f"{sorted(FAMILY_TRAIN_LEAVES[arch])}")
    n_params = sum(t.numel() for t in tree_lib.leaves(state["params"]))
    say(f"[train6b] {arch} state drawn on the card in "
        f"{time.perf_counter() - t0:.1f}s: {n_params / 1e9:.3f} B f32 "
        f"parameters, {torch.cuda.memory_allocated() / 2**30:.1f} GiB "
        f"allocated with the AdamW moments; {n_leaves} quantized leaves "
        f"({', '.join(leaves)})")
    # FROZEN, NOISE and CLEAN layers at once (whisper: only its embedding
    # (modes[0]) and the rest (modes[-1]) are moded: the last block NOISE)
    say(f"[time] phase 6b {arch}: state drawn at "
        f"{time.perf_counter() - t_phase:.0f}s")
    train_plain_check(state, cfg, opts, tc, data, sched, seed,
                      steps - 1 if cfg.family == "audio"
                      else min(3, steps - 1))
    torch.cuda.empty_cache()            # the plain check's cached blocks
    torch.cuda.reset_peak_memory_stats()
    kops.reset_launch_counts()
    audio = cfg.family == "audio"
    wd = tc.optim.weight_decay
    times = []
    # whisper's encoder normalizes the zero frames' rows to 0 and scales
    # their gradient by ~1 / sqrt(eps) a LayerNorm: its gradient norm
    # overflows f32 at full depth (finite elements; the reference's too,
    # tests/test_torch_train_families.py), the clip zeroes every gradient
    # and the weights move by weight decay alone.  One more step, on frames
    # drawn from the seed, shows the gradient reaching the encoder.
    for step in range(steps + audio):
        drawn = audio and step == steps
        modes = sched.modes_at(step)
        snap = _frozen_snapshot(state, modes)
        probes = [_noise_probe(state, modes)]
        if drawn:
            probes.append((f"{WHISPER_ENC_PROBE}[0]",
                           lambda st: _at(st["params"], WHISPER_ENC_PROBE)[0],
                           _at(state["params"], WHISPER_ENC_PROBE)[0].clone()))
        probes = [pr for pr in probes if pr is not None]
        before = kops.launch_counts()
        t0 = time.perf_counter()
        batch = train_cli.train_batch(cfg, data, step, DEV)
        if drawn:
            gen = torch.Generator(device=DEV).manual_seed(seed)
            batch["frames"] = torch.randn(batch["frames"].shape,
                                          generator=gen, device=DEV)
        state, m = step_fn(state, batch, seed)
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        sync()
        dt = time.perf_counter() - t0
        times.append(dt)
        after = kops.launch_counts()
        nf = after["uniq_noise_fwd"] - before["uniq_noise_fwd"]
        nb = after["uniq_noise_bwd"] - before["uniq_noise_bwd"]
        # a NaN or inf gradient element turns its parameter NaN (through
        # the clip's factor or AdamW's moments, FROZEN ones included)
        finite = _all_finite(state["params"])
        kept = _unchanged(snap, state)
        lr = float(m["lr"])
        moves = [(pr[0], not torch.equal(pr[1](state), pr[2]),
                  _beyond_decay(pr, state, lr, wd)) for pr in probes]
        say(f"[train6b] {arch} step {step} modes (first / last layer) "
            f"{int(modes[0])} / {int(modes[-1])}"
            + (", frames drawn from the seed" if drawn else "")
            + f": loss {loss:.4f}, grad norm {gnorm:.4f}, every parameter "
            f"finite {finite}, {dt * 1e3:.0f} ms; uniq_noise launches fwd "
            f"{nf} bwd {nb}; FROZEN tensors unchanged {kept}/{len(snap)}"
            + "".join(f"; slice {name} moved {mv}, by {beyond:.2e} beyond "
                      f"weight decay (lr {lr:.2e})"
                      for name, mv, beyond in moves))
        if not (math.isfinite(loss) and finite):
            raise SystemExit(f"{arch} train step {step}: loss or a gradient "
                             f"element not finite")
        if not (math.isfinite(gnorm) or (audio and not drawn)):
            raise SystemExit(f"{arch} train step {step}: gradient norm "
                             f"{gnorm}")
        if nf != n_leaves or nb != n_leaves:
            raise SystemExit(f"{arch} train step {step}: expected "
                             f"{n_leaves} uniq_noise launches forward and "
                             f"backward")
        if kept != len(snap):
            raise SystemExit(f"{arch} train step {step}: a FROZEN slice "
                             f"changed")
        for name, mv, beyond in moves:
            if not mv or (math.isfinite(gnorm)
                          and beyond < TRAIN_MOVE_MIN_LR * lr):
                raise SystemExit(f"{arch} train step {step}: the slice "
                                 f"{name} moved by {beyond:.2e} beyond "
                                 f"weight decay (at least "
                                 f"{TRAIN_MOVE_MIN_LR} x lr {lr:.2e})")
        del snap, probes, batch
    counts = kops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    med = float(np.median(times[1:]))
    before = kops.launch_counts()
    say(f"[time] phase 6b {arch}: plain check and steps done at "
        f"{time.perf_counter() - t_phase:.0f}s")
    ev = float(train_steps.eval_step(cfg, opts)(
        state["params"], train_cli.train_batch(cfg, data, steps, DEV),
        tc.uniq.w_bits))
    n_ev = kops.launch_counts()["uniq_noise_fwd"] - before["uniq_noise_fwd"]
    say(f"[train6b] {arch} eval_step (every quantized weight FROZEN, W4): "
        f"loss {ev:.4f}; uniq_noise_fwd launches {n_ev}")
    if not math.isfinite(ev) or n_ev != n_leaves:
        raise SystemExit(f"{arch} eval_step failed")
    dev_ms, wall_ms = train_profile(state, step_fn, cfg, data, steps, seed,
                                    rows=8)
    del state, step_fn
    gc.collect()
    torch.cuda.empty_cache()
    say(f"[time] phase 6b {arch}: eval and profile done at "
        f"{time.perf_counter() - t_phase:.0f}s")
    small_train_phase(seed, arch)
    res = dict(fwd=counts["uniq_noise_fwd"], bwd=counts["uniq_noise_bwd"],
               leaves=n_leaves, median_ms=med * 1e3, first_ms=times[0] * 1e3,
               peak_gib=peak, busy=dev_ms / wall_ms, params=n_params,
               dev_ms=dev_ms, seconds=time.perf_counter() - t_phase)
    say(f"[train6b] {arch}: {len(times)} steps, median step "
        f"{res['median_ms']:.0f}"
        f" ms after the first ({res['first_ms']:.0f} ms); peak "
        f"{peak:.1f} GiB allocated; a profiled step {dev_ms:.1f} ms of "
        f"device time in {wall_ms:.1f} ms ({100 * res['busy']:.1f} % busy; "
        f"{100 * dev_ms / res['median_ms']:.1f} % of the median step); "
        f"launches uniq_noise_fwd {res['fwd']}, uniq_noise_bwd "
        f"{res['bwd']} ({n_leaves} a step); phase {res['seconds']:.0f}s; "
        f"{CARD}")
    return res


def family_train_phases(seed: int, vlm_layers: int):
    """Phase 6b: each family's trainer in turn, each model freed before the
    next; returns the launch counts summed over their steps."""
    total = {"uniq_noise_fwd": 0, "uniq_noise_bwd": 0}
    for arch in FAMILY_TRAIN_ARCHS:
        t0 = time.perf_counter()
        res = family_train_phase(
            arch, seed, FAMILY_TRAIN_STEPS,
            layers=vlm_layers if arch == "pixtral_12b" else None)
        total["uniq_noise_fwd"] += res["fwd"]
        total["uniq_noise_bwd"] += res["bwd"]
        say(f"[time] phase 6b {arch} took {time.perf_counter() - t0:.0f}s")
    return total


# --------------------------------------------------------------------------
# Phase 6c: UNIQ training of the MoE family
# --------------------------------------------------------------------------

# the steps of the trainer's schedule (its --steps), and the steps run: 2 x 2
# stages of NOISE at one layer, then two steps past the schedule's end, where
# every quantized leaf is FROZEN (one layer alone has no FROZEN block within
# the schedule)
MOE_SCHEDULE_STEPS = 4
MOE_TRAIN_STEPS = 6
# the reckoned bytes a parameter takes in a train step: the f32 parameter,
# its gradient and SGD momentum, its UNIQ-transformed copy and that copy's
# gradient (a quantized leaf; the rest 12)
MOE_BYTES_QUANT, MOE_BYTES_OTHER = 20, 12
MOE_PEAK_LIMIT = 70e9
MOE_TRAIN_LEAVES = ("embed", "lm_head") + tuple(
    f"layers/{n}" for n in _ATTN + ("eg", "eu", "ed"))


def moe_reckoning(cfg, n_experts: int):
    """(quantized parameters, other parameters, reckoned bytes) of one
    layer of ``cfg`` at ``n_experts`` experts."""
    d, f, V, L = cfg.d_model, cfg.d_ff, cfg.vocab, cfg.n_layers
    attn = 2 * d * cfg.n_heads * cfg.head_dim \
        + 2 * d * cfg.n_kv_heads * cfg.head_dim
    quant = 2 * V * d + L * (attn + 3 * n_experts * d * f)
    other = L * (d * n_experts + 2 * d) + d
    return quant, other, quant * MOE_BYTES_QUANT + other * MOE_BYTES_OTHER


def moe_expert_cut(arch: str) -> int:
    """The largest multiple of 8 experts whose reckoned one-layer train
    step stays under MOE_PEAK_LIMIT."""
    cfg = dataclasses.replace(cb.get(arch), n_layers=1)
    n = 8
    while moe_reckoning(cfg, n + 8)[2] <= MOE_PEAK_LIMIT:
        n += 8
    return n


def _dropped(ids, cfg) -> int:
    """Copies past their expert's capacity in one router call's (T, k)
    ids (the drop rule of ``moe.route``)."""
    C = moe_lib.capacity(ids.shape[0], moe_lib.MoEConfig(
        cfg.n_experts, cfg.top_k, cfg.capacity_factor))
    counts = torch.bincount(ids.reshape(-1), minlength=cfg.n_experts)
    return int((counts - C).clamp_min(0).sum())


def _sgd_probe(state, path: str, l: int):
    """(name, getter, parameter copy, momentum copy) of slice ``l`` of a
    stacked leaf."""
    return (f"{path}[{l}]", lambda st: _at(st["params"], path)[l],
            _at(state["params"], path)[l].clone(),
            _at(state["opt"], f"mu/{path}/m")[l].clone())


def _beyond_sgd_decay(probe, state, lr: float, oc) -> float:
    """max |p' - (p - lr (momentum m + wd p))| of a probed slice, in f32
    ulps of its largest |p|: what the step's gradient moved it by, beyond
    what SGD's momentum and weight decay alone give."""
    _, get, p, m = probe
    alone = p - lr * (oc.momentum * m + oc.weight_decay * p)
    ulp = float(p.abs().max()) * 2.0 ** -23
    return float((get(state) - alone).abs().max()) / ulp


def moe_train_phase(arch: str, seed: int):
    """The trainer's main path for one MoE model at its published widths,
    depth 1 and the expert count cut (``moe_expert_cut``): the CLI's
    settings with ``--optim sgd``.  One step's loss and gradients with the
    plain versions forced, MOE_TRAIN_STEPS steps (every ``uniq_noise_fwd``
    / ``_bwd`` launch counted, the loss and every parameter finite, FROZEN
    slices of the 4-D stacks bit-unchanged, a NOISE expert slice and, at
    top-k > 1, the router moved by their gradient; the copies each step
    drops), one more step whose first rows repeat one token (its routing
    must drop copies), the all-FROZEN eval, a profiled step, and the tiny
    f32 step of the smoke config on the card against the CPU."""
    t_phase = time.perf_counter()
    full = cb.get(arch)
    n_exp = moe_expert_cut(arch)
    cfg, opts, tc, data = train_setup(1, MOE_SCHEDULE_STEPS, seed, arch=arch,
                                      extra=("--optim", "sgd"))
    cfg = dataclasses.replace(cfg, n_experts=n_exp)
    step_fn, sched = train_steps.make_train_step(cfg, opts, tc)
    quant, other, reck = moe_reckoning(cfg, n_exp)
    C = moe_lib.capacity(data.global_batch * data.seq_len, moe_lib.MoEConfig(
        n_exp, cfg.top_k, cfg.capacity_factor))
    say(f"[train6c] {arch} (moe) at its published widths (d_model "
        f"{cfg.d_model}, {cfg.n_heads} / {cfg.n_kv_heads} heads, head_dim "
        f"{cfg.head_dim}, d_ff {cfg.d_ff} an expert, vocab {cfg.vocab}, "
        f"top-{cfg.top_k}, capacity factor {cfg.capacity_factor}); cut: "
        f"depth 1 of {full.n_layers} layers, {n_exp} of {full.n_experts} "
        f"experts (the largest multiple of 8 whose reckoned peak stays "
        f"under {MOE_PEAK_LIMIT / 1e9:.0f} GB); the CLI's settings with "
        f"--optim sgd: f32, {tc.optim.kind} lr {tc.optim.lr} momentum "
        f"{tc.optim.momentum} wd {tc.optim.weight_decay}, batch "
        f"{data.global_batch} x seq {data.seq_len} (C = {C} rows an "
        f"expert), W{tc.uniq.w_bits}, {sched.n_stages} gradual stages of "
        f"{sched.steps_per_stage} step(s) in --steps {MOE_SCHEDULE_STEPS}, "
        f"{MOE_TRAIN_STEPS} steps run; reckoned peak {quant / 1e9:.3f} G "
        f"quantized parameters x {MOE_BYTES_QUANT} B + {other / 1e6:.2f} M "
        f"others x {MOE_BYTES_OTHER} B = {reck / 1e9:.1f} GB")
    t0 = time.perf_counter()
    state = train_steps.init_state(seed, cfg, tc, device=DEV)
    sync()
    leaves = sorted(p for p, _ in _quantized(state["params"]))
    if leaves != sorted(MOE_TRAIN_LEAVES):
        raise SystemExit(f"{arch}: quantized leaves {leaves}, expected "
                         f"{sorted(MOE_TRAIN_LEAVES)}")
    n_leaves = len(leaves)
    n_params = sum(t.numel() for t in tree_lib.leaves(state["params"]))
    say(f"[train6c] {arch} state drawn on the card in "
        f"{time.perf_counter() - t0:.1f}s: {n_params / 1e9:.3f} B f32 "
        f"parameters, {torch.cuda.memory_allocated() / 2**30:.1f} GiB "
        f"allocated with the momentum; {n_leaves} quantized leaves "
        f"({', '.join(leaves)}; layers/eg {tuple(state['params']['layers']['eg'].shape)})")
    say(f"[time] phase 6c {arch}: state drawn at "
        f"{time.perf_counter() - t_phase:.0f}s")
    plain_peaks = train_plain_check(state, cfg, opts, tc, data, sched, seed,
                                    MOE_SCHEDULE_STEPS - 1)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kops.reset_launch_counts()
    oc = tc.optim
    times, drops = [], []
    first_frozen = next(s for s in range(MOE_TRAIN_STEPS)
                        if int(sched.modes_at(s)[0]) == FROZEN)
    for step in range(MOE_TRAIN_STEPS + 1):
        repeated = step == MOE_TRAIN_STEPS
        modes = sched.modes_at(step)
        # the embedding and head of a FROZEN step (4.7 GB each at kimi_k2)
        # do not fit beside the step: their copies wait on the host.  Taken
        # and compared at the first FROZEN step alone (each such step's
        # copies and comparison took ~15 s at kimi_k2)
        snap = _frozen_snapshot(state, modes, keep="cpu") \
            if step == first_frozen else {}
        if step == first_frozen and not snap:
            raise SystemExit(f"{arch} train step {step}: nothing FROZEN to "
                             f"hold unchanged")
        probes = []
        if int(modes[0]) == NOISE:
            probes.append(_sgd_probe(state, "layers/eg", 0))
        if cfg.top_k > 1:
            probes.append(_sgd_probe(state, "layers/router", 0))
        before = kops.launch_counts()
        batch = train_cli.train_batch(cfg, data, step, DEV)
        if repeated:
            # six rows of one token: their hidden rows, and so their top-k
            # experts, are the same: 384 copies an expert, past C
            batch["tokens"][:6] = batch["tokens"][0, 0]
        rec = {"ids": []}
        t0 = time.perf_counter()
        with routing(rec):
            state, m = step_fn(state, batch, seed)
            loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        sync()
        dt = time.perf_counter() - t0
        if not repeated:
            times.append(dt)
        after = kops.launch_counts()
        nf = after["uniq_noise_fwd"] - before["uniq_noise_fwd"]
        nb = after["uniq_noise_bwd"] - before["uniq_noise_bwd"]
        n_drop = sum(_dropped(ids, cfg) for ids in rec["ids"])
        drops.append(n_drop)
        finite = _all_finite(state["params"])
        kept = _unchanged(snap, state)
        lr = float(m["lr"])
        moves = [(pr[0], _beyond_sgd_decay(pr, state, lr, oc))
                 for pr in probes]
        say(f"[train6c] {arch} step {step} mode {int(modes[0])}"
            + (", rows 0-5 one token" if repeated else "")
            + f": loss {loss:.4f}, grad norm {gnorm:.4f}, every parameter "
            f"finite {finite}, {dt * 1e3:.0f} ms; copies dropped {n_drop} "
            f"of {sum(ids.numel() for ids in rec['ids'])}; uniq_noise "
            f"launches fwd {nf} bwd {nb}; FROZEN tensors unchanged "
            + (f"{kept}/{len(snap)}" if snap else "not compared")
            + "".join(
                f"; slice {name} moved by its gradient {ulps:.1f} f32 ulps "
                f"of its largest |p| beyond momentum and weight decay"
                for name, ulps in moves))
        if not (math.isfinite(loss) and math.isfinite(gnorm) and finite):
            raise SystemExit(f"{arch} train step {step}: loss, gradient "
                             f"norm or a parameter not finite")
        if nf != n_leaves or nb != n_leaves:
            raise SystemExit(f"{arch} train step {step}: expected "
                             f"{n_leaves} uniq_noise launches forward and "
                             f"backward")
        if kept != len(snap):
            raise SystemExit(f"{arch} train step {step}: a FROZEN slice "
                             f"changed")
        for name, ulps in moves:
            if ulps < 4.0:
                raise SystemExit(f"{arch} train step {step}: the slice "
                                 f"{name} did not move by its gradient")
        if repeated and n_drop == 0:
            raise SystemExit(f"{arch}: the repeated-token step dropped no "
                             f"copy")
        del snap, probes, batch, rec
    seen = {int(sched.modes_at(s)[0]) for s in range(MOE_TRAIN_STEPS)}
    if seen != {NOISE, FROZEN}:
        raise SystemExit(f"{arch}: the steps saw modes {seen}, not NOISE "
                         f"and FROZEN")
    counts = kops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    med = float(np.median(times[1:]))
    if cfg.top_k == 1:
        say(f"[train6c] {arch}: the router is not probed: a renormalised "
            f"top-1 gate is 1 whatever the router, so its gradient is "
            f"zero (as in the reference) and weight decay alone moves it")
    before = kops.launch_counts()
    say(f"[time] phase 6c {arch}: plain check and steps done at "
        f"{time.perf_counter() - t_phase:.0f}s")
    ev = float(train_steps.eval_step(cfg, opts)(
        state["params"], train_cli.train_batch(cfg, data, MOE_TRAIN_STEPS,
                                               DEV), tc.uniq.w_bits))
    n_ev = kops.launch_counts()["uniq_noise_fwd"] - before["uniq_noise_fwd"]
    say(f"[train6c] {arch} eval_step (every quantized weight FROZEN, W4): "
        f"loss {ev:.4f}; uniq_noise_fwd launches {n_ev}")
    if not math.isfinite(ev) or n_ev != n_leaves:
        raise SystemExit(f"{arch} eval_step failed")
    dev_ms, wall_ms = train_profile(state, step_fn, cfg, data,
                                    MOE_TRAIN_STEPS, seed, rows=8)
    del state, step_fn
    gc.collect()
    torch.cuda.empty_cache()
    say(f"[time] phase 6c {arch}: eval and profile done at "
        f"{time.perf_counter() - t_phase:.0f}s")
    small_train_phase(seed, arch)
    res = dict(fwd=counts["uniq_noise_fwd"], bwd=counts["uniq_noise_bwd"],
               median_ms=med * 1e3, peak_gib=peak, busy=dev_ms / wall_ms,
               seconds=time.perf_counter() - t_phase)
    say(f"[train6c] {arch}: {MOE_TRAIN_STEPS + 1} steps, median step "
        f"{med * 1e3:.0f} ms after the first ({times[0] * 1e3:.0f} ms) over "
        f"the schedule's data; peak {peak:.1f} GiB allocated ({peak * 2**30 / 1e9:.1f} GB; "
        f"reckoned {reck / 1e9:.1f} GB; the plain-versions check "
        f"{plain_peaks['plain']:.1f} GiB with the momentum parked on the "
        f"host); copies dropped by step {drops}; a profiled step "
        f"{dev_ms:.1f} ms of device time in {wall_ms:.1f} ms "
        f"({100 * res['busy']:.1f} % busy); launches uniq_noise_fwd "
        f"{res['fwd']}, uniq_noise_bwd {res['bwd']} ({n_leaves} a step); "
        f"phase {res['seconds']:.0f}s; {CARD}")
    return res


def moe_train_phases(seed: int):
    """Phase 6c: each MoE model's trainer in turn, each freed before the
    next; returns the launch counts summed over their steps."""
    total = {"uniq_noise_fwd": 0, "uniq_noise_bwd": 0}
    for arch in MOE_ARCHS:
        t0 = time.perf_counter()
        res = moe_train_phase(arch, seed)
        total["uniq_noise_fwd"] += res["fwd"]
        total["uniq_noise_bwd"] += res["bwd"]
        say(f"[time] phase 6c {arch} took {time.perf_counter() - t0:.0f}s")
    return total


# --------------------------------------------------------------------------
# The paper's CNN trainer (ResNet-18 / MobileNet under UNIQ)
# --------------------------------------------------------------------------

# quantized leaves of ResNet-18: conv1, the 16 convs of the 8 BasicBlocks,
# the 3 strided 1x1 downsamples and the fc
CNN_LEAVES = 21
# MobileNet: conv1, 7 depthwise + 7 pointwise, the fc
MOBILENET_LEAVES = 16
# ResNet-18 QAT steps: one per gradual stage, 21 layers x 2 iterations
CNN_STEPS = 2 * CNN_LEAVES
# ResNet-18 QAT step, kernels vs plain versions forced on the card, same
# key: the transform's kernels equal their plain versions to the bit (phase
# 3), the forward is the same cuDNN calls on the same weights; what may
# remain is the order of cuDNN's backward reductions.  Loss relative;
# gradients relative to each leaf's largest.
TOL_CNN_PLAIN_LOSS_REL = 1e-6
TOL_CNN_PLAIN_GRAD_REL = 1e-5
# tiny f32 ResNet-18 QAT step (width 8, batch 8, logits not fake-quantized,
# so no int8 code of a logit can flip between the devices), card vs CPU on
# the same params, batch and key, so the same Philox bits on both: ~20 f32
# conv + GroupNorm layers summed in another order (loss relative);
# gradients relative to each leaf's largest, read at 1.9e-6 on the H100.
TOL_CNN_SMALL_LOSS_REL = 1e-4
TOL_CNN_SMALL_GRAD_REL = 1e-4


def _cnn_experiment(**kw):
    from repro_torch.configs import resnet18_cifar
    return resnet18_cifar.experiment(**kw)


def _cnn_grads_compare(a, b, tol, what):
    """Worst max |diff| / max |grad| over the leaves of two grad trees."""
    worst = 0.0
    for (path, x), (_, y) in zip(tree_lib.leaves_with_paths(a),
                                 tree_lib.leaves_with_paths(b)):
        x, y = x.float().cpu(), y.float().cpu()
        rel = ((x - y).abs().max() / y.abs().max().clamp_min(1e-30)).item()
        worst = max(worst, rel)
        if not torch.isfinite(x).all() or rel > tol:
            raise SystemExit(f"{what}: gradient of {path} {rel:.3e} > {tol}")
    return worst


def cnn_plain_check(trainer, step: int):
    """One QAT step's loss and gradients, kernels vs plain versions forced,
    on one batch and one key (so one noise draw)."""
    modes = trainer.schedule.modes_at(step)
    images, labels = image_batch(trainer.dcfg, step, device=DEV)
    noise = onchip_noise(trainer.exp.seed, step)
    res = {}
    for name, use in (("kernels", True), ("plain", False)):
        before = kops.launch_counts()
        res[name] = trainer.loss_and_grads(images, labels, modes, noise,
                                           use_kernel=use)
        sync()
        if not use and kops.launch_counts() != before:
            raise SystemExit("use_kernel=False launched a kernel")
    (lk, gk), (lp, gp) = res["kernels"], res["plain"]
    loss_rel = abs(lk.item() - lp.item()) / abs(lp.item())
    worst = _cnn_grads_compare(gk, gp, TOL_CNN_PLAIN_GRAD_REL,
                               "CNN QAT step, kernels vs plain versions")
    say(f"[cnn] step {step} (modes {modes.tolist()}) loss and gradients, "
        f"kernels vs plain versions forced (same key): loss {lk.item():.6f} "
        f"vs {lp.item():.6f} (rel {loss_rel:.1e}, tolerance "
        f"{TOL_CNN_PLAIN_LOSS_REL}); worst leaf max |diff| / max |grad| "
        f"{worst:.1e} (tolerance {TOL_CNN_PLAIN_GRAD_REL})")
    if loss_rel > TOL_CNN_PLAIN_LOSS_REL:
        raise SystemExit("CNN QAT loss: kernels disagree with the plain "
                         "versions")


def _cnn_frozen_snapshot(trainer, modes):
    """Copies of the quantized leaves of FROZEN layers and their AdamW
    moments: one step must leave them bit-unchanged."""
    snap = {}
    for name, m in zip(trainer.layer_order, modes.tolist()):
        if m == FROZEN:
            snap[name] = (trainer.params[name].clone(),
                          trainer.opt_state["mu"][name]["m"].clone())
    return snap


def cnn_phase(seed: int, steps: int):
    """The CNN trainer's main path: ResNet-18 at its published widths under
    UNIQ (W4, A8 logits, AdamW, one gradual block per layer, two
    iterations), then the all-FROZEN eval, a profile of one more step, and
    MobileNet (depthwise convs) for a few steps.  Returns the launch counts
    of the ResNet-18 QAT steps."""
    exp = _cnn_experiment(width=64, batch=128, w_bits=4, a_bits=8,
                          steps=steps, iterations=2, seed=seed, device="cuda")
    t0 = time.perf_counter()
    trainer = CNNTrainer(exp)
    sync()
    sched = trainer.schedule
    n_w = cnn_lib.n_quantized(trainer.params)
    n_all = sum(t.numel() for t in tree_lib.leaves(trainer.params))
    say(f"[cnn] ResNet-18 at its published widths (width 64, stages "
        f"64/128/256/512), 32x32x3 images, batch {exp.batch}: "
        f"{len(trainer.layer_order)} quantized leaves, {n_w} weights "
        f"({n_all} parameters); W{exp.w_bits}, A{exp.a_bits} logits, AdamW "
        f"lr {exp.lr}, {sched.n_stages} gradual stages of "
        f"{sched.steps_per_stage} step(s); f32, TF32 off; set up in "
        f"{time.perf_counter() - t0:.1f}s")
    if len(trainer.layer_order) != CNN_LEAVES or n_w != 11_164_352:
        raise SystemExit("ResNet-18 at width 64 does not have 21 quantized "
                         "leaves of 11,164,352 weights")
    # layers < 10 FROZEN, 10 NOISE, > 10 CLEAN: all three modes at once
    cnn_plain_check(trainer, 10)
    kops.reset_launch_counts()
    times, losses = [], []
    for i in range(steps):
        modes = sched.modes_at(i)
        snap = _cnn_frozen_snapshot(trainer, modes)
        noisy = [n for n, m in zip(trainer.layer_order, modes.tolist())
                 if m == 1]
        probe = {n: trainer.params[n].clone() for n in noisy}
        before = kops.launch_counts()
        t0 = time.perf_counter()
        loss = float(trainer.step(i))
        sync()
        times.append(time.perf_counter() - t0)
        losses.append(loss)
        after = kops.launch_counts()
        d = {k: after[k] - before[k] for k in
             ("uniq_noise_fwd_onchip", "uniq_noise_bwd", "uniq_noise_fwd")}
        kept = sum(torch.equal(trainer.params[n], p) and torch.equal(
            trainer.opt_state["mu"][n]["m"], m) for n, (p, m) in snap.items())
        moved = sum(not torch.equal(trainer.params[n], p)
                    for n, p in probe.items())
        if i % 7 == 0 or i == steps - 1:
            say(f"[cnn] step {i} (NOISE {noisy}, {len(snap)} FROZEN): loss "
                f"{loss:.4f}, {times[-1] * 1e3:.1f} ms; launches "
                f"uniq_noise_fwd_onchip {d['uniq_noise_fwd_onchip']}, "
                f"uniq_noise_bwd {d['uniq_noise_bwd']}, uniq_noise_fwd "
                f"{d['uniq_noise_fwd']}; FROZEN leaves unchanged "
                f"{kept}/{len(snap)}")
        if not math.isfinite(loss):
            raise SystemExit(f"CNN step {i}: loss is not finite")
        if d != {"uniq_noise_fwd_onchip": CNN_LEAVES,
                 "uniq_noise_bwd": CNN_LEAVES, "uniq_noise_fwd": 0}:
            raise SystemExit(f"CNN step {i}: launches {d}, expected "
                             f"{CNN_LEAVES} on-chip forward, {CNN_LEAVES} "
                             f"backward and no host-noise forward")
        if kept != len(snap):
            raise SystemExit(f"CNN step {i}: a FROZEN leaf changed")
        if moved != len(probe):
            raise SystemExit(f"CNN step {i}: the NOISE leaf did not move")
        del snap, probe
    counts = kops.launch_counts()
    med = float(np.median(times[1:]))
    say(f"[cnn] {steps} QAT steps: median {med * 1e3:.1f} ms after the first "
        f"({times[0] * 1e3:.1f} ms): {exp.batch / med:.0f} images/s; loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}; launches "
        f"uniq_noise_fwd_onchip {counts['uniq_noise_fwd_onchip']}, "
        f"uniq_noise_bwd {counts['uniq_noise_bwd']}, uniq_noise_fwd "
        f"{counts['uniq_noise_fwd']}")
    before = kops.launch_counts()
    params_q = trainer.quantized_params()
    acc = trainer.accuracy(params_q)
    n_ev = kops.launch_counts()["uniq_noise_fwd_onchip"] \
        - before["uniq_noise_fwd_onchip"]
    say(f"[cnn] all-FROZEN eval (W4 k-quantile weights): accuracy {acc:.4f} "
        f"on 8 x {exp.batch} held-out images (10 classes: chance 0.1); "
        f"uniq_noise_fwd_onchip launches {n_ev}")
    if n_ev != CNN_LEAVES or not 0.0 <= acc <= 1.0:
        raise SystemExit("CNN all-FROZEN eval failed")
    del params_q
    cnn_profile(trainer, steps)
    del trainer
    torch.cuda.empty_cache()
    mobilenet_phase(seed)
    return counts, med


def cnn_profile(trainer, step: int):
    """Device time of one more QAT step by kernel (torch.profiler), and the
    device's busy share of the step's wall time."""
    from torch.profiler import ProfilerActivity, profile
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as tp:
        t0 = time.perf_counter()
        trainer.step(step)
        sync()
        wall = time.perf_counter() - t0
    events = tp.key_averages()
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in kernels)
    groups = {}
    for e in kernels:
        n = e.key.lower()
        g = ("uniq_noise_fwd_onchip" if "uniq_fwd" in n else
             "uniq_noise_bwd" if "uniq_bwd" in n else
             "convolution (cuDNN)" if "conv" in n or "cudnn" in n
             or "implicit" in n or "gemm" in n or "xmma" in n
             or "winograd" in n or "fft" in n or "sm90" in n else
             "group norm" if "group_norm" in n or "groupnorm" in n else
             "other (elementwise, reductions, AdamW)")
        groups[g] = groups.get(g, 0.0) + e.self_device_time_total
    say(f"[profile] one CNN QAT step: device busy {dev_us / 1e3:.2f} ms of "
        f"{wall * 1e3:.2f} ms wall ({100 * dev_us / 1e3 / (wall * 1e3):.1f}"
        f"%); by kind: " + ", ".join(
            f"{g} {us / 1e3:.2f} ms" for g, us in
            sorted(groups.items(), key=lambda kv: -kv[1])))
    say(events.table(sort_by="self_device_time_total", row_limit=14,
                     max_name_column_width=60))


def mobilenet_phase(seed: int, steps: int = 4):
    """MobileNet at its config's width (16) for a few QAT steps: the
    depthwise (3, 3, 1, cin) leaves through the on-chip kernel."""
    from repro_torch.configs import mobilenet_cifar
    exp = mobilenet_cifar.experiment(w_bits=4, a_bits=8, seed=seed,
                                     steps=2 * MOBILENET_LEAVES,
                                     device="cuda")
    trainer = CNNTrainer(exp)
    before = kops.launch_counts()
    losses, times = [], []
    for i in range(steps):
        t0 = time.perf_counter()
        losses.append(float(trainer.step(i)))
        sync()
        times.append(time.perf_counter() - t0)
    after = kops.launch_counts()
    n_f = after["uniq_noise_fwd_onchip"] - before["uniq_noise_fwd_onchip"]
    n_b = after["uniq_noise_bwd"] - before["uniq_noise_bwd"]
    say(f"[cnn] MobileNet width {exp.width}, batch {exp.batch}, "
        f"{len(trainer.layer_order)} quantized leaves: {steps} QAT steps, "
        f"median {np.median(times[1:]) * 1e3:.1f} ms after the first "
        f"({times[0] * 1e3:.1f} ms), losses {[round(x, 4) for x in losses]}; "
        f"launches "
        f"uniq_noise_fwd_onchip {n_f}, uniq_noise_bwd {n_b}")
    if not all(math.isfinite(x) for x in losses) or \
            n_f != steps * MOBILENET_LEAVES or n_b != steps * MOBILENET_LEAVES:
        raise SystemExit("MobileNet QAT steps failed")


def small_cnn_phase(seed: int):
    """A tiny f32 ResNet-18 QAT step on the card (kernels) against the
    same step on the CPU (plain versions): one state, one batch, one key,
    so one noise draw on both."""
    kw = dict(width=8, batch=8, w_bits=4, a_bits=32, steps=42, seed=seed)
    res = []
    state = None
    for dev in ("cpu", DEV):
        trainer = CNNTrainer(_cnn_experiment(device=str(dev), **kw))
        if state is None:
            state = convert.train_state_to_numpy(
                {"params": trainer.params, "opt": trainer.opt_state})
        moved = convert.train_state_from_numpy(state, device=dev)
        trainer.params, trainer.opt_state = moved["params"], moved["opt"]
        step = 10
        images, labels = image_batch(trainer.dcfg, step, device=dev)
        loss, grads = trainer.loss_and_grads(
            images, labels, trainer.schedule.modes_at(step),
            onchip_noise(seed, step))
        res.append((float(loss), grads))
    loss_rel = abs(res[0][0] - res[1][0]) / abs(res[0][0])
    worst = _cnn_grads_compare(res[1][1], res[0][1], TOL_CNN_SMALL_GRAD_REL,
                               "tiny CNN step, card vs CPU")
    say(f"[small] ResNet-18 width 8 f32 QAT step (same params, batch, key), "
        f"card vs CPU: loss {res[1][0]:.6f} vs {res[0][0]:.6f} (rel "
        f"{loss_rel:.1e}, tolerance {TOL_CNN_SMALL_LOSS_REL}); worst leaf "
        f"max |diff| / max |grad| {worst:.1e} (tolerance "
        f"{TOL_CNN_SMALL_GRAD_REL})")
    if loss_rel > TOL_CNN_SMALL_LOSS_REL:
        raise SystemExit("the tiny CNN step on the card disagrees with the "
                         "CPU")


# --------------------------------------------------------------------------
# Phase 6: times
# --------------------------------------------------------------------------

def qmm_bound(M, K, N, bits, a_dtype, out_dtype):
    a_b = 2 if a_dtype == torch.bfloat16 else 4
    o_b = 2 if out_dtype == torch.bfloat16 else 4
    nbytes = M * K * a_b + K * N * bits // 8 + 2 * N * 4 \
        + (2 ** bits) * 4 + M * N * o_b
    flops = 2.0 * M * K * N
    peak = PEAK_FLOPS["bf16" if a_dtype == torch.bfloat16 else "f32"]
    t_b, t_f = nbytes / PEAK_BYTES_PER_S, flops / peak
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations"), \
        nbytes


def time_qmatmul(gen, M, K, N, bits):
    """Kernel, plain version and cuBLAS on a dequantized bf16 weight, at the
    model's types (bf16 in, bf16 out), each over weight copies that together
    exceed the L2 cache."""
    a_dtype = out_dtype = torch.bfloat16
    n_copies = max(2, math.ceil(120e6 / (K * N * bits / 8)))
    sets = [make_qmm_inputs(gen, M, K, N, bits, a_dtype)
            for _ in range(n_copies)]
    ms = time_ms([lambda s=s: qmm.qmatmul(*s, bits=bits, out_dtype=out_dtype)
                  for s in sets])
    plain_ms = time_ms([lambda s=s: qmm.qmatmul_plain(
        *s, bits=bits, out_dtype=out_dtype) for s in sets[:2]],
        warmup=1, iters=4)
    dense = [lm.materialize({"q_codes": s[1], "q_mu": s[2], "q_sigma": s[3]},
                            torch.bfloat16) for s in sets[:3]]
    lib_ms = time_ms([lambda s=s, w=w: torch.matmul(s[0], w)
                      for s, w in zip(sets, dense)])
    bound_ms, by, nbytes = qmm_bound(M, K, N, bits, a_dtype, out_dtype)
    host = host_us(lambda: qmm.qmatmul(*sets[0], bits=bits,
                                       out_dtype=out_dtype))
    return dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=bound_ms, bound_by=by, bytes=nbytes, host_us=host)


def time_qmatmul_a8(gen, M, K, N, bits):
    """The int8-activation kernel at the engine's types (per-token scales,
    bf16 out), its plain version, and cuBLAS in f32 on the f32 ``code *
    scale`` activation and the dequantized f32 weight (the reference's own
    product).

    Bound: the least time the card could take for this exact product,
    max(bytes / 3.35 TB/s, 3 * 2 M K N / 989 TFLOP/s).  Bytes: codes,
    scales, packed weight, statistics, table and output, each once.
    Operations: an f32-exact product of int8 codes and f32 levels takes
    three bf16 tensor-core products (the level split into three bf16
    parts, each product exact in f32), so 3 * 2 M K N at the bf16 peak.
    At M=16, K=4096, N=12800 the bytes set it (26.8 MB, 0.0080 ms); at
    M=256 the operations (0.081 ms)."""
    n_copies = max(2, math.ceil(120e6 / (K * N * bits / 8)))
    sets = []
    for _ in range(n_copies):
        _, w, mu, sigma = make_qmm_inputs(gen, 1, K, N, bits, torch.float32)
        codes, scale = make_a8_inputs(gen, M, K)
        sets.append((codes, scale, w, mu, sigma))
    out = torch.bfloat16
    ms = time_ms([lambda s=s: qmm.qmatmul_a8(*s, bits=bits, out_dtype=out)
                  for s in sets])
    plain_ms = time_ms([lambda s=s: qmm.qmatmul_a8_plain(
        *s, bits=bits, out_dtype=out) for s in sets[:2]], warmup=1, iters=4)
    lib = [((s[0].float() * s[1]), lm.materialize(
        {"q_codes": s[2], "q_mu": s[3], "q_sigma": s[4]}, torch.float32))
        for s in sets[:2]]
    lib_ms = time_ms([lambda a=a, w=w: torch.matmul(a, w) for a, w in lib])
    nbytes = M * K + M * 4 + K * N * bits // 8 + 2 * N * 4 \
        + (2 ** bits) * 4 + M * N * 2
    t_b = nbytes / PEAK_BYTES_PER_S
    t_f = 3 * 2.0 * M * K * N / PEAK_FLOPS["bf16"]
    host = host_us(lambda: qmm.qmatmul_a8(*sets[0], bits=bits,
                                          out_dtype=out))
    return dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=max(t_b, t_f) * 1e3,
                bound_by="bytes" if t_b >= t_f else "operations",
                bytes=nbytes, host_us=host)


def time_qmatmul_lut(gen, M, K, N, bits):
    """The codebook kernel at the engine's types (bf16 in and out, one (k,)
    codebook), its plain version, and cuBLAS on the dequantized bf16
    weight."""
    n_copies = max(2, math.ceil(120e6 / (K * N * bits / 8)))
    sets = []
    for _ in range(n_copies):
        a, w, _, _ = make_qmm_inputs(gen, M, K, N, bits, torch.bfloat16)
        sets.append((a, w, make_lut(gen, N, bits, False)))
    out = torch.bfloat16
    ms = time_ms([lambda s=s: qmm.qmatmul_lut(*s, bits=bits, out_dtype=out)
                  for s in sets])
    plain_ms = time_ms([lambda s=s: qmm.qmatmul_lut_plain(
        *s, bits=bits, out_dtype=out) for s in sets[:2]], warmup=1, iters=4)
    dense = [lm.materialize({"q_codes": s[1], "q_lut": s[2]}, torch.bfloat16)
             for s in sets[:3]]
    lib_ms = time_ms([lambda s=s, w=w: torch.matmul(s[0], w)
                      for s, w in zip(sets, dense)])
    nbytes = M * K * 2 + K * N * bits // 8 + (2 ** bits) * 4 + M * N * 2
    t_b, t_f = nbytes / PEAK_BYTES_PER_S, 2.0 * M * K * N / PEAK_FLOPS["bf16"]
    host = host_us(lambda: qmm.qmatmul_lut(*sets[0], bits=bits,
                                           out_dtype=out))
    return dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=max(t_b, t_f) * 1e3,
                bound_by="bytes" if t_b >= t_f else "operations",
                bytes=nbytes, host_us=host)


# f32 operations per element of the codec kernels, CUDA's erff polynomial
# included (an estimate from its source; the byte bound is larger)
KQ_QUANT_OPS = 30
KQ_DEQUANT_OPS = 2


def _bound(nbytes, ops):
    t_b = nbytes / PEAK_BYTES_PER_S
    t_f = ops / PEAK_FLOPS["f32"]
    return dict(bound_ms=max(t_b, t_f) * 1e3,
                bound_by="bytes" if t_b >= t_f else "operations",
                bytes=nbytes, library_ms=None)


def time_kquantile(gen, G, R, C, k, per_col, w_dtype=torch.float32,
                   out_dtype=torch.bfloat16):
    """Quantize (values -> codes, packed two a byte at k = 16 with an even
    C, as the W4 path stores them) and dequantize (those codes ->
    ``out_dtype``) kernels and their plain versions at one shape, inputs
    beyond the L2 cache where the shape allows; beside each, a same-bytes
    copy as a bandwidth yardstick (``w.to(torch.int8)``;
    ``codes.to(torch.bfloat16)`` of int8 codes of the same shape): it
    moves the bytes of the int8 codec (more than the packed one) and is
    not the same function.  No PyTorch call computes the k-quantile codec:
    no library time."""
    n = G * R * C
    packed = k == 16 and C % 2 == 0
    n_copies = max(2, math.ceil(120e6 / (n * 5)))
    sets = []
    for _ in range(n_copies):
        w = (torch.randn((G, R, C), generator=gen, device=DEV)
             * 0.02).to(w_dtype)
        mu, sigma = _codec_stats(w, per_col)
        stored = kq.kquantile_quantize(w, mu, sigma, k=k, packed=packed)
        c8 = stored if not packed else torch.randint(
            -128, 128, (G, R, C), generator=gen, device=DEV,
            dtype=torch.int8)
        sets.append((w, mu, sigma, stored, c8))
    n_stats = mu.numel()
    r = {}
    for key, kern, plain, copy in (
            ("quantize",
             lambda s: kq.kquantile_quantize(s[0], s[1], s[2], k=k,
                                             packed=packed),
             lambda s: kq.kquantile_quantize_plain(s[0], s[1], s[2], k=k,
                                                   packed=packed),
             lambda s: s[0].to(torch.int8)),
            ("dequantize",
             lambda s: kq.kquantile_dequantize(s[3], s[1], s[2], k=k,
                                               out_dtype=out_dtype),
             lambda s: kq.kquantile_dequantize_plain(s[3], s[1], s[2], k=k,
                                                     out_dtype=out_dtype),
             lambda s: s[4].to(torch.bfloat16))):
        r[key] = dict(
            ms=time_ms([lambda s=s: kern(s) for s in sets]),
            host_us=host_us(lambda: kern(sets[0])),
            plain_ms=time_ms([lambda s=s: plain(s) for s in sets[:2]],
                             warmup=1, iters=4),
            copy_ms=time_ms([lambda s=s: copy(s) for s in sets]))
    in_b = 4 if w_dtype == torch.float32 else 2
    out_b = 4 if out_dtype == torch.float32 else 2
    code_b = 0.5 if packed else 1
    r["quantize"].update(_bound(n * (in_b + code_b) + 2 * n_stats * 4,
                                n * KQ_QUANT_OPS))
    r["dequantize"].update(_bound(n * (code_b + out_b) + 2 * n_stats * 4
                                  + k * 4, n * KQ_DEQUANT_OPS))
    r["quantize"]["copy_bytes"] = n * (in_b + 1)
    r["dequantize"]["copy_bytes"] = n * 3
    r["packed"] = packed
    del sets
    torch.cuda.empty_cache()
    return r


def eager_pool_read(codes, mu, sigma, block_tables, kv_bits,
                    dtype=torch.bfloat16):
    """The prefill pool read as the engine ran it before the paged entry:
    three gathers, then ``dequantize_kv`` (statistics cast to f32 and laid
    out by ``codec_layout``, then the dense dequantize kernel)."""
    g = functools.partial(kq.gather_pages, block_tables=block_tables)
    return kvc.dequantize_kv(g(codes), g(mu), g(sigma), kv_bits, dtype=dtype)


def time_paged(gen, B, kv_bits, n_pages=32, page=64, KV=8, hd=128):
    """One layer's prefill pool read of K (or V), 32 pages of 64 rows a
    sequence, bf16 out: the paged kernel, the eager chain it replaced
    (``eager_pool_read``, with this tree's dense kernel), the plain version,
    and a same-bytes copy (``codes.to(torch.bfloat16)`` of int8 codes of the
    output's shape: the kv8 read's bytes, twice the kv4 codes).  Bytes of
    the bound: each distinct page the tables name, read once, the output
    written once."""
    rows = B * n_pages * page
    per_set = rows * KV * hd * 3
    sets = []
    for _ in range(max(3, math.ceil(150e6 / per_set))):
        codes, mu, sigma, tables = make_paged_pool(gen, B, n_pages, page, KV,
                                                   hd, kv_bits)
        c8 = torch.randint(-128, 128, (rows, KV, hd), generator=gen,
                           device=DEV, dtype=torch.int8)
        sets.append((codes, mu, sigma, tables, c8))
    calls = {
        "ms": lambda s: kq.kquantile_dequantize_paged(*s[:4],
                                                      kv_bits=kv_bits),
        "eager_ms": lambda s: eager_pool_read(*s[:4], kv_bits),
        "plain_ms": lambda s: kq.kquantile_dequantize_paged_plain(
            *s[:4], kv_bits=kv_bits),
        "copy_ms": lambda s: s[4].to(torch.bfloat16)}
    r = {}
    for key, fn in calls.items():
        r[key] = time_ms([lambda s=s: fn(s) for s in sets])
        r[key.replace("ms", "host_us")] = host_us(lambda: fn(sets[0]))
    hdc = hd // 2 if kv_bits == 4 else hd
    distinct = int(torch.unique(sets[0][3]).numel())
    nbytes = distinct * page * KV * (hdc + 4) + rows * KV * hd * 2 \
        + B * n_pages * 4 + (2 ** kv_bits) * 4
    r.update(_bound(nbytes, rows * KV * hd * KQ_DEQUANT_OPS))
    r["copy_bytes"] = rows * KV * hd * 3
    del sets
    torch.cuda.empty_cache()
    return r


def attn_bound(t, H, KV, D, page, kv_bits, window):
    qp = t["q_pos"].to(torch.int64).cpu().numpy()
    rows = np.minimum(qp + 1, window if window else 1 << 30).clip(min=0)
    n_rows = int(rows.sum())
    Dc = D // 2 if kv_bits == 4 else D
    B = len(qp)
    q_b = t["q"].element_size()
    nbytes = n_rows * KV * 2 * (Dc + 4) + 2 * B * H * D * q_b \
        + t["block_tables"].numel() * 4 + B * 4 + (2 ** kv_bits) * 4
    flops = 4.0 * n_rows * H * D
    t_b, t_f = nbytes / PEAK_BYTES_PER_S, flops / PEAK_FLOPS["f32"]
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations"), \
        nbytes


def gathered_kv(t, kv_bits, ctx_rows):
    """The first ``ctx_rows`` rows of every sequence, gathered by block
    table and dequantized to bf16 exactly as the plain version does, as
    (B, KV, ctx, D) K and V: the library yardstick's operands."""
    B = t["q"].shape[0]
    bt = t["block_tables"].long()

    def one(codes, mu, sigma):
        KV = mu.shape[2]
        c = codes[bt].reshape(B, -1, KV, codes.shape[-1])[:, :ctx_rows]
        m = mu[bt].reshape(B, -1, KV)[:, :ctx_rows]
        s = sigma[bt].reshape(B, -1, KV)[:, :ctx_rows]
        x = pa._dequant(c, m, s, kv_bits, torch.bfloat16)
        return x.transpose(1, 2).contiguous()

    return (one(t["k_codes"], t["k_mu"], t["k_sigma"]),
            one(t["v_codes"], t["v_mu"], t["v_sigma"]))


def time_attention(gen, kv_bits, ctx_rows, B=16):
    g = dict(B=B, H=32, KV=8, D=128, page=64,
             n_pages=max(32, -(-ctx_rows // 64)))
    S = g["page"] * g["n_pages"]
    sets = [make_attn_inputs(gen, kv_bits=kv_bits, q_dtype=torch.bfloat16,
                             q_pos=[min(ctx_rows, S) - 1] * g["B"], **g)
            for _ in range(3)]
    t = sets[0]
    ms = time_ms([lambda t=t: attn_call(pa.paged_quant_attention, t,
                                        kv_bits=kv_bits) for t in sets])
    plain_ms = time_ms([lambda: attn_call(pa.paged_quant_attention_plain, t,
                                          kv_bits=kv_bits)],
                       warmup=1, iters=4)
    # the library yardstick: SDPA on the already gathered and dequantized
    # bf16 K / V (it reads 2x the coded bytes; gather and dequant untimed)
    lib = []
    for u in sets:
        k, v = gathered_kv(u, kv_bits, min(ctx_rows, S))
        lib.append((u["q"].transpose(1, 2), k, v))
    library_ms = time_ms([
        lambda x=x: torch.nn.functional.scaled_dot_product_attention(
            *x, enable_gqa=True) for x in lib])
    del lib
    bound_ms, by, nbytes = attn_bound(t, g["H"], g["KV"], g["D"], g["page"],
                                      kv_bits, None)
    host = host_us(lambda: attn_call(pa.paged_quant_attention, t,
                                     kv_bits=kv_bits))
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by=by, bytes=nbytes, host_us=host,
                route=pa.attn_route(torch.bfloat16, g["D"], g["KV"],
                                    g["page"], kv_bits))


# f32 operations per element, CUDA's erff and erfinvf polynomials included
# (an estimate from their source: the byte bound is several times larger)
UNIQ_FWD_OPS = 40
UNIQ_BWD_OPS = 12


def uniq_bound(n, nbytes_per_elem, ops_per_elem, n_stats):
    nbytes = n * nbytes_per_elem + 2 * n_stats * 4
    t_b = nbytes / PEAK_BYTES_PER_S
    t_f = n * ops_per_elem / PEAK_FLOPS["f32"]
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations"), \
        nbytes


def time_uniq(gen, G, R, C, modes):
    """Forward and backward kernels and their plain versions at one f32
    leaf shape of the main path, per-group statistics as the trainer fits
    them.  One leaf is hundreds of MB, far beyond the L2 cache."""
    w, mu, sigma, mode, e01 = make_uniq_inputs(gen, G, R, C, torch.float32,
                                               False, modes)
    g = torch.randn((G, R, C), generator=gen, device=DEV)
    w_hat = un.uniq_noise_fwd(w, mu, sigma, mode, e01, k=16)
    calls = {
        "fwd": (lambda: un.uniq_noise_fwd(w, mu, sigma, mode, e01, k=16),
                lambda: un.uniq_noise_fwd_plain(w, mu, sigma, mode, e01,
                                                k=16)),
        "bwd": (lambda: un.uniq_noise_bwd(g, w, w_hat, mu, sigma, mode),
                lambda: un.uniq_noise_bwd_plain(g, w, w_hat, mu, sigma,
                                                mode))}
    r = {key: dict(ms=time_ms([kernel]), host_us=host_us(kernel),
                   plain_ms=time_ms([plain], warmup=1, iters=3))
         for key, (kernel, plain) in calls.items()}
    # the first body (flat) on the same inputs, in the same call
    r["fwd"]["flat_ms"] = time_ms([lambda: un._launch_fwd(
        un.FLAT, w, mu, sigma, mode, k=16, e01=e01)])
    r["fwd"]["route"] = un.onchip_route(G, R, C, False)
    n = G * R * C
    # what this input needs: e01 is read for NOISE groups only
    n_noise = R * C * sum(1 for m in modes if m == 1)
    f_bytes = (n * 8 + n_noise * 4) / n
    for key, nb, ops in (("fwd", f_bytes, UNIQ_FWD_OPS),
                         ("bwd", 16, UNIQ_BWD_OPS)):
        r[key]["bound_ms"], r[key]["bound_by"], r[key]["bytes"] = uniq_bound(
            n, nb, ops, G)
        r[key]["library_ms"] = None
    del w, mu, sigma, mode, e01, w_hat, g, calls
    torch.cuda.empty_cache()
    return r


# Philox4x32-10's integer operations per element (ten rounds of two
# multiplies, two xors and the key bumps for a run of four, plus the
# conversion), counted at the f32 rate beside the body's UNIQ_FWD_OPS
PHILOX_OPS = 15


def time_uniq_onchip(gen, G, R, C, modes, copies: int = 1,
                     by_value: bool = False):
    """The on-chip forward, its plain version (plain Philox + the reference
    transform) and the host-noise forward on the same shape, f32, per-group
    statistics; beside them the first (flat) body on the same inputs.
    ``copies`` sets of inputs are cycled so a leaf smaller than the L2 cache
    is read from device memory, as the trainer finds it.  ``by_value``: the
    one mode of every group passed by value, as the CNN trainer does."""
    sets = [make_uniq_inputs(gen, G, R, C, torch.float32, False, modes)
            for _ in range(copies)]
    if by_value:
        sets = [(*s[:3], modes[0], *s[4:]) for s in sets]
    key = 0x5DEECE66D
    r = dict(
        ms=time_ms([lambda s=s: un.uniq_noise_fwd_onchip(
            s[0], s[1], s[2], s[3], key, k=16) for s in sets]),
        flat_ms=time_ms([lambda s=s: un._launch_fwd(
            un.FLAT, s[0], s[1], s[2], s[3], k=16, key=key) for s in sets]),
        route=un.onchip_route(G, R, C, False),
        host_fwd_ms=time_ms([lambda s=s: un.uniq_noise_fwd(
            s[0], s[1], s[2], s[3], s[4], k=16) for s in sets]),
        plain_ms=time_ms([lambda s=sets[0]: un.uniq_noise_fwd_onchip_plain(
            s[0], s[1], s[2], s[3], key, k=16)], warmup=1, iters=3),
        host_us=host_us(lambda s=sets[0]: un.uniq_noise_fwd_onchip(
            s[0], s[1], s[2], s[3], key, k=16)),
        # the draw alone (the debug entry point: Philox and a 4-byte write)
        e01_ms=time_ms([lambda: un.onchip_e01(key, G * R * C, DEV)]),
        library_ms=None)
    n = G * R * C
    r["e01_bound_ms"] = n * 4 / PEAK_BYTES_PER_S * 1e3
    # what these inputs need: CLEAN groups copy, only NOISE groups draw
    n_noise = R * C * sum(1 for m in modes if m == 1)
    n_clean = R * C * sum(1 for m in modes if m == 0)
    ops = (n - n_clean) * UNIQ_FWD_OPS + n_noise * PHILOX_OPS
    r["bound_ms"], r["bound_by"], r["bytes"] = uniq_bound(n, 8, ops / n, G)
    del sets
    torch.cuda.empty_cache()
    return r


def time_kv_append(gen, N, KV, hd, kv_bits):
    """The fused append against the eager append it replaced (the flat
    quantize kernel between eager ops, then six index writes) and its
    plain version, on one bf16 layer: device ms (launches queued behind a
    spin) and host us per call.  K/V rows come straight from a projection
    in the engine, so they sit in the L2 cache as here.  No PyTorch call
    computes the coded append: no library time."""
    page = 64
    sets = []
    for _ in range(3):
        k, v, pages, rows, P = make_kv_rows(gen, N, KV, hd, page,
                                            torch.bfloat16)
        sets.append((make_kv_pool(gen, P, page, KV, hd, kv_bits), pages,
                     rows, k, v))
    calls = {"ms": lambda s: kq.kv_append(*s, kv_bits=kv_bits),
             "eager_ms": lambda s: eager_append(*s, kv_bits),
             "plain_ms": lambda s: kq.kv_append_plain(*s, kv_bits=kv_bits)}
    r = {}
    for key, fn in calls.items():
        r[key] = time_ms([lambda s=s: fn(s) for s in sets])
        r[key.replace("ms", "host_us")] = host_us(lambda: fn(sets[0]))
    hdc = hd // 2 if kv_bits == 4 else hd
    n = 2 * N * KV * hd
    nbytes = n * 2 + 2 * N * 8 + 2 * N * KV * (hdc + 4)
    t_b = nbytes / PEAK_BYTES_PER_S
    t_f = n * (KQ_QUANT_OPS + 4) / PEAK_FLOPS["f32"]
    r.update(bound_ms=max(t_b, t_f) * 1e3,
             bound_by="bytes" if t_b >= t_f else "operations", bytes=nbytes,
             library_ms=None)
    del sets
    return r


def time_codec(gen, rows):
    """The codec kernels at the shapes their launches run, into ``rows``:
    every distinct weight shape of granite_3_8b coded at load (W4 packed
    and W8), the embedding rows (decode: 16 tokens; a prefill chunk: 256),
    the prefill pool read (B sequences x 2048 rows)."""
    for (R, C), what in (((4096, 4096), "wq / wo"), ((4096, 1024), "wk / wv"),
                         ((4096, 12800), "w_gate / w_up"),
                         ((12800, 4096), "w_down"), ((49155, 4096), "embed")):
        for k in (16, 256):
            r = time_kquantile(gen, 1, R, C, k, True)
            rows[("kquantile", 1, R, C, k)] = r
            for key in ("quantize", "dequantize"):
                t = r[key]
                form = "packed" if r["packed"] else "int8"
                say(f"[time] kquantile_{key} (1, {R}, {C}) k={k} {form} "
                    f"({what}; f32 in, bf16 out): kernel {t['ms']:.4f} ms, "
                    f"bound {t['bound_ms']:.4f} ms ({t['bound_by']}, "
                    f"{t['bytes'] / 1e6:.2f} MB), same-bytes copy (a "
                    f"bandwidth yardstick, not the same function; "
                    f"{t['copy_bytes'] / 1e6:.2f} MB) {t['copy_ms']:.4f} ms, "
                    f"plain {t['plain_ms']:.3f} ms; host enqueue "
                    f"{t['host_us']:.0f} us per call; {CARD}")
    for T in (16, 256):
        r = time_kquantile(gen, 1, T, 4096, 16, True)
        rows[("kquantile", 1, T, 4096, 16)] = r
        t = r["dequantize"]
        say(f"[time] kquantile_dequantize (1, {T}, 4096) k=16 packed (W4 "
            f"embedding rows, {T} tokens; bf16 out): kernel {t['ms']:.4f} "
            f"ms, bound {t['bound_ms']:.5f} ms ({t['bound_by']}, "
            f"{t['bytes'] / 1e6:.3f} MB), same-bytes copy (yardstick) "
            f"{t['copy_ms']:.4f} ms, plain {t['plain_ms']:.3f} ms; host "
            f"enqueue {t['host_us']:.0f} us per call; {CARD}")
    for kv_bits, B in ((8, 1), (8, 4), (8, 8), (4, 1), (4, 8)):
        r = time_paged(gen, B, kv_bits)
        rows[("paged", kv_bits, B)] = r
        say(f"[time] kquantile_dequantize_paged kv{kv_bits} B={B} x 2048 "
            f"rows, KV=8, hd=128, bf16 out (one layer's K or V at a prefill "
            f"chunk): kernel {r['ms']:.4f} ms, {r['host_us']:.1f} us host; "
            f"the eager chain it replaced (3 gathers, casts, the dense "
            f"kernel) {r['eager_ms']:.4f} ms, {r['eager_host_us']:.1f} us "
            f"host; plain {r['plain_ms']:.4f} ms; bound {r['bound_ms']:.4f} "
            f"ms ({r['bound_by']}, {r['bytes'] / 1e6:.2f} MB); same-bytes "
            f"copy (yardstick, {r['copy_bytes'] / 1e6:.2f} MB) "
            f"{r['copy_ms']:.4f} ms; {CARD}")


def routed_rows(gen, T, E, k, C):
    """(E,) int32 rows of a call of T tokens routed top-k at random: each
    expert's copies, at most C (the capacity buffer's rows)."""
    ids = torch.rand((T, E), generator=gen, device=DEV).topk(k).indices
    counts = torch.bincount(ids.reshape(-1), minlength=E)
    return counts.clamp(max=C).to(torch.int32)


def time_qmatmul_experts(gen, E, C, K, N, rows, bits=4, lut=False):
    """The expert kernel at the model's types (bf16 in and out) on
    ``rows``, its plain version, and ``torch.bmm`` on the dequantized bf16
    stack of the experts in use (their rows only); ``lut``: the codebook
    kernel ``qmatmul_lut_experts`` with a (k,) codebook.

    Bound: the bytes this call must move, each once: the codes of the
    experts in use (an idle expert's are never read), their activation
    rows, the whole (E, C, N) output, the statistics or the codebook and
    the table; the operations 2 * (rows in use) * K * N at the bf16
    peak."""
    a = torch.randn((E, C, K), generator=gen, device=DEV).to(torch.bfloat16)
    _, _, mu, sigma = make_qmm_inputs(gen, 1, 64, N, bits, torch.bfloat16)
    book = make_lut(gen, N, bits, per_col=False)
    n_copies = 2 if E * K * N * bits // 8 > 120e6 else 4
    ws = [torch.randint(0, 256, (E, K, N * bits // 8), generator=gen,
                        device=DEV, dtype=torch.uint8).view(
        torch.uint8 if bits == 4 else torch.int8) for _ in range(n_copies)]
    out = torch.bfloat16
    if lut:
        def kern(w):
            return qmm.qmatmul_lut_experts(a, w, book, rows, bits=bits,
                                           out_dtype=out)

        def plain():
            return qmm.qmatmul_lut_experts_plain(a, ws[0], book, rows,
                                                 bits=bits, out_dtype=out)
    else:
        def kern(w):
            return qmm.qmatmul_experts(a, w, mu, sigma, rows, bits=bits,
                                       out_dtype=out)

        def plain():
            return qmm.qmatmul_experts_plain(a, ws[0], mu, sigma, rows,
                                             bits=bits, out_dtype=out)
    ms = time_ms([lambda w=w: kern(w) for w in ws])
    plain_ms = time_ms([plain], warmup=1, iters=2)
    used = (rows > 0).nonzero().flatten()
    n_used, n_rows = int(used.numel()), int(rows.sum())
    dense = lm.materialize({"q_codes": ws[0][used], "q_lut": book},
                           torch.bfloat16) if lut else \
        kops.dequantize_weights(ws[0][used], mu, sigma, bits=bits,
                                out_dtype=torch.bfloat16)
    a_used = a[used].contiguous()
    lib_ms = time_ms([lambda: torch.bmm(a_used, dense)])
    del dense
    host = host_us(lambda: kern(ws[0]), iters=50)
    nbytes = n_used * K * N * bits // 8 + n_rows * K * 2 + E * C * N * 2 \
        + (book.numel() * 4 if lut else 2 * N * 4) + (2 ** bits) * 4 + E * 4
    t_b = nbytes / PEAK_BYTES_PER_S
    t_f = 2.0 * n_rows * K * N / PEAK_FLOPS["bf16"]
    torch.cuda.empty_cache()
    return dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=max(t_b, t_f) * 1e3,
                bound_by="bytes" if t_b >= t_f else "operations",
                bytes=nbytes, host_us=host, used=n_used, rows=n_rows)


# phase 7's expert rows: (config, matrix, (E, K, N), tokens of the call);
# a decode bucket of 16 tokens, and the engine's coalesced prefill of 4, 8
# and 16 slots of one 64-token page (256, 512 and 1024 tokens; C =
# capacity(T): 8, 16 and 32 at kimi_k2, 8 and 16 at llama4)
EXPERT_TIMINGS = (
    ("kimi_k2_1t_a32b", "eg", (384, 7168, 2048), 16),
    ("kimi_k2_1t_a32b", "ed", (384, 2048, 7168), 16),
    ("kimi_k2_1t_a32b", "eg", (384, 7168, 2048), 256),
    ("kimi_k2_1t_a32b", "ed", (384, 2048, 7168), 256),
    ("kimi_k2_1t_a32b", "eg", (384, 7168, 2048), 512),
    ("kimi_k2_1t_a32b", "ed", (384, 2048, 7168), 512),
    ("kimi_k2_1t_a32b", "eg", (384, 7168, 2048), 1024),
    ("kimi_k2_1t_a32b", "ed", (384, 2048, 7168), 1024),
    ("llama4_maverick_400b_a17b", "eg", (128, 5120, 8192), 16),
    ("llama4_maverick_400b_a17b", "eg", (128, 5120, 8192), 256),
    ("llama4_maverick_400b_a17b", "eg", (128, 5120, 8192), 1024),
)


# the codebook kernel's rows (phase 4c's empirical engine): kimi_k2's eg at
# a decode bucket and a 256-token prefill
LUT_EXPERT_TIMINGS = (("kimi_k2_1t_a32b", "eg", (384, 7168, 2048), 16),
                      ("kimi_k2_1t_a32b", "eg", (384, 7168, 2048), 256))


def time_experts(gen, rows_out):
    for (arch, mat, (E, K, N), T), lut in (
            [(t, False) for t in EXPERT_TIMINGS]
            + [(t, True) for t in LUT_EXPERT_TIMINGS]):
        k, C = cb.get(arch).top_k, moe_capacity(arch, T)
        rows = routed_rows(gen, T, E, k, C)
        r = time_qmatmul_experts(gen, E, C, K, N, rows, lut=lut)
        name = "qmatmul_lut_experts" if lut else "qmatmul_experts"
        rows_out[("lut_experts" if lut else "experts", arch, mat, T)] = r
        say(f"[time] {name} W4 bf16 {arch} {mat} E={E} C={C} K={K} "
            f"N={N}, {T} tokens top-{k}: {r['used']} experts in use, "
            f"{r['rows']} rows; kernel {r['ms']:.4f} ms, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}, "
            f"{r['bytes'] / 1e6:.1f} MB), plain {r['plain_ms']:.2f} ms, "
            f"torch.bmm on the dequantized bf16 experts in use "
            f"{r['library_ms']:.4f} ms; host enqueue {r['host_us']:.0f} us "
            f"per call; {CARD}")
        torch.cuda.empty_cache()


# phase 7's rows of the state-space models' decode (M = 4, bf16) whose N is
# no multiple of the 128-column tile: (what, K, N, the N of whole tiles
# just below, timed beside it)
SSM_QMM_TIMED = (("mamba2 in_proj", 2048, 8512, 8448),
                 ("zamba2 in_proj", 2560, 10448, 10368),
                 ("mamba2 LM head", 2048, 50280, 50176))


# phase 7's rows of whisper_base's and pixtral_12b's coded matmuls (bf16):
# (key of the kernels line, what, M, K, N, bits, the N of whole 128-column
# tiles just below or None), timed as the closed batch's decode (M = 4) and
# the prefill rows of phase 5e give them
ENCDEC_VLM_QMM_TIMED = (
    ("whisper_qkvo_m4", "whisper wq / wk / wv / wo", 4, 512, 512, 4, None),
    ("whisper_up_m4", "whisper w_up", 4, 512, 2048, 4, None),
    ("whisper_down_m4", "whisper w_down", 4, 2048, 512, 4, None),
    ("whisper_head_w8_m4", "whisper LM head, W8", 4, 512, 51865, 8, 51840),
    ("whisper_up_m6000", "whisper encoder w_up, 4 x 1500 frames", 6000, 512,
     2048, 4, None),
    ("pixtral_up_m4", "pixtral w_gate / w_up", 4, 5120, 14336, 4, None),
    ("pixtral_head_m4", "pixtral LM head", 4, 5120, 131072, 4, None),
    ("pixtral_up_m1280", "pixtral w_gate / w_up, 4 x 320 rows", 1280, 5120,
     14336, 4, None))


# the largest leaves of phase 6b's trainers, timed beside row 7's: the
# stacked in_proj of mamba2 (48 x 2048 x 8512) and zamba2 (54 x 2560 x
# 10448)
FAMILY_UNIQ_TIMED = ((48, 2048, 8512), (54, 2560, 10448))
# phase 6c's expert stacks, timed beside row 7's: kimi_k2's layers/eg at 16
# experts (1 x 114688 x 2048) and llama4's at 8 (1 x 40960 x 8192), one
# group each, NOISE and FROZEN
MOE_UNIQ_TIMED = ((1, 16 * 7168, 2048), (1, 8 * 5120, 8192))


def time_long_rows(gen, rows):
    """Phase 7's rows at phase 4L's shapes."""
    # phase 4L's prefill rows: a 16,384-row bucket through granite's FFN
    r = time_qmatmul(gen, 16384, 4096, 12800, 4)
    rows[("qmatmul", 4, 16384, 4096, 12800)] = r
    say(f"[time] qmatmul W4 bf16 M=16384 K=4096 N=12800 (phase 4L's "
        f"16,384-row prefill): kernel {r['ms']:.4f} ms, bound "
        f"{r['bound_ms']:.4f} ms ({r['bound_by']}, {r['bytes'] / 1e6:.1f} "
        f"MB), plain {r['plain_ms']:.3f} ms, torch.matmul on dequantized "
        f"bf16 {r['library_ms']:.4f} ms; {CARD}")
    # phase 4L's decode: B = 4 sequences of 16,384 and 32,768 rows
    for ctx in (16384, 32768):
        r = time_attention(gen, 8, ctx, B=4)
        rows[("attn", 8, ctx)] = r
        say(f"[time] paged_quant_attention kv8 B=4 H=32 KV=8 D=128 page=64 "
            f"ctx={ctx} ({ctx // 64} pages a sequence; {r['route']} body): "
            f"kernel {r['ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}, {r['bytes'] / 1e6:.1f} MB), plain "
            f"{r['plain_ms']:.3f} ms, SDPA on the gathered bf16 K/V "
            f"{r['library_ms']:.4f} ms; {CARD}")


def timing_phase(gen, counts, errs):
    rows = {}
    for bits in (4, 8):
        for (M, K, N) in ((16, 4096, 12800), (16, 4096, 4096),
                          (16, 4096, 1024), (16, 12800, 4096),
                          (8, 4096, 12800), (32, 4096, 12800),
                          (256, 4096, 12800), (512, 4096, 4096)):
            if bits == 8 and M != 16:
                continue
            r = time_qmatmul(gen, M, K, N, bits)
            rows[("qmatmul", bits, M, K, N)] = r
            say(f"[time] qmatmul W{bits} bf16 M={M} K={K} N={N}: kernel "
                f"{r['ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
                f"({r['bound_by']}, {r['bytes'] / 1e6:.1f} MB), plain "
                f"{r['plain_ms']:.3f} ms, torch.matmul on dequantized bf16 "
                f"{r['library_ms']:.4f} ms; host enqueue "
                f"{r['host_us']:.0f} us per call")
    time_long_rows(gen, rows)
    for what, K, N, twin in SSM_QMM_TIMED:
        for bits in ((4, 8) if what == "mamba2 LM head" else (4,)):
            r = time_qmatmul(gen, 4, K, N, bits)
            t = time_qmatmul(gen, 4, K, twin, bits)
            rows[("qmatmul", bits, 4, K, N)] = r
            pitch = N * bits // 8
            say(f"[time] qmatmul W{bits} bf16 M=4 K={K} N={N} ({what}; code "
                f"rows of {pitch} B, {'a' if pitch % 16 == 0 else 'no'} "
                f"multiple of 16): kernel {r['ms']:.4f} ms, bound "
                f"{r['bound_ms']:.4f} ms ({r['bound_by']}, "
                f"{r['bytes'] / 1e6:.1f} MB), plain {r['plain_ms']:.3f} ms, "
                f"torch.matmul on dequantized bf16 {r['library_ms']:.4f} ms; "
                f"host enqueue {r['host_us']:.0f} us per call; N={twin} "
                f"(whole 128-column tiles, rows of {twin * bits // 8} B) "
                f"{t['ms']:.4f} ms, bound {t['bound_ms']:.4f} ms; {CARD}")
    for key, what, M, K, N, bits, twin in ENCDEC_VLM_QMM_TIMED:
        r = time_qmatmul(gen, M, K, N, bits)
        rows[key] = r
        pitch = N * bits // 8
        side = ""
        if twin:
            t = time_qmatmul(gen, M, K, twin, bits)
            side = (f"; N={twin} (whole 128-column tiles, rows of "
                    f"{twin * bits // 8} B) {t['ms']:.4f} ms, bound "
                    f"{t['bound_ms']:.4f} ms")
        say(f"[time] qmatmul W{bits} bf16 M={M} K={K} N={N} ({what}; code "
            f"rows of {pitch} B, {'a' if pitch % 16 == 0 else 'no'} "
            f"multiple of 16): kernel {r['ms']:.4f} ms, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}, "
            f"{r['bytes'] / 1e6:.1f} MB), plain {r['plain_ms']:.3f} ms, "
            f"torch.matmul on dequantized bf16 {r['library_ms']:.4f} ms; "
            f"host enqueue {r['host_us']:.0f} us per call{side}; {CARD}")
    for kv_bits in (8, 4):
        for ctx in (2048, 512):
            r = time_attention(gen, kv_bits, ctx)
            rows[("attn", kv_bits, ctx)] = r
            say(f"[time] paged_quant_attention kv{kv_bits} B=16 H=32 KV=8 "
                f"D=128 page=64 ctx={ctx} ({r['route']} body): kernel "
                f"{r['ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
                f"({r['bound_by']}, {r['bytes'] / 1e6:.1f} MB), plain "
                f"{r['plain_ms']:.3f} ms, SDPA on the gathered bf16 K/V "
                f"(reads 2x the coded bytes; gather and dequant not timed) "
                f"{r['library_ms']:.4f} ms; host enqueue {r['host_us']:.0f} "
                f"us per call")
    L = counts["train_layers"]
    for (G, R, C) in ((L, 4096, 12800), (L, 12800, 4096), (L, 4096, 4096),
                      (1, 4096, 49155)) + FAMILY_UNIQ_TIMED + MOE_UNIQ_TIMED:
        mixed = [2] if G == 1 else [m % 3 for m in range(G)]
        for modes in ([1] * G, mixed):
            r = time_uniq(gen, G, R, C, modes)
            rows[("uniq", G, R, C, tuple(modes))] = r
            for key in ("fwd", "bwd"):
                t = r[key]
                body = (f" ({t['route']} body; the flat body "
                        f"{t['flat_ms']:.4f} ms)" if key == "fwd" else "")
                shown = modes if G <= 8 else (
                    "all NOISE" if set(modes) == {1} else "mixed 1, 2, 0")
                say(f"[time] uniq_noise_{key} f32 G={G} R={R} C={C} modes "
                    f"{shown}{body}: kernel {t['ms']:.4f} ms, bound "
                    f"{t['bound_ms']:.4f} ms ({t['bound_by']}, "
                    f"{t['bytes'] / 1e6:.1f} MB), plain {t['plain_ms']:.3f} "
                    f"ms; host enqueue {t['host_us']:.0f} us per call; "
                    f"{CARD}")
    for (G, R, C), what, copies, by_value in (
            ((L, 4096, 12800), "granite w_up stack, row 7's shape", 1,
             False),
            ((3, 3 * 512, 512), "largest ResNet-18 conv, (3, 3, 512, 512)",
             4, True)):
        for m, label in ((1, "NOISE"), (2, "FROZEN"), (0, "CLEAN")):
            r = time_uniq_onchip(gen, G, R, C, [m] * G, copies, by_value)
            rows[("uniq_onchip", G, R, C, m)] = r
            say(f"[time] uniq_noise_fwd_onchip f32 G={G} R={R} C={C} "
                f"({what}), every group {label}, mode "
                f"{'by value' if by_value else 'as a (G,) tensor'} "
                f"({r['route']} body): kernel {r['ms']:.4f} ms, the flat "
                f"body {r['flat_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
                f"({r['bound_by']}, {r['bytes'] / 1e6:.1f} MB), plain "
                f"{r['plain_ms']:.3f} ms; uniq_noise_fwd (noise read as an "
                f"operand) on the same shape {r['host_fwd_ms']:.4f} ms; the "
                f"draw alone (Philox, f32 written) {r['e01_ms']:.4f} ms "
                f"against its {r['e01_bound_ms']:.4f} ms write bound; host "
                f"enqueue {r['host_us']:.0f} us per call")
    for (N, hd, what) in ((16, 128, "decode, 16 rows"),
                          (256, 128, "a prefill chunk"),
                          (16, 160, "decode, stablelm_12b's head_dim")):
        for kv_bits in (8, 4):
            r = time_kv_append(gen, N, 8, hd, kv_bits)
            rows[("kv_append", N, kv_bits, hd)] = r
            say(f"[time] kv_append kv{kv_bits} N={N} KV=8 hd={hd} bf16 "
                f"({what}): fused kernel {r['ms']:.4f} ms device, "
                f"{r['host_us']:.1f} us host; the eager append it replaced "
                f"{r['eager_ms']:.4f} ms device, {r['eager_host_us']:.1f} us "
                f"host; plain version {r['plain_ms']:.4f} ms device, "
                f"{r['plain_host_us']:.1f} us host; bound "
                f"{r['bound_ms'] * 1e3:.3f} us ({r['bound_by']}, "
                f"{r['bytes']} B)")
    for bits in (4, 8):
        for (M, K, N) in ((16, 4096, 12800), (16, 4096, 4096),
                          (16, 12800, 4096), (256, 4096, 12800)):
            if bits == 8 and M != 16:
                continue
            for name, fn in (("qmatmul_a8", time_qmatmul_a8),
                             ("qmatmul_lut", time_qmatmul_lut)):
                r = fn(gen, M, K, N, bits)
                rows[(name, bits, M, K, N)] = r
                lib = ("torch.matmul f32 on the f32 code x scale and the "
                       "dequantized f32 weight" if name == "qmatmul_a8" else
                       "torch.matmul on the dequantized bf16 weight")
                say(f"[time] {name} W{bits} M={M} K={K} N={N}: kernel "
                    f"{r['ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
                    f"({r['bound_by']}, {r['bytes'] / 1e6:.1f} MB), plain "
                    f"{r['plain_ms']:.3f} ms, {lib} {r['library_ms']:.4f} "
                    f"ms; host enqueue {r['host_us']:.0f} us per call")
    time_codec(gen, rows)
    time_experts(gen, rows)
    q = rows[("qmatmul", 4, 16, 4096, 12800)]
    a = rows[("attn", 8, 2048)]
    u = rows[("uniq", L, 4096, 12800, (1,) * L)]
    um, uz = (rows[("uniq", G, R, C, (1,) * G)]
              for (G, R, C) in FAMILY_UNIQ_TIMED)
    uk, ul = (rows[("uniq", G, R, C, (1,) * G)]
              for (G, R, C) in MOE_UNIQ_TIMED)
    q8 = rows[("qmatmul_a8", 4, 16, 4096, 12800)]
    ql = rows[("qmatmul_lut", 4, 16, 4096, 12800)]
    kw = rows[("kquantile", 1, 4096, 12800, 16)]        # W4: packed
    k8 = rows[("kquantile", 1, 4096, 12800, 256)]       # W8: int8
    ke = rows[("kquantile", 1, 16, 4096, 16)]           # embedding rows
    uo = rows[("uniq_onchip", L, 4096, 12800, 1)]
    ka = rows[("kv_append", 16, 8, 128)]

    def entry(name, source, replaces, r, **more):
        e = {"name": name, "route": "cuda", "source": source,
             "replaces": replaces, "launches": counts[name],
             "max_abs_err": errs[name], "ms": r["ms"],
             "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
             "bound_by": r["bound_by"], "library_ms": r["library_ms"]}
        for key, o in more.items():  # the same kernel at another shape
            e[key] = {k: o[k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
        return e

    return {"kernels": [
        entry("qmatmul", "src/repro_torch/kernels/csrc/qmatmul.cu",
              "src/repro/kernels/qmatmul.py:182", q,
              prefill_m256=rows[("qmatmul", 4, 256, 4096, 12800)],
              prefill_m16384=rows[("qmatmul", 4, 16384, 4096, 12800)],
              mamba2_in_proj_m4=rows[("qmatmul", 4, 4, 2048, 8512)],
              zamba2_in_proj_m4=rows[("qmatmul", 4, 4, 2560, 10448)],
              mamba2_head_m4=rows[("qmatmul", 4, 4, 2048, 50280)],
              mamba2_head_w8_m4=rows[("qmatmul", 8, 4, 2048, 50280)],
              **{key: rows[key] for key, *_ in ENCDEC_VLM_QMM_TIMED}),
        entry("paged_quant_attention",
              "src/repro_torch/kernels/csrc/paged_attn.cu",
              "src/repro/kernels/paged_attn.py:227", a,
              ctx512=rows[("attn", 8, 512)],
              kv4_ctx2048=rows[("attn", 4, 2048)],
              b4_ctx16384=rows[("attn", 8, 16384)],
              b4_ctx32768=rows[("attn", 8, 32768)]),
        entry("uniq_noise_fwd", "src/repro_torch/kernels/csrc/uniq_noise.cu",
              "src/repro/kernels/uniq_noise.py:123", u["fwd"],
              mamba2_in_proj=um["fwd"], zamba2_in_proj=uz["fwd"],
              kimi_eg16=uk["fwd"], llama4_eg8=ul["fwd"]),
        entry("uniq_noise_bwd", "src/repro_torch/kernels/csrc/uniq_noise.cu",
              "src/repro/kernels/ops.py:72", u["bwd"],
              mamba2_in_proj=um["bwd"], zamba2_in_proj=uz["bwd"],
              kimi_eg16=uk["bwd"], llama4_eg8=ul["bwd"]),
        entry("qmatmul_a8", "src/repro_torch/kernels/csrc/qmatmul.cu",
              "src/repro/kernels/qmatmul.py:316", q8),
        entry("qmatmul_lut", "src/repro_torch/kernels/csrc/qmatmul.cu",
              "src/repro/kernels/qmatmul.py:263", ql,
              prefill_m256=rows[("qmatmul_lut", 4, 256, 4096, 12800)]),
        entry("kquantile_quantize", "src/repro_torch/kernels/csrc/kquantile.cu",
              "src/repro/kernels/kquantile.py:86", kw["quantize"],
              w8_int8=k8["quantize"],
              embed_49155x4096=rows[("kquantile", 1, 49155, 4096, 16)][
                  "quantize"]),
        entry("kquantile_dequantize",
              "src/repro_torch/kernels/csrc/kquantile.cu",
              "src/repro/kernels/kquantile.py:97", ke["dequantize"],
              rows256=rows[("kquantile", 1, 256, 4096, 16)]["dequantize"],
              w8_4096x12800=k8["dequantize"]),
        entry("kquantile_dequantize_paged",
              "src/repro_torch/kernels/csrc/kquantile.cu",
              "src/repro/kernels/kquantile.py:67", rows[("paged", 8, 4)],
              b1=rows[("paged", 8, 1)], b8=rows[("paged", 8, 8)],
              kv4_b8=rows[("paged", 4, 8)]),
        entry("uniq_noise_fwd_onchip",
              "src/repro_torch/kernels/csrc/uniq_noise.cu",
              "src/repro/kernels/uniq_noise.py:153", uo,
              cnn_leaf=rows[("uniq_onchip", 3, 3 * 512, 512, 1)]),
        entry("kv_append", "src/repro_torch/kernels/csrc/kquantile.cu",
              "src/repro/kernels/kquantile.py:67", ka,
              kv4_decode=rows[("kv_append", 16, 4, 128)],
              prefill_n256=rows[("kv_append", 256, 8, 128)],
              hd160_decode=rows[("kv_append", 16, 8, 160)],
              hd160_kv4_decode=rows[("kv_append", 16, 4, 160)]),
        entry("qmatmul_experts", "src/repro_torch/kernels/csrc/qmatmul.cu",
              "src/repro/models/moe.py:102",
              rows[("experts", "kimi_k2_1t_a32b", "eg", 16)],
              kimi_ed_decode=rows[("experts", "kimi_k2_1t_a32b", "ed", 16)],
              kimi_eg_prefill256=rows[("experts", "kimi_k2_1t_a32b", "eg",
                                       256)],
              kimi_ed_prefill256=rows[("experts", "kimi_k2_1t_a32b", "ed",
                                       256)],
              kimi_eg_prefill512=rows[("experts", "kimi_k2_1t_a32b", "eg",
                                       512)],
              kimi_ed_prefill512=rows[("experts", "kimi_k2_1t_a32b", "ed",
                                       512)],
              kimi_eg_prefill1024=rows[("experts", "kimi_k2_1t_a32b", "eg",
                                        1024)],
              kimi_ed_prefill1024=rows[("experts", "kimi_k2_1t_a32b", "ed",
                                        1024)],
              llama4_eg_decode=rows[("experts", "llama4_maverick_400b_a17b",
                                     "eg", 16)],
              llama4_eg_prefill256=rows[("experts",
                                         "llama4_maverick_400b_a17b", "eg",
                                         256)],
              llama4_eg_prefill1024=rows[("experts",
                                          "llama4_maverick_400b_a17b", "eg",
                                          1024)]),
        entry("qmatmul_lut_experts", "src/repro_torch/kernels/csrc/qmatmul.cu",
              "src/repro/models/moe.py:102",
              rows[("lut_experts", "kimi_k2_1t_a32b", "eg", 16)],
              kimi_eg_prefill256=rows[("lut_experts", "kimi_k2_1t_a32b",
                                       "eg", 256)])]}


def profile_phase(cfg, seed: int, new_tokens: int):
    """Where an engine run spends its time: host side by cProfile, device
    side by torch.profiler (kernel time by name, busy share of the wall)."""
    import cProfile
    import io
    import pstats
    params = model.init(seed, cfg, device=DEV, w_bits=4,
                        dense_dtype=torch.bfloat16)
    opts = lm.ModelOpts(compute_dtype=torch.bfloat16)
    run_stream(params, cfg, opts, seed, 4)                    # warm-up
    prof = cProfile.Profile()
    prof.enable()
    eng, outs, wall, _ = run_stream(params, cfg, opts, seed, new_tokens)
    prof.disable()
    buf = io.StringIO()
    pstats.Stats(prof, stream=buf).sort_stats("tottime").print_stats(28)
    say(f"[profile] host (cProfile), stream wall {wall:.2f}s, "
        f"{eng.n_decode_steps} decode steps + {eng.n_prefill_calls} chunk "
        f"calls:")
    say(buf.getvalue())
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as tp:
        t0 = time.perf_counter()
        run_stream(params, cfg, opts, seed, 8)
        sync()
        wall = time.perf_counter() - t0
    events = tp.key_averages()
    # kernel rows only: an operator row repeats the time of its kernels
    dev_us = sum(e.self_device_time_total for e in events
                 if e.device_type == torch.autograd.DeviceType.CUDA)
    say(f"[profile] device busy {dev_us / 1e6:.3f}s of {wall:.3f}s wall "
        f"({100 * dev_us / 1e6 / wall:.1f}%) over a short stream")
    say(events.table(sort_by="self_device_time_total", row_limit=16,
                     max_name_column_width=60))
    decode_launches(params, cfg, opts)
    prefill_launches(params, cfg, opts)
    pool_read_launches()


MEASURED = "measured call"


def _device_ops(fn):
    """Device operations of one call of ``fn`` on the card, counted by
    torch.profiler after a warm-up call: ((kernels, memory copies /
    fills), {kernel name: launches})."""
    from torch.profiler import ProfilerActivity, profile, record_function
    fn()
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as tp:
        with record_function(MEASURED):
            fn()
            sync()
    ev = [e for e in tp.key_averages()
          if e.device_type == torch.autograd.DeviceType.CUDA
          and e.key != MEASURED]
    mem = sum(e.count for e in ev if e.key.startswith("Mem"))
    names = {e.key: e.count for e in ev if not e.key.startswith("Mem")}
    return (sum(names.values()), mem), names


def eager_prefill_attention_quant(q, cache, block_tables, q_pos, p, *,
                                  kv_bits, use_kernel=True):
    """``attention.paged_prefill_attention_quant`` as it was before the
    paged entry (``eager_pool_read`` for K and V): the comparison of the
    profile phase."""
    read = functools.partial(eager_pool_read, block_tables=block_tables,
                             kv_bits=kv_bits, dtype=q.dtype)
    k = read(cache["k_codes"], cache["k_mu"], cache["k_sigma"])
    v = read(cache["v_codes"], cache["v_mu"], cache["v_sigma"])
    k_pos = torch.arange(k.shape[1], device=q.device)
    return attn_lib.full_attention(q, k, v, q_pos, k_pos, p)


def prefill_launches(params, cfg, opts, B: int = 4, n_pages: int = 32):
    """Device operations of one prefill-chunk call (B sequences, their
    second page of 64 rows, tables of ``n_pages`` pages, kv8) with the
    paged pool read and with the eager read it replaced, in turns: paged,
    eager, eager, paged."""
    opts = dataclasses.replace(opts, kv_bits=8)
    page = 64
    cache = model.init_paged_cache(cfg, 1 + B * n_pages, page,
                                   torch.bfloat16, kv_bits=8, device=DEV)
    tables = torch.arange(1, 1 + B * n_pages, device=DEV,
                          dtype=torch.int32).reshape(B, n_pages)
    pos = (page + torch.arange(page, device=DEV))[None].expand(B, page)
    toks = torch.randint(0, cfg.vocab, (B, page), device=DEV)
    write_pages = tables[:, 1:2].to(torch.long).expand(B, page)
    write_rows = torch.arange(page, device=DEV)[None].expand(B, page)
    last = torch.full((B,), page - 1, device=DEV)
    paged = attn_lib.paged_prefill_attention_quant
    seen = {}
    try:
        for name in ("paged", "eager", "eager", "paged"):
            lm.attn.paged_prefill_attention_quant = paged \
                if name == "paged" else eager_prefill_attention_quant
            ops, names = _device_ops(lambda: model.prefill_chunk(
                params, cfg, opts, cache, toks, pos, write_pages, write_rows,
                tables, last))
            paged_seen = sum(n for k, n in names.items()
                             if "dequant_paged" in k)
            seen.setdefault(name, []).append((*ops, paged_seen))
    finally:
        lm.attn.paged_prefill_attention_quant = paged
    for name, what in (("paged", "the paged pool read"),
                       ("eager", "the eager read it replaced")):
        say(f"[profile] one prefill-chunk call, B={B} x {page} rows against "
            f"{n_pages} pages of {page}, {cfg.n_layers} layers, kv8, with "
            f"{what}: (kernels, memory copies / fills, of the kernels the "
            f"paged read's) per call {seen[name]}")
    del cache


def pool_read_launches(B: int = 4, n_pages: int = 32):
    """Device operations of one layer's prefill pool read (K and V) at the
    engine's pool geometry, with the paged entry and with the eager chain
    it replaced: the paged read must be its two kernels and nothing
    else."""
    gen = torch.Generator(device=DEV)
    gen.manual_seed(0)
    pools = [make_paged_pool(gen, B, n_pages, 64, 8, 128, 8)
             for _ in range(2)]
    tables = pools[0][3]
    reads = {"paged": lambda c, m, s: kq.kquantile_dequantize_paged(
                 c, m, s, tables, kv_bits=8),
             "eager": lambda c, m, s: eager_pool_read(c, m, s, tables, 8)}
    seen = {}
    for name, read in reads.items():
        before = kops.launch_counts()
        ops, names = _device_ops(lambda: [read(*p[:3]) for p in pools])
        counted = {k: n - before[k] for k, n in kops.launch_counts().items()
                   if n != before[k]}
        seen[name] = (ops, names, counted)
        say(f"[profile] one layer's prefill pool read (K and V), B={B} x "
            f"{n_pages} pages of 64, KV 8, hd 128, kv8, {name}: (kernels, "
            f"memory copies / fills) {ops}; kernels by name {names}; "
            f"wrapper launches over the warm-up and the profiled call "
            f"{counted}")
    # the profiled call launches the paged kernel twice and nothing else:
    # no gather, cast or copy around it
    ops, names, counted = seen["paged"]
    if ops[1] or any("dequant_paged" not in k for k in names) \
            or sum(names.values()) not in (0, 2) \
            or counted != {"kquantile_dequantize_paged": 4}:
        raise SystemExit("the paged pool read launched more than its two "
                         "kernels")


def decode_launches(params, cfg, opts, B: int = 16, ctx: int = 100):
    """Device operations (kernels, and copies / fills) of one decode step
    of B sequences on a kv8 pool, counted by torch.profiler, with the fused
    KV append and with the eager append it replaced (``eager_write_rows``
    in place of ``lm._write_rows``), in turns: fused, eager, eager, fused."""
    from torch.profiler import ProfilerActivity, profile
    opts = dataclasses.replace(opts, kv_bits=8)
    page = 64
    n_pages = ctx // page + 1
    cache = model.init_paged_cache(cfg, 1 + B * n_pages, page,
                                   torch.bfloat16, kv_bits=8, device=DEV)
    tables = torch.arange(1, 1 + B * n_pages, device=DEV,
                          dtype=torch.int32).reshape(B, n_pages)
    toks = torch.arange(B, device=DEV)[:, None]
    pos = torch.full((B,), ctx, device=DEV)
    fused = lm._write_rows
    seen = {}
    try:
        for name in ("fused", "eager", "eager", "fused"):
            lm._write_rows = fused if name == "fused" else eager_write_rows
            model.decode(params, cfg, opts, cache, toks, pos,
                         block_tables=tables)                 # warm-up
            sync()
            with profile(activities=[ProfilerActivity.CUDA]) as tp:
                model.decode(params, cfg, opts, cache, toks, pos,
                             block_tables=tables)
                sync()
            ev = [e for e in tp.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
            mem = sum(e.count for e in ev if e.key.startswith("Mem"))
            seen.setdefault(name, []).append(
                (sum(e.count for e in ev) - mem, mem))
    finally:
        lm._write_rows = fused
    for name, what in (("fused", "the fused kv_append"),
                       ("eager", "the eager append it replaced")):
        say(f"[profile] one decode step, B={B}, {cfg.n_layers} layers, kv8, "
            f"with {what}: (kernels, memory copies / fills) per step "
            f"{seen[name]}")
    del cache


def a8_against_exact(gen):
    """``qmatmul_a8`` (h alone, d + l in a second accumulator) and its plain
    version held against the exact sum (f64, the factored form of the same
    f32 inputs), and against each other."""
    for (M, K, N, bits) in ((16, 4096, 12800, 4), (256, 4096, 12800, 4),
                            (16, 4096, 12800, 8), (16, 12800, 4096, 4)):
        _, w, mu, sigma = make_qmm_inputs(gen, 1, K, N, bits, torch.float32)
        codes, scale = make_a8_inputs(gen, M, K)
        k = 2 ** bits
        wc = packing.unpack_int4(w) if bits == 4 else w
        t = kref.level_table(k, DEV).double()[wc.long() + kref.code_offset(k)]
        c = codes.double()
        exact = scale.double() * (mu.double() * c.sum(1, keepdim=True)
                                  + sigma.double() * (c @ t))
        plain = qmm.qmatmul_a8_plain(codes, scale, w, mu, sigma, bits=bits)
        two = qmm.qmatmul_a8(codes, scale, w, mu, sigma, bits=bits)
        sync()
        res = {name: ((o.double() - exact).abs().max().item(),
                      (o.double() - plain.double()).abs().max().item())
               for name, o in (("kernel", two), ("plain", plain))}
        say(f"[sweep] qmatmul_a8 W{bits} M={M} K={K} N={N} max abs err vs "
            f"the exact sum / vs the plain version: " + "; ".join(
                f"{n} {e:.3e} / {q:.3e}" for n, (e, q) in res.items())
            + f" (max |out| {exact.abs().max().item():.3f})")


def sweep_phase(gen):
    """Times over the tuning axes, for choosing the defaults."""
    for (M, K, N) in ((16, 4096, 12800), (16, 4096, 4096), (16, 4096, 1024),
                      (16, 12800, 4096), (64, 4096, 12800),
                      (128, 4096, 12800), (256, 4096, 12800),
                      (512, 4096, 4096)):
        n_copies = max(2, math.ceil(120e6 / (K * N / 2)))
        sets = []
        for _ in range(n_copies):
            a, w, mu, sigma = make_qmm_inputs(gen, M, K, N, 4, torch.bfloat16)
            sets.append((a, w, mu, sigma, make_lut(gen, N, 4, False)))
        entries = [("qmatmul", lambda s, **kw: qmm.qmatmul(*s[:4], **kw))]
        if (M, K, N) in ((16, 4096, 12800), (256, 4096, 12800)):
            entries.append(("qmatmul_lut", lambda s, **kw: qmm.qmatmul_lut(
                s[0], s[1], s[4], **kw)))
        for name, fn in entries:
            for bm in ((16, 32) if M <= 32 else (32, 64, 128)):
                for splitk in (1, 2, 4, 8, 16):
                    ms = time_ms([lambda s=s: fn(
                        s, bits=4, out_dtype=torch.bfloat16,
                        blocks=qmm.BlockConfig(bm=bm), splitk=splitk)
                        for s in sets])
                    say(f"[sweep] {name} W4 bf16 M={M} K={K} N={N} bm={bm} "
                        f"splitk={splitk}: {ms:.4f} ms (default bm "
                        f"{qmm.default_blocks(M).bm}, splitk "
                        f"{qmm.default_splitk(K, N)})")
        del sets
    K, N = 4096, 12800
    for M in (16, 256):
        n_copies = max(2, math.ceil(120e6 / (K * N / 2)))
        sets = []
        for _ in range(n_copies):
            _, w, mu, sigma = make_qmm_inputs(gen, 1, K, N, 4, torch.float32)
            sets.append((*make_a8_inputs(gen, M, K), w, mu, sigma))
        for bm in ((16, 32) if M <= 32 else (16, 32, 64)):
            for splitk in (1, 2, 4, 8, 16):
                ms = time_ms([lambda s=s: qmm.qmatmul_a8(
                    *s, bits=4, out_dtype=torch.bfloat16,
                    blocks=qmm.BlockConfig(bm=bm), splitk=splitk)
                    for s in sets])
                say(f"[sweep] qmatmul_a8 W4 M={M} K={K} N={N} bm={bm} "
                    f"splitk={splitk}: {ms:.4f} ms (default bm "
                    f"{qmm.default_blocks(M, a8=True).bm}, splitk "
                    f"{qmm.default_splitk(K, N)})")
        del sets
    a8_against_exact(gen)
    attention_sweep(gen)


def attention_sweep(gen):
    """The tensor-core attention body over its split count, beside the
    CUDA-core body, at the engine's heads and page (kv8, bf16 queries); the
    default split count is ``tc_splits``."""
    g = dict(B=16, H=32, KV=8, D=128, page=64, n_pages=32)
    for B in (8, 16):
        for ctx in (2048, 512, 128):
            sets = [make_attn_inputs(gen, kv_bits=8, q_dtype=torch.bfloat16,
                                     q_pos=[ctx - 1] * B, **dict(g, B=B))
                    for _ in range(3)]
            default = pa.tc_splits(B, g["n_pages"], g["page"],
                                   loader.sm_count(DEV))
            t = sets[0]
            want = attn_call(pa.paged_quant_attention_plain, t, kv_bits=8)
            for route in (pa.CUDA_CORE, pa.TENSOR_CORE):
                body = functools.partial(pa._launch, route, kv_bits=8,
                                         window=pa.BIG_WINDOW,
                                         logit_cap=None, splits=None)
                err = (attn_call(body, t).float() - want.float()).abs() \
                    .max().item()
                ms = time_ms([lambda t=t: attn_call(body, t) for t in sets])
                say(f"[sweep] attention kv8 bf16 B={B} ctx={ctx} {route} "
                    f"body, default splits: {ms:.4f} ms, max abs err vs "
                    f"plain {err:.3e}")
            for splits in sorted({4, 8, 16, default, 2 * default}):
                body = functools.partial(pa._launch, pa.TENSOR_CORE,
                                         kv_bits=8, window=pa.BIG_WINDOW,
                                         logit_cap=None, splits=splits)
                ms = time_ms([lambda t=t: attn_call(body, t) for t in sets])
                say(f"[sweep] attention kv8 B={B} ctx={ctx} tensor_core "
                    f"splits={splits}: {ms:.4f} ms (default {default})")
            del sets


# --------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--layers", type=int, default=40,
                    help="depth of the full-width model (default: all 40)")
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--train-layers", type=int, default=8,
                    help="depth of the full-width train run (default 8: "
                         "f32 AdamW state for all 40 exceeds 80 GB)")
    ap.add_argument("--train-steps", type=int, default=10)
    ap.add_argument("--train-vlm-layers", type=int, default=4,
                    help="depth of pixtral_12b in phase 6b (default 4 of "
                         "40: its f32 AdamW state at 4 layers is ~39 GB, "
                         "its embedding and head ~1.34 B parameters)")
    ap.add_argument("--moe-layers", type=int, default=4,
                    help="depth of the full-width MoE models of phase 4c "
                         "(default 4: ~35 GB of W4 expert codes at "
                         "kimi_k2; all 61 would be ~500 GB)")
    ap.add_argument("--quick", action="store_true",
                    help="build + a reduced kernel check, then stop")
    ap.add_argument("--sweep", nargs="?", const="all",
                    choices=("all", "attention", "codec"),
                    help="build, time the tuning axes (all kernels, the "
                         "attention body alone, or the codec kernels at "
                         "their shapes), then stop")
    ap.add_argument("--profile", action="store_true",
                    help="build, profile an engine run (host and device), "
                         "then stop")
    ap.add_argument("--long", action="store_true",
                    help="build, run phase 4L alone (the long-context engine "
                         "on a fresh granite load, its chunked-vs-whole and "
                         "training checks, the empirical train step, its "
                         "phase 7 rows), then stop")
    ap.add_argument("--analysis", action="store_true",
                    help="build, run phase 4M alone (the model checker, its "
                         "replays on a fresh granite_3_8b W4 load, the check "
                         "CLI's four passes, the examples), then stop")
    ap.add_argument("--ptxas", action="store_true",
                    help="print ptxas' register / shared-memory report")
    args = ap.parse_args(argv)

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    say(f"[device] torch {torch.__version__}, CUDA {torch.version.cuda}; "
        f"{kind}; {torch.cuda.device_count()} device(s)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        and smi.stdout.strip() else f"{kind}, power limit unknown"
    global CARD
    CARD = card

    nvcc = subprocess.run([loader.find_nvcc(), "--version"],
                          capture_output=True, text=True, timeout=60)
    try:
        from importlib.metadata import version
        triton_version = version("triton")
    except Exception:                   # not installed: nothing here needs it
        triton_version = "not installed"
    say(f"[device] nvcc: {nvcc.stdout.strip().splitlines()[-2:]}; triton "
        f"{triton_version} (not used by this package); {card}")

    t0 = time.perf_counter()
    took = loader.build_all(
        extra_flags=("-Xptxas", "-v") if args.ptxas else (),
        verbose=args.ptxas)
    if args.ptxas:
        loader.build_all()
    say(f"[build] nvcc -gencode arch=compute_90a,code=sm_90a into "
        f"{loader.build_dir()}: " + ", ".join(
            f"{n} {s:.1f}s" for n, s in took.items())
        + f"; set-up time {time.perf_counter() - t0:.1f}s")

    gen = torch.Generator(device=DEV)
    gen.manual_seed(args.seed)
    if args.sweep:
        if args.sweep == "attention":
            attention_sweep(gen)
        elif args.sweep == "codec":
            time_codec(gen, {})
        else:
            sweep_phase(gen)
        say(card)
        say("sweep run: stopped after the tuning sweep")
        return 0
    if args.profile:
        profile_phase(dataclasses.replace(cb.get("granite_3_8b"),
                                          n_layers=args.layers), args.seed,
                      args.new_tokens)
        say(card)
        say("profile run: stopped after the profile")
        return 0
    art = tempfile.TemporaryDirectory(prefix="chip_smoke_")
    if args.analysis:
        cfg = dataclasses.replace(cb.get("granite_3_8b"),
                                  n_layers=args.layers)
        params = model.init(args.seed, cfg, device=DEV, w_bits=4,
                            dense_dtype=torch.bfloat16)
        analysis_phase(params, cfg)
        art.cleanup()
        say(f"[time] analysis run done at "
            f"{time.perf_counter() - t_start:.0f}s")
        say(card)
        say("analysis run: stopped after phase 4M")
        return 0
    if args.long:
        cfg = dataclasses.replace(cb.get("granite_3_8b"),
                                  n_layers=args.layers)
        params = model.init(args.seed, cfg, device=DEV, w_bits=4,
                            dense_dtype=torch.bfloat16)
        long_context_phase(params, cfg, args.seed, args.new_tokens, art.name)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        long_family_checks(args.seed)
        long_train_check(args.seed)
        empirical_train_check(args.seed)
        time_long_rows(gen, {})
        art.cleanup()
        say(f"[time] long run done at {time.perf_counter() - t_start:.0f}s")
        say(card)
        say("long run: stopped after phase 4L")
        return 0
    errs = {"qmatmul": check_qmatmul(gen, args.quick),
            "paged_quant_attention": check_attention(gen, args.quick)}
    errs["uniq_noise_fwd"], errs["uniq_noise_bwd"] = check_uniq(
        gen, args.quick, args.train_layers)
    errs["uniq_noise_fwd_onchip"] = check_uniq_onchip(gen, args.quick,
                                                      args.train_layers)
    errs.update(check_qmatmul_variants(gen, args.quick))
    errs["kquantile_quantize"] = errs["kquantile_dequantize"] = \
        check_kquantile(gen, args.quick)
    errs["kquantile_dequantize_paged"] = check_paged_dequant(gen, args.quick)
    errs["kv_append"] = check_kv_append(gen, args.quick)
    errs.update(check_qmatmul_experts(gen, args.quick))
    say("[kernels] max abs err vs plain versions: " + ", ".join(
        f"{n} {e:.3e}" for n, e in errs.items()))
    if args.quick:
        say(card)
        say("quick run: stopped after the kernel checks")
        return 0

    cfg = cb.get("granite_3_8b")
    if args.layers != cfg.n_layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    # three engines one after another, each freed before the next; every
    # count is read from its own run (reset just before it): a matmul
    # kernel's from the engine that serves through it, the attention's from
    # the W4 engine, the codecs' summed over the three runs (the quantize
    # kernel's over their loads: the stream appends KV rows by kv_append)
    counts = {c: 0 for c in CODECS}
    for i, mode in enumerate(ENGINE_MODES):
        params, opts, outs, run_counts = engine_phase(
            cfg, args.seed, args.new_tokens, mode,
            art.name if i == 0 else None)
        plain_phase(params, cfg, opts, outs, args.seed, args.new_tokens,
                    mode)
        counts[mode["matmul"]] = run_counts[mode["matmul"]]
        for c in CODECS:
            counts[c] += run_counts[c]
        if i == 0:
            counts["paged_quant_attention"] = \
                run_counts["paged_quant_attention"]
            # phase 4L on the W4 engine's coded weights; its counted run's
            # launches join the kernels line's
            say(f"[time] phase 4 (W4) done at "
                f"{time.perf_counter() - t_start:.0f}s")
            long_counts = long_context_phase(params, cfg, args.seed,
                                             args.new_tokens, art.name)
            for c, n in long_counts.items():
                if n:
                    counts[c] = counts.get(c, 0) + n
            say(f"[time] phase 4L engine done at "
                f"{time.perf_counter() - t_start:.0f}s")
            # phase 4M on the same coded weights; its healthy replays'
            # launches join the kernels line's too
            mc_counts, audit_table = analysis_phase(params, cfg)
            for c, n in mc_counts.items():
                if n:
                    counts[c] = counts.get(c, 0) + n
            say(f"[time] phase 4M done at "
                f"{time.perf_counter() - t_start:.0f}s")
        del params, opts, outs
        gc.collect()            # an engine holds reference cycles: free its
        torch.cuda.empty_cache()  # pool before the next one is made
    long_family_checks(args.seed)
    say(f"[time] phase 4L done at {time.perf_counter() - t_start:.0f}s")
    small_reference_phase(args.seed)
    say(f"[time] phases 1-5 done at {time.perf_counter() - t_start:.0f}s")
    closed_batch_phase(args.seed)
    slot_phase(cfg, args.seed, args.new_tokens)
    say(f"[time] phase 5b done at {time.perf_counter() - t_start:.0f}s")
    # the state-space families' closed batch at full width (phase 5d); its
    # counted runs' matmul and codec launches join the kernels line's
    ssm_counts = ssm_phases(args.seed)
    for c in ("qmatmul", "qmatmul_lut", "kquantile_dequantize",
              "kquantile_quantize"):
        counts[c] = counts.get(c, 0) + ssm_counts[c]
    say(f"[time] phase 5d done at {time.perf_counter() - t_start:.0f}s")
    # the audio and vlm families' closed batch at full width (phase 5e);
    # its counted runs' launches join the kernels line's as 5d's do
    ev_counts = encdec_vlm_phases(args.seed)
    for c in ("qmatmul", "qmatmul_lut", "kquantile_dequantize",
              "kquantile_quantize"):
        counts[c] += ev_counts[c]
    say(f"[time] phase 5e done at {time.perf_counter() - t_start:.0f}s")
    # the MoE family at full width, one model after another (each freed
    # before the next), after the dense serving phases so that their
    # host-bound readings keep the conditions of earlier runs; the count of
    # qmatmul_experts is summed over its counted runs (kimi_k2's and
    # llama4's streams, kimi_k2's closed batch)
    moe_counts = moe_phases(args.seed, args.new_tokens, args.moe_layers)
    counts["qmatmul_experts"] = moe_counts["qmatmul_experts"]
    counts["qmatmul_lut_experts"] = moe_counts["qmatmul_lut_experts"]
    counts["qmatmul_lut"] += moe_counts["qmatmul_lut"]
    say(f"[time] phase 4c done at {time.perf_counter() - t_start:.0f}s")
    train_counts, _ = train_phase(args.seed, args.train_layers,
                                  args.train_steps)
    torch.cuda.empty_cache()
    # phase 4L's training step at 8,192 rows and the empirical step; their
    # launches join the LM trainer's
    for extra in (long_train_check(args.seed),
                  empirical_train_check(args.seed)):
        for c, n in extra.items():
            train_counts[c] += n
    small_train_phase(args.seed)
    cnn_counts, _ = cnn_phase(args.seed, CNN_STEPS)
    small_cnn_phase(args.seed)
    say(f"[time] phase 6 done at {time.perf_counter() - t_start:.0f}s")
    # the state-space, audio and vlm trainers (phase 6b); their steps'
    # launches join the LM trainer's in the kernels line
    family_counts = family_train_phases(args.seed, args.train_vlm_layers)
    say(f"[time] phase 6b done at {time.perf_counter() - t_start:.0f}s")
    # the MoE trainers (phase 6c); their steps' launches join the others'
    moe_train_counts = moe_train_phases(args.seed)
    counts = dict(counts, uniq_noise_fwd=sum(
        c["uniq_noise_fwd"] for c in (train_counts, family_counts,
                                      moe_train_counts)),
                  uniq_noise_bwd=sum(
        c["uniq_noise_bwd"] for c in (train_counts, family_counts,
                                      moe_train_counts)),
                  uniq_noise_fwd_onchip=cnn_counts["uniq_noise_fwd_onchip"],
                  train_layers=args.train_layers)
    say(f"[time] phase 6c done at {time.perf_counter() - t_start:.0f}s")
    line = timing_phase(gen, counts, errs)
    # phase 4M's audit figures beside each kernel's times
    for e in line["kernels"]:
        row = audit_table.get(e["name"])
        if row is None:
            raise SystemExit(f"the kernel audit has no case of {e['name']}")
        e["audit"] = {k: row[k] for k in (
            "static_smem", "dynamic_smem", "regs", "local_bytes",
            "blocks_per_sm", "instantiations")}
    say(f"[time] phase 7 done at {time.perf_counter() - t_start:.0f}s")
    art.cleanup()

    say(card)
    say(json.dumps(line))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
