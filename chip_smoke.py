"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's two build paths at the GW workload's full width
(N = 10,000 frequencies, complex64, max_k = 100, M = 131,072 TaylorF2
snapshots: 10.5 GB of S on the card) — the paper's RB-greedy build, then
the artifact and the ROQ online stage, then the blocked build
(``strategy="block_greedy"``, block_p = 8), the streamed and randomized
builds up to the paper's M = 3,276,800 — then the LM serving paths
(granite-3-8b, stablelm-3b and starcoder2-15b whole, launch.serve's LM
mode, mixtral-8x7b at 16 of its 32 layers, recurrentgemma-9b,
mamba2-780m, llama-3.2-vision-11b and seamless-m4t-medium at full width,
their prefill self-attention in the flash kernel, the encoder's
bidirectional), then trains stablelm-3b at full width, and holds each
hand-written kernel against its plain PyTorch version.  Phases, each one
JSON line:

  env        torch / CUDA versions and the card
  build      seconds to build the CUDA kernels (nvcc, at first use)
  roofline   the "auto" strategy's machine model measured on the card
             through its raw calibration functions (an exception fails
             the run): the greedy_update sweep's GB/s (1,500-3,350), a
             512^3 float32 GEMM's GFLOP/s, the L2 cliff of the llc_probe
             working-set sweep (8-64 MB; one launch a timed call) beside
             the L2 size torch reports, each working set's rate
  kernels    each kernel vs its plain version at the paths' shapes and at
             small ragged ones, with the tolerance of each check, each call
             on the route its wrapper's rule gives and, for greedy_update,
             imgs_project, imgs_panel, roq_apply and taylorf2_tile, on their
             general routes too (two launches bitwise equal; roq_apply's
             sm90 kernel bitwise its general one, taylorf2_tile's too
             unnormalized; a tile's columns bitwise those of a wider tile
             and of a strided slice); both routes of greedy_update and
             imgs_project with a false active flag on NaN-filled S / Q (the
             zero-vector result exactly: the kernel never read them) and a
             true one (bitwise the unflagged call); times of the kernel,
             the plain version and the one-call library yardstick (CUDA
             events, best of n, the card's time alone: the host has issued
             a call before the card reaches it), with the routes of a
             wrapper timed in turns, and the bound; sketch_omega at the
             randomized path's block (65,536 x 110 complex64, both kinds)
             and at 288 ragged cases (m 1 / 7 / 4,097, ell 1 / 25, the four
             types, seeds 0 / 7 / 2^40 + 3, tiles 0 / 49): rademacher
             bitwise, gaussian within 1e-5 (float32) / 1e-10 (float64) of
             max(1, |omega|), two launches bitwise; the fold and co-range
             GEMMs of one paper tile, the column norms, the SVD and the thin
             QRs a pass runs; column_norms bitwise its plain tree at the
             four types, N 1 / 2 / 3 / 313 / 9,999 / 10,001, widths off a
             CTA's columns, column slices and a transposed view, at the
             paths' tile (a 65,536-column slice of S) and on the whole S;
             llc_probe against its plain loop of dots, one launch a call;
             greedy_update_lanes (the B-lane sweep) against its plain
             version and, lane by lane, bitwise the scalar sm90 kernel, at
             the four types, B 1 / 3 / 16 / 17, ragged N and M, shared and
             stacked, masked lanes and every lane masked on NaN S and q;
             timed at the GW S shared for B 1, 2, 4, 8, 16 and stacked as
             (8, 1,250, 131,072), beside the plain version and
             torch.matmul / torch.bmm
  snapshots  generation of S on the card, every taylorf2_tile launch on the
             sm90 route
  build_basis  the full-width greedy build through the front door;
             launches of each kernel (counted from 0 just before it), every
             greedy_update and imgs_project launch on the sm90 route, the
             sweeps that read S (the steps up to the latched stop: the
             later ones' flags are false), orthogonality and
             per-column-error checks
  artifact   save/load bit-equality, EIM nodes
  roq        16 ROQ inner products against full quadrature
  paper      the paper's oracles on complex128 cuts of the same grid (N
             10,000, 2,048 columns at a stride of 64): POD's error
             identities (Thm 3.2), the optimal RRQR (Thm 5.1), pivoted MGS
             against RB-greedy on unnormalized snapshots (Prop. 5.3), the
             reconstruction's bound (Thm 5.11), rb_greedy_scan against
             rb_greedy; every greedy_update and imgs_project launch of the
             scan and the reconstruction on the sm90 route; then MGS through
             the front door on the full-width S (max_k 100): its wall beside
             the greedy build's, its peak memory, its sampled error
  randomized_cut  the range-finder on the same complex128 cut (max_k 100,
             sketch_p 10, 512-column tiles), power 0 and 1 within the
             reference test's bound on POD's tail, power 1's leading ten
             estimates within 1e-3 of POD's sigma, one sketch_omega launch a
             tile; sketch+greedy on the cut from a power-0 sketch with no
             oversampling (k0 94 of max_k 100): launches counted from 0
             just before it, at least one refinement sweep, one
             greedy_update launch a tile a sweep and every imgs_project
             launch on the sm90 route, every column within tau
  roq_serve  the full-width greedy basis and the cut's greedy basis saved
             as artifacts and served by launch.serve's basis mode (4,096
             requests, max_batch 64, max_wait 2 ms), launches counted from 0
             just before it, every roq_apply launch on the sm90 route:
             every answer resolved and bitwise its direct evaluation, no
             death, breaker or rejection, the error within the launcher's
             tolerance; roq_apply's two routes timed per bucket (complex64
             and complex128) beside torch.matmul, and the widths at which
             torch.matmul's columns change their bits (why the apply is a
             kernel)
  block_build  the full-width blocked build through the front door, with
             the bases freed first; launches counted from 0 just
             before it, every imgs_panel and imgs_project launch on the
             sm90 route, the same checks, k within the staleness bound
  auto       the front door with no strategy on the resident S: (a) the
             default call on the measured roofs, bitwise the named
             strategy's build; (c) max_k None (the rank estimate's outcome,
             the choice, k, stop and sampled error reported); (e)
             sketch_power 3, where the rule picks block_greedy at block_p 8
             (bitwise the named build, its quality reported); (d) a 1 GiB
             budget with roofs pinned not roof-bound: "streamed" at
             block_p 1, bitwise strategy="streamed"
  batched_shared  a tau sweep through the front door: strategy="batched"
             on the resident S at 8 taus above its float32 floor (between
             the greedy build's last 9 errors, max_k 100: 8 distinct bases,
             each stopped on tau), launches
             counted from 0 just before it, beside the 8 scalar
             strategy="greedy" builds: every lane bitwise its scalar build
             (Q, R, pivots, errs, rnorms, pass counts, k, stop), one
             greedy_update_lanes launch a lockstep round, no scalar
             greedy_update launch, one column_norms launch (and those of
             any lane's refresh), each lane's sampled error within 1.5x its
             last; the two walls and the GB of S each read
  batched_stacked  band_split(S, 8) (the full FFT of each column: 8 bands
             of 1,250 bins) built the same way at tau 1e-4 beside the 8
             scalar builds of the bands, with the same gates (a
             column_norms launch a band); the set saved and loaded
             bitwise, registered with a BasisRouter, one request a band
             served by a ROQEngine, bitwise its direct evaluation
  distributed  the column-distributed greedy (the paper's Sec. 6 system)
             on the same S through the front door with a mesh: (a) one
             rank in this process over NCCL ("auto" with a mesh picks
             "distributed"), the greedy path's checks, every greedy_update
             and imgs_project launch on the sm90 route, its pivots the
             greedy build's on the shared prefix and its errs bitwise up to
             the first refresh; the blocked one (block_p 8) beside it; (b)
             four ranks spawned on the same card over gloo, each
             generating its 32,768 columns with taylorf2_tile: k, stop,
             pivots, errs and Q bitwise (a)'s, launches counted from 0 on
             each rank and summed; a step taken apart (sweep and GS by
             CUDA events, the exchange and the column fetch on the host's
             clock) on (a) and on each rank; (c) their blocked build: k and
             pivots (a)'s blocked ones; (d) a 4-rank build checkpointed
             after two chunks and resumed on 2 ranks: k, stop, pivots and
             errs bitwise (b)'s
  streamed   the streamed driver over generated tiles at M 131,072, bitwise
             the resident build at two tilings and after a crash and
             resume; a pinned host provider's pivots those of the resident
             build of the same columns
  streamed_paper, streamed_paper_blocked  the paper's M = 3,276,800 (S
             never formed), stepwise then block_p 8; every generator launch
             on the sm90 route, one generation of each tile a pass; the
             stepwise basis sampled within 100 tau
  randomized_resume  a sketch over generated tiles at M 131,072 killed
             mid-pass (phase 0 at power 0, the odd phase at power 1) and
             resumed: Y, sigma_hat, k, Q and the norms bitwise
  randomized_paper, randomized_paper_sketch_greedy  the paper's M through
             strategy="randomized" at power 0 and 1 (launches counted from
             0 just before each: sketch_omega once a tile, taylorf2_tile
             once a tile a pass, all sm90), then strategy="sketch+greedy"
             with tau between power 0's 90th and 91st estimates; the
             sampled error of each basis, the last within 100 tau; then
             auto (b), the default call at the paper's M: "randomized",
             the source never materialized, bitwise the power-0 basis

  lm_kernels  flash_attention's two kernels vs the plain version at the
             serve path's shape (B 4, Hq 32, Hkv 8, S 2048, D 128, bf16,
             causal), at each family cell's (FAMILY_CELLS: the windows of
             mixtral and recurrentgemma, llama-3.2-vision's GQA 32/8,
             seamless-m4t's decoder at D 64 causal over 256 tokens and its
             encoder non-causal, MHA 16/16 at D 64 over 4,096 frames) and
             at small ones (f32/bf16/f16, D 16-256, groups 1/4/8/16,
             windows 40-256 inside and across key tiles, non-causal, ragged
             S, Sq < Skv, non-causal D 64 on whole tiles, D 80 / 96 causal,
             windowed and non-causal), each with near-uniform and with
             peaked logits, each call on the route the rule gives (the
             general kernel also at the sm90 kernel's shapes); stablelm-3b's
             D 80 (MHA 32/32) at its serve cell's (4 x 2,048) and the
             pipeline's (2 x 2,048) shapes, and D 96 at the first, on the
             sm90 route, both routes at both logit scales; at the serve
             path's shape, at the encoder's and at those three the sm90
             kernel and the general one (the first design) timed in turns
             beside the plain version and SDPA (causal / not), with TFLOP/s
             and the share of the bound
  serve      granite-3-8b at full width (bf16, attn_impl="flash", random
             weights from the seed, initialized on the card, the GW S freed
             first): ServeEngine.generate on 4 prompts of 2048 tokens, 32
             new tokens each; launches counted from 0 just before it, all
             40 flash launches on the sm90 route; prefill logits against
             the einsum (plain) path, two greedy runs equal, every logit
             finite
  serve_stablelm, serve_starcoder2  the other dense cells (DENSE_CELLS),
             whole, with serve_moe's gates below: stablelm-3b (32 layers,
             MHA 32/32, D 80) on 4 prompts of 2,048 tokens, starcoder2-15b
             (40 layers, GQA 48/4, 31.9 GB) on 4 of 4,096, 32 new tokens
             each; 32 / 40 flash launches, all sm90; the float32 decode
             check on stablelm whole and on starcoder2 cut to 8 of its 40
             layers (its bf16 model freed first: the float32 copy would
             not fit beside it); the busy share of a traced prefill and 8
             traced decode steps; starcoder2 again with
             kv_cache_dtype="int8": the prefill's int8 planes and bf16
             scales the quantization of the bf16 cache's k / v (within
             one int8 step, scales within a bf16 eps), 32 decode steps fed
             the bf16 run's tokens, every logit finite and within
             INT8_DECODE_RTOL of the bf16 cache's, cache bytes against the
             bf16 cache's, decode ms beside the bf16 cache's
  launcher   python -m repro_torch.launch.serve --arch stablelm-3b
             --device cuda (the LM mode at full width, its default batch,
             prompt and new tokens) in a subprocess: exit 0, its
             "generated (4, 16) on cuda:..." line, its sample the tokens
             of ServeEngine in this process from the same seed and config
  serve_moe, serve_hybrid, serve_ssm  the decoder-only families, each
             model freed before the next (FAMILY_CELLS): mixtral-8x7b at 16
             of its 32 layers (47 GB; whole it would not fit) on 2 prompts
             of 6,144 tokens, recurrentgemma-9b on 4 of 4,096, mamba2-780m
             on 4 of 4,096, 32 new tokens each, through
             ServeEngine.generate; launches counted from 0 just before it:
             16 / 12 / 0 flash launches, all sm90; two greedy runs equal,
             in-place and functional decode equal, every logit finite; the
             forward at every prompt position, flash against
             attn_impl="chunked", within 8 bf16 eps a row (moe: each
             layer's attention output on the same input, its routing flips
             cascading through a whole forward; ssm: bitwise); ssm and
             hybrid decode steps 1, 8 and 32 against the prefill over the
             prompt plus the tokens fed, gated in float32 on the first
             prompt (bf16 reported); weight GB, prefill ms and tok/s,
             decode ms a token beside
             its weight-read bound (moe: the experts chosen in the step),
             the share of (token, choice) pairs dropped at capacity (moe),
             peak memory, the card's name and power limit
  serve_vlm, serve_encdec  the cross-attention families, the same way
             and with the same gates: llama-3.2-vision-11b whole (20.2 GB)
             on 4 prompts of 2,048 tokens, each with 1,600 vision tokens of
             width 1,280, and seamless-m4t-medium whole on 8 requests of
             4,096 audio frames of width 1,024 with 256-token decoder
             prompts, 32 new tokens each: 40 / 24 flash launches, all sm90,
             the encoder's 12 non-causal; each vlm cross gate opened to
             tanh(gate) in [0.25, 0.75] (drawn from the seed) before the
             run; the cross path live: the prefill's logits with the vision
             embeddings (frames) zeroed differ in every row by far more
             than the tolerance; flash against chunked also on the
             encoder's memory (encdec); decode steps 1, 8 and 32 against
             the forward, gated in float32 on the first request; the
             decode bound also with the caches read (the cross K/V
             included)

  dryrun     (after train; no kernel runs) each in a process of its own,
             started together: (a) stablelm-3b train_4k and granite-3-8b
             decode_32k traced in a fake world of 256 ranks (16 x 16) with
             the production shardings, full mode and roofline variant,
             mamba2-780m prefill_32k in the roofline variant, and
             REPRO_DRYRUN's flagship greedy step on 256 and 512 ranks; one
             line each with the per-device memory, FLOPs, bytes,
             collective bytes by kind and the H100 roofline; the gate is
             that every cell traces (and the GW step's FLOPs reach 8 N M /
             P); (b) stablelm-3b at the train phase's shape (8 x 2,048, 2
             microbatches, remat) in a world of one, held to the train
             phase: the predicted argument bytes equal the bytes its
             state and batch held, and the traced FLOPs the counting
             mode's (launch/roofline.py::CostCounter) on one more real
             step of the train phase, both exactly; the predicted peak and
             roofline seconds beside the measured peak and step, as
             ratios with no gate

  pipeline   (after dryrun) training/pipeline.py's GPipe schedule on
             stablelm-3b whole (2.795 B bf16 parameters, remat), 2 stages
             of 16 layers on 2 ranks spawned on the card (gloo: ranks on
             one card cannot form an NCCL group; the stage shift staged
             through pinned host buffers), 4 microbatches of 2 x 2,048
             tokens: (a) under grad, einsum attention: the loss within
             1e-3 relative of the one-process loss of the same
             microbatches on the same parameters (bitwise reported), the
             embedding gradient finite, nonzero and within 1e-2 relative
             L2 of the one-process one, every stage leaf's gradient
             finite; (b) attn_impl "flash" under no_grad: the same loss
             check, flash launches counted from 0 just before it, all on
             the sm90 route (D 80): 5 ticks x 16 layers x 2 ranks = 160;
             the step's ms, the shift's ms and bytes staged, each tick's
             compute and the measured bubble share beside the schedule's
             0.20, each rank's peak GB
  tp_modes   the tensor-parallel modes on 4 ranks spawned on the card
             (gloo) on a (2, 2) ("data", "model") mesh, the parameters
             distributed with the production shardings, a forward on 4 x
             2,048 tokens a mode: stablelm-3b whole in megatron, ulysses
             and megatron_rs, mixtral-8x7b at full width cut to 2 of its
             32 layers in megatron and ulysses + moe_ep; each loss within
             5e-3 of the model's one-rank loss, and megatron_rs's
             gradient norm (one backward pass) within 1e-2 of megatron's

  train      the trainer (no kernel of its own; attention by einsum), in
             a child process of this script (``--train``), the one
             that sets CUBLAS_WORKSPACE_CONFIG for the deterministic step:
             (a) stablelm-3b whole (2.795 B parameters, bf16, remat on,
             attn_impl "auto": einsum at 2,048 keys), a global batch of 8 x
             2,048 tokens in 2 microbatches, 6 steps of make_train_step on
             SyntheticLMData; launches counted from 0 just before them, no
             flash launch; the loss, grad_norm and every parameter finite,
             every parameter leaf moved; step ms (steps 2-6), tokens/s,
             peak and state GB, the model FLOPs of a step (6 P T for the
             GEMMs plus the einsum attention's) and their share of the bf16
             dense peak; (b) python -m repro_torch.launch.train on the card
             (reduced stablelm-3b, 30 steps, checkpoints every 10):
             uninterrupted, then --crash-at 17 and resumed: the final
             checkpoints bitwise equal; (c) reduced stablelm-3b in float32,
             the same parameters and batches, 5 steps on the card and on
             the CPU: the losses within 1e-4 relative

Then a line listing every ported kernel, the card's name and power limit,
and last ``{"ok": true, "device": {...}}``.  Any failed check raises: the
script exits non-zero and prints no result.  It needs a CUDA device and
the repository's ``src/`` beside it.
"""

from __future__ import annotations

import json
import logging
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

# Shapes of the GW workload (the paper's N, dtype and max_k; M cut from
# 3,276,800 to what one 80 GB card holds beside the build's temporaries).
N, M, MAX_K = 10_000, 131_072, 100
N_MC, N_ETA = 512, 256            # chirp grid, N_MC * N_ETA == M
F_MIN, F_MAX = 40.0, 1024.0       # Hz
TAU = 1e-4
BLOCK_P = 8                       # the blocked path's pivots per sweep
# The paper phase's cut: every 64th column of the chirp grid (all 512
# chirp masses, 4 mass ratios), in complex128.
CUT_STRIDE = 64
POD_REL_TAU = 1e-4                # POD / RRQR rank: sigma_{k+1} < 1e-4 sigma_1
CUT_MAX_K = 500                   # slots of the Prop. 5.3 builds (they stop
                                  # at tau well before)
# The served cell: the launcher's basis mode over two artifacts.
SERVE_REQUESTS, SERVE_MAX_BATCH, SERVE_WAIT_MS = 4096, 64, 2.0
ROQ_MAX_ERR = 1e-4                # the reference launcher test's bound
# The streamed cell: the paper's M (a 12,800 x 256 chirp grid, S = 262 GB
# at complex64, never formed), 50 tiles of 65,536 columns; the parity
# tilings at the resident M (the second leaves a ragged 8,192-column last
# tile); the host provider's every 8th column of S, 4,096-column tiles.
N_MC_PAPER = 12_800
STREAM_TILE = 65_536
PARITY_TILES = (16_384, 24_576)
HOST_STRIDE, HOST_TILE = 8, 4_096
# The randomized cells: the GW config's max_k plus the reference's default
# oversampling (ell 110); the range-finder on the paper phase's cut in
# 512-column tiles; the cut's sketch+greedy tau, for a power-0 sketch with
# no oversampling (ell = max_k 100): its estimates take k0 = 94 (5.0e-9 and
# 1.5e-9 the 94th and 95th, on the H100) while its 94-column basis leaves a
# column at 4.6e-9, so the refinement has work (the run prints all three);
# the resume check's tiling at the resident M; the sketch's k0 in the
# paper-size sketch+greedy run.
SKETCH_P = 10
SKETCH_ELL = MAX_K + SKETCH_P
CUT_TILE = 512
CUT_SG_TAU = 2.7e-9
RESUME_TILE = 16_384
SG_K0 = 90
# auto (d): a device budget below the resident S's 10.5 GB
# The lockstep phases: a tau sweep of 8 lanes over the resident S (taus
# from sweep_taus), and a band split of it into 8 bands of N / 8 frequency
# bins.
BATCH = 8
AUTO_BUDGET = 1 << 30
OMEGA_SEEDS = [0, 7, 2 ** 40 + 3]
# a gaussian block against its plain version, relative to max(1, |omega|):
# only erfinv differs (CUDA's against PyTorch's)
OMEGA_TOL = {torch.float32: 1e-5, torch.float64: 1e-10}
SEED = 0
HBM_BYTES_PER_S = 3.35e12         # H100 SXM data sheet
FP32_FLOPS = 67e12                # H100 SXM, float32 outside tensor cores
FP64_FLOPS = 34e12                # H100 SXM, float64 outside tensor cores
BF16_FLOPS = 989e12               # H100 SXM, bf16 / f16 tensor cores, dense
# integer ALU instructions: 64 an SM a clock (CUDA's throughput table for
# compute capability 9.0), 132 SMs, 1.98 GHz (the clock of the data
# sheet's FP64 rate, which has 64 lanes an SM too)
INT32_INSTR_PER_S = 132 * 64 * 1.98e9
# instructions issued: 4 warp-instructions an SM a clock, 32 lanes each
ISSUE_PER_S = 132 * 4 * 32 * 1.98e9
# The dense serving cells, whole at full width (bf16, random weights from
# the seed): (phase, arch, batch, prompt, new tokens, layers of the float32
# decode check (None: all), an int8 KV-cache run).  granite-3-8b's row is
# the serve phase (held to the einsum path); stablelm-3b (MHA 32/32 at D
# 80: small-model chat and completion) and starcoder2-15b (GQA 48/4,
# 31.9 GB: code completion over repository-sized context) take
# family_serve_phase's gates.  starcoder2's float32 copy (63.8 GB) does not
# fit beside its bf16 weights, so its float32 decode check runs at full
# width on the model cut to 8 of its 40 layers, the bf16 model freed
# first.  If memory presses, the batch shrinks, never the width or depth.
DENSE_CELLS = (
    ("serve", "granite-3-8b", 4, 2048, 32, None, False),
    ("serve_stablelm", "stablelm-3b", 4, 2048, 32, None, False),
    ("serve_starcoder2", "starcoder2-15b", 4, 4096, 32, 8, True),
)
LM_ARCH = DENSE_CELLS[0][1]
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = DENSE_CELLS[0][2:5]
# launch.serve's LM mode, run as a subprocess at its default batch (4),
# prompt (32) and new tokens (16), and again in this process
LAUNCH_ARCH = "stablelm-3b"
LAUNCH_BATCH, LAUNCH_PROMPT, LAUNCH_GEN = 4, 32, 16
# The decoder-only families at full width (bf16, random weights from the
# seed): (phase, arch, config overrides, batch, prompt, new tokens).
# mixtral-8x7b's 32 layers take 93.4 GB in bf16, past one 80 GB card: 16 of
# them (47.0 GB) leave room for the chunked comparison and the dispatch
# buffers.  Its prompts are 1.5x its 4,096-token window, recurrentgemma's
# 2x its 2,048-token local window.
# llama-3.2-vision-11b (20.2 GB) and seamless-m4t-medium (1.8 GB) are
# whole: image-grounded chat (1,600 vision tokens, long text prompts) and
# speech translation (4,096 audio frames, short decoder prompts).
FAMILY_CELLS = (
    ("serve_moe", "mixtral-8x7b", {"n_layers": 16}, 2, 6144, 32),
    ("serve_hybrid", "recurrentgemma-9b", {}, 4, 4096, 32),
    ("serve_ssm", "mamba2-780m", {}, 4, 4096, 32),
    ("serve_vlm", "llama-3.2-vision-11b", {}, 4, 2048, 32),
    ("serve_encdec", "seamless-m4t-medium", {}, 8, 256, 32),
)
# The training cell: stablelm-3b whole (the largest model of the repo
# whose bf16 parameters, bf16 gradients, float32 moments and float32
# microbatch sums, ~44.7 GB, fit one 80 GB card), a global batch of 8 x
# 2,048 tokens in 2 microbatches, 6 steps (the first not timed); if it
# stops fitting, the microbatch shrinks here, never the width.  The
# card-against-CPU check: reduced stablelm-3b in float32, 5 steps of 4 x
# 32 tokens; the restart check: the launcher's reduced run of the
# reference's fault-tolerance test (30 steps, checkpoints every 10, a
# crash after step 17).
TRAIN_ARCH = "stablelm-3b"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 2048, 6
TRAIN_MICRO = 2
TRAIN_CMP_STEPS, TRAIN_CMP_BATCH, TRAIN_CMP_SEQ = 5, 4, 32
TRAIN_CMP_RTOL = 1e-4
TRAIN_LAUNCH_ARGS = ["--arch", TRAIN_ARCH, "--reduced", "--steps", "30",
                     "--seq", "32", "--batch", "4", "--ckpt-every", "10",
                     "--log-every", "30", "--device", "cuda"]
# (B, Hq, Hkv, Sq, Skv, D, causal, window) of the small flash checks:
# groups 1, 4 and 8; ragged S; a window of 48 against key tiles of 64; Sq <
# Skv end-aligned; non-causal, with Sq > Skv too; D 16 to 256 (MHA at D 80
# over several tiles, D 96 non-causal); one query.
FA_CASES = [
    (2, 4, 4, 200, 200, 64, True, None),
    (1, 8, 2, 256, 256, 128, True, None),
    (1, 8, 1, 130, 130, 16, True, 48),
    (2, 4, 1, 64, 300, 80, True, 48),
    (1, 4, 4, 300, 300, 80, True, None),
    (1, 4, 2, 150, 200, 96, False, None),
    (1, 4, 2, 100, 100, 256, False, None),
    (1, 2, 2, 80, 48, 32, False, None),
    (1, 4, 4, 1, 77, 64, True, None),
]
# 16-bit cases of the sm90 kernel (D 64 / 128 / 256): Sq and Skv off its
# 128-row query and key tiles, a window of 48 inside one key tile, Sq < Skv,
# non-causal with Sq > Skv; recurrentgemma's MQA (16 query heads on one kv
# head) at D 256 with a window inside one key tile and one across several;
# mixtral's GQA 32/8 at D 128 with a window below Sq; non-causal MHA at D
# 64 on whole query and key tiles (the encoder's mode: no tile masked); D
# 80 and 96 (the D 128 kernel on zero-filled columns) causal, windowed
# inside and across key tiles and non-causal, Sq above and below Skv.
SM90_CASES = [
    (1, 8, 2, 333, 333, 128, True, None),
    (1, 8, 1, 300, 300, 128, True, 48),
    (2, 4, 1, 70, 390, 64, True, 48),
    (1, 4, 4, 190, 130, 128, False, None),
    (1, 4, 2, 150, 200, 256, True, None),
    (1, 16, 1, 300, 300, 256, True, 40),
    (2, 16, 1, 530, 530, 256, True, 200),
    (1, 32, 8, 700, 700, 128, True, 256),
    (2, 16, 16, 384, 512, 64, False, None),
    (1, 4, 4, 333, 333, 80, True, None),
    (1, 8, 2, 300, 300, 80, True, 48),
    (2, 4, 4, 190, 130, 80, False, None),
    (1, 8, 2, 70, 390, 96, True, 200),
    (1, 4, 4, 129, 257, 96, False, None),
]


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def time_ms(fn, reps: int, queued: bool = True) -> float:
    """Best of ``reps`` CUDA-event timings of one call, after a warm-up.

    ``queued``: a ~1 ms spin kernel is enqueued before the start event, so
    the host has issued the call's launches before the card reaches them
    and the time is the card's alone.  Without it the time also holds the
    host's cost of issuing the call (Python, argument checks, launches)."""
    fn()
    best = math.inf
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if queued:
            torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end))
    return best


def bound(nbytes: int, flops: int,
          flops_per_s: float = FP32_FLOPS) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sum_tol(dtype: torch.dtype, n: int) -> float:
    """Rounding of an n-term sum, relative to the terms' scale: the kernel
    and the plain version sum in different orders, each off by
    ~eps*sqrt(n); 10x margin."""
    return 10.0 * torch.finfo(dtype.to_real()).eps * math.sqrt(n)


# ------------------------------------------------------------- kernels ----
def check_greedy_update(S, q, acc, norms, exact_argmax: bool,
                        general: bool = False) -> float:
    """Kernel vs plain on one input, on the route kernel_route gives (or,
    with ``general``, the general kernel); the call must launch once, on
    that route, and a second launch give the same bits.  Returns the max
    abs error of c."""
    from repro_torch.kernels.greedy_update import ops as gu_ops
    from repro_torch.kernels.greedy_update.ref import greedy_update_ref

    route = "general" if general else gu_ops.kernel_route(
        S.dtype, S.shape[1], S.data_ptr() % 16 == 0 and q.data_ptr() % 16 == 0)
    fn = gu_ops._greedy_update_general if general else gu_ops.greedy_update
    n0 = getattr(gu_ops, f"launches_{route}")
    c, a, mx, am = fn(q, S, acc, norms)
    again = fn(q, S, acc, norms)
    cr, ar, mxr, amr = greedy_update_ref(q, S, acc, norms)
    torch.cuda.synchronize()
    check(getattr(gu_ops, f"launches_{route}") == n0 + 2,
          f"greedy_update: the calls did not launch the {route} kernel")
    check(all(torch.equal(x, y) for x, y in zip((c, a, mx, am), again)),
          f"greedy_update [{route}]: two launches differ")
    eps = torch.finfo(acc.dtype).eps
    scale = float(torch.linalg.vector_norm(S, dim=0).max())
    tol = sum_tol(S.dtype, S.shape[0]) * scale * float(
        torch.linalg.vector_norm(q))
    err_c = float((c - cr).abs().max())
    tol_a = 2 * float(cr.abs().max()) * tol + 4 * eps * float(
        ar.abs().max())
    err_a = float((a - ar).abs().max())
    check(err_c <= tol, f"greedy_update c: {err_c} > {tol}")
    check(err_a <= tol_a, f"greedy_update acc_out: {err_a} > {tol_a}")
    # the kernel's argmax indexes a residual equal to its own max_res
    check(float(norms[am] - a[am]) == float(mx),
          "greedy_update argmax does not index max_res")
    tol_m = tol_a + 4 * eps * float(norms.abs().max())
    check(abs(float(mx) - float(mxr)) <= tol_m,
          f"greedy_update max_res: {float(mx)} vs {float(mxr)}")
    if exact_argmax:
        check(int(am) == int(amr), f"argmax {int(am)} != {int(amr)}")
    emit("kernels", kernel="greedy_update", route=route, dtype=str(S.dtype),
         shape=list(S.shape), max_abs_err_c=err_c, tol_c=tol,
         max_abs_err_acc=err_a, tol_acc=tol_a, max_res=float(mx),
         argmax=int(am), plain_argmax=int(amr), exact_argmax=exact_argmax)
    return err_c


def check_block_sweep(Qnew, S, acc) -> float:
    """Kernel vs plain on one input; returns the max abs error of C."""
    from repro_torch.kernels.block_sweep.ops import block_sweep
    from repro_torch.kernels.block_sweep.ref import block_sweep_ref

    C, a = block_sweep(Qnew, S, acc)
    Cr, ar = block_sweep_ref(Qnew, S, acc)
    torch.cuda.synchronize()
    p = Qnew.shape[1]
    eps = torch.finfo(acc.dtype).eps
    tol = sum_tol(S.dtype, S.shape[0]) * float(
        torch.linalg.vector_norm(S, dim=0).max()) * float(
        torch.linalg.vector_norm(Qnew, dim=0).max())
    err_c = float((C - Cr).abs().max())
    # acc_out adds p terms |C_i|^2, each off by ~2 |C_i| tol, and rounds
    # a (p + 1)-term sum
    tol_a = 2 * p * float(Cr.abs().max()) * tol + (p + 4) * eps * float(
        ar.abs().max())
    err_a = float((a - ar).abs().max())
    check(err_c <= tol, f"block_sweep C: {err_c} > {tol}")
    check(err_a <= tol_a, f"block_sweep acc_out: {err_a} > {tol_a}")
    zero = (Qnew == 0).all(0)
    check(bool((C[zero] == 0).all()), "block_sweep: a zero column of Qnew "
          "gave a nonzero row of C")
    emit("kernels", kernel="block_sweep", dtype=str(S.dtype),
         shape=list(S.shape), p=p, max_abs_err_c=err_c, tol_c=tol,
         max_abs_err_acc=err_a, tol_acc=tol_a)
    return err_c


def check_imgs_panel(V, Q, general: bool = False) -> float:
    """Kernel vs plain on one input, on the route kernel_route gives (or,
    with ``general``, the general kernel); the call must launch once, on
    that route, and a second launch give the same bits."""
    from repro_torch.kernels.imgs_panel import ops as pp_ops
    from repro_torch.kernels.imgs_panel.ref import imgs_panel_ref

    route = "general" if general else pp_ops.kernel_route(
        Q.dtype, Q.shape[1], V.shape[1])
    fn = pp_ops._imgs_panel_general if general else pp_ops.imgs_panel
    n0 = getattr(pp_ops, f"launches_{route}")
    Vo, C = fn(V, Q)
    again = fn(V, Q)
    Vr, Cr = imgs_panel_ref(V, Q)
    torch.cuda.synchronize()
    check(getattr(pp_ops, f"launches_{route}") == n0 + 2,
          f"imgs_panel: the calls did not launch the {route} kernel")
    check(torch.equal(Vo, again[0]) and torch.equal(C, again[1]),
          f"imgs_panel [{route}]: two launches differ")
    tol = sum_tol(Q.dtype, Q.shape[0]) * float(
        torch.linalg.vector_norm(V, dim=0).max())
    err = max(float((C - Cr).abs().max()), float((Vo - Vr).abs().max()))
    check(err <= tol, f"imgs_panel [{route}]: {err} > {tol}")
    emit("kernels", kernel="imgs_panel", route=route, dtype=str(Q.dtype),
         shape=list(Q.shape), p=V.shape[1], max_abs_err=err, tol=tol)
    return err


def check_imgs_project(v, Q, general: bool = False) -> float:
    """Kernel vs plain on one input, on the route kernel_route gives (or,
    with ``general``, the general kernel); the call must launch once, on
    that route, and a second launch give the same bits."""
    from repro_torch.kernels.imgs_project import ops as ip_ops
    from repro_torch.kernels.imgs_project.ref import imgs_project_ref

    route = "general" if general else ip_ops.kernel_route(
        Q.dtype, Q.shape[1])
    fn = ip_ops._imgs_project_general if general else ip_ops.imgs_project
    n0 = getattr(ip_ops, f"launches_{route}")
    vo, c = fn(v, Q)
    again = fn(v, Q)
    vr, cr = imgs_project_ref(v, Q)
    torch.cuda.synchronize()
    check(getattr(ip_ops, f"launches_{route}") == n0 + 2,
          f"imgs_project: the calls did not launch the {route} kernel")
    check(torch.equal(vo, again[0]) and torch.equal(c, again[1]),
          f"imgs_project [{route}]: two launches differ")
    tol = sum_tol(Q.dtype, Q.shape[0]) * float(torch.linalg.vector_norm(v))
    err = max(float((c - cr).abs().max()), float((vo - vr).abs().max()))
    check(err <= tol, f"imgs_project [{route}] {tuple(Q.shape)} "
          f"{Q.dtype}: {err} > {tol}")
    emit("kernels", kernel="imgs_project", route=route, dtype=str(Q.dtype),
         shape=list(Q.shape), max_abs_err=err, tol=tol)
    return err


def check_roq_apply(B, F, general: bool = False) -> float:
    """Kernel vs plain on one input, on the route kernel_route gives (or,
    with ``general``, the general kernel): one launch on that route a call,
    the same bits twice, each column's bits those of the column alone in a
    width-2 call (the serving contract), the sm90 kernel's bits those of
    the general one; within the rounding of a k-term sum of |B||F|.
    Returns the max abs error."""
    from repro_torch.kernels.roq_apply import ops as ra_ops
    from repro_torch.kernels.roq_apply.ref import roq_apply_ref

    k, nb = B.shape[1], F.shape[1]
    route = "general" if general else ra_ops.kernel_route(B.dtype, k, nb)
    fn = ra_ops._roq_apply_general if general else ra_ops.roq_apply
    what = f"roq_apply [{route}] {tuple(B.shape)} x {nb} {B.dtype}"
    n0 = getattr(ra_ops, f"launches_{route}")
    out = fn(B, F)
    again = fn(B, F)
    ref = roq_apply_ref(B, F)
    torch.cuda.synchronize()
    check(getattr(ra_ops, f"launches_{route}") == n0 + 2,
          f"{what}: the calls did not launch the {route} kernel")
    check(torch.equal(out, again), f"{what}: two launches differ")
    for j in sorted({0, nb // 2, nb - 1}):
        pair = F[:, [j, j]].contiguous()
        check(torch.equal(fn(B, pair)[:, 0], out[:, j]),
              f"{what}: column {j} depends on the batch width")
    if route == "sm90":
        check(torch.equal(out, ra_ops._roq_apply_general(B, F)),
              f"{what}: not bitwise the general kernel")
    scale = float((B.abs() @ F.abs()).max())
    tol = sum_tol(B.dtype, k) * scale
    err = float((out - ref).abs().max())
    check(err <= tol, f"{what}: {err} > {tol}")
    emit("kernels", kernel="roq_apply", route=route, dtype=str(B.dtype),
         shape=[*B.shape, nb], max_abs_err=err, tol=tol,
         bitwise_general=route == "sm90")
    return err


def check_flags(gen, dtype, dev) -> None:
    """Both routes of greedy_update and imgs_project with a false active
    flag return exactly what a zero vector gives with S / Q full of NaN
    (so the kernel never read them), and with a true flag the bits of the
    unflagged call; each case then a normal call on the same route, held
    to the plain version (the counters the kernels take were left at 0)."""
    from repro_torch.kernels.greedy_update import ops as gu_ops
    from repro_torch.kernels.imgs_project import ops as ip_ops

    off = torch.zeros((), dtype=torch.bool, device=dev)
    on = torch.ones((), dtype=torch.bool, device=dev)
    S, q, acc, norms = random_update_inputs(gen, (300, 1024), dtype, dev)
    # a tie of the largest residual norms - acc at columns 5 and 900: 5 wins
    acc_t, norms_t = acc.clone(), norms.clone()
    acc_t[5] = acc_t[900] = 0.5
    norms_t[5] = norms_t[900] = (norms - acc).max() + 1.5
    S_nan = torch.full_like(S, float("nan"))
    Q = torch.linalg.qr(rand(gen, (N, MAX_K), dtype, dev))[0].contiguous()
    Q_nan = torch.full_like(Q, float("nan"))
    v = rand(gen, (N,), dtype, dev)
    for general in (False, True):
        fn = gu_ops._greedy_update_general if general else \
            gu_ops.greedy_update
        c, a, mx, am = fn(q, S_nan, acc_t, norms_t, off)
        torch.cuda.synchronize()
        check(torch.equal(c, torch.zeros_like(c)) and torch.equal(a, acc_t)
              and int(am) == 5
              and float(mx) == float((norms_t - acc_t).max()),
              f"greedy_update [{general=}] {dtype}: a false flag did not "
              "give the zero-vector result")
        check(all(torch.equal(x, y) for x, y in
                  zip(fn(q, S, acc, norms, on), fn(q, S, acc, norms))),
              f"greedy_update [{general=}] {dtype}: a true flag changed "
              "the bits")
        check_greedy_update(S, q, acc, norms, exact_argmax=True,
                            general=general)
        fn = ip_ops._imgs_project_general if general else \
            ip_ops.imgs_project
        vo, c = fn(v, Q_nan, off)
        torch.cuda.synchronize()
        check(torch.equal(vo, v) and torch.equal(c, torch.zeros_like(c)),
              f"imgs_project [{general=}] {dtype}: a false flag did not "
              "give the zero-vector result")
        check(all(torch.equal(x, y) for x, y in
                  zip(fn(v, Q, on), fn(v, Q))),
              f"imgs_project [{general=}] {dtype}: a true flag changed "
              "the bits")
        check_imgs_project(v, Q, general)
    emit("kernels", check="active_flag", dtype=str(dtype),
         kernels=["greedy_update", "imgs_project"],
         routes=["sm90", "general"], ok=True)


def random_update_inputs(gen, shape, dtype, dev):
    """Residuals separated by design (a distinct offset per column, far
    above the tolerance), so the argmax must match exactly."""
    n, m = shape
    S = rand(gen, (n, m), dtype, dev)
    q = rand(gen, (n,), dtype, dev)
    q = q / torch.linalg.vector_norm(q)
    rdt = dtype.to_real()
    acc = torch.rand(m, generator=gen, dtype=torch.float64).to(rdt).to(dev)
    perm = torch.randperm(m, generator=gen).to(dev).to(rdt)
    return S, q, acc, (S.abs() ** 2).sum(0) + perm


def rand(gen, shape, dtype, dev):
    x = torch.randn(shape, generator=gen, dtype=torch.float64)
    if dtype.is_complex:
        x = torch.complex(x, torch.randn(shape, generator=gen,
                                         dtype=torch.float64))
    return x.to(dtype).to(dev)


def macs_flops(dtype: torch.dtype) -> int:
    """Flops of one multiply-add: 8 in complex, 2 in real."""
    return 8 if dtype.is_complex else 2


def timed(name, shape, dtype, nbytes, flops, err, reps, kernel, plain,
          library, flops_per_s=FP32_FLOPS) -> dict:
    """Times of the kernel, its plain version and the library yardstick
    (best of ``reps``; ``library`` None where no one PyTorch call computes
    the function), the bound; one kernels line."""
    b = bound(nbytes, flops, flops_per_s)
    entry = {"ms": time_ms(kernel, reps), "plain_ms": time_ms(plain, reps),
             "library_ms": None if library is None
             else time_ms(library, reps), "bound_ms": b[0],
             "bound_by": b[1], "max_abs_err": err}
    emit("kernels", kernel=name, timing_shape=shape, dtype=str(dtype),
         achieved_gb_s=nbytes / (entry["ms"] * 1e-3) / 1e9, **entry)
    return entry


def timed_turns(name, shape, dtype, nbytes, flops, errs, reps, kernels,
                plain, library, host_reps=0, flops_per_s=FP32_FLOPS,
                **fields) -> dict:
    """A kernel's routes timed in turns beside its plain version and the
    library yardstick (routes, plain, library, routes reversed; best of
    ``reps`` each; ``library`` None where no one PyTorch call computes the
    function); one kernels line per route, with ``fields``.  ``kernels``
    and ``errs`` map each entry name to its call and its max abs error.
    With ``host_reps``, also the time of a call issued to an idle card, the
    host's cost of issuing it included (``call_ms``)."""
    b = bound(nbytes, flops, flops_per_s)
    turns = {n: [] for n in (*kernels, "plain", "library")}
    for n, fn in kernels.items():
        turns[n].append(time_ms(fn, reps))
    turns["plain"].append(time_ms(plain, reps))
    turns["library"].append(None if library is None
                            else time_ms(library, reps))
    for n, fn in reversed(kernels.items()):
        turns[n].append(time_ms(fn, reps))
    calls = {}
    if host_reps:
        for n, fn in (*kernels.items(), ("library", library)):
            calls[n] = time_ms(fn, host_reps, queued=False)
    out = {}
    for n in kernels:
        ms = min(turns[n])
        out[n] = {"ms": ms, "plain_ms": turns["plain"][0],
                  "library_ms": turns["library"][0], "bound_ms": b[0],
                  "bound_by": b[1], "max_abs_err": errs[n]}
        extra = {"call_ms": calls[n], "library_call_ms": calls["library"]} \
            if host_reps else {}
        emit("kernels", kernel=n, timing_shape=shape, dtype=str(dtype),
             turns_ms=turns[n], bound_share=b[0] / ms,
             achieved_gb_s=nbytes / (ms * 1e-3) / 1e9, **fields, **extra,
             **out[n])
    return out


def time_greedy_update(S, gen, dev, suffix="") -> dict:
    """greedy_update's two routes at full width, on the GW snapshots
    themselves (real residuals may have near-ties: the argmax is checked
    through max_res)."""
    from repro_torch.kernels.greedy_update import ops as gu_ops
    from repro_torch.kernels.greedy_update.ref import greedy_update_ref

    q = rand(gen, (N,), S.dtype, dev)
    q = q / torch.linalg.vector_norm(q)
    norms = torch.linalg.vector_norm(S, dim=0) ** 2
    acc = torch.rand(M, generator=gen, dtype=torch.float64).to(
        norms.dtype).to(dev) * 0.5
    check(gu_ops.kernel_route(S.dtype, M, True) == "sm90",
          "greedy_update: the path's shape is not on the sm90 route")
    errs = {"greedy_update" + suffix: check_greedy_update(
                S, q, acc, norms, exact_argmax=False),
            "greedy_update_general" + suffix: check_greedy_update(
                S, q, acc, norms, exact_argmax=False, general=True)}
    qc = q.conj().resolve_conj()
    # bytes: S, q, acc, norms read once; c, acc_out written once
    nbytes = S.nbytes + q.nbytes + 2 * acc.nbytes + norms.nbytes \
        + M * S.element_size()
    return timed_turns(
        "greedy_update", [N, M], S.dtype, nbytes, macs_flops(S.dtype) * N * M,
        errs, 10,
        {"greedy_update" + suffix: lambda: gu_ops.greedy_update(
            q, S, acc, norms),
         "greedy_update_general" + suffix:
             lambda: gu_ops._greedy_update_general(q, S, acc, norms)},
        lambda: greedy_update_ref(q, S, acc, norms),
        lambda: torch.mv(S.mT, qc))


def kernel_phase(S, dev) -> dict:
    """Every kernel vs its plain version; timings at the build paths'
    shapes.  Returns the per-kernel entries of the final kernels line."""
    from repro_torch.kernels.block_sweep.ops import block_sweep
    from repro_torch.kernels.block_sweep.ref import block_sweep_ref
    from repro_torch.kernels.imgs_panel import ops as pp_ops
    from repro_torch.kernels.imgs_panel.ref import imgs_panel_ref
    from repro_torch.kernels.imgs_project import ops as ip_ops
    from repro_torch.kernels.imgs_project.ref import imgs_project_ref

    gen = torch.Generator().manual_seed(SEED)
    for dtype in (torch.float32, torch.complex64, torch.float64,
                  torch.complex128):
        # both routes: odd M (the general route but in complex128), M off
        # the sm90 kernel's 128-column tiles, N off its stages
        for shape in ((17, 33), (300, 700), (129, 1000)):
            for general in (False, True):
                check_greedy_update(
                    *random_update_inputs(gen, shape, dtype, dev),
                    exact_argmax=True, general=general)
        # both routes: odd K, a ragged last slab (N off a multiple of a
        # CTA's rows), K 1, 8 and 100, and N = 40,001: every SM, rows past
        # what fits in shared memory (two chunks a CTA)
        for shape in ((33, 17), (513, 37), (2113, 7), (3001, 1), (3001, 8),
                      (1000, 100), (40001, 100)):
            Q = torch.linalg.qr(rand(gen, shape, dtype, dev))[0]
            if shape[1] > 1:   # an empty slot of the basis
                Q[:, shape[1] // 2] = 0
            v = rand(gen, (shape[0],), dtype, dev)
            for general in (False, True):
                check_imgs_project(v, Q.contiguous(), general)
        check_flags(gen, dtype, dev)
        # p below, at and above the kernels' widest panel of 32; a zero
        # column stands for a rejected candidate / an empty slot
        for n, m, p in ((17, 33, 1), (300, 700, 3), (257, 130, 8),
                        (129, 257, 33)):
            Qnew = torch.linalg.qr(rand(gen, (n, p), dtype, dev))[0]
            Qnew[:, p // 2] = 0
            acc = torch.rand(m, generator=gen, dtype=torch.float64).to(
                dtype.to_real()).to(dev)
            check_block_sweep(Qnew.contiguous(), rand(gen, (n, m), dtype, dev),
                              acc)
        # both routes: ragged slabs and a ticket tree of one to three
        # levels, odd and even K and p, two column panels
        for n, k, p in ((33, 17, 1), (513, 37, 3), (300, 40, 8),
                        (1100, 40, 33), (40001, 9, 2)):
            Q = torch.linalg.qr(rand(gen, (n, k), dtype, dev))[0]
            Q[:, k // 2] = 0
            V = rand(gen, (n, p), dtype, dev)
            for general in (False, True):
                check_imgs_panel(V, Q.contiguous(), general)
        # both routes: a ragged last panel, k 1, widths 1 to 128, and k so
        # large that F overflows the sm90 kernel's shared memory (general)
        for n, k, nb in ((17, 3, 1), (301, 1, 5), (1000, 83, 64),
                         (129, 100, 128), (300, 4000, 16)):
            B, F = rand(gen, (n, k), dtype, dev), rand(gen, (k, nb), dtype,
                                                        dev)
            for general in (False, True):
                check_roq_apply(B, F, general)

    out = time_greedy_update(S, gen, dev)
    # the f32 case of greedy_update (greedy_update_real on the TPU) at the
    # same width, on the real part of the snapshots; not on the GW path
    S32 = S.real.contiguous()
    time_greedy_update(S32, gen, dev, suffix="_f32")
    del S32
    torch.cuda.empty_cache()

    # imgs_project at the greedy path's (N, max_k) with a half-filled basis
    Q = torch.zeros((N, MAX_K), dtype=S.dtype, device=dev)
    Q[:, :MAX_K // 2] = torch.linalg.qr(
        rand(gen, (N, MAX_K // 2), S.dtype, dev))[0]
    v = rand(gen, (N,), S.dtype, dev)
    check(ip_ops.kernel_route(S.dtype, MAX_K) == "sm90",
          "imgs_project: the path's shape is not on the sm90 route")
    # bytes: Q and v read once; c and v' written once
    out.update(timed_turns(
        "imgs_project", [N, MAX_K], S.dtype,
        Q.nbytes + 2 * v.nbytes + MAX_K * Q.element_size(),
        2 * macs_flops(S.dtype) * N * MAX_K,
        {"imgs_project": check_imgs_project(v, Q),
         "imgs_project_general": check_imgs_project(v, Q, general=True)},
        50,
        {"imgs_project": lambda: ip_ops.imgs_project(v, Q),
         "imgs_project_general": lambda: ip_ops._imgs_project_general(v, Q)},
        lambda: imgs_project_ref(v, Q),
        lambda: torch.addmv(v, Q, torch.mv(Q.mH, v), alpha=-1),
        host_reps=50))

    # block_sweep at the blocked path's (N, M) and p
    Qnew = torch.linalg.qr(rand(gen, (N, BLOCK_P), S.dtype, dev))[0] \
        .contiguous()
    acc = torch.rand(M, generator=gen, dtype=torch.float64).to(
        S.dtype.to_real()).to(dev) * 0.5
    # bytes: S, Qnew, acc read once; C, acc_out written once
    out["block_sweep"] = timed(
        "block_sweep", [N, M, BLOCK_P], S.dtype,
        S.nbytes + Qnew.nbytes + 2 * acc.nbytes
        + BLOCK_P * M * S.element_size(),
        macs_flops(S.dtype) * BLOCK_P * N * M,
        check_block_sweep(Qnew, S, acc), 10,
        lambda: block_sweep(Qnew, S, acc),
        lambda: block_sweep_ref(Qnew, S, acc),
        lambda: torch.matmul(Qnew.mH, S))

    # imgs_panel at the blocked path's (N, max_k + p) slots, half filled
    K = MAX_K + BLOCK_P
    Q = torch.zeros((N, K), dtype=S.dtype, device=dev)
    Q[:, :K // 2] = torch.linalg.qr(rand(gen, (N, K // 2), S.dtype, dev))[0]
    V = rand(gen, (N, BLOCK_P), S.dtype, dev)
    check(pp_ops.kernel_route(S.dtype, K, BLOCK_P) == "sm90",
          "imgs_panel: the path's shape is not on the sm90 route")
    # bytes: Q and V read once; C and V' written once
    out.update(timed_turns(
        "imgs_panel", [N, K, BLOCK_P], S.dtype,
        Q.nbytes + 2 * V.nbytes + K * BLOCK_P * Q.element_size(),
        2 * macs_flops(S.dtype) * N * K * BLOCK_P,
        {"imgs_panel": check_imgs_panel(V, Q),
         "imgs_panel_general": check_imgs_panel(V, Q, general=True)}, 50,
        {"imgs_panel": lambda: pp_ops.imgs_panel(V, Q),
         "imgs_panel_general": lambda: pp_ops._imgs_panel_general(V, Q)},
        lambda: imgs_panel_ref(V, Q),
        lambda: torch.addmm(V, Q, torch.mm(Q.mH, V), alpha=-1),
        host_reps=50))
    return out


# --------------------------------------------------------- LM kernels ----
# q and k scales of the flash checks: 0.3 gives logits of std 0.09 (a
# near-uniform softmax, as at initialization); 2.0 gives logits of std 4,
# peaked, so that the running max of a row moves across key tiles and the
# rescale of the output by alpha = exp(m_old - m_new) is far from 1.
FA_QK_SCALES = (0.3, 2.0)


def fa_tol(q, k, v, causal, window):
    """The plain version r (f32, from the same rounded inputs) and the
    elementwise tolerance of the kernel's output against it.

    16-bit: the kernel differs from r by (1) P rounded to the input type
    for the second product, each p_j off by at most u = eps / 2 of itself
    (or half the smallest subnormal, f16), which moves o_i by at most
    u * sum_j p_j |v_j| / l = u * attention(q, k, |v|)_i; (2) the output's
    rounding, u |o_i|; (3) f32 sums in another order, ~1e-6 relative.  The
    tolerance is twice that bound: eps (|r| + attention(q, k, |v|)) plus
    Skv subnormal steps of max|v|.  f32: both sum in f32 in different
    orders, ~eps * sqrt(D) of the logits' scale; 1e-4 of max|v|."""
    from repro_torch.kernels.flash_attention.ref import attention_ref

    qf, kf, vf = q.float(), k.float(), v.float()
    r = attention_ref(qf, kf, vf, causal=causal, window=window)
    vmax = float(vf.abs().max())
    if q.dtype == torch.float32:
        return r, torch.full_like(r, 1e-4 * vmax)
    a = attention_ref(qf, kf, vf.abs(), causal=causal, window=window)
    fi = torch.finfo(q.dtype)
    return r, fi.eps * (r.abs() + a) + (
        k.shape[2] * fi.smallest_normal * fi.eps * vmax)


def fa_inputs(gen, B, hq, hkv, sq, skv, D, dtype, dev, qk_scale=0.3):
    """q, k, v as transposed views of (B, S, H, D) tensors: the layout
    multihead_attention hands the kernel.  q and k are scaled by
    ``qk_scale``, v is standard normal."""
    out = []
    for h, s, scale in ((hq, sq, qk_scale), (hkv, skv, qk_scale),
                        (hkv, skv, 1.0)):
        x = torch.randn((B, s, h, D), generator=gen, device=dev) * scale
        out.append(x.to(dtype).transpose(1, 2))
    return out


def check_flash(q, k, v, causal, window, qk_scale, general=False) -> float:
    """Kernel vs plain on one input, elementwise within fa_tol; 16-bit
    also within eps in relative L2 (the two roundings are unbiased and
    ~u / sqrt(3) of |o| each in rms, ~0.4 eps together).  The call takes
    the route kernel_route gives, or with ``general`` the general kernel;
    it must launch once, on that route."""
    from repro_torch.kernels.flash_attention import ops as fa_ops

    route = "general" if general else fa_ops.kernel_route(
        q.dtype, q.shape[3], fa_ops.aligned16(q, k, v))
    fn = fa_ops._flash_attention_general if general else \
        fa_ops.flash_attention
    n0 = getattr(fa_ops, f"launches_{route}")
    o = fn(q, k, v, causal=causal, window=window)
    r, tol = fa_tol(q, k, v, causal, window)
    torch.cuda.synchronize()
    check(getattr(fa_ops, f"launches_{route}") == n0 + 1,
          f"flash_attention: the call did not launch the {route} kernel")
    check(o.dtype == q.dtype and o.shape == q.shape,
          "flash_attention: output dtype / shape")
    d = o.float() - r
    err = float(d.abs().max())
    worst = float((d.abs() / tol).max())
    rel_l2 = float(torch.linalg.vector_norm(d) / torch.linalg.vector_norm(r))
    rel_tol = (None if q.dtype == torch.float32
               else torch.finfo(q.dtype).eps)
    what = (f"flash_attention [{route}] {tuple(q.shape)} {q.dtype} "
            f"causal={causal} window={window} qk_scale={qk_scale}")
    check(worst <= 1.0, f"{what}: |o - r| up to {worst} x its tolerance")
    check(rel_tol is None or rel_l2 <= rel_tol,
          f"{what}: relative L2 {rel_l2} > {rel_tol}")
    emit("lm_kernels", kernel="flash_attention", route=route,
         dtype=str(q.dtype), q_shape=list(q.shape), kv_shape=list(k.shape),
         causal=causal, window=window, qk_scale=qk_scale, max_abs_err=err,
         max_err_over_tol=worst, rel_l2=rel_l2, rel_l2_tol=rel_tol,
         mean_abs_ref=float(r.abs().mean()))
    return err


def lm_kernel_phase(dev) -> dict:
    """flash_attention's two kernels vs the plain version at small shapes,
    at the serve path's, the family cells' and the pipeline phase's; the
    two kernels timed in turns at the serve path's shape, at the
    encoder's (non-causal) and at stablelm-3b's D 80 (and the same at D
    96).  Returns the timing entries of both, the encoder's under
    ``"noncausal"``, the others' under ``"d80"``, ``"d80_pipeline"`` and
    ``"d96"``."""
    from repro_torch.kernels.flash_attention import ops as fa_ops

    gen = torch.Generator(device=dev).manual_seed(SEED)
    half = (torch.bfloat16, torch.float16)
    for dtype in (torch.float32, *half):
        for case in FA_CASES + (SM90_CASES if dtype in half else []):
            for qs in FA_QK_SCALES:
                check_flash(*fa_inputs(gen, *case[:6], dtype, dev, qs),
                            case[6], case[7], qs)
    # the general kernel's 16-bit branch where the sm90 kernel now serves
    for dtype in half:
        for case in FA_CASES:
            if case[5] in fa_ops.SM90_HEAD_DIMS:
                check_flash(*fa_inputs(gen, *case[:6], dtype, dev, 2.0),
                            case[6], case[7], 2.0, general=True)
    # determinism: no atomics, the same bits twice, on both kernels
    q, k, v = fa_inputs(gen, 2, 8, 2, 300, 300, 128, torch.bfloat16, dev)
    for fn in (fa_ops.flash_attention, fa_ops._flash_attention_general):
        check(torch.equal(fn(q, k, v, window=100), fn(q, k, v, window=100)),
              "flash_attention: two launches differ")

    from repro_torch.configs import get_config
    cfg = get_config(LM_ARCH)
    B, hq, hkv, S, D = (SERVE_BATCH, cfg.n_heads, cfg.n_kv_heads,
                        SERVE_PROMPT, cfg.hd)
    peaked = fa_inputs(gen, B, hq, hkv, S, S, D, torch.bfloat16, dev,
                       FA_QK_SCALES[1])
    err = check_flash(*peaked, True, None, FA_QK_SCALES[1])
    err_general = check_flash(*peaked, True, None, FA_QK_SCALES[1],
                              general=True)
    check(torch.equal(fa_ops.flash_attention(*peaked),
                      fa_ops.flash_attention(*peaked)),
          "flash_attention: two launches differ at the path's shape")
    del peaked
    # the families' attention at their cells' shapes (FAMILY_CELLS):
    # mixtral's GQA 32/8 with its 4,096 window over 6,144 tokens,
    # recurrentgemma's MQA at D 256 with its 2,048 local window,
    # llama-3.2-vision's GQA 32/8, seamless-m4t's decoder (causal, D 64)
    # and its encoder (non-causal, MHA 16/16 at D 64 over the frames)
    enc, enc_err = None, 0.0
    for _, arch, over, n_batch, prompt, _ in FAMILY_CELLS:
        c = get_config(arch).replace(**over)
        if c.family == "ssm":
            continue
        window = c.sliding_window or c.local_window
        shapes = [(prompt, True, window)]
        if c.family == "encdec":
            enc = (n_batch, c.n_heads, c.n_kv_heads, c.audio_frames, c.hd)
            shapes.append((c.audio_frames, False, None))
        for n, causal, win in shapes:
            for qs in FA_QK_SCALES:
                e = check_flash(*fa_inputs(
                    gen, n_batch, c.n_heads, c.n_kv_heads, n, n, c.hd,
                    torch.bfloat16, dev, qs), causal, win, qs)
                err = max(err, e)
                if not causal:
                    enc_err = max(enc_err, e)
            torch.cuda.empty_cache()
    # stablelm-3b's MHA 32/32 at D 80 (the sm90 kernel's D 128 build on
    # zero-filled columns) at its serve cell's prefill and at the pipeline
    # phase's, and the same MHA at D 96 (no configuration has it), through
    # the default entry and the general one at both qk scales; each then
    # timed like the serve path's shape
    pc = get_config(PIPE_ARCH)
    by_dim = {}
    for key, n_batch, n, hd in (
            ("d80", DENSE_CELLS[1][2], DENSE_CELLS[1][3], pc.hd),
            ("d80_pipeline", PIPE_B, PIPE_SEQ, pc.hd),
            ("d96", DENSE_CELLS[1][2], DENSE_CELLS[1][3], 96)):
        e_sm90 = e_general = 0.0
        for qs in FA_QK_SCALES[::-1]:   # the near-uniform ones timed
            pin = fa_inputs(gen, n_batch, pc.n_heads, pc.n_kv_heads, n, n,
                            hd, torch.bfloat16, dev, qs)
            check(fa_ops.kernel_route(pin[0].dtype, hd,
                                      fa_ops.aligned16(*pin)) == "sm90",
                  f"flash_attention: stablelm's views at D {hd} are not on "
                  f"the sm90 route")
            e_sm90 = max(e_sm90, check_flash(*pin, True, None, qs))
            e_general = max(e_general, check_flash(*pin, True, None, qs,
                                                   general=True))
        by_dim[key] = time_flash(*pin, True, e_sm90, e_general)
        err, err_general = max(err, e_sm90), max(err_general, e_general)
        del pin
        torch.cuda.empty_cache()
    q, k, v = fa_inputs(gen, B, hq, hkv, S, S, D, torch.bfloat16, dev)
    err = max(err, check_flash(q, k, v, True, None, FA_QK_SCALES[0]))
    err_general = max(err_general, check_flash(
        q, k, v, True, None, FA_QK_SCALES[0], general=True))
    out = time_flash(q, k, v, True, err, err_general)
    for name in out:
        for key, timing in by_dim.items():
            out[name][key] = timing[name]
    del q, k, v
    torch.cuda.empty_cache()
    # the encoder's bidirectional attention, timed the same way
    eb, ehq, ehkv, es, ed = enc
    q, k, v = fa_inputs(gen, eb, ehq, ehkv, es, es, ed, torch.bfloat16, dev)
    enc_err_general = check_flash(q, k, v, False, None, FA_QK_SCALES[0],
                                  general=True)
    noncausal = time_flash(q, k, v, False, enc_err, enc_err_general)
    for name in out:
        out[name]["noncausal"] = noncausal[name]
    del q, k, v
    torch.cuda.empty_cache()
    return out


def time_flash(q, k, v, causal, err, err_general) -> dict:
    """flash_attention's sm90 kernel and its general one timed in turns
    beside the plain version and SDPA on (q, k, v) (Sq == Skv), with the
    bound: two products of 2 flops a multiply-add over the (query, key)
    pairs the mask keeps (S (S + 1) / 2 a head under causality, S^2
    without); q, k, v read once and o written once.  Returns the timing
    entry of each kernel."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import attention_ref

    B, hq, S, D = q.shape
    hkv = k.shape[1]
    pairs = S * (S + 1) // 2 if causal else S * S
    flops = 4 * B * hq * D * pairs
    nbytes = 2 * q.nbytes + k.nbytes + v.nbytes
    try:    # the library call: PyTorch's fused attention, GQA in place
        F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                       enable_gqa=True)
        library = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q, k, v, is_causal=causal, enable_gqa=True)
    except TypeError:   # an older PyTorch: K/V repeated outside the timing
        kr, vr = (t.repeat_interleave(hq // hkv, dim=1) for t in (k, v))
        library = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q, kr, vr, is_causal=causal)
    b_ms, b_by = bound(nbytes, flops, BF16_FLOPS)
    kernels = {"flash_attention":
                   lambda: fa_ops.flash_attention(q, k, v, causal=causal),
               "flash_attention_general":
                   lambda: fa_ops._flash_attention_general(q, k, v,
                                                           causal=causal)}
    # in turns: sm90, general, plain, library, general, sm90
    turns = {name: [] for name in (*kernels, "plain", "library")}
    for name in ("flash_attention", "flash_attention_general"):
        turns[name].append(time_ms(kernels[name], 10))
    turns["plain"].append(time_ms(
        lambda: attention_ref(q, k, v, causal=causal), 10))
    turns["library"].append(time_ms(library, 10))
    for name in ("flash_attention_general", "flash_attention"):
        turns[name].append(time_ms(kernels[name], 10))
    out = {}
    for name, e in (("flash_attention", err),
                    ("flash_attention_general", err_general)):
        ms = min(turns[name])
        out[name] = {"ms": ms, "plain_ms": turns["plain"][0],
                     "library_ms": turns["library"][0], "bound_ms": b_ms,
                     "bound_by": b_by, "max_abs_err": e}
        emit("lm_kernels", kernel=name, timing_shape=[B, hq, hkv, S, D],
             causal=causal, dtype=str(q.dtype), gflop=flops / 1e9,
             turns_ms=turns[name],
             achieved_tflop_s=flops / (ms * 1e-3) / 1e12,
             bound_share=b_ms / ms,
             library_tflop_s=flops / (turns["library"][0] * 1e-3) / 1e12,
             **out[name])
    return out


def serve_phase(dev, reset_counts, read_counts) -> dict:
    """granite-3-8b at full width through ServeEngine.generate; returns the
    launches of the generate run, counted from 0 just before it."""
    from repro_torch.configs import get_config
    from repro_torch.models import api
    from repro_torch.serving import ServeEngine

    cfg = get_config(LM_ARCH).replace(attn_impl="flash")
    check(cfg.dtype == "bfloat16" and cfg.family == "dense",
          f"{LM_ARCH}: unexpected config {cfg}")
    max_len = SERVE_PROMPT + SERVE_GEN
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = api.init_params(cfg, SEED, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weight_gb = torch.cuda.memory_allocated() / 1e9
    batch = api.make_batch(cfg, SEED, SERVE_BATCH, SERVE_PROMPT, device=dev)
    eng = ServeEngine(cfg, params, max_len=max_len)

    # the main path, launches counted from 0 just before it
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks = eng.generate(batch, SERVE_GEN)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(launches["flash_attention"] == cfg.n_layers
          and launches["flash_attention_sm90"] == cfg.n_layers,
          f"serve: {launches} flash launches in one prefill, expected "
          f"{cfg.n_layers}, all on the sm90 route")
    t0 = time.perf_counter()
    again = eng.generate(batch, SERVE_GEN)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    check(tuple(toks.shape) == (SERVE_BATCH, SERVE_GEN)
          and toks.dtype == torch.int32, f"serve: tokens {toks.shape}")
    check(torch.equal(toks, again), "serve: two greedy runs differ")
    check(bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
          "serve: token id out of range")

    # prefill and decode apart: flash vs the einsum (plain) path, timings
    def prefill(c):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = api.prefill(c, params, batch, max_len=max_len)
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    (logits, cache), prefill_ms = prefill(cfg)
    check(tuple(logits.shape) == (SERVE_BATCH, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()), "serve: prefill logits")
    del cache
    (ref, ref_cache), einsum_ms = prefill(cfg.replace(attn_impl="einsum"))
    del ref_cache
    d = (logits.float() - ref.float())
    rel_l2 = float(torch.linalg.vector_norm(d)
                   / torch.linalg.vector_norm(ref.float()))
    max_rel = float(d.abs().max() / ref.float().abs().max())
    # the two paths round differently inside attention only (P in bf16,
    # the einsum path's f32 softmax); through 40 layers that is ~sqrt(40)
    # half-ulps, ~2.5% of the logits; the gate is 8 bf16 eps = 6.25%
    tol = 8 * torch.finfo(torch.bfloat16).eps
    check(rel_l2 <= tol and max_rel <= tol,
          f"serve: flash vs einsum prefill logits {rel_l2} / {max_rel} > "
          f"{tol}")
    agree = float((logits.argmax(-1) == ref.argmax(-1)).float().mean())
    del ref
    def decode(inplace):
        """ms per decode step over SERVE_GEN steps from a fresh prefill:
        in place, as generate() decodes, or the default functional step
        (a copy of the whole cache per step); and the steps' logits."""
        _, cache = api.prefill(cfg, params, batch, max_len=max_len)
        tok = logits.argmax(-1).to(torch.int32)
        out = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(SERVE_GEN):
            step_logits, cache = api.decode_step(cfg, params, tok, cache,
                                                 inplace=inplace)
            check(bool(torch.isfinite(step_logits).all()),
                  "serve: decode logits not finite")
            tok = step_logits.argmax(-1).to(torch.int32)
            out.append(tok)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / SERVE_GEN, out

    decode_ms, toks_inplace = decode(True)
    copying_ms, toks_copying = decode(False)
    check(all(torch.equal(a, b) for a, b in zip(toks_inplace, toks_copying)),
          "serve: in-place and functional decode steps differ")
    emit("serve", arch=LM_ARCH, dtype=cfg.dtype, attn_impl=cfg.attn_impl,
         params_b=cfg.param_count() / 1e9, weight_gb=weight_gb,
         init_s=init_s,
         batch=SERVE_BATCH, prompt=SERVE_PROMPT, new_tokens=SERVE_GEN,
         launches=launches, first_generate_s=first_s,
         warm_generate_s=warm_s,
         generated_tok_s=SERVE_BATCH * SERVE_GEN / warm_s,
         prefill_ms=prefill_ms, einsum_prefill_ms=einsum_ms,
         prefill_tok_s=SERVE_BATCH * SERVE_PROMPT / prefill_ms * 1e3,
         decode_ms_per_token=decode_ms,
         functional_decode_ms_per_token=copying_ms, peak_mem_gb=peak_gb,
         logits_rel_l2_vs_einsum=rel_l2, logits_max_rel_vs_einsum=max_rel,
         logits_tol=tol, first_token_agree=agree,
         sample=toks[0, :8].tolist())
    del params, eng
    torch.cuda.empty_cache()
    return launches


def launcher_phase(dev) -> None:
    """``python -m repro_torch.launch.serve --arch LAUNCH_ARCH --device
    cuda`` (the LM mode, full width, the launcher's default batch, prompt
    and new tokens; attn_impl "auto", einsum at this length) in a
    subprocess: it exits 0, prints its ``generated (4, 16) on cuda:...``
    line, and its sample's tokens are those of ServeEngine in this process
    from the same seed and config."""
    from repro_torch.configs import get_config
    from repro_torch.models import api
    from repro_torch.serving import ServeEngine

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")
    t0 = time.perf_counter()
    p = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         LAUNCH_ARCH, "--device", "cuda"], env=dict(os.environ,
                                                   PYTHONPATH=src),
        capture_output=True, text=True, timeout=300)
    wall = time.perf_counter() - t0
    check(p.returncode == 0, f"launcher: launch.serve --arch {LAUNCH_ARCH} "
          f"exited {p.returncode}: {p.stderr[-2000:]}")
    lines = p.stdout.splitlines()
    generated = [ln for ln in lines if ln.startswith("generated ")]
    want = f"generated ({LAUNCH_BATCH}, {LAUNCH_GEN}) on cuda:"
    check(len(generated) == 1 and generated[0].startswith(want),
          f"launcher: no {want!r} line in {lines}")
    sample = [json.loads(ln[len("sample:"):]) for ln in lines
              if ln.startswith("sample:")]
    cfg = get_config(LAUNCH_ARCH)
    params = api.init_params(cfg, SEED, device=dev)
    eng = ServeEngine(cfg, params, max_len=LAUNCH_PROMPT + LAUNCH_GEN + 1)
    batch = api.make_batch(cfg, SEED, LAUNCH_BATCH, LAUNCH_PROMPT,
                           device=dev)
    toks = eng.generate(batch, LAUNCH_GEN, temperature=0.0, seed=SEED)
    check(sample == [toks[0].tolist()],
          f"launcher: its sample {sample} is not the in-process "
          f"{toks[0].tolist()}")
    emit("launcher", arch=LAUNCH_ARCH, attn_impl=cfg.attn_impl,
         params_b=cfg.param_count() / 1e9, batch=LAUNCH_BATCH,
         prompt=LAUNCH_PROMPT, new_tokens=LAUNCH_GEN, wall_s=wall,
         line=generated[0], sample=sample[0], in_process_equal=True)
    del params, eng
    torch.cuda.empty_cache()


def _tree_tensors(tree):
    """Every tensor of a parameter / cache tree (NamedTuples, dicts, lists)."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tree_tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tree_tensors(v)


def row_rel_errors(a: torch.Tensor, ref: torch.Tensor,
                   rows: int = 256) -> torch.Tensor:
    """Relative L2 error of each row (last axis) of ``a`` against ``ref``,
    in float32, a slab of ``rows`` rows at a time (a full-width vocabulary
    in float32 would not fit twice)."""
    a2 = a.reshape(-1, a.shape[-1])
    r2 = ref.reshape(-1, ref.shape[-1])
    out = []
    for lo in range(0, a2.shape[0], rows):
        x = a2[lo:lo + rows].float()
        y = r2[lo:lo + rows].float()
        out.append(torch.linalg.vector_norm(x - y, dim=-1)
                   / torch.linalg.vector_norm(y, dim=-1))
    return torch.cat(out)


def _tree_map(fn, tree):
    """``fn`` on every tensor of a tree (NamedTuples, dicts, lists)."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return tree


def attention_layerwise(params, cfg, batch) -> list:
    """Each decoder block's attention output through the flash kernel and
    through attn_impl="chunked" on the same input, the flash model's
    residual stream (advanced by transformer.decoder_block): the largest
    row's relative L2 error of each layer."""
    from repro_torch.models import attention as att
    from repro_torch.models import transformer as tfm
    from repro_torch.models.layers import rms_norm

    tokens = batch["tokens"]
    B, S = tokens.shape
    x = params.embed[tokens]
    positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
    worst = []
    for bp in params.blocks:
        h = rms_norm(x, bp["attn_norm"], cfg.norm_eps)
        a, r = (att.multihead_attention(
            bp["attn"], h, cfg, positions=positions,
            window=cfg.sliding_window, impl=impl)
            for impl in ("flash", "chunked"))
        worst.append(float(row_rel_errors(a, r).max()))
        del a, r, h
        x = tfm.decoder_block(bp, x, cfg, positions, cfg.sliding_window)
    return worst


# The cross path's liveness gate.  A dead cross path (a gate left at 0, the
# memory unused) moves nothing when the vision / frame embeddings are
# zeroed: the same path on the same input gives the same bits, so in bf16
# every row of the prefill's logits must move at all.  At random weights a
# live one moves llama-3.2-vision's rows by only ~2-3% (its 8 cross blocks
# average 1,600 memory rows each), under the 8-eps flash-vs-chunked
# tolerance, so the margin is taken in float32 on the first request (the
# float32 decode check's model): the move there must exceed
# CROSS_LIVE_F32_TOLS x F32_DECODE_TOL.
CROSS_LIVE_F32_TOLS = 10
# The cached cross decode on the bf16 memory (read as it is) against the
# same function on the memory cast to float32, elementwise
# (cross_decode_tol): both sides sum exact products in float32 in other
# orders (q and the probabilities as three bf16 pieces on one side).
CROSS_DECODE_EPS = 2.0


def cross_decode_tol(q, k32, v32):
    """The elementwise tolerance of cross_attend_cached(q, k, v) on a bf16
    memory against the float32 route: a logit is a sum of hd products,
    off by ~eps sqrt(hd) of its terms' magnitudes, at most lmax = max_s
    |q| . |k_s| in a row, which moves the output by that much of
    attention(q, k, |v|); the output sums S products, off by ~eps sqrt(S)
    of attention(q, k, |v|).  CROSS_DECODE_EPS times the two."""
    from repro_torch.models.attention import cross_attend_cached

    B, _, H, hd = q.shape
    K, S = k32.shape[1], k32.shape[2]
    lmax = torch.bmm(q.abs().reshape(B * K, H // K, hd),
                     k32.abs().reshape(B * K, S, hd).transpose(1, 2)
                     ).amax(-1).reshape(B, 1, H, 1)
    a = cross_attend_cached(q, k32, v32.abs()).reshape(B, 1, H, hd)
    eps = torch.finfo(torch.float32).eps
    tol = CROSS_DECODE_EPS * eps * (S ** 0.5 + hd ** 0.5 * lmax) * a
    return tol.reshape(B, 1, H * hd)

# float32 decode against the forward: both paths sum in f32 in other
# orders (GEMMs of up to 16,512 rows against 1, the recurrent and the
# chunked/scanned SSD and RG-LRU), ~eps * sqrt(n) ~ 1.3e-5 a GEMM; the
# bf16 runs show the layers amplify a rounding up to ~50x (errors of 3-11%
# from bf16's 0.2%), so ~7e-4 at most
F32_DECODE_TOL = 1e-3


def decode_vs_forward_f32(cfg, params, prompt, fed, steps,
                          extras=None) -> tuple:
    """The model in float32 (its bf16 weights cast, exactly): decode from
    the prompt's prefill, fed the tokens ``fed``; step i's logits against
    the prefill over the prompt and the first i tokens fed.  ``extras``:
    the batch's vision / frame embeddings (cast too).  Returns the largest
    row's relative L2 error at each step of ``steps``, and with ``extras``
    the least row's relative move of the prompt's prefill logits when they
    are zeroed (else None)."""
    from repro_torch.models import api

    c32 = cfg.replace(dtype="float32")
    p32 = _tree_map(lambda t: t.float(), params)
    x32 = {k: t.float() for k, t in (extras or {}).items()}
    n = max(steps)
    first, cache = api.prefill(c32, p32, {"tokens": prompt, **x32},
                               max_len=prompt.shape[1] + n)
    live = None
    if x32:
        zeroed, c = api.prefill(c32, p32, {"tokens": prompt, **{
            k: torch.zeros_like(t) for k, t in x32.items()}},
            max_len=prompt.shape[1])
        del c
        live = float(row_rel_errors(zeroed, first).min())
        del zeroed
    out = {}
    for i in range(1, n + 1):
        step_logits, cache = api.decode_step(c32, p32, fed[i - 1], cache,
                                             inplace=True)
        if i in steps:
            seq = torch.cat([prompt] + [t[:, None] for t in fed[:i]], dim=1)
            full, c = api.prefill(c32, p32, {"tokens": seq, **x32},
                                  max_len=seq.shape[1])
            del c
            out[i] = float(row_rel_errors(step_logits, full).max())
    del p32, cache
    torch.cuda.empty_cache()
    return out, live


def open_cross_gates(params, dev):
    """A vlm's parameters with each cross block's gate set so that
    tanh(gate) is drawn uniformly from [0.25, 0.75] (from the seed); at
    its initial 0 a cross block adds nothing."""
    u = torch.rand((len(params.cross),), generator=torch.Generator(
        device=dev).manual_seed(SEED), device=dev) * 0.5 + 0.25
    return params._replace(cross=[
        dict(cp, gate=torch.atanh(t)) for cp, t in zip(params.cross, u)])


# decode steps of a dense cell's traced busy share
BUSY_DECODE_STEPS = 8
# The int8 KV cache's decode logits against the model-dtype cache's, the
# same tokens fed: the largest row's relative L2 over the decode steps.
# Predicted 5e-2 before it was measured; starcoder2-15b whole gave
# 1.30-1.36e-2 at every one of its 32 steps on the H100 (PERF.md), so the
# gate is 2.2x that.
INT8_DECODE_RTOL = 3e-2


def traced_busy(fn) -> float:
    """The card's busy share of one call of ``fn``, traced by
    torch.profiler (whose cost is included)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return busy_share(prof, wall)


def int8_cache_run(phase, cfg, params, batch, max_len, fed, outs,
                   model_ms) -> dict:
    """The same prompts with kv_cache_dtype="int8": the prefill, then one
    in-place decode step a token of ``fed`` (the model-dtype run's tokens,
    whose step logits are ``outs``).  Gates: after the prefill each layer's
    int8 k / v planes are the port's quantization (quantize_kv) of the
    model-dtype cache's k / v at the prompt's positions, within one int8
    step in under 1e-3 of their values, and the bf16 scales within a bf16
    eps; every decode logit finite; each step's logits within
    INT8_DECODE_RTOL (a row's relative L2) of the model-dtype run's.
    Returns the run's record: cache bytes against the model-dtype cache's,
    decode ms a token against ``model_ms``."""
    from repro_torch.models import api
    from repro_torch.models.attention import quantize_kv

    c8 = cfg.replace(kv_cache_dtype="int8")
    S = batch["tokens"].shape[1]
    logits_m, cache_m = api.prefill(cfg, params, batch, max_len=max_len)
    logits8, cache8 = api.prefill(c8, params, batch, max_len=max_len)
    eps = torch.finfo(torch.bfloat16).eps
    off, n_off, n, scale_rel = 0, 0, 0, 0.0
    for cm, cq in zip(cache_m.self_kv, cache8.self_kv):
        check(cq.k.dtype == cq.v.dtype == torch.int8
              and cq.k_scale.dtype == cq.v_scale.dtype == torch.bfloat16,
              f"{phase} int8: cache planes {cq.k.dtype} / {cq.k_scale.dtype}")
        for name in ("k", "v"):
            want, want_scale = quantize_kv(getattr(cm, name)[:, :S])
            d = (getattr(cq, name)[:, :S].int() - want.int()).abs()
            off = max(off, int(d.max()))
            n_off += int((d > 0).sum())
            n += d.numel()
            scale_rel = max(scale_rel, float((
                getattr(cq, name + "_scale")[:, :S].float()
                - want_scale.float()).abs().div(want_scale.float()).max()))
    check(off <= 1 and n_off < 1e-3 * n and scale_rel <= eps,
          f"{phase} int8: the prefill's cache is not the quantized "
          f"model-dtype cache: planes up to {off} steps off ({n_off} of "
          f"{n}), scales {scale_rel} relative")
    model_bytes = sum(t.nbytes for c in cache_m.self_kv for t in (c.k, c.v))
    int8_bytes = sum(t.nbytes for c in cache8.self_kv
                     for t in (c.k, c.v, c.k_scale, c.v_scale))
    prefill_rel = float(row_rel_errors(logits8, logits_m).max())
    del cache_m, logits_m, logits8
    steps = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for tok in fed:
        step_logits, cache8 = api.decode_step(c8, params, tok, cache8,
                                              inplace=True)
        steps.append(step_logits)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / len(fed)
    check(all(bool(torch.isfinite(o).all()) for o in steps),
          f"{phase} int8: decode logits not finite")
    rel = [float(row_rel_errors(a, b).max()) for a, b in zip(steps, outs)]
    check(max(rel) <= INT8_DECODE_RTOL,
          f"{phase} int8: decode logits against the model-dtype cache's, "
          f"rows up to {max(rel)} > {INT8_DECODE_RTOL}")
    del cache8, steps
    torch.cuda.empty_cache()
    return {"prefill_plane_steps_off_max": off,
            "prefill_plane_share_off": n_off / n,
            "prefill_scale_rel_max": scale_rel,
            "prefill_logits_row_rel_max": prefill_rel,
            "decode_steps": len(fed), "decode_row_rel_max": max(rel),
            "decode_row_rel_by_step": rel,
            "decode_row_rel_tol": INT8_DECODE_RTOL,
            "cache_gb": int8_bytes / 1e9,
            "model_dtype_cache_gb": model_bytes / 1e9,
            "cache_ratio": int8_bytes / model_bytes,
            "decode_ms_per_token": ms,
            "model_dtype_decode_ms_per_token": model_ms}


def family_serve_phase(phase, cfg, batch_size, prompt, gen_len, dev, smi,
                       reset_counts, read_counts, f32_layers=None,
                       int8=False) -> dict:
    """One model at full width (bf16, attn_impl="flash", random weights
    from the seed, initialized on the card) through ServeEngine.generate:
    a family's cell (FAMILY_CELLS) or a dense one (DENSE_CELLS); returns
    the launches of the generate run, counted from 0 just before it.

    Gates: the flash launches of the run are the model's attention layers
    (one prefill), all on the sm90 route; two greedy runs give equal
    tokens; the in-place and functional decode give equal tokens; every
    logit is finite; the prefill's logits are the forward's last row; the
    flash path against attn_impl="chunked" (the einsum path's (B, Hq, S,
    S) f32 scores would not fit); for ssm and hybrid the decode steps
    against the prefill (a full forward) over the prompt plus the tokens
    fed so far.

    Flash against chunked, relative L2 of a row: 8 bf16 eps (6.25%), as
    the dense serve phase.  The paths round attention differently (P in
    bf16 against an f32 softmax); each layer's bf16 output is off by
    ~2^-9 of itself, and L layers add ~sqrt(L) of those.  ssm has no
    attention: the paths are bitwise.  hybrid: every row of the forward's
    logits.  moe: a (token, choice) pair whose 2nd and 3rd gates tie
    within that rounding takes another expert (or falls on the other side
    of its expert's capacity) on one path, its row then differs by O(1),
    and its keys move the other tokens' attention in the next layers, so
    the flips cascade (most rows of a 16-layer forward at random weights).
    So moe is held layer by layer: each attention block's output on the
    same input, every row; the forward's rows, and the share routed alike
    at every layer, are reported.

    Decode against the forward: bf16 errors reported (the layers amplify
    the two paths' roundings, GEMMs of B rows against B * S, the
    recurrent SSD / RG-LRU against the chunked / scanned ones, and the
    recurrent state carries them from step to step), float32 on the first
    prompt gated at F32_DECODE_TOL.  moe is exempt: its prefill drops
    pairs that decode keeps.  With ``f32_layers`` the float32 check runs
    on the model cut to that many layers at full width (from the seed),
    the bf16 model freed first: its float32 copy would not fit beside it.

    dense: the card's busy share of a traced prefill and of traced decode
    steps; with ``int8`` the int8 KV-cache run (int8_cache_run).

    vlm and encdec: the batch carries the stub vision / frame embeddings
    (make_batch, bf16 from the seed).  Each vlm cross gate is set first so
    that tanh(gate) lies in [0.25, 0.75] (at its initial 0 a cross block
    adds nothing and a wrong cross path would pass every gate); the cross
    path must be live: with the embeddings zeroed every row of the
    prefill's logits moves (bf16), and the first request's by more than
    CROSS_LIVE_F32_TOLS x F32_DECODE_TOL in float32.  Each layer's cached
    cross decode on the prefill's bf16 memory holds to the float32 route
    elementwise (cross_decode_tol).  The encoder's flash launches are the
    non-causal ones, and its memory is held flash against chunked too."""
    from repro_torch.models import api, moe
    from repro_torch.models import transformer as tfm
    from repro_torch.serving import ServeEngine

    check(cfg.dtype == "bfloat16" and cfg.family in (
        "dense", "moe", "ssm", "hybrid", "vlm", "encdec"),
          f"{phase}: unexpected config {cfg}")
    n_attn = {"dense": cfg.n_layers, "moe": cfg.n_layers, "ssm": 0,
              "hybrid": cfg.n_layers // max(cfg.attn_every, 1),
              "vlm": cfg.n_layers // max(cfg.cross_every, 1)
              * cfg.cross_every,
              "encdec": cfg.encoder_layers + cfg.n_layers}[cfg.family]
    n_noncausal = cfg.encoder_layers if cfg.family == "encdec" else 0
    max_len = prompt + gen_len
    tol = 8 * torch.finfo(torch.bfloat16).eps
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base_gb = torch.cuda.memory_allocated() / 1e9
    t0 = time.perf_counter()
    params = api.init_params(cfg, SEED, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    gates = None
    if cfg.family == "vlm":
        params = open_cross_gates(params, dev)
        gates = torch.tanh(torch.stack([cp["gate"] for cp in params.cross]))
        check(bool(((gates >= 0.25) & (gates <= 0.75)).all()),
              f"{phase}: tanh(gate) {gates.tolist()} outside [0.25, 0.75]")
        gates = gates.tolist()
    weight_bytes = sum(t.nbytes for t in _tree_tensors(params))
    batch = api.make_batch(cfg, SEED, batch_size, prompt, device=dev)
    extras = {k: t for k, t in batch.items() if k in ("vision", "frames")}
    eng = ServeEngine(cfg, params, max_len=max_len)

    # the main path, launches counted from 0 just before it
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with moe.routing_stats() as routing:
        toks = eng.generate(batch, gen_len)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(launches["flash_attention"] == n_attn
          and launches["flash_attention_sm90"] == n_attn
          and launches["flash_attention_noncausal"] == n_noncausal,
          f"{phase}: {launches} flash launches in one generate, expected "
          f"{n_attn}, all on the sm90 route, {n_noncausal} of them "
          f"non-causal")
    dropped = (float(routing["dropped"]) / routing["pairs"]
               if routing["pairs"] else None)
    t0 = time.perf_counter()
    again = eng.generate(batch, gen_len)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    check(tuple(toks.shape) == (batch_size, gen_len)
          and toks.dtype == torch.int32, f"{phase}: tokens {toks.shape}")
    check(torch.equal(toks, again), f"{phase}: two greedy runs differ")
    check(bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
          f"{phase}: token id out of range")
    del again

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = api.prefill(cfg, params, batch, max_len=max_len)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    check(tuple(logits.shape) == (batch_size, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()), f"{phase}: prefill logits")
    cache_bytes = sum(t.nbytes for t in _tree_tensors(cache))
    cross_decode_rel = None
    if extras:
        # the cached cross decode on each layer's bf16 memory, read as it
        # is, against the same function on the memory cast to float32
        from repro_torch.models.attention import cross_attend_cached

        mems = (cache.cross_kv if cfg.family == "vlm"
                else list(zip(cache.cross_k, cache.cross_v)))
        qgen = torch.Generator(device=dev).manual_seed(SEED)
        cross_decode_rel = 0.0    # the worst |a - r| over its tolerance
        for mk, mv in mems:
            q = torch.randn((batch_size, 1, cfg.n_heads, cfg.hd),
                            generator=qgen, device=dev) * cfg.hd ** -0.5
            a = cross_attend_cached(q, mk, mv)
            k32, v32 = mk.float(), mv.float()
            r = cross_attend_cached(q, k32, v32)
            tol_e = cross_decode_tol(q, k32, v32)
            cross_decode_rel = max(cross_decode_rel,
                                   float(((a - r).abs() / tol_e).max()))
            del a, r, k32, v32, tol_e
        check(cross_decode_rel <= 1.0,
              f"{phase}: cached cross decode on the bf16 memory vs the "
              f"float32 route: {cross_decode_rel} x its tolerance")
    del cache

    # the cross path is live: the embeddings zeroed move every row
    cross_live = None
    if extras:
        zeroed, c = api.prefill(cfg, params, {**batch, **{
            k: torch.zeros_like(t) for k, t in extras.items()}},
            max_len=prompt)
        del c
        cross_live = row_rel_errors(zeroed, logits)
        check(float(cross_live.min()) > 0.0,
              f"{phase}: the {'/'.join(extras)} zeroed leave a row of the "
              f"prefill's logits as it was: the cross path is dead")
        del zeroed

    # the forward at every prompt position: flash against chunked, with
    # each token's experts and kept pairs at every layer (moe)
    with moe.routing_stats() as flash_routes:
        flash = api.forward_logits(cfg, params, batch)
    check(bool(torch.isfinite(flash).all()), f"{phase}: forward logits")
    last_rel = float(row_rel_errors(flash[:, -1], logits).max())
    check(last_rel <= tol, f"{phase}: prefill logits vs the forward's last "
          f"position {last_rel} > {tol}")
    with moe.routing_stats() as ref_routes:
        ref = api.forward_logits(cfg.replace(attn_impl="chunked"), params,
                                 batch)
    rel = row_rel_errors(flash, ref)
    del flash, ref
    memory_rel = None
    if cfg.family == "encdec":
        # the encoder's memory, flash (non-causal) against chunked
        memory_rel = float(row_rel_errors(
            tfm.encode_audio(params, cfg, batch["frames"]),
            tfm.encode_audio(params, cfg.replace(attn_impl="chunked"),
                             batch["frames"])).max())
        check(memory_rel <= tol, f"{phase}: flash vs chunked encoder "
              f"memory, rows up to {memory_rel} > {tol}")
    if n_attn == 0:
        check(float(rel.max()) == 0.0,
              f"{phase}: no attention, yet flash and chunked differ")
    # rows whose token took the same experts and kept the same pairs at
    # every layer on both paths (all rows, but moe's)
    same = torch.ones_like(rel, dtype=torch.bool)
    for a, b in zip(flash_routes["routes"], ref_routes["routes"]):
        same &= (a == b).all(-1)
    same_share = float(same.float().mean())
    del flash_routes, ref_routes
    layer_rel = None
    if cfg.family == "moe":
        # routing flips cascade through the layers (a flipped token's keys
        # move the others' attention), so the paths are held layer by
        # layer on the same input: each attention block's output, flash
        # against chunked, on the flash model's residual stream
        layer_rel = attention_layerwise(params, cfg, batch)
        gated = max(layer_rel)
        check(gated <= tol, f"{phase}: flash vs chunked attention output, "
              f"a layer's rows up to {gated} > {tol}")
    else:
        gated = float(rel.max())
        check(gated <= tol, f"{phase}: flash vs chunked forward logits, "
              f"rows up to {gated} > {tol}")

    def decode(inplace):
        """ms per decode step over gen_len steps from a fresh prefill: in
        place, as generate() decodes, or the default functional step; the
        steps' tokens and logits."""
        _, cache = api.prefill(cfg, params, batch, max_len=max_len)
        tok = logits.argmax(-1).to(torch.int32)
        fed, outs = [], []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(gen_len):
            step_logits, cache = api.decode_step(cfg, params, tok, cache,
                                                 inplace=inplace)
            fed.append(tok)
            outs.append(step_logits)
            tok = step_logits.argmax(-1).to(torch.int32)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / gen_len
        check(all(bool(torch.isfinite(o).all()) for o in outs),
              f"{phase}: decode logits not finite")
        return ms, fed, outs

    with moe.routing_stats() as step_routing:
        decode_ms, fed, outs = decode(True)
    copying_ms, fed_copying, _ = decode(False)
    check(all(torch.equal(a, b) for a, b in zip(fed, fed_copying)),
          f"{phase}: in-place and functional decode steps differ")

    # the least time of a decode step: each weight read once (a tied head
    # reads the whole embedding; an untied one reads one row a token of
    # it), and of the experts only those chosen in the step
    read = weight_bytes
    if not cfg.tie_embeddings:
        read -= params.embed.nbytes
    experts_a_step = None
    if cfg.family == "moe":
        per_expert = params.blocks[0]["moe"]["w_gate"][0].nbytes * 3
        experts_a_step = step_routing["decode_experts"] / gen_len
        read -= cfg.n_layers * cfg.n_experts * per_expert
        read += experts_a_step * per_expert
    bound_ms = read / HBM_BYTES_PER_S * 1e3
    # with the caches read too: every KV slot (decode reads the whole
    # cache), the recurrent states and the cross K/V
    read_all_ms = (read + cache_bytes) / HBM_BYTES_PER_S * 1e3

    busy = int8_run = None
    if cfg.family == "dense":
        def decode_steps():
            """BUSY_DECODE_STEPS in-place steps from a fresh prefill (made
            before the trace), fed the run's tokens."""
            _, cache = api.prefill(cfg, params, batch, max_len=max_len)

            def run():
                c = cache
                for t in fed[:BUSY_DECODE_STEPS]:
                    _, c = api.decode_step(cfg, params, t, c, inplace=True)
            return run

        busy = {"prefill": traced_busy(lambda: api.prefill(
                    cfg, params, batch, max_len=max_len)),
                "decode": traced_busy(decode_steps()),
                "decode_steps": BUSY_DECODE_STEPS}
    if int8:
        int8_run = int8_cache_run(phase, cfg, params, batch, max_len, fed,
                                  outs, decode_ms)
    # decode step i (from 1) against the prefill (a full forward) over the
    # prompt + i tokens: in bf16 reported, in float32 (the same weights,
    # cast exactly) on the first prompt gated
    vs_forward, vs_forward_f32, cross_live_f32 = {}, {}, None
    if cfg.family != "moe":
        steps = (1, 8, gen_len)
        for i in steps:
            seq = torch.cat([batch["tokens"]] + [t[:, None] for t in fed[:i]],
                            dim=1)
            full, c = api.prefill(cfg, params, {"tokens": seq, **extras},
                                  max_len=seq.shape[1])
            del c
            vs_forward[i] = float(row_rel_errors(outs[i - 1], full).max())
        f32_cfg, f32_params = cfg, params
        if f32_layers is not None:
            # the bf16 model freed, the float32 check's model cut in depth
            eng = params = f32_params = None
            torch.cuda.empty_cache()
            f32_cfg = cfg.replace(n_layers=f32_layers)
            f32_params = api.init_params(f32_cfg, SEED, device=dev)
        vs_forward_f32, cross_live_f32 = decode_vs_forward_f32(
            f32_cfg, f32_params, batch["tokens"][:1], [t[:1] for t in fed],
            steps, {k: t[:1] for k, t in extras.items()})
        del f32_params
        worst = max(vs_forward_f32.values())
        check(worst <= F32_DECODE_TOL,
              f"{phase}: float32 decode steps vs the forward over the prompt "
              f"and the tokens fed: {vs_forward_f32} > {F32_DECODE_TOL}")
        check(cross_live_f32 is None or cross_live_f32
              > CROSS_LIVE_F32_TOLS * F32_DECODE_TOL,
              f"{phase}: in float32 the {'/'.join(extras)} zeroed move the "
              f"first request's logits by only {cross_live_f32} <= "
              f"{CROSS_LIVE_F32_TOLS} x {F32_DECODE_TOL}")

    emit(phase, arch=cfg.name, family=cfg.family, dtype=cfg.dtype,
         n_layers=cfg.n_layers, attn_impl=cfg.attn_impl,
         params_b=cfg.param_count() / 1e9, weight_gb=weight_bytes / 1e9,
         other_resident_gb=base_gb, init_s=init_s, batch=batch_size,
         prompt=prompt, new_tokens=gen_len, launches=launches,
         attention_layers=n_attn, first_generate_s=first_s,
         warm_generate_s=warm_s,
         generated_tok_s=batch_size * gen_len / warm_s,
         prefill_ms=prefill_ms,
         prefill_tok_s=batch_size * prompt / prefill_ms * 1e3,
         decode_ms_per_token=decode_ms,
         functional_decode_ms_per_token=copying_ms,
         decode_weight_read_gb=read / 1e9,
         decode_weight_bound_ms=bound_ms,
         decode_bound_share=bound_ms / decode_ms,
         cache_gb=cache_bytes / 1e9,
         decode_read_bound_ms=read_all_ms,
         decode_read_bound_share=read_all_ms / decode_ms,
         cross_gates=gates,
         cross_live_row_rel_min=(None if cross_live is None
                                 else float(cross_live.min())),
         cross_live_row_rel_median=(None if cross_live is None
                                    else float(cross_live.median())),
         cross_live_f32_first_request=cross_live_f32,
         cross_live_f32_gate=(CROSS_LIVE_F32_TOLS * F32_DECODE_TOL
                              if extras else None),
         cross_decode_vs_f32_over_tol=cross_decode_rel,
         encoder_memory_row_rel_max=memory_rel,
         decode_experts_read_a_step=experts_a_step,
         prefill_dropped_pair_share=dropped,
         moe_capacity=(max(1, int(min(cfg.moe_group_size,
                                      batch_size * prompt)
                              * cfg.experts_per_token
                              * cfg.capacity_factor / cfg.n_experts))
                       if cfg.family == "moe" else None),
         peak_mem_gb=peak_gb, logits_tol=tol,
         forward_row_rel_max=float(rel.max()),
         forward_row_rel_p90=float(torch.quantile(rel, 0.9)),
         forward_rows_over_tol=float((rel > tol).float().mean()),
         forward_rows_routed_alike=same_share,
         forward_row_rel_max_routed_alike=float(rel[same].max()),
         gated_rel_max=gated,
         prefill_vs_forward_last=last_rel,
         decode_vs_forward=vs_forward,
         decode_vs_forward_f32=vs_forward_f32,
         decode_vs_forward_f32_tol=F32_DECODE_TOL,
         decode_f32_layers=(None if cfg.family == "moe" else
                            f32_layers or cfg.n_layers),
         busy_share=busy, int8_cache=int8_run,
         attention_layer_rel_max=layer_rel, sample=toks[0, :8].tolist(),
         nvidia_smi=smi)
    del params, eng, logits, outs
    torch.cuda.empty_cache()
    return launches


# ------------------------------------------------------- paper oracles ----
def paper_phase(S, f, m1, m2, dev, cols, greedy_wall, smi, reset_counts,
                read_counts):
    """The paper's oracles on complex128 cuts of the smoke's grid, then MGS
    at full width.  Returns the cut's greedy basis (served next) and the
    launches of the scan and the reconstruction."""
    from repro_torch.api import build_basis
    from repro_torch.core.errors import per_column_errors, proj_error_2norm
    from repro_torch.core.greedy import rb_greedy, rb_greedy_scan
    from repro_torch.core.pod import (
        first_below, pod, pod_error_2norm, pod_error_fro,
    )
    from repro_torch.core.reconstruction import reconstruction
    from repro_torch.core.rrqr import optimal_rrqr, rrqr_error_2norm
    from repro_torch.gw import build_snapshot_matrix
    from repro_torch.gw.waveform import taylorf2_batch

    t_phase = time.perf_counter()
    m1c, m2c = m1[::CUT_STRIDE], m2[::CUT_STRIDE]
    S1 = build_snapshot_matrix(f, m1c, m2c, dtype=torch.complex128,
                               device=dev)
    S2 = taylorf2_batch(torch.as_tensor(f, device=dev), torch.as_tensor(m1c),
                        torch.as_tensor(m2c), normalize=False,
                        dtype=torch.complex128)
    Mc = S1.shape[1]
    cut = {"N": N, "M": Mc, "stride": CUT_STRIDE, "dtype": "complex128"}

    # Thm 3.2: POD's error is sigma_{k+1} in the 2-norm and the tail's
    # root sum of squares in Frobenius
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sig = pod(S1, 0.0, device=dev).sigmas
    k = first_below(sig, POD_REL_TAU * float(sig[0]))
    e2 = float(pod_error_2norm(S1, k, device=dev))
    ef = float(pod_error_fro(S1, k, device=dev))
    torch.cuda.synchronize()
    pod_s = time.perf_counter() - t0
    tail = float(torch.sqrt((sig[k:] ** 2).sum()))
    check(0 < k < Mc, f"paper: POD rank {k} of {Mc}")
    check(abs(e2 - float(sig[k])) <= 1e-10 * float(sig[k]),
          f"paper Thm 3.2 (2-norm): {e2} vs sigma_k+1 {float(sig[k])}")
    check(abs(ef - tail) <= 1e-10 * tail,
          f"paper Thm 3.2 (Frobenius): {ef} vs {tail}")

    # Thm 5.1: the optimal RRQR reaches sigma_{k+1} exactly
    t0 = time.perf_counter()
    rr = optimal_rrqr(S1, k, device=dev)
    er = float(rrqr_error_2norm(S1, rr.Qk))
    eye = torch.eye(k, dtype=rr.Qk.dtype, device=dev)
    orth = float((rr.Qk.mH @ rr.Qk - eye).abs().max())
    torch.cuda.synchronize()
    rrqr_s = time.perf_counter() - t0
    check(abs(er - float(sig[k])) <= 1e-10 * float(sig[k]),
          f"paper Thm 5.1: {er} vs sigma_k+1 {float(sig[k])}")
    # elementwise within 1e-10, as tests/test_rrqr.py holds it
    check(orth <= 1e-10, f"paper Thm 5.1: Qk not orthonormal ({orth})")
    del rr

    # Prop 5.3 on unnormalized snapshots, tau 1e-5 of the largest column
    # norm (the reference test's rule); then the scan and the
    # reconstruction, every launch of theirs on the sm90 route
    tau = 1e-5 * float(torch.linalg.vector_norm(S2, dim=0).max())
    t0 = time.perf_counter()
    g = build_basis(source=S2, strategy="greedy", tau=tau,
                    max_k=CUT_MAX_K, device=dev)
    mg = build_basis(source=S2, strategy="mgs", tau=tau, max_k=CUT_MAX_K,
                     device=dev)
    torch.cuda.synchronize()
    prop_s = time.perf_counter() - t0
    check(g.provenance["stop"] == "STOP_TAU",
          f"paper Prop 5.3: the greedy build stopped by {g.provenance}")
    # the same k, unless the next error lies within its rounding of tau:
    # greedy's comes from |s|^2 - sum |c|^2, off by ~eps |s|^2 / err^2
    # relative (~2e-6 at err = 1e-5 |s|), MGS's from a deflated column, so
    # the two stop decisions may part there by one basis
    kk = min(mg.k, g.k)
    longer = g if g.k > mg.k else mg
    tie = mg.k != g.k
    check(kk >= 5 and abs(mg.k - g.k) <= 1 and (
        not tie or abs(float(longer.errs[kk]) - tau) <= 1e-5 * tau),
        f"paper Prop 5.3: k {mg.k} vs {g.k} (tau {tau}, next errs "
        f"{longer.errs[kk:]})")
    check(np.array_equal(mg.pivots[:kk], g.pivots[:kk]),
          "paper Prop 5.3: MGS and greedy pivots differ")
    # errs within 1e-6 relative, plus the rounding of greedy's Eq.-(6.3)
    # err = sqrt(|s|^2 - sum |c|^2): ~eps |s|^2 / err in absolute terms
    scale = tau / 1e-5
    diff = np.abs(mg.errs[:kk] - g.errs[:kk])
    errs_tol = 1e-6 * g.errs[:kk] + 10 * np.finfo(np.float64).eps \
        * scale ** 2 / g.errs[:kk]
    errs_rel = float(np.max(diff / g.errs[:kk]))
    errs_worst = float(np.max(diff / errs_tol))
    check(errs_worst <= 1.0, f"paper Prop 5.3: errs differ by {errs_rel} "
          f"relative, {errs_worst} x the tolerance")
    # sin of the largest principal angle, |(I - Q_g Q_g^H) Q_mgs|_2: stable
    # where sqrt(1 - s_min^2) turns MGS's 1e-10 loss of orthogonality
    # into 1e-5
    span = float(torch.linalg.matrix_norm(
        mg.Q[:, :kk] - g.Q[:, :kk] @ (g.Q[:, :kk].mH @ mg.Q[:, :kk]),
        ord=2))
    check(span < 1e-5, f"paper Prop 5.3: span distance {span}")

    reset_counts()
    t0 = time.perf_counter()
    scan = rb_greedy_scan(S2, tau, g.k + 4, device=dev)
    k_scan = int(scan.k)
    torch.cuda.synchronize()
    scan_s = time.perf_counter() - t0
    check(k_scan == g.k and np.array_equal(
        scan.pivots[:g.k].cpu().numpy(), g.pivots),
        f"paper rb_greedy_scan: k {k_scan} vs {g.k} or pivots differ")
    check(bool((scan.pivots[g.k:] == -1).any()),
          "paper rb_greedy_scan: no masked step wrote pivot -1")
    del scan
    # Thm 5.11 on the normalized cut: the partial QR to tau1, its R
    tau1, tau2 = 1e-6, 1e-5
    t0 = time.perf_counter()
    rec = reconstruction(S1, tau1, tau2, max_j=MAX_K, device=dev)
    torch.cuda.synchronize()
    rec_s = time.perf_counter() - t0
    gq = rb_greedy(S1, tau1, max_k=MAX_K, device=dev)
    launches = read_counts()
    check(gq.k == rec.j and torch.equal(gq.Q[:, :rec.j], rec.Qj),
          "paper Thm 5.11: the partial QR is not rb_greedy's")
    for n in ("greedy_update", "imgs_project"):
        check(launches[n] > 0 and launches[n + "_sm90"] == launches[n]
              and launches[n + "_general"] == 0,
              f"paper: a launch of {n} left the sm90 route: {launches}")
    # S1 = Q_j R(1:j, :); its singular values are R's (Q_j orthonormal),
    # which the reconstruction has taken: sigmas_R
    S1_qr = rec.Qj @ gq.R[:rec.j]
    sig1 = rec.sigmas_R
    r22 = float(torch.linalg.matrix_norm(S1 - S1_qr, ord=2))
    bound_511 = []
    for jj in (3, 5):
        lhs = float(proj_error_2norm(S1, rec.X[:, :jj]))
        rhs = float(sig1[jj]) + r22
        check(lhs <= rhs * (1 + 1e-8) + 1e-12,
              f"paper Thm 5.11 at j={jj}: {lhs} > {rhs}")
        bound_511.append({"j": jj, "lhs": lhs, "rhs": rhs})
    del S1_qr, gq
    emit("paper", cut=cut, card=smi,
         pod={"k": k, "sigma_1": float(sig[0]), "sigma_k1": float(sig[k]),
              "err_2norm": e2, "err_fro": ef, "fro_tail": tail,
              "rel_tol": 1e-10, "seconds": pod_s},
         rrqr={"k": k, "err_2norm": er, "orthogonality": orth,
               "seconds": rrqr_s},
         prop_5_3={"tau": tau, "k": g.k, "k_mgs": mg.k,
                   "stop": g.provenance["stop"], "tie_at_tau": tie,
                   "next_err_over_tau": (float(longer.errs[kk]) / tau
                                         if tie else None),
                   "pivots_equal": True,
                   "errs_max_rel_diff": errs_rel,
                   "errs_diff_over_tol": errs_worst, "span_distance": span,
                   "seconds": prop_s},
         scan={"k": k_scan, "max_k": g.k + 4, "seconds": scan_s},
         reconstruction={"tau1": tau1, "tau2": tau2, "j": rec.j,
                         "k": rec.k, "r22_2norm": r22,
                         "thm_5_11": bound_511, "seconds": rec_s},
         launches={n: launches[n] for n in (
             "greedy_update", "greedy_update_sm90", "imgs_project",
             "imgs_project_sm90")})
    del S1, rec, mg

    # MGS through the front door on the full-width S: one working copy of
    # S (Remark 5.4), ~6kNM against greedy's 2kNM
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    m = build_basis(source=S, strategy="mgs", tau=TAU, max_k=MAX_K,
                    device=dev)
    torch.cuda.synchronize()
    mgs_wall = time.perf_counter() - t0
    extra_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
    check(5 <= m.k <= MAX_K and np.all(np.isfinite(m.errs)),
          f"paper MGS: bad rank {m.k}")
    # one working copy of S, plus Q, R and the chunked norms' temporaries
    # (two 8192-column slices of |V|^2: ~0.66 GB here)
    check(extra_gb <= 1.15 * S.nbytes / 1e9,
          f"paper MGS: {extra_gb} GB above S, more than one working copy")
    pce = float(per_column_errors(S.index_select(1, cols), m.Q).max())
    check(math.isfinite(pce), "paper MGS: sampled errors not finite")
    emit("paper", check="mgs_full_width", card=smi, shape=[N, M],
         dtype="complex64", tau=TAU, k=m.k, wall_s=mgs_wall,
         greedy_wall_s=greedy_wall, wall_ratio=mgs_wall / greedy_wall,
         s_per_basis=mgs_wall / m.k, peak_extra_gb=extra_gb,
         s_gb=S.nbytes / 1e9, peak_extra_over_s=extra_gb * 1e9 / S.nbytes, max_sampled_col_err=pce,
         last_r_diag=float(m.errs[-1]),
         phase_s=time.perf_counter() - t_phase)
    del m
    torch.cuda.empty_cache()
    return g, launches


def roq_serve_phase(basis, cut_basis, dev, smi, reset_counts, read_counts):
    """Both bases saved as artifacts and served by the launcher's basis
    mode, every roq_apply launch on the sm90 route; roq_apply's two routes
    timed per bucket beside torch.matmul.  Returns the launches of the
    serving run and the timing entries of roq_apply's routes."""
    from repro_torch.kernels.roq_apply import ops as ra_ops
    from repro_torch.kernels.roq_apply.ref import roq_apply_ref
    from repro_torch.launch.serve import main as serve_main

    with tempfile.TemporaryDirectory() as tmp:
        d1, d2 = os.path.join(tmp, "gw_full"), os.path.join(tmp, "gw_cut")
        basis.save(d1)
        cut_basis.save(d2)
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stats = serve_main(["--basis", d1, "--basis", d2,
                            "--max-batch", str(SERVE_MAX_BATCH),
                            "--max-wait-ms", str(SERVE_WAIT_MS),
                            "--requests", str(SERVE_REQUESTS),
                            "--device", str(dev)])
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = read_counts()
    c = stats["counters"]
    check(launches["roq_apply"] > 0
          and launches["roq_apply_sm90"] == launches["roq_apply"],
          f"roq_serve: roq_apply was not launched, or left the sm90 route: "
          f"{launches}")
    check(stats["served"] == c["completed"] == SERVE_REQUESTS,
          f"roq_serve: {stats['served']} served, {c['completed']} "
          f"completed of {SERVE_REQUESTS}")
    check(c["worker_deaths"] == c["breaker_opened"] == c["rejected"]
          == c["shed"] == c["quota_rejected"] == c["errors"]
          == c["timeouts"] == 0, f"roq_serve: counters {c}")
    check(stats["direct_mismatches"] == 0,
          f"roq_serve: {stats['direct_mismatches']} answers differ from "
          "their direct evaluation")
    check(stats["max_err"] <= ROQ_MAX_ERR,
          f"roq_serve: max error {stats['max_err']} > {ROQ_MAX_ERR}")

    # roq_apply per bucket on the full-width basis (and on its complex128
    # copy), both routes in turns beside torch.matmul; the entries of the
    # kernels line at the served dtype's largest bucket
    gen = torch.Generator().manual_seed(SEED)
    per_bucket = []
    entries = {}
    for dtype in (torch.complex64, torch.complex128):
        B = basis.eim().B.to(dtype).contiguous()
        b = 2
        while b <= SERVE_MAX_BATCH:
            F = rand(gen, (basis.k, b), B.dtype, B.device)
            errs = {"roq_apply": check_roq_apply(B, F),
                    "roq_apply_general": check_roq_apply(B, F, True)}
            # bytes: B and F read once, out written once
            nbytes = B.nbytes + F.nbytes + B.shape[0] * b * B.element_size()
            flops = macs_flops(B.dtype) * B.shape[0] * basis.k * b
            rate = FP32_FLOPS if dtype == torch.complex64 else FP64_FLOPS
            bms, bby = bound(nbytes, flops, rate)
            turns = {"sm90": [], "general": [], "matmul": []}
            calls = {"sm90": lambda: ra_ops.roq_apply(B, F),
                     "general": lambda: ra_ops._roq_apply_general(B, F),
                     "matmul": lambda: torch.matmul(B, F)}
            for name in ("sm90", "general", "matmul", "matmul", "general",
                         "sm90"):
                turns[name].append(time_ms(calls[name], 50))
            row = {"dtype": str(dtype), "bucket": b,
                   "route": ra_ops.kernel_route(dtype, basis.k, b),
                   "ms": min(turns["sm90"]),
                   "general_ms": min(turns["general"]),
                   "matmul_ms": min(turns["matmul"]), "bound_ms": bms,
                   "bound_by": bby}
            per_bucket.append(row)
            if b == SERVE_MAX_BATCH and dtype == basis.Q.dtype:
                plain_ms = time_ms(lambda: roq_apply_ref(B, F), 50)
                for name, ms in (("roq_apply", row["ms"]),
                                 ("roq_apply_general", row["general_ms"])):
                    entries[name] = {
                        "ms": ms, "library_ms": row["matmul_ms"],
                        "plain_ms": plain_ms, "bound_ms": bms,
                        "bound_by": bby, "max_abs_err": errs[name]}
            b *= 2
    # why the apply is a kernel: the widths 2..128 at which torch.matmul's
    # (cuBLAS's) columns lose the bits they have at width 128
    matmul_widths = {}
    for dtype in (torch.float32, torch.complex64, torch.float64,
                  torch.complex128):
        for n, k in ((N, basis.k), (120, 8)):
            Bt = rand(gen, (n, k), dtype, B.device)
            Ft = rand(gen, (k, 128), dtype, B.device)
            full = torch.matmul(Bt, Ft)
            matmul_widths[f"{dtype}-{n}x{k}"] = [
                w for w in range(2, 129) if not torch.equal(
                    torch.matmul(Bt, Ft[:, :w].contiguous()), full[:, :w])]
    lat = stats["latency_ms"]
    emit("roq_serve", card=smi, bases=[
             {"k": basis.k, "N": basis.N, "dtype": str(basis.Q.dtype)},
             {"k": cut_basis.k, "N": cut_basis.N,
              "dtype": str(cut_basis.Q.dtype)}],
         requests=SERVE_REQUESTS, max_batch=SERVE_MAX_BATCH,
         max_wait_ms=SERVE_WAIT_MS, wall_s=stats["wall_s"], run_s=run_s,
         req_s=stats["served"] / stats["wall_s"],
         latency_ms=lat, batches=c["batches"],
         occupancy=stats["batch_occupancy_mean"],
         cache_hit_rate=stats["cache_hit_rate"],
         max_err=stats["max_err"], max_err_bound=ROQ_MAX_ERR,
         direct_mismatches=stats["direct_mismatches"],
         apply_route="roq_apply", apply_per_bucket=per_bucket,
         matmul_width_dependent_widths=matmul_widths,
         launches={n: launches[n] for n in (
             "roq_apply", "roq_apply_sm90", "roq_apply_general")})
    return launches, entries


# ------------------------------------------------ the TaylorF2 generator ----
def check_taylorf2(args, dtype, normalize, dev, lo=0, hi=None,
                   general=False) -> float:
    """Kernel vs plain on columns [lo, hi) of the grid ``args`` (f, m1s,
    m2s), on the route kernel_route gives (or, with ``general``, the
    general kernel): one launch on that route; within 10 eps sqrt(N) of the
    largest column norm; the tile's columns bitwise those of a wider tile,
    of a tile written into a column slice of a wider matrix and of
    ``WaveformProvider.column`` (on the route's kernel); unnormalized, the
    sm90 kernel's bits those of the general one.  Returns the max abs
    error."""
    from repro_torch.data import WaveformProvider
    from repro_torch.kernels.taylorf2 import ops as tf_ops
    from repro_torch.kernels.taylorf2.ref import taylorf2_tile_ref

    prov = WaveformProvider(*args, dtype=dtype, normalize=normalize,
                            device=dev)
    g = prov.grid
    N, M = g.shape
    hi = M if hi is None else hi
    route = "general" if general else tf_ops.kernel_route(N, dtype)

    def tile(a, b, out=None):
        if general:
            return tf_ops._taylorf2_tile_general(g.rows, g.cols, a, b,
                                                 normalize, dtype, out)
        return g.tile(a, b, out)

    what = (f"taylorf2_tile [{route}] ({N}, [{lo}, {hi})) {dtype} "
            f"normalize={normalize}")
    n0 = getattr(tf_ops, f"launches_{route}")
    t = tile(lo, hi)
    torch.cuda.synchronize()
    check(getattr(tf_ops, f"launches_{route}") == n0 + 1,
          f"{what}: the call did not launch the {route} kernel")
    r = taylorf2_tile_ref(g.rows, g.cols[:, lo:hi].contiguous(), normalize,
                          dtype)
    tol = sum_tol(dtype, N) * float(torch.linalg.vector_norm(r, dim=0).max())
    err = float((t - r).abs().max())
    check(err <= tol, f"{what}: {err} > {tol}")
    a, b = max(lo - 5, 0), min(hi + 7, M)
    check(torch.equal(tile(a, b)[:, lo - a:hi - a], t),
          f"{what}: columns differ inside a wider tile")
    wide = torch.zeros((N, hi - lo + 9), dtype=dtype, device=dev)
    check(torch.equal(tile(lo, hi, wide[:, 3:3 + hi - lo]), t),
          f"{what}: columns differ written into a strided slice")
    if not general:
        for j in sorted({lo, (lo + hi) // 2, hi - 1}):
            check(torch.equal(prov.column(j), t[:, j - lo]),
                  f"{what}: column {j} differs alone")
    if route == "sm90" and not normalize:
        check(torch.equal(t, tf_ops._taylorf2_tile_general(
            g.rows, g.cols, lo, hi, False, dtype)),
            f"{what}: not bitwise the general kernel")
    emit("kernels", kernel="taylorf2_tile", route=route, dtype=str(dtype),
         normalize=normalize, shape=[N, hi - lo], first_column=lo,
         max_abs_err=err, tol=tol, exact=bool(torch.equal(t, r)))
    return err


def taylorf2_phase(dev) -> dict:
    """The generator's checks at the kernels phase's shapes, on both routes
    (an N whose slab overflows the sm90 kernel's shared memory takes the
    general one), and both routes' times in turns on a paper-path tile
    (10,000 x 65,536 complex64), normalized (the path's tiles) and not.
    Returns the entries of the kernels line, one per route."""
    from repro_torch.gw import WaveformGrid, chirp_grid, frequency_grid
    from repro_torch.kernels.taylorf2 import ops as tf_ops
    from repro_torch.kernels.taylorf2.ref import taylorf2_tile_ref

    grid = (frequency_grid(F_MIN, F_MAX, N),
            *chirp_grid(n_mc=N_MC, n_eta=N_ETA))
    check(tf_ops.kernel_route(N, torch.complex64) == "sm90"
          and tf_ops.kernel_route(N, torch.complex128) == "sm90",
          "taylorf2_tile: the path's N is not on the sm90 route")
    errs = {True: {}, False: {}}   # by normalize, then route
    for general in (False, True):
        name = "taylorf2_tile_general" if general else "taylorf2_tile"
        for normalize in (True, False):
            errs[normalize][name] = check_taylorf2(
                grid, torch.complex64, normalize, dev, 40_960, 45_056,
                general)
        # ragged: a width and a first column off the cluster's columns
        check_taylorf2(grid, torch.complex128, False, dev, 40_963, 45_056,
                       general)
        check_taylorf2(grid, torch.complex64, True, dev, 5, 1_000, general)
    # an N past the sm90 kernel's slab: the general route's own shape
    big = N
    while tf_ops.kernel_route(big, torch.complex64) == "sm90":
        big += N
    for n, n_mc, n_eta in ((17, 3, 1), (17, 1, 1), (big, 3, 2)):
        small = (frequency_grid(F_MIN, F_MAX, n),
                 *chirp_grid(n_mc=n_mc, n_eta=n_eta))
        for dtype in (torch.complex64, torch.complex128):
            for normalize in (True, False):
                for general in (False, True):
                    check_taylorf2(small, dtype, normalize, dev,
                                   general=general)

    w = STREAM_TILE
    g = WaveformGrid(*grid, dtype=torch.complex64, device=dev)
    buf = torch.empty((N, w), dtype=torch.complex64, device=dev)
    out = {}
    for normalize in (True, False):
        def plain():
            # the plain version in 4,096-column chunks (its float64
            # temporaries of a whole tile would not fit beside S)
            for lo in range(0, w, 4096):
                buf[:, lo:lo + 4096] = taylorf2_tile_ref(
                    g.rows, g.cols[:, lo:lo + 4096], normalize,
                    torch.complex64)

        args = (g.rows, g.cols, 0, w, normalize, torch.complex64, buf)
        # bytes: the tile written once and the terms read once; operations:
        # float64 instructions, each issued at half the FMA rate in flops
        entries = timed_turns(
            "taylorf2_tile", [N, w], torch.complex64,
            buf.nbytes + g.rows.nbytes + g.cols[:, :w].nbytes,
            tf_ops.f64_instructions(N, w, normalize), errs[normalize], 10,
            {"taylorf2_tile": lambda: tf_ops.taylorf2_tile(*args),
             "taylorf2_tile_general":
                 lambda: tf_ops._taylorf2_tile_general(*args)},
            plain, None, flops_per_s=FP64_FLOPS / 2, normalize=normalize,
            f64_instructions=tf_ops.f64_instructions(N, w, normalize))
        if normalize:
            out = entries
    del buf
    torch.cuda.empty_cache()
    return out


# ------------------------------------------------------ the streamed cell ----
def busy_share(prof, wall_s: float) -> float:
    """Union of the card's kernel intervals in a profiler run over its
    wall time."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("cat") == "kernel")
    busy, end = 0.0, -1.0
    for lo, hi in spans:
        if hi > end:
            busy += hi - max(lo, end)
            end = hi
    return busy / (wall_s * 1e6)


def streamed_phase(S, resident, f, m1, m2, dev) -> None:
    """The streamed driver at the resident cell's M against the resident
    greedy build ``resident`` of S: bitwise at two tilings, after a crash
    and a resume, and the pivots over a pinned host copy of every 8th
    column."""
    from repro_torch.api import build_basis
    from repro_torch.core.streaming import rb_greedy_streamed
    from repro_torch.data import ArrayProvider, FaultPlan, FaultyProvider
    from repro_torch.data import WaveformProvider
    from repro_torch.kernels.taylorf2 import ops as tf_ops

    n0 = (tf_ops.launches, tf_ops.launches_sm90)

    def same(b, what):
        ok = (b.k == resident.k
              and b.provenance["stop"] == resident.provenance["stop"]
              and np.array_equal(b.pivots, resident.pivots)
              and np.array_equal(b.errs, resident.errs)
              and torch.equal(b.Q, resident.Q))
        check(ok, f"streamed {what}: not bitwise the resident build (k "
              f"{b.k} vs {resident.k}, stop {b.provenance['stop']} vs "
              f"{resident.provenance['stop']})")

    prov = WaveformProvider(f, m1, m2, dtype=torch.complex64, device=dev)
    parity = {}
    for tile_m in PARITY_TILES:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        b = build_basis(source=prov, strategy="streamed", tau=TAU,
                        max_k=MAX_K, tile_m=tile_m, device=dev)
        torch.cuda.synchronize()
        parity[tile_m] = time.perf_counter() - t0
        same(b, f"tile_m {tile_m}")
        check(np.array_equal(b.R, resident.R),
              f"streamed tile_m {tile_m}: R differs from the resident R")
    # crash mid-build, mid-sweep of the basis half-way (a hard fault on a
    # tile read: the init reads every tile, then each basis a column and
    # every tile), and resume from the checkpoints of every 2 tiles
    n_tiles = -(-M // PARITY_TILES[0])
    crash_at = n_tiles + (n_tiles + 1) * (resident.k // 2) + n_tiles // 2 + 1
    with tempfile.TemporaryDirectory() as ck:
        kw = dict(tau=TAU, max_k=MAX_K, tile_m=PARITY_TILES[0],
                  keep_R=False, checkpoint_dir=ck, checkpoint_every_tiles=2)
        try:
            rb_greedy_streamed(FaultyProvider(
                prov, FaultPlan(raise_at_tile=crash_at)), **kw)
            check(False, "streamed resume: the injected fault did not fire")
        except IOError as e:
            check("injected hard I/O fault" in str(e), f"streamed: {e}")
        r = rb_greedy_streamed(prov, resume=True, **kw)
        k = r.k
        check(k == resident.k and np.array_equal(
            r.pivots[:k].numpy(), resident.pivots)
            and np.array_equal(r.errs[:k].numpy(), resident.errs)
            and torch.equal(r.Q[:, :k], resident.Q),
            "streamed resume: not bitwise the uninterrupted build")
    gen_launches = tf_ops.launches - n0[0]
    check(gen_launches == tf_ops.launches_sm90 - n0[1] > 0,
          "streamed: a taylorf2_tile launch left the sm90 route")
    emit("streamed", check="resident_parity", M=M, tile_m=list(PARITY_TILES),
         wall_s=[parity[t] for t in PARITY_TILES], k=resident.k,
         stop=resident.provenance["stop"], bitwise=True,
         resume_crash_at_tile_read=crash_at, resume_bitwise=True,
         taylorf2_launches_sm90=gen_launches)

    # a host matrix: every 8th column of S, pinned, streamed through the
    # side stream, against the resident build of the same columns
    Sd = S[:, ::HOST_STRIDE].contiguous()
    host = Sd.cpu().pin_memory()
    ref = build_basis(source=Sd, strategy="greedy", tau=TAU, max_k=MAX_K,
                      chunk=16, device=dev)
    del Sd
    hprov = ArrayProvider(host, device=dev)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        hb = build_basis(source=hprov, strategy="streamed", tau=TAU,
                         max_k=MAX_K, tile_m=HOST_TILE, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    check(hb.k == ref.k and hb.provenance["stop"] == ref.provenance["stop"]
          and np.array_equal(hb.pivots, ref.pivots),
          f"streamed host provider: k {hb.k} / {hb.provenance['stop']} vs "
          f"{ref.k} / {ref.provenance['stop']}, or the pivots differ")
    emit("streamed", check="host_provider", shape=list(host.shape),
         gbytes=host.nbytes / 1e9, tile_m=HOST_TILE, k=hb.k,
         stop=hb.provenance["stop"], pivots_identical=True, wall_s=wall,
         h2d_gb=hprov.bytes_to_device / 1e9,
         h2d_gb_s=hprov.bytes_to_device / wall / 1e9,
         busy_share=busy_share(prof, wall), traced=True)
    del host, hprov, ref, hb, prof
    torch.cuda.empty_cache()


def paper_streamed(dev, f, smi, reset_counts, read_counts, tf_ms):
    """The paper's M through the front door: stepwise, then block_p 8.
    Returns each build's launches, by block_p, and the stepwise basis's
    sampled error.

    The stepwise basis must be usable: its sampled error within 100 tau
    (complex64's rank guard ends it short of tau).  The blocked build on
    this grid is not held to that: its stale p = 8 picks are near
    neighbours, rank-rejected holes use up its slots and it stops far from
    tau, as the reference's blocked streamed driver does on a cut of the
    grid (tests/test_torch_streaming.py::
    test_blocked_stream_falls_short_on_a_dense_grid_as_the_reference);
    its line records ``usable`` false."""
    from repro_torch.api import ReductionSpec, build_basis
    from repro_torch.core.errors import per_column_errors
    from repro_torch.gw import WaveformGrid, chirp_grid

    m1, m2 = chirp_grid(n_mc=N_MC_PAPER, n_eta=N_ETA)
    Mp = m1.shape[0]
    n_tiles = -(-Mp // STREAM_TILE)
    gen = torch.Generator().manual_seed(SEED)
    cols = torch.randperm(Mp, generator=gen)[:8192].numpy()
    sample = WaveformGrid(f, m1[cols], m2[cols], device=dev).tile(
        0, len(cols))
    s_gb = N * Mp * 8 / 1e9
    eps = torch.finfo(torch.float32).eps
    out, k1 = {}, None
    for p in (1, BLOCK_P):
        spec = ReductionSpec.waveform(f, m1, m2, strategy="streamed",
                                      tau=TAU, max_k=MAX_K,
                                      tile_m=STREAM_TILE, block_p=p,
                                      device=dev)
        reset_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        b = build_basis(spec)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts()
        peak = torch.cuda.max_memory_allocated()
        pv = b.provenance
        k = b.k
        phase = "streamed_paper" if p == 1 else "streamed_paper_blocked"
        check(5 <= k <= MAX_K and np.all(np.isfinite(b.errs)),
              f"{phase}: bad rank {k}")
        Q64 = b.Q.to(torch.complex128)
        defect = float(torch.linalg.matrix_norm(
            Q64.mH @ Q64 - torch.eye(k, dtype=Q64.dtype, device=dev), ord=2))
        defect_bound = 100 * 2.0 * eps * math.sqrt(k)
        check(defect <= defect_bound,
              f"{phase}: orthogonality {defect} > {defect_bound}")
        pce = float(per_column_errors(sample, b.Q).max())
        last = float(b.errs[-1])
        check(pce <= 1.5 * last,
              f"{phase}: sampled error {pce} > 1.5 * {last}")
        usable = pce <= 100 * TAU
        check(usable or p > 1,
              f"{phase}: sampled error {pce} > 100 tau: not a usable basis")
        # every tile generated once a pass: init, sweeps, refreshes
        tiles_gen = n_tiles * pv["passes"] + pv["columns"]
        check(pv["passes"] == 1 + pv["sweeps"] + pv["refreshes"]
              and launches["taylorf2_tile"] == tiles_gen,
              f"{phase}: {launches['taylorf2_tile']} generator launches, "
              f"expected {n_tiles} x {pv['passes']} + {pv['columns']}")
        if p == 1:
            check(pv["sweeps"] == k and pv["columns"] == k + (
                pv["stop"] == "STOP_RANK"),
                f"{phase}: {pv['sweeps']} sweeps / {pv['columns']} columns "
                f"for k {k} ({pv['stop']})")
            sm90 = ("greedy_update", "imgs_project", "taylorf2_tile")
            k1 = k
        else:
            check(k <= int(1.15 * k1) + BLOCK_P,
                  f"{phase}: k {k} above 1.15 * {k1} + {BLOCK_P}")
            sm90 = ("imgs_project", "imgs_panel", "taylorf2_tile")
        check(all(launches[n] > 0 and launches[n + "_sm90"] == launches[n]
                  for n in sm90),
              f"{phase}: a launch of {sm90} left the sm90 route: {launches}")
        check(launches["column_norms"] >= n_tiles,
              f"{phase}: {launches['column_norms']} column_norms launches "
              f"for the init pass's {n_tiles} tiles")
        mem_bound = N * (MAX_K + 3 * STREAM_TILE) * 8 + 32 * Mp + 2e9
        check(peak <= mem_bound, f"{phase}: peak {peak} B > {mem_bound}")
        # the generator's card time, estimated from its measured time on
        # a tile of this width (the single pivot columns left out)
        gen_ms = n_tiles * pv["passes"] * tf_ms if p == 1 else None
        emit(phase, M=Mp, N=N, tile_m=STREAM_TILE, n_tiles=n_tiles,
             block_p=p, k=k, stop=pv["stop"], tau=TAU, wall_s=wall,
             s_per_basis=wall / k, sweeps=pv["sweeps"],
             refreshes=pv["refreshes"], s_per_sweep=wall / pv["sweeps"],
             swept_gb_s=pv["sweeps"] * s_gb / wall,
             s_gbytes=s_gb, generator_ms_est=gen_ms,
             generator_share_of_wall_est=(None if gen_ms is None
                                          else gen_ms / 1e3 / wall),
             launches=launches, orthogonality=defect,
             orthogonality_bound=defect_bound, max_sampled_col_err=pce,
             last_err=last, col_err_bound=1.5 * last,
             usable_err_bound=100 * TAU, usable=usable, peak_mem_gb=peak / 1e9,
             peak_mem_bound_gb=mem_bound / 1e9, nvidia_smi=smi)
        out[p] = launches
        if p == 1:
            stepwise_err = pce
        del b
        torch.cuda.empty_cache()
    return out, stepwise_err


# ------------------------------------------------ the randomized cells ----
def check_sketch_omega(seed, tile, shape, dtype, kind, dev) -> float:
    """The generator kernel against its plain version on the card: one
    launch a call, two launches bitwise, rademacher bitwise, gaussian
    within OMEGA_TOL of max(1, |omega|) (only erfinv differs).  Returns
    the max abs error."""
    from repro_torch.kernels.sketch_omega import ops as so_ops
    from repro_torch.kernels.sketch_omega.ref import sketch_omega_ref

    what = f"sketch_omega {shape} {dtype} {kind} seed {seed} tile {tile}"
    n0 = so_ops.launches
    out = so_ops.sketch_omega(seed, tile, torch.empty(
        shape, dtype=dtype, device=dev), kind)
    again = so_ops.sketch_omega(seed, tile, torch.empty_like(out), kind)
    torch.cuda.synchronize()
    check(so_ops.launches == n0 + 2, f"{what}: not one launch a call")
    check(torch.equal(out, again), f"{what}: two launches differ")
    ref = sketch_omega_ref(seed, tile, shape, dtype, kind, dev)
    if kind == "rademacher":
        check(torch.equal(out, ref), f"{what}: not bitwise the plain "
              "version")
        return 0.0
    rel = float(((out - ref).abs() / ref.abs().clamp(min=1.0)).max())
    check(rel <= OMEGA_TOL[dtype.to_real()],
          f"{what}: {rel} > {OMEGA_TOL[dtype.to_real()]} relative")
    return float((out - ref).abs().max())


def sketch_omega_phase(S, dev) -> dict:
    """sketch_omega against its plain version at the randomized path's
    shape (65,536 x 110 complex64, both kinds) and at ragged shapes across
    the four types, seeds and tiles; its time beside the plain version's
    and the bound; then the fold and the co-range GEMMs of one paper tile
    (torch.matmul) beside their bound.  Returns the kernels-line entry."""
    from repro_torch.kernels.sketch_omega import ops as so_ops
    from repro_torch.kernels.sketch_omega.ref import sketch_omega_ref

    pairs = [(seed, tile) for seed in OMEGA_SEEDS for tile in (0, 49)]
    n_checks = 0
    for m in (1, 7, 4_097):
        for ell in (1, 25):
            for dtype in (torch.float32, torch.float64, torch.complex64,
                          torch.complex128):
                for seed, tile in pairs:
                    for kind in ("gaussian", "rademacher"):
                        check_sketch_omega(seed, tile, (m, ell), dtype, kind,
                                           dev)
                        n_checks += 1
    shape = (STREAM_TILE, SKETCH_ELL)
    errs = {"gaussian": 0.0, "rademacher": 0.0}
    for seed, tile in pairs:
        for kind in errs:
            errs[kind] = max(errs[kind], check_sketch_omega(
                seed, tile, shape, torch.complex64, kind, dev))
    emit("kernels", kernel="sketch_omega", check="vs_plain",
         ragged_checks=n_checks, path_shape=list(shape),
         path_max_abs_err=errs, rel_tol={str(k): v for k, v in
                                         OMEGA_TOL.items()},
         seeds=OMEGA_SEEDS, tiles=[0, 49])

    out = torch.empty(shape, dtype=torch.complex64, device=dev)
    draws = 2 * out.numel()  # a Threefry evaluation each
    entry = None
    for kind in ("gaussian", "rademacher"):
        # operations: the integer-ALU operations the draws need on the ALU
        # pipe, or every instruction they must issue at the issue rate,
        # whichever takes longer (ops.ISSUE_PER_DRAW)
        alu = draws * so_ops.ALU_OPS_PER_DRAW[kind]
        issue = draws * so_ops.ISSUE_PER_DRAW[kind]
        ops, rate = max((alu, INT32_INSTR_PER_S), (issue, ISSUE_PER_S),
                        key=lambda o: o[0] / o[1])
        t = timed("sketch_omega", list(shape), torch.complex64, out.nbytes,
                  ops, errs[kind], 50,
                  lambda: so_ops.sketch_omega(SEED, 0, out, kind),
                  lambda: sketch_omega_ref(SEED, 0, shape, torch.complex64,
                                           kind, dev),
                  None, flops_per_s=rate)
        emit("kernels", kernel="sketch_omega", kind=kind,
             threefry_calls=draws, alu_ops=alu, issued=issue,
             alu_pipe_ms=alu / INT32_INSTR_PER_S * 1e3,
             issue_ms=issue / ISSUE_PER_S * 1e3,
             bound_share=t["bound_ms"] / t["ms"])
        if entry is None:
            entry = t

    # the fold Y + T @ Omega and the co-range T^H @ Y of one paper tile:
    # plain GEMMs (torch.addmm / matmul), bound by the FP32 rate
    T = S[:, :STREAM_TILE].contiguous()
    Om = so_ops.sketch_omega(SEED, 0, out, "gaussian")
    Y = torch.zeros((N, SKETCH_ELL), dtype=torch.complex64, device=dev)
    flops = 8 * N * STREAM_TILE * SKETCH_ELL
    for name, fn in (("sketch_fold", lambda: torch.addmm(Y, T, Om)),
                     ("sketch_project", lambda: T.mH @ Y)):
        ms = time_ms(fn, 10)
        b = bound(T.nbytes + Om.nbytes + 2 * Y.nbytes, flops)
        emit("kernels", check=name, library="torch.addmm" if name ==
             "sketch_fold" else "torch.matmul", shape=[N, STREAM_TILE,
                                                     SKETCH_ELL],
             dtype="complex64", ms=ms, bound_ms=b[0], bound_by=b[1],
             bound_share=b[0] / ms, tflop_s=flops / (ms * 1e-3) / 1e12)
    # the rest of a pass: a tile's fixed-order column norms (phase 0), the
    # final SVD of Y, and the power iteration's thin QRs of Y and of the
    # paper-size co-range Z (M 3,276,800 x ell)
    from repro_torch.core.randomized import _thin_q
    from repro_torch.sums import column_norms_sq

    Mp = N_MC_PAPER * N_ETA
    gen = torch.Generator(device=dev).manual_seed(SEED)
    Z = torch.randn((Mp, SKETCH_ELL), dtype=torch.complex64, device=dev,
                    generator=gen)
    Y = torch.randn((N, SKETCH_ELL), dtype=torch.complex64, device=dev,
                    generator=gen)
    rest = {"column_norms_sq_tile": time_ms(lambda: column_norms_sq(T), 5),
            "svd_Y": time_ms(lambda: torch.linalg.svd(
                Y, full_matrices=False), 5),
            "thin_qr_Y": time_ms(lambda: _thin_q(Y), 5),
            "thin_qr_Z": time_ms(lambda: _thin_q(Z), 3)}
    emit("kernels", check="sketch_pass_parts", tile=[N, STREAM_TILE],
         Y=[N, SKETCH_ELL], Z=[Mp, SKETCH_ELL], dtype="complex64",
         ms=rest)
    del T, Om, Y, Z, out
    torch.cuda.empty_cache()
    return entry


def randomized_cut_phase(f, m1, m2, dev, smi, reset_counts, read_counts):
    """The range-finder on the paper phase's complex128 cut (N 10,000, every
    64th column, M 2,048), POD from the ported oracle: power 0 and 1 within
    the reference test's bound (slack 4 on sqrt(1 + k/(p-1)) times POD's
    tail, plus 100 eps |sigma|), power 1's leading ten estimates within
    1e-3 of POD's sigma, one sketch_omega launch a tile; then sketch+greedy
    from a power-0 sketch with no oversampling, whose basis misses tau, so
    the warm-started greedy refines it (one greedy_update launch a tile a
    sweep, all sm90) until every column is within tau.  Returns the
    sketch+greedy run's launches."""
    from repro_torch.api import build_basis
    from repro_torch.core.errors import per_column_errors
    from repro_torch.core.pod import pod
    from repro_torch.core.randomized import rb_randomized_streamed
    from repro_torch.gw import build_snapshot_matrix

    S1 = build_snapshot_matrix(f, m1[::CUT_STRIDE], m2[::CUT_STRIDE],
                               dtype=torch.complex128, device=dev)
    Mc = S1.shape[1]
    sig = pod(S1, 0.0, device=dev).sigmas.cpu().numpy()
    tail = float(np.sqrt(np.sum(sig[MAX_K:] ** 2)))
    eps = float(np.finfo(np.float64).eps)
    floor = 100.0 * eps * float(np.linalg.norm(sig))
    bound_rf = math.sqrt(1.0 + MAX_K / (SKETCH_P - 1)) * tail
    n_tiles = -(-Mc // CUT_TILE)
    runs = []
    for power in (0, 1):
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = rb_randomized_streamed(S1, tau=None, max_k=MAX_K,
                                     sketch_p=SKETCH_P, power=power,
                                     seed=SEED, tile_m=CUT_TILE, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts()
        check(res.k == MAX_K and res.ell == MAX_K + SKETCH_P
              and res.n_passes == 1 + 2 * power and res.n_tiles == n_tiles,
              f"randomized_cut power {power}: k {res.k} ell {res.ell} "
              f"passes {res.n_passes} tiles {res.n_tiles}")
        check(launches["sketch_omega"] == n_tiles,
              f"randomized_cut power {power}: {launches['sketch_omega']} "
              f"sketch_omega launches for {n_tiles} tiles")
        err = float(torch.linalg.matrix_norm(
            S1 - res.Q @ (res.Q.mH @ S1)))
        check(err <= 4.0 * bound_rf + floor,
              f"randomized_cut power {power}: error {err} > 4 x "
              f"{bound_rf} + {floor}")
        lead = np.abs(res.svals[:10] - sig[:10]) / sig[:10]
        if power == 1:
            check(float(lead.max()) <= 1e-3,
                  f"randomized_cut power 1: sigma_hat off by {lead.max()}")
        runs.append({"power": power, "k": res.k, "ell": res.ell,
                     "passes": res.n_passes, "wall_s": wall,
                     "err_fro": err, "bound": 4.0 * bound_rf + floor,
                     "err_over_pod_tail": err / tail,
                     "lead10_max_rel_err": float(lead.max()),
                     "sketch_omega_launches": launches["sketch_omega"]})
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sg = build_basis(source=S1, strategy="sketch+greedy", tau=CUT_SG_TAU,
                     max_k=MAX_K, sketch_p=0, sketch_power=0,
                     tile_m=CUT_TILE, device=dev)
    torch.cuda.synchronize()
    sg_wall = time.perf_counter() - t0
    sg_launches = read_counts()
    worst = float(per_column_errors(S1, sg.Q).max())
    pv = sg.provenance
    k0, sweeps = pv["sketch"]["k0"], pv["sweeps"]
    k0_worst = float(per_column_errors(S1, sg.Q[:, :k0].contiguous()).max())
    check(pv["stop"] == "STOP_TAU" and worst < CUT_SG_TAU,
          f"randomized_cut sketch+greedy: {pv['stop']}, worst column "
          f"{worst} vs tau {CUT_SG_TAU}")
    check(k0 < sg.k and sweeps > 0,
          f"randomized_cut sketch+greedy: no refinement (k0 {k0}, k "
          f"{sg.k}, {sweeps} sweeps)")
    check(np.all(sg.pivots[:k0] == -1) and np.all(sg.pivots[k0:] >= 0),
          "randomized_cut sketch+greedy: pivots")
    check(sg_launches["greedy_update"] == n_tiles * sweeps
          and sg_launches["greedy_update_sm90"]
          == sg_launches["greedy_update"],
          f"randomized_cut sketch+greedy: greedy_update launches "
          f"{sg_launches} for {n_tiles} tiles x {sweeps} sweeps")
    check(sg_launches["imgs_project"] > 0
          and sg_launches["imgs_project_sm90"]
          == sg_launches["imgs_project"],
          f"randomized_cut sketch+greedy: imgs_project launches "
          f"{sg_launches}")
    check(sg_launches["sketch_omega"] == n_tiles,
          f"randomized_cut sketch+greedy: {sg_launches['sketch_omega']} "
          f"sketch_omega launches for {n_tiles} tiles")
    emit("randomized_cut", card=smi, cut={"N": N, "M": Mc,
                                          "stride": CUT_STRIDE,
                                          "dtype": "complex128"},
         tile_m=CUT_TILE, sketch_p=SKETCH_P, pod_tail=tail,
         range_finder_bound=bound_rf, slack=4.0, floor=floor, runs=runs,
         sketch_greedy={"tau": CUT_SG_TAU, "sketch_p": 0, "power": 0,
                        "k0": k0, "sigma_at_k0": pv["sigma_estimates"][
                            k0 - 1:k0 + 1], "k0_max_col_err": k0_worst,
                        "k": sg.k, "stop": pv["stop"],
                        "sweeps": sweeps, "refreshes": pv["refreshes"],
                        "max_col_err": worst, "wall_s": sg_wall,
                        "launches": sg_launches})
    del S1, sg
    torch.cuda.empty_cache()
    return sg_launches


def randomized_resume_phase(f, m1, m2, dev) -> None:
    """A sketch over generated tiles at M 131,072 killed mid-pass and
    resumed (checkpoints every 2 tiles): at a tile of phase 0 (power 0) and
    of the odd phase (power 1).  Y (the final checkpoint's), sigma_hat, k,
    Q and the norms bitwise the uninterrupted run's."""
    from repro_torch.checkpoint.io import load_checkpoint_raw
    from repro_torch.core.randomized import rb_randomized_streamed
    from repro_torch.data import FaultPlan, FaultyProvider, WaveformProvider

    prov = WaveformProvider(f, m1, m2, dtype=torch.complex64, device=dev)
    n_tiles = -(-M // RESUME_TILE)
    out = []
    for power, raise_at in ((0, 5), (1, n_tiles + 5)):
        kw = dict(tau=TAU, max_k=MAX_K, sketch_p=SKETCH_P, power=power,
                  tile_m=RESUME_TILE, seed=SEED)
        with tempfile.TemporaryDirectory() as a, \
                tempfile.TemporaryDirectory() as b:
            ref = rb_randomized_streamed(prov, checkpoint_dir=a, **kw)
            try:
                rb_randomized_streamed(FaultyProvider(
                    prov, FaultPlan(raise_at_tile=raise_at)),
                    checkpoint_dir=b, checkpoint_every_tiles=2, **kw)
                check(False, "randomized_resume: the fault did not fire")
            except IOError as e:
                check("injected hard I/O fault" in str(e),
                      f"randomized_resume: {e}")
            mid = load_checkpoint_raw(b)
            check(int(mid["phase"]) == power and int(mid["cursor"]) > 0,
                  f"randomized_resume power {power}: checkpoint at phase "
                  f"{int(mid['phase'])} tile {int(mid['cursor'])}")
            got = rb_randomized_streamed(prov, checkpoint_dir=b,
                                         resume=True, **kw)
            same_y = np.array_equal(load_checkpoint_raw(a)["Y"],
                                    load_checkpoint_raw(b)["Y"])
        ok = (same_y and got.k == ref.k
              and np.array_equal(got.svals, ref.svals)
              and torch.equal(got.Q, ref.Q)
              and torch.equal(got.norms_sq, ref.norms_sq))
        check(ok, f"randomized_resume power {power}: not bitwise the "
              f"uninterrupted run (Y equal: {same_y})")
        out.append({"power": power, "crash_at_tile_read": raise_at,
                    "resumed_from": [int(mid["phase"]),
                                     int(mid["cursor"])],
                    "k": got.k, "bitwise": ok})
    emit("randomized_resume", M=M, tile_m=RESUME_TILE, n_tiles=n_tiles,
         runs=out)


def randomized_paper(dev, f, smi, reset_counts, read_counts, stream_err):
    """The paper's M through the front door: strategy="randomized" at power
    0, then 1, then strategy="sketch+greedy" with a tau taken from power
    0's estimates (so that the sketch's k0 stays below max_k); each
    basis's sampled error beside ``stream_err``, the stepwise streamed
    build's on the same columns.  Returns the launches of the power-1 run
    and of the sketch+greedy run."""
    from repro_torch.api import ReductionSpec, build_basis
    from repro_torch.core.errors import per_column_errors
    from repro_torch.gw import WaveformGrid, chirp_grid

    m1, m2 = chirp_grid(n_mc=N_MC_PAPER, n_eta=N_ETA)
    Mp = m1.shape[0]
    n_tiles = -(-Mp // STREAM_TILE)
    gen = torch.Generator().manual_seed(SEED)
    cols = torch.randperm(Mp, generator=gen)[:8192].numpy()
    sample = WaveformGrid(f, m1[cols], m2[cols], device=dev).tile(
        0, len(cols))
    eps = torch.finfo(torch.float32).eps
    # device memory: three tiles (the current one, the next one, the
    # column norms' temporaries), the co-range Z and the two copies its QR
    # makes, 2 GB of small buffers
    mem_bound = 3 * N * STREAM_TILE * 8 + 3 * Mp * SKETCH_ELL * 8 + 2e9

    def run(phase, **kw):
        spec = ReductionSpec.waveform(f, m1, m2, max_k=MAX_K,
                                      tile_m=STREAM_TILE, sketch_p=SKETCH_P,
                                      sketch_seed=SEED, device=dev, **kw)
        reset_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        b = build_basis(spec)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts()
        peak = torch.cuda.max_memory_allocated()
        k = b.k
        check(5 <= k <= MAX_K and np.all(np.isfinite(b.errs)),
              f"{phase}: bad rank {k}")
        Q64 = b.Q.to(torch.complex128)
        defect = float(torch.linalg.matrix_norm(
            Q64.mH @ Q64 - torch.eye(k, dtype=Q64.dtype, device=dev), ord=2))
        defect_bound = 100 * 2.0 * eps * math.sqrt(k)
        check(defect <= defect_bound,
              f"{phase}: orthogonality {defect} > {defect_bound}")
        E = sample - b.Q @ (b.Q.mH @ sample)
        pce = float(per_column_errors(sample, b.Q).max())
        fro = float(torch.linalg.matrix_norm(E))
        check(math.isfinite(pce) and math.isfinite(fro),
              f"{phase}: sampled errors not finite")
        check(peak <= mem_bound, f"{phase}: peak {peak} B > {mem_bound}")
        check(launches["sketch_omega"] == n_tiles,
              f"{phase}: {launches['sketch_omega']} sketch_omega launches "
              f"for {n_tiles} tiles")
        check(launches["taylorf2_tile"] > 0 and launches[
            "taylorf2_tile_sm90"] == launches["taylorf2_tile"],
            f"{phase}: a taylorf2_tile launch left the sm90 route")
        # phase 0's norms, one launch a tile (sketch+greedy's refinement
        # adds its warm init's)
        check(launches["column_norms"] >= n_tiles,
              f"{phase}: {launches['column_norms']} column_norms launches "
              f"for {n_tiles} tiles")
        return b, wall, launches, peak, defect, defect_bound, pce, fro

    out, fro0, est0 = {}, None, None
    for power in (0, 1):
        phase = "randomized_paper"
        b, wall, launches, peak, defect, defect_bound, pce, fro = run(
            phase, strategy="randomized", tau=TAU, sketch_power=power)
        sk = b.provenance["sketch"]
        est = np.asarray(b.provenance["sigma_estimates"])
        check(sk["n_passes"] == 1 + 2 * power and sk["n_tiles"] == n_tiles
              and sk["ell"] == SKETCH_ELL,
              f"{phase} power {power}: sketch record {sk}")
        check(launches["taylorf2_tile"] == n_tiles * sk["n_passes"],
              f"{phase} power {power}: {launches['taylorf2_tile']} "
              f"generator launches for {n_tiles} x {sk['n_passes']}")
        check(launches["column_norms"] == n_tiles,
              f"{phase} power {power}: {launches['column_norms']} "
              f"column_norms launches for {n_tiles} tiles")
        if power == 0:
            fro0, est0 = fro, est
            basis0, wall0 = b, wall
        else:
            # the reference's power test: no worse a projection
            check(fro <= 2.0 * fro0, f"{phase}: power 1's sampled error "
                  f"{fro} > 2 x power 0's {fro0}")
        # the two scales the sketch+greedy tau is chosen between: the
        # estimates near SG_K0 and the sampled error of the basis's
        # leading columns
        prefix_err = {j: float(per_column_errors(
            sample, b.Q[:, :j].contiguous()).max())
            for j in (75, 85, SG_K0) if j < b.k}
        emit(phase, M=Mp, N=N, tile_m=STREAM_TILE, n_tiles=n_tiles,
             power=power, passes=sk["n_passes"], ell=sk["ell"], k=b.k,
             tau=TAU, wall_s=wall, s_per_pass=wall / sk["n_passes"],
             swept_gb_s=sk["n_passes"] * N * Mp * 8 / wall / 1e9,
             sigma_head=est[:5].tolist(), sigma_tail=est[-5:].tolist(),
             sigma_at_k=float(est[b.k - 1]),
             sigma_at={i: float(est[i - 1]) for i in
                       (75, 85, SG_K0, SG_K0 + 1, SG_K0 + 2)},
             max_sampled_col_err_of_first_k=prefix_err, launches=launches,
             orthogonality=defect, orthogonality_bound=defect_bound,
             max_sampled_col_err=pce, sampled_fro_err=fro,
             streamed_paper_max_sampled_col_err=stream_err,
             peak_mem_gb=peak / 1e9, peak_mem_bound_gb=mem_bound / 1e9,
             nvidia_smi=smi)
        out[power] = launches
        del b
        torch.cuda.empty_cache()

    # auto (b): the default call at the paper's M streams the sketch of
    # power 0 (S is 262 GB, past the budget; the sweep roof-bound; 13
    # blocked greedy passes against 2 x 1): never materialized, bitwise
    # the power-0 basis
    from repro_torch.data import providers

    materialized = []
    real_source, real_method = (providers.materialize_source,
                                providers.SnapshotProvider.materialize)

    def counted(real):
        def wrapper(*a, **kw):
            materialized.append(real.__name__)
            return real(*a, **kw)
        return wrapper

    providers.materialize_source = counted(real_source)
    providers.SnapshotProvider.materialize = counted(real_method)
    try:
        with LogLines() as log:
            b, wall, auto_launches, peak, *_ = run("auto_paper", tau=TAU)
    finally:
        providers.materialize_source = real_source
        providers.SnapshotProvider.materialize = real_method
    pv = b.provenance
    check(not materialized, f"auto (b): materialized {materialized}")
    check(pv["strategy"] == "randomized" and pv["requested_strategy"]
          == "auto", f"auto (b): chose {pv['strategy']}")
    check(b.k == basis0.k and torch.equal(b.Q, basis0.Q)
          and np.array_equal(b.errs, basis0.errs),
          "auto (b): not bitwise the power-0 randomized basis")
    check(auto_launches["column_norms"] == n_tiles,
          f"auto (b): {auto_launches['column_norms']} column_norms launches")
    emit("auto", case="b_paper_default", M=Mp, strategy=pv["strategy"],
         block_p=pv["block_p"], max_k=pv["max_k"], k=b.k, wall_s=wall,
         randomized_power0_wall_s=wall0,
         materialize_calls=0, bitwise_power0=True,
         reason=[ln for ln in log.lines if ln.startswith("auto strategy")],
         launches=auto_launches, peak_mem_gb=peak / 1e9,
         peak_mem_bound_gb=mem_bound / 1e9, nvidia_smi=smi)
    del b, basis0
    torch.cuda.empty_cache()

    # sketch+greedy: tau between power 0's estimates SG_K0 and SG_K0 + 1,
    # so the sketch (the same seed, width and tiles: the same estimates)
    # keeps k0 = SG_K0 < max_k and the greedy refinement has slots
    tau_sg = float(math.sqrt(est0[SG_K0 - 1] * est0[SG_K0]))
    b, wall, launches, peak, defect, defect_bound, pce, fro = run(
        "randomized_paper_sketch_greedy", strategy="sketch+greedy",
        tau=tau_sg, sketch_power=0, keep_R=False)
    pv = b.provenance
    k0 = pv["sketch"]["k0"]
    check(k0 == SG_K0 and b.k >= k0 and pv["sketch"]["refined_k"] == b.k,
          f"sketch+greedy: k0 {k0} (expected {SG_K0}), k {b.k}")
    check(np.all(b.pivots[:k0] == -1) and np.all(b.pivots[k0:] >= 0),
          "sketch+greedy: pivots")
    # the sketch's pass, then the refinement's: its warm init, its sweeps
    # and refreshes, one generated tile each, and its single columns
    gen_expect = n_tiles * (1 + pv["passes"]) + pv["columns"]
    check(launches["taylorf2_tile"] == gen_expect,
          f"sketch+greedy: {launches['taylorf2_tile']} generator launches,"
          f" expected {gen_expect}")
    check(launches["greedy_update"] == n_tiles * pv["sweeps"]
          and launches["greedy_update_sm90"] == launches["greedy_update"],
          f"sketch+greedy: greedy_update launches {launches}")
    check(pce <= 100 * tau_sg,
          f"sketch+greedy: sampled error {pce} > 100 tau ({tau_sg})")
    emit("randomized_paper_sketch_greedy", M=Mp, N=N, tile_m=STREAM_TILE,
         tau=tau_sg, tau_rule=f"sqrt(sigma_hat[{SG_K0 - 1}] * "
         f"sigma_hat[{SG_K0}]) of power 0", k0=k0, k=b.k,
         stop=pv["stop"], sweeps=pv["sweeps"], refreshes=pv["refreshes"],
         refine_passes=pv["passes"], wall_s=wall, launches=launches,
         orthogonality=defect, max_sampled_col_err=pce,
         sampled_fro_err=fro, streamed_paper_max_sampled_col_err=stream_err,
         usable_err_bound=100 * tau_sg,
         usable=pce <= 100 * tau_sg, peak_mem_gb=peak / 1e9,
         peak_mem_bound_gb=mem_bound / 1e9, nvidia_smi=smi)
    del b, sample
    torch.cuda.empty_cache()
    return out[1], launches, auto_launches


# ------------------------------------------- the roofline model, auto ----
class LogLines(logging.Handler):
    """The messages logged on ``repro_torch.api`` while it is installed:
    the front door's "auto" decision, its rank estimate, the measured
    roofs."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())

    def __enter__(self):
        log = logging.getLogger("repro_torch.api")
        self.level = log.level
        log.setLevel(logging.INFO)
        log.addHandler(self)
        return self

    def __exit__(self, *exc):
        log = logging.getLogger("repro_torch.api")
        log.removeHandler(self)
        log.setLevel(self.level)


def roofline_phase(dev, smi, reset_counts, read_counts) -> dict:
    """The roofline model's calibration on the card, through the raw
    functions (an exception fails the run; the public wrappers would fall
    back to the defaults): the sweep's bandwidth (greedy_update), the
    FP32 GEMM rate and the LLC cliff (llc_probe, one launch a timed
    call), launches counted from 0 just before; then each working set's
    rate from a second sweep.  Returns the launches."""
    from repro_torch.api import roofline as R

    key = str(dev)
    R.measured_roofline.cache_clear()
    R.measured_cache_bytes.cache_clear()
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bw, gf = R._measure_roofline_once(key)
    t_roof = time.perf_counter() - t0
    t0 = time.perf_counter()
    cache = R._measure_cache_once(key)
    t_cache = time.perf_counter() - t0
    launches = read_counts()
    rates = R._stream_rates(dev)
    props = torch.cuda.get_device_properties(dev)
    l2 = getattr(props, "L2_cache_size", None)
    emit("roofline", bandwidth_gb_s=bw, gemm_gflop_s=gf,
         cache_mb=cache / (1 << 20), calibration_s=t_roof,
         cache_sweep_s=t_cache, device_l2_mb=None if l2 is None
         else l2 / (1 << 20),
         stream_rates_gb_s={mb: r for mb, r in zip(R._CACHE_SIZES_MB,
                                                   rates)},
         launches={n: launches[n] for n in ("greedy_update",
                                            "greedy_update_sm90",
                                            "llc_probe")},
         nvidia_smi=smi)
    calls = len(R._CACHE_SIZES_MB) * 4  # one warm-up, three timed
    check(launches["llc_probe"] == calls,
          f"roofline: {launches['llc_probe']} llc_probe launches for "
          f"{calls} calls")
    check(launches["greedy_update_sm90"] == launches["greedy_update"] == 7,
          f"roofline: the sweep's launches {launches}")
    check(1500 <= bw <= 3350, f"roofline: bandwidth {bw} GB/s outside "
          "[1500, 3350]")
    check(gf > 0, f"roofline: GEMM rate {gf}")
    check(8 << 20 <= cache <= 64 << 20,
          f"roofline: cache {cache / (1 << 20)} MB outside [8, 64]")
    return launches


def check_column_norms(X, what: str) -> None:
    """The kernel against the plain tree on the same CUDA tensor: bitwise,
    one launch a stage of its plan."""
    from repro_torch.kernels.column_norms import ops as cn_ops
    from repro_torch.kernels.column_norms.ref import column_norms_sq_ref

    n0 = cn_ops.launches
    got = cn_ops.column_norms_sq(X)
    torch.cuda.synchronize()
    check(cn_ops.launches - n0 == len(cn_ops.plan(X.shape[0])),
          f"column_norms {what}: {cn_ops.launches - n0} launches")
    check(torch.equal(got, column_norms_sq_ref(X)),
          f"column_norms {what}: not bitwise the plain tree")


def column_norms_phase(S, dev) -> dict:
    """column_norms bitwise its plain tree at f32 / f64 / c64 / c128, at
    ragged N and widths off a CTA's 16 / 32 columns, on column slices of a
    wider matrix and on a transposed view, and against the CPU's tree; at
    the paths' tile (a 65,536-column slice of the resident S, row stride
    M) and on the whole S (the greedy init: its halves' bits); its time
    beside the plain tree's, the bound and torch.linalg.vector_norm's.
    Returns the kernels-line entry."""
    from repro_torch.core.greedy import _column_norms_sq
    from repro_torch.kernels.column_norms import ops as cn_ops
    from repro_torch.kernels.column_norms.ref import column_norms_sq_ref

    gen = torch.Generator().manual_seed(SEED)
    n_checks = 0
    for dtype in (torch.float32, torch.float64, torch.complex64,
                  torch.complex128):
        for n in (1, 2, 3, 313, 9_999, 10_001):
            wide = rand(gen, (n, 101), dtype, dev)
            for X in (wide[:, :1], wide[:, :33], wide[:, 7:90], wide,
                      rand(gen, (37, n), dtype, dev).mT):
                check_column_norms(X, f"{tuple(X.shape)} {X.stride()} "
                                      f"{dtype}")
                n_checks += 1
            check(torch.equal(cn_ops.column_norms_sq(wide).cpu(),
                              column_norms_sq_ref(wide.cpu())),
                  f"column_norms ({n}, 101) {dtype}: not the CPU's bits")
    T = S[:, :STREAM_TILE]
    check_column_norms(T, "the path's tile")
    n0 = cn_ops.launches
    whole = _column_norms_sq(S)
    halves = torch.cat([cn_ops.column_norms_sq(S[:, :M // 2]),
                        cn_ops.column_norms_sq(S[:, M // 2:])])
    torch.cuda.synchronize()
    check(cn_ops.launches - n0 == 3 and torch.equal(whole, halves),
          "column_norms: the resident init is not one launch with its "
          "tiles' bits")
    emit("kernels", kernel="column_norms", check="vs_plain",
         ragged_checks=n_checks, path_shape=[N, STREAM_TILE],
         path_row_stride=T.stride(0), bitwise=True)
    # bytes: T read once, the norms written once; operations: a complex
    # element's two squares and an add, and its add in the tree
    entry = timed("column_norms", [N, STREAM_TILE], S.dtype,
                  T.nbytes + STREAM_TILE * 4, 4 * N * STREAM_TILE, 0.0, 10,
                  lambda: cn_ops.column_norms_sq(T),
                  lambda: column_norms_sq_ref(T),
                  lambda: torch.linalg.vector_norm(T, dim=0))
    init_ms = time_ms(lambda: _column_norms_sq(S), 5)
    emit("kernels", kernel="column_norms", check="resident_init",
         shape=[N, M], ms=init_ms, bound_ms=bound(S.nbytes + M * 4,
                                                  4 * N * M)[0],
         library="torch.linalg.vector_norm (the norms, not their squares)")
    return entry


def llc_probe_phase(dev) -> dict:
    """llc_probe against its plain version (a loop of torch.dot, on the
    card): one launch a call, the partial sums' total within the rounding
    of the n * reps-term sum; its time on the largest working set (128
    MB, one pass) beside the plain loop's, the bound and torch.dot's.
    Returns the kernels-line entry."""
    from repro_torch.kernels.llc_probe import ops as lp_ops
    from repro_torch.kernels.llc_probe.ref import llc_probe_ref

    gen = torch.Generator(device=dev).manual_seed(SEED)
    err = 0.0
    for n, reps in ((4, 1), (1 << 10, 3), (1 << 18, 64), (1 << 22, 4),
                    (32 << 20, 1)):
        x = torch.randn((n,), generator=gen, device=dev)
        n0 = lp_ops.launches
        got = float(lp_ops.llc_probe(x, reps).double().sum())
        torch.cuda.synchronize()
        check(lp_ops.launches == n0 + 1,
              f"llc_probe ({n}, {reps}): not one launch")
        plain = float(llc_probe_ref(x, reps))
        want = reps * float(torch.dot(x.double(), x.double()))
        tol = sum_tol(torch.float32, n * reps) * want
        check(abs(got - want) <= tol and abs(plain - want) <= tol,
              f"llc_probe ({n}, {reps}): {got} / plain {plain} vs {want}")
        err = abs(got - plain)
    return timed("llc_probe", [32 << 20, 1], torch.float32, x.nbytes, 2 * n,
                 err, 20, lambda: lp_ops.llc_probe(x, 1),
                 lambda: llc_probe_ref(x, 1), lambda: torch.dot(x, x))


def auto_phase(S, dev, cols, smi, reset_counts, read_counts) -> dict:
    """The front door with no strategy on the resident GW S: (a) its
    default call on the measured roofs, bitwise the named strategy's
    build; (c) max_k None, where the rank estimate runs (its outcome,
    the choice and the basis quality reported, not gated); (e)
    sketch_power 3, where the rule sends the build to block_p 8 (its
    quality reported, not gated; bitwise the named build); (d) a 1 GiB
    budget with roofs pinned not roof-bound: "streamed" at block_p 1,
    bitwise strategy="streamed".  Returns (a)'s launches."""
    from repro_torch.api import build_basis
    from repro_torch.core.errors import per_column_errors

    sample = S.index_select(1, cols)
    base = dict(source=S, tau=TAU, max_k=MAX_K, chunk=16, device=dev)

    def build(**kw):
        reset_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with LogLines() as log:
            t0 = time.perf_counter()
            b = build_basis(**{**base, **kw})
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        pv = b.provenance
        return b, wall, read_counts(), log.lines, {
            "strategy": pv["strategy"], "block_p": pv["block_p"],
            "max_k": pv["max_k"], "k": b.k, "stop": pv.get("stop"),
            "wall_s": wall, "peak_mem_gb":
                torch.cuda.max_memory_allocated() / 1e9}

    def same(a, b, what):
        check(a.k == b.k and torch.equal(a.Q, b.Q)
              and np.array_equal(a.pivots, b.pivots)
              and np.array_equal(a.errs, b.errs),
              f"{what}: not bitwise the named strategy's build")

    def reason(lines):
        return [ln for ln in lines if ln.startswith("auto strategy")]

    # (a) the default call on the measured roofs
    a, _, launches, lines, rec = build()
    named = build_basis(**{**base, "strategy": rec["strategy"],
                           "block_p": rec["block_p"],
                           "max_k": rec["max_k"]})
    same(a, named, "auto (a)")
    check(launches["column_norms"] > 0, "auto (a): no column_norms launch")
    pce = float(per_column_errors(sample, a.Q).max())
    emit("auto", case="a_resident_default", M=M, **rec, reason=reason(lines),
         max_sampled_col_err=pce, launches=launches, bitwise_named=True,
         nvidia_smi=smi)
    del a, named
    torch.cuda.empty_cache()

    # (c) no max_k: the rank estimate decides the plan
    c, _, c_launches, lines, rec = build(max_k=None)
    est = [ln for ln in lines if ln.startswith("sketch-estimated rank")
           or ln.startswith("rank estimate saturated")]
    check(len(est) == 1, f"auto (c): the rank estimate did not run: {lines}")
    pce = float(per_column_errors(sample, c.Q).max())
    emit("auto", case="c_estimated_max_k", M=M, **rec, estimate=est[0],
         saturated="saturated" in est[0], reason=reason(lines),
         max_sampled_col_err=pce, usable_err_bound=100 * TAU,
         usable=pce <= 100 * TAU, launches=c_launches, nvidia_smi=smi)
    del c
    torch.cuda.empty_cache()

    # (e) where the reference's rule sends a build to block_p 8: at
    # sketch_power 3 the sketch costs 7 passes and 13 blocked greedy
    # passes no longer exceed twice that (the limit ROADMAP.md queue 3
    # records: the blocked basis falls short on this grid in both
    # packages; reported, not gated)
    e, _, e_launches, lines, rec = build(sketch_power=3)
    check(rec["strategy"] == "block_greedy" and rec["block_p"] == BLOCK_P,
          f"auto (e): chose {rec['strategy']} at block_p {rec['block_p']}")
    named = build_basis(**{**base, "strategy": "block_greedy",
                           "block_p": BLOCK_P})
    same(e, named, "auto (e)")
    pce = float(per_column_errors(sample, e.Q).max())
    emit("auto", case="e_blocked_by_the_rule", M=M, **rec,
         reason=reason(lines), max_sampled_col_err=pce,
         usable_err_bound=100 * TAU, usable=pce <= 100 * TAU,
         launches=e_launches, bitwise_named=True, nvidia_smi=smi)
    del e, named
    torch.cuda.empty_cache()

    # (d) a forced small budget, roofs pinned not roof-bound (balance
    # 1 / 3350 FLOP/B, below the complex sweep's 1 FLOP/B)
    pinned = dict(memory_budget_bytes=AUTO_BUDGET, bandwidth_gbps=3350.0,
                  peak_gflops=1.0, cache_bytes=50 << 20, tile_m=STREAM_TILE)
    d, _, d_launches, lines, rec = build(**pinned)
    check(rec["strategy"] == "streamed" and rec["block_p"] == 1,
          f"auto (d): chose {rec['strategy']} at block_p {rec['block_p']}")
    named = build_basis(**{**base, **pinned, "strategy": "streamed"})
    same(d, named, "auto (d)")
    emit("auto", case="d_forced_budget", M=M, **rec, reason=reason(lines),
         launches=d_launches, bitwise_named=True, nvidia_smi=smi)
    del d, named, sample
    torch.cuda.empty_cache()
    return launches


# ------------------------------------------------ the lockstep build ----
def lanes_operands(S, B, gen, dev):
    """q in 512-byte lane rows (as the lockstep driver places them), acc
    and norms (B, M) for a B-lane sweep of S ((N, M) shared or (B, N, M)
    stacked)."""
    from repro_torch.core.backend import lane_rows

    N, Mx = S.shape[-2:]
    q = lane_rows(B, (N,), S.dtype, dev)
    q.copy_(rand(gen, (B, N), S.dtype, dev))
    q /= torch.linalg.vector_norm(q, dim=1, keepdim=True)
    rdt = S.dtype.to_real()
    acc = torch.rand((B, Mx), generator=gen, dtype=torch.float64).to(
        rdt).to(dev) * 0.5
    norms = (torch.linalg.vector_norm(S, dim=-2) ** 2).expand(
        B, Mx).contiguous()
    return q, acc, norms


def check_greedy_update_lanes(q, S, acc, norms, active=None) -> float:
    """The B-lane kernel on one input: one launch on the "lanes" route;
    each lane bitwise the scalar route's one-lane launch on its lane (the
    same flag: a lane's bits do not depend on B or its group, what makes
    every lockstep lane its scalar build);
    every lane within the stated tolerance of the plain version (c,
    acc_out, max_res), or, with every lane masked (S and q may be NaN
    then), bitwise it; two launches the same bits.  Returns the max abs
    error of c against the plain version."""
    from repro_torch.kernels.greedy_update import ops as gu_ops
    from repro_torch.kernels.greedy_update_lanes import ops as gl_ops
    from repro_torch.kernels.greedy_update_lanes.ref import (
        greedy_update_lanes_ref,
    )

    stacked = S.dim() == 3
    n0, s0 = gl_ops.launches_lanes, gu_ops.launches_sm90
    got = gl_ops.greedy_update_lanes(q, S, acc, norms, active)
    again = gl_ops.greedy_update_lanes(q, S, acc, norms, active)
    torch.cuda.synchronize()
    check(gl_ops.launches_lanes == n0 + 2,
          "greedy_update_lanes: a call left the lanes route")
    check(all(torch.equal(x, y) for x, y in zip(got, again)),
          "greedy_update_lanes: two launches differ")
    B = q.shape[0]
    for b in range(B):
        one = gu_ops.greedy_update(
            q[b], S[b] if stacked else S, acc[b], norms[b],
            None if active is None else active[b])
        check(all(torch.equal(x[b], y) for x, y in zip(got, one)),
              f"greedy_update_lanes: lane {b} is not its one-lane launch's")
    check(gu_ops.launches_sm90 == s0 + B,
          "greedy_update_lanes: a one-lane launch left the sm90 route")
    plain = greedy_update_lanes_ref(q, S, acc, norms, active)
    if active is not None and not bool(active.any()):
        check(all(torch.equal(x, y) for x, y in zip(got, plain)),
              "greedy_update_lanes: every lane masked is not what q = 0 "
              "gives")
        emit("kernels", kernel="greedy_update_lanes", route="lanes",
             layout="stacked" if stacked else "shared", dtype=str(S.dtype),
             shape=list(S.shape), batch=B, masked=B,
             bitwise_one_lane=True, bitwise_plain=True)
        return 0.0
    eps = torch.finfo(acc.dtype).eps
    scale = float(torch.linalg.vector_norm(S, dim=-2).max())
    tol = sum_tol(S.dtype, S.shape[-2]) * scale * float(
        torch.linalg.vector_norm(q, dim=1).max())
    err_c = float((got[0] - plain[0]).abs().max())
    tol_a = 2 * float(plain[0].abs().max()) * tol + 4 * eps * float(
        plain[1].abs().max())
    err_a = float((got[1] - plain[1]).abs().max())
    err_m = float((got[2] - plain[2]).abs().max())
    tol_m = tol_a + 4 * eps * float(norms.abs().max())
    check(err_c <= tol, f"greedy_update_lanes c: {err_c} > {tol}")
    check(err_a <= tol_a, f"greedy_update_lanes acc_out: {err_a} > {tol_a}")
    check(err_m <= tol_m, f"greedy_update_lanes max_res: {err_m} > {tol_m}")
    emit("kernels", kernel="greedy_update_lanes", route="lanes",
         layout="stacked" if stacked else "shared", dtype=str(S.dtype),
         shape=list(S.shape), batch=B,
         masked=0 if active is None else int((~active).sum()),
         bitwise_one_lane=True, max_abs_err_c=err_c, tol_c=tol,
         max_abs_err_acc=err_a, tol_acc=tol_a, max_abs_err_max=err_m,
         tol_max=tol_m)
    return err_c


def greedy_update_lanes_phase(S, dev) -> dict:
    """greedy_update_lanes against its plain version and, lane by lane,
    its own one-lane launch (the scalar sm90 route): the four types at small ragged shapes (B 1, 3,
    16 and 17: a second group past 16), masked lanes and all lanes masked
    on NaN S and q (nothing read), both layouts; then at the GW cell's
    shapes, the shared S at B 1, 2, 4, 8 and 16 and the band split's
    stacked (8, 1,250, 131,072), timed beside the plain version and the
    library call (``torch.matmul(q.conj(), S)``, c only; ``torch.bmm``
    stacked).  Bytes: S read once a group of up to 16 lanes, q, acc and
    norms read once, c and acc_out written once; operations 8 B N M (one
    complex multiply-add an element a lane) at the FP32 rate.  Returns the
    kernels-line entry (shared B 8) with the other timings under
    ``by_batch`` and ``stacked``."""
    gen = torch.Generator().manual_seed(SEED)
    for dtype in (torch.float32, torch.complex64, torch.float64,
                  torch.complex128):
        step = 16 // dtype.itemsize
        for B, n, m in ((1, 17, 128), (3, 131, 704), (16, 300, 1000),
                        (17, 129, 4100)):
            m -= m % step
            for stacked in (False, True):
                Sx = rand(gen, (B, n, m) if stacked else (n, m), dtype, dev)
                q, acc, norms = lanes_operands(Sx, B, gen, dev)
                check_greedy_update_lanes(q, Sx, acc, norms)
                active = torch.arange(B, device=dev) % 3 != 1
                check_greedy_update_lanes(q, Sx, acc, norms, active)
                off = torch.zeros(B, dtype=torch.bool, device=dev)
                Sx.fill_(float("nan"))
                q.fill_(float("nan"))
                check_greedy_update_lanes(q, Sx, acc, norms, off)
    from repro_torch.kernels.greedy_update_lanes import ops as gl_ops
    from repro_torch.kernels.greedy_update_lanes.ref import (
        greedy_update_lanes_ref,
    )

    def entry(Sx, B, reps):
        q, acc, norms = lanes_operands(Sx, B, gen, dev)
        stacked = Sx.dim() == 3
        err = check_greedy_update_lanes(q, Sx, acc, norms)
        groups = 1 if stacked else -(-B // 16)
        nbytes = groups * Sx.nbytes + q[0].nbytes * B + 3 * acc.nbytes \
            + acc.numel() * Sx.element_size()
        N_ = Sx.shape[-2]
        qc = q.conj().resolve_conj().contiguous()
        lib = (lambda: torch.bmm(qc.unsqueeze(1), Sx)) if stacked else \
            (lambda: torch.matmul(qc, Sx))
        return timed("greedy_update_lanes", [B, *Sx.shape[-2:]], Sx.dtype,
                     nbytes, macs_flops(Sx.dtype) * B * N_ * Sx.shape[-1],
                     err, reps,
                     lambda: gl_ops.greedy_update_lanes(q, Sx, acc, norms),
                     lambda: greedy_update_lanes_ref(q, Sx, acc, norms), lib)

    by_batch = {B: entry(S, B, 10) for B in (1, 2, 4, 8, 16)}
    stacked = entry(S.view(BATCH, N // BATCH, M), BATCH, 10)
    return {**by_batch[BATCH],
            "by_batch": {str(b): e for b, e in by_batch.items()},
            "stacked": stacked}


def sweep_taus(errs, B) -> list[float]:
    """A tau sweep of B lanes above S's float32 floor: one tau between each
    pair of the greedy build's last B + 1 errors (their geometric mean),
    largest first.  Every lane of a shared S takes the greedy build's
    pivots, so lane b stops on tau at its own k, and the B bases differ (a
    tau below the floor, where the rank guard stops the build, would give
    each such lane the same basis)."""
    e = np.asarray(errs, np.float64)[-(B + 1):]
    return [float(np.sqrt(a * b)) for a, b in zip(e[:-1], e[1:])]


def lane_records(res_lanes, scalars):
    """Per-lane gates of a lockstep build against its scalar builds: the
    front door's children (Q, R, pivots, errs, k, the lane's stop) and the
    drivers' last states (rnorms and pass counts) bitwise."""
    out = []
    for b, ((child, last), (ref, ref_last)) in enumerate(zip(res_lanes,
                                                             scalars)):
        k = child.k
        ok = (k == ref.k and torch.equal(child.Q, ref.Q)
              and np.array_equal(child.R, ref.R)
              and np.array_equal(child.pivots, ref.pivots)
              and np.array_equal(child.errs, ref.errs)
              and child.provenance["lane"]["stop"] == ref.provenance["stop"]
              and torch.equal(last.rnorms[b], ref_last.rnorms)
              and torch.equal(last.n_passes[b], ref_last.n_passes))
        check(ok, f"lane {b}: not bitwise its scalar build (k {k} vs "
                  f"{ref.k}, stop {child.provenance['lane']['stop']} vs "
                  f"{ref.provenance['stop']})")
        out.append({"k": k, "stop": ref.provenance["stop"]})
    return out


def batched_phase(phase, source, lanes_S, taus, dev, cols, smi,
                  reset_counts, read_counts) -> dict:
    """One lockstep build through the front door (``strategy="batched"``,
    max_k 100, chunk 16; launches counted from 0 just before it) beside
    the B scalar ``strategy="greedy"`` builds of its lanes (``lanes_S[b]``
    at ``taus[b]``).  Gates: every lane bitwise its scalar build (Q, R,
    pivots, errs, rnorms, pass counts, k, stop); one greedy_update_lanes
    launch a lockstep round, all on the lanes route; no scalar
    greedy_update launch in the lockstep build; the column norms one
    launch a distinct S; each lane's sampled error within 1.5x its last
    accepted error.  Returns the set, its launches and the record."""
    from repro_torch.api import build_basis
    from repro_torch.core.errors import per_column_errors

    def last_state(box):
        return lambda st: box.__setitem__(0, st)

    box = [None]
    reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    bset = build_basis(source=source, strategy="batched", tau=taus,
                       max_k=MAX_K, chunk=16, device=dev,
                       callback=last_state(box))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    lock = bset.provenance["lockstep"]
    B = bset.batch
    shared = bset.provenance["layout"] == "shared"
    check(launches["greedy_update_lanes"] == lock["rounds"]
          == launches["greedy_update_lanes_lanes"],
          f"{phase}: greedy_update_lanes launches {launches} != the "
          f"{lock['rounds']} lockstep rounds on the lanes route")
    check(launches["greedy_update"] == 0,
          f"{phase}: the scalar greedy_update launched in the lockstep "
          f"build: {launches}")
    # the init sums the norms once (shared) or once a lane's S; a lane's
    # refresh sums its residuals' norms a chunk of 8,192 columns at a time
    norms_launches = (1 if shared else B) + lock["refreshes"] * -(
        -bset.provenance["shape"][1] // 8192)
    check(launches["column_norms"] == norms_launches,
          f"{phase}: column_norms launches {launches['column_norms']} != "
          f"{norms_launches}")
    check(launches["imgs_project"] == launches["imgs_project_sm90"] > 0,
          f"{phase}: an imgs_project launch left the sm90 route")

    scalars, seq_wall = [], 0.0
    for b in range(B):
        rbox = [None]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = build_basis(source=lanes_S[b], strategy="greedy", tau=taus[b],
                          max_k=MAX_K, chunk=16, device=dev,
                          callback=last_state(rbox))
        torch.cuda.synchronize()
        seq_wall += time.perf_counter() - t0
        scalars.append((ref, rbox[0]))
    lanes = lane_records([(c, box[0]) for c in bset], scalars)
    del scalars
    for b, rec in enumerate(lanes):
        sample = lanes_S[b].index_select(1, cols)
        pce = float(per_column_errors(sample, bset[b].Q).max())
        last = float(bset[b].errs[-1])
        check(pce <= 1.5 * last,
              f"{phase}: lane {b}'s sampled error {pce} > 1.5 * {last}")
        rec.update(tau=taus[b], max_sampled_col_err=pce, last_err=last)
    # sweeps that read a lane's S: the live steps of each build (its k,
    # and the step whose basis a rank or tau stop drops); the lockstep
    # shared build reads S once a live round for up to 16 lanes
    sum_k = sum(r["k"] + (r["stop"] in ("STOP_RANK", "STOP_TAU"))
                for r in lanes)
    gb = lanes_S[0].nbytes / 1e9
    record = dict(layout=bset.provenance["layout"], batch=B,
                  shape=bset.provenance["shape"], max_k=MAX_K,
                  wall_s=wall, sequential_wall_s=seq_wall,
                  rounds=lock["rounds"], live_rounds=lock["live_rounds"],
                  chunks=lock["chunks"], refreshes=lock["refreshes"],
                  sum_k_swept=sum_k,
                  gb_read=(lock["live_rounds"] * -(-B // 16) if shared
                           else sum_k) * gb,
                  sequential_gb_read=sum_k * gb, lanes=lanes,
                  launches=launches, peak_mem_gb=peak, nvidia_smi=smi)
    emit(phase, **record)
    return bset, launches, record


def batched_stacked_phase(S, dev, cols, smi, reset_counts, read_counts):
    """The band split of the resident S (``band_split(S, 8)``: the full
    FFT of each column, 8 bands of 1,250 bins: (8, 1,250, 131,072)
    complex64) built at tau 1e-4 through :func:`batched_phase`; then the
    set saved, loaded (children bitwise) and registered with a
    BasisRouter, and one request a band served by a ROQEngine, bitwise its
    direct evaluation."""
    from repro_torch.api import ReducedBasisSet
    from repro_torch.data import band_split
    from repro_torch.serving import BasisRouter, ROQEngine, direct_interpolate

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    split = band_split(S, BATCH, device=dev)
    torch.cuda.synchronize()
    fft_s = time.perf_counter() - t0
    check(tuple(split.stack.shape) == (BATCH, N // BATCH, M)
          and not split.from_real and split.n_freq == N,
          f"band_split: {tuple(split.stack.shape)}")
    lanes_S = [split.stack[b] for b in range(BATCH)]
    bset, launches, record = batched_phase(
        "batched_stacked", split, lanes_S, [TAU] * BATCH, dev, cols, smi,
        reset_counts, read_counts)
    with tempfile.TemporaryDirectory() as tmp:
        bset.save(tmp)
        back = ReducedBasisSet.load(tmp, dev)
        check(all(x.k == y.k and torch.equal(x.Q, y.Q)
                  and np.array_equal(x.R, y.R)
                  and np.array_equal(x.pivots, y.pivots)
                  and np.array_equal(x.errs, y.errs)
                  and torch.equal(x.eim().nodes, y.eim().nodes)
                  for x, y in zip(bset, back)),
              "batched_stacked: the set's save / load is not bit-equal")
        router = BasisRouter(device=dev)
        ids = back.register(router, prefix="band")
        engine = ROQEngine(router, max_batch=16, max_wait_ms=1.0)
        served = 0
        try:
            for b, bid in enumerate(ids):
                basis, eim = router.get(bid)
                check(torch.equal(basis.Q, bset[b].Q),
                      f"batched_stacked: routed band {b} is not the build's")
                f_nodes = split.stack[b][:, int(cols[b])][eim.nodes]
                out = engine.submit(bid, f_nodes).result(timeout=60)
                check(torch.equal(out, direct_interpolate(eim, f_nodes)),
                      f"batched_stacked: band {b}'s answer is not its "
                      f"direct evaluation")
                served += 1
        finally:
            engine.close()
    emit("batched_stacked_set", fft_s=fft_s, saved_loaded_bitwise=True,
         registered=ids, served=served, served_bitwise=True,
         edges=[list(e) for e in split.edges])
    del split, lanes_S, bset, back
    torch.cuda.empty_cache()
    return launches


# ------------------------------------------------------ launch counts ----
# the wrappers that route between two kernels count each route apart
ROUTED = ("greedy_update", "imgs_project", "imgs_panel", "flash_attention",
          "roq_apply", "taylorf2_tile")


# ------------------------------------------------------------ training ----
def train_flops(cfg, batch: int, seq: int) -> dict:
    """Floating-point operations of one train step on ``batch`` x ``seq``
    tokens.  ``model``: 6 P T for the GEMMs (P without the embedding
    table, which is a lookup) plus the einsum attention's two products,
    2 B H S^2 hd each a layer forward, three times that with the
    backward; the einsum computes every (query, key) pair, the masked half
    too, in float32.  ``executed``: with remat the forward runs twice
    (8 P T, four times the attention's forward)."""
    T = batch * seq
    p_gemm = cfg.param_count() - cfg.vocab_size * cfg.d_model
    attn_fwd = cfg.n_layers * 4 * batch * cfg.n_heads * seq * seq * cfg.hd
    remat = 2 if cfg.remat else 1
    return {"gemm": 6 * p_gemm * T, "attention": 3 * attn_fwd,
            "model": 6 * p_gemm * T + 3 * attn_fwd,
            "executed": (4 + 2 * remat) * p_gemm * T
            + (2 + remat) * attn_fwd}


def _tree_gb(tree) -> float:
    from repro_torch.tree import leaves
    return sum(t.nbytes for t in leaves(tree)) / 1e9


def train_full_width(dev, smi, reset_counts, read_counts):
    """(a): stablelm-3b whole through make_train_step; returns the
    launches of the 6 steps, counted from 0 just before them, and the
    phase's fields."""
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLMData
    from repro_torch.tree import leaves
    from repro_torch.training import make_train_step, train_state_init

    cfg = get_config(TRAIN_ARCH)
    check(cfg.dtype == "bfloat16" and cfg.remat and cfg.attn_impl == "auto"
          and TRAIN_SEQ <= 8192,
          f"train: {TRAIN_ARCH} is not bf16 / remat / einsum attention")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = train_state_init(cfg, SEED, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    state_gb = _tree_gb(state)
    before = [p.to("cpu", copy=True) for p in leaves(state.params)]
    data = SyntheticLMData(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH,
                           seed=SEED, device=dev)
    step = make_train_step(cfg, n_microbatches=TRAIN_MICRO, base_lr=3e-4,
                           warmup=2, total_steps=TRAIN_STEPS)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    times, metrics = [], []
    for i in range(TRAIN_STEPS):
        batch = data.batch(i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        metrics.append({k: float(v) for k, v in m.items()})
    launches = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(launches["flash_attention"] == 0,
          f"train: {launches['flash_attention']} flash launches: training "
          f"attends by einsum")
    check(all(math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])
              for m in metrics), f"train: loss or grad_norm not finite: "
          f"{metrics}")
    moved = 0
    for p, b in zip(leaves(state.params), before):
        check(bool(torch.isfinite(p).all()), "train: a parameter is not "
              "finite")
        moved += not torch.equal(p, b.to(dev))
    n_leaves = len(before)
    check(moved == n_leaves, f"train: {n_leaves - moved} of {n_leaves} "
          f"parameter leaves did not move")
    check(int(state.step) == TRAIN_STEPS, f"train: step {int(state.step)}")
    del before
    # the dry run's grounding (its part (b)): the bytes the state and a
    # batch hold, summed over their live tensors, and the counting mode's
    # FLOPs of one more real step (after the timed ones, uncounted by the
    # launch counters)
    from repro_torch.launch.roofline import CostCounter
    grounding = dict(state_bytes=sum(t.nbytes for t in leaves(state)),
                     batch_bytes=sum(t.nbytes for t in leaves(batch)),
                     peak_mem_gb=peak_gb, step_ms_mean=None)
    counter = CostCounter()
    with counter:
        state, _ = step(state, data.batch(TRAIN_STEPS))
    torch.cuda.synchronize()
    grounding["step_flops"] = counter.flops
    step_ms = float(np.mean(times[1:]))
    tokens = TRAIN_BATCH * TRAIN_SEQ
    fl = train_flops(cfg, TRAIN_BATCH, TRAIN_SEQ)
    fields = dict(
        arch=TRAIN_ARCH, params_b=cfg.param_count() / 1e9, dtype=cfg.dtype,
        remat=cfg.remat, attn_impl=cfg.attn_impl, batch=TRAIN_BATCH,
        seq=TRAIN_SEQ, microbatches=TRAIN_MICRO, steps=TRAIN_STEPS,
        init_s=init_s, step_ms=times, step_ms_mean=step_ms,
        step_ms_min=min(times[1:]), tokens_per_s=tokens / step_ms * 1e3,
        peak_mem_gb=peak_gb, state_gb=state_gb,
        model_flops=fl["model"], gemm_flops=fl["gemm"],
        attention_flops=fl["attention"], executed_flops=fl["executed"],
        model_tflops_per_s=fl["model"] / step_ms / 1e9,
        bf16_peak_share=fl["model"] / (step_ms / 1e3) / BF16_FLOPS,
        losses=[m["loss"] for m in metrics],
        grad_norms=[m["grad_norm"] for m in metrics],
        lrs=[m["lr"] for m in metrics], leaves_moved=moved,
        launches=launches, card=smi)
    grounding["step_ms_mean"] = step_ms
    fields["grounding"] = grounding
    del state, step, data
    torch.cuda.empty_cache()
    return launches, fields


def train_restart(dev) -> dict:
    """(b): the launcher on the card uninterrupted, then crashed after step
    17 and resumed; the final checkpoints must be bitwise equal."""
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")
    env = dict(os.environ, PYTHONPATH=src)

    def run(ckpt, *extra):
        t0 = time.perf_counter()
        p = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train",
             *TRAIN_LAUNCH_ARGS, "--ckpt-dir", ckpt, *extra],
            env=env, capture_output=True, text=True, timeout=300)
        return p, time.perf_counter() - t0

    with tempfile.TemporaryDirectory() as tmp:
        ref, ft = os.path.join(tmp, "ref"), os.path.join(tmp, "ft")
        p, ref_s = run(ref)
        check(p.returncode == 0, f"train restart: the uninterrupted run "
              f"failed: {p.stderr[-2000:]}")
        p, crash_s = run(ft, "--crash-at", "17")
        check(p.returncode == 42, f"train restart: the crash run exited "
              f"{p.returncode}: {p.stderr[-2000:]}")
        p, resume_s = run(ft)
        check(p.returncode == 0, f"train restart: the resumed run failed: "
              f"{p.stderr[-2000:]}")
        restored = [ln for ln in p.stdout.splitlines()
                    if ln.startswith("restored")]
        last_ref, last_ft = sorted(os.listdir(ref))[-1], sorted(
            os.listdir(ft))[-1]
        check(last_ref == last_ft == "step_00000030",
              f"train restart: final steps {last_ref} / {last_ft}")
        names = sorted(os.listdir(os.path.join(ref, last_ref)))
        check(names == sorted(os.listdir(os.path.join(ft, last_ft))),
              "train restart: the final checkpoints hold other leaves")
        differ = [n for n in names if open(os.path.join(ref, last_ref, n),
                                           "rb").read()
                  != open(os.path.join(ft, last_ft, n), "rb").read()]
        check(not differ, f"train restart: {differ} differ after the "
              f"crash and resume")
    return {"restart_files": len(names), "restart_bitwise": True,
            "restart_restored": restored, "restart_run_s": [
                ref_s, crash_s, resume_s]}


def train_card_vs_cpu(dev) -> dict:
    """(c): reduced stablelm-3b in float32 from the same parameters and
    batches, 5 steps on the card and on the CPU: losses within
    TRAIN_CMP_RTOL.  TF32 is off (repro_torch.device), so both sum float32
    products in float32 and differ in order only."""
    from repro_torch.configs import get_reduced
    from repro_torch.data import SyntheticLMData
    from repro_torch.tree import leaves
    from repro_torch.training import make_train_step, train_state_init
    from repro_torch.training.trainer import state_to

    cfg = get_reduced(TRAIN_ARCH)
    check(cfg.dtype == "float32", f"train: reduced {TRAIN_ARCH} not f32")
    cpu_state = train_state_init(cfg, SEED, device="cpu")
    card_state = state_to(cpu_state, dev)
    out = {}
    for name, state, d in (("cpu", cpu_state, "cpu"),
                           ("card", card_state, dev)):
        data = SyntheticLMData(cfg.vocab_size, TRAIN_CMP_SEQ,
                               TRAIN_CMP_BATCH, seed=SEED, device=d)
        step = make_train_step(cfg, base_lr=1e-3, warmup=0,
                               total_steps=TRAIN_CMP_STEPS)
        losses = []
        for i in range(TRAIN_CMP_STEPS):
            state, m = step(state, data.batch(i))
            losses.append(float(m["loss"]))
        out[name] = (losses, state)
    rel = [abs(a - b) / abs(b) for a, b in zip(out["card"][0],
                                               out["cpu"][0])]
    check(max(rel) <= TRAIN_CMP_RTOL,
          f"train: card losses {out['card'][0]} against the CPU's "
          f"{out['cpu'][0]}: {max(rel)} > {TRAIN_CMP_RTOL}")
    pdiff = max(float((a.cpu() - b).abs().max()) for a, b in zip(
        leaves(out["card"][1].params), leaves(out["cpu"][1].params)))
    return {"cmp_steps": TRAIN_CMP_STEPS, "cmp_losses_card": out["card"][0],
            "cmp_losses_cpu": out["cpu"][0], "cmp_loss_max_rel": max(rel),
            "cmp_loss_rtol": TRAIN_CMP_RTOL, "cmp_param_max_abs_diff": pdiff}


def train_main(out: str) -> None:
    """The child process of the train phase: (a), (b) and (c) (see the
    module docstring); writes (a)'s launches and the dry run's grounding
    (the state's and a batch's bytes, one real step's counted FLOPs, the
    peak and the step time) as JSON to ``out``.  cuBLAS's
    reproducible workspace is fixed here, before the process's first
    cuBLAS call, so that it reaches no other phase."""
    from repro_torch.training.trainer import CUBLAS_WORKSPACE
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", CUBLAS_WORKSPACE)
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    launches, fields = train_full_width(dev, smi, reset_counts, read_counts)
    fields.update(train_restart(dev))
    fields.update(train_card_vs_cpu(dev))
    emit("train", phase_s=time.perf_counter() - t0, **fields)
    with open(out, "w") as f:
        json.dump({"launches": launches, "grounding": fields["grounding"]},
                  f)


def train_phase() -> dict:
    """Runs :func:`train_main` in a child process on the same card, with
    this process's cached blocks released first; returns (a)'s launches
    and the dry run's grounding."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "launches.json")
        p = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--train", out], timeout=900)
        check(p.returncode == 0, f"train: the phase's process exited "
              f"{p.returncode}")
        with open(out) as f:
            rec = json.load(f)
        return rec["launches"], rec["grounding"]


# the dry run's cells, each traced in its own process in a fake world of
# 256 ranks (full mode and roofline variant); mamba2-780m's prefill only in
# the roofline variant (one SSD chunk, scaled), its full 128-chunk trace
# takes minutes; mixtral-8x7b train_4k multi is not traced here (its full
# and roofline traces take 6 and 4 minutes of a CPU: PERF.md)
DRYRUN_CELLS = (("stablelm-3b", "train_4k", "both"),
                ("granite-3-8b", "decode_32k", "both"),
                ("mamba2-780m", "prefill_32k", "roofline"))

# (b): stablelm-3b traced in a world of one at the train phase's shape
DRYRUN_ONE = """
import json, sys
import torch
from repro_torch.compat import make_auto_mesh
from repro_torch.configs import get_config
from repro_torch.launch import dryrun as D
from repro_torch.launch import roofline as R
from repro_torch.launch.mesh import init_fake_world
from repro_torch.models.config import ShapeConfig
init_fake_world(1)
mesh = make_auto_mesh((1, 1), ("data", "model"), sys.argv[1])
cfg = get_config("stablelm-3b")
shape = ShapeConfig("train_phase", 2048, 8, "train")
fn, mk, extra = D.build_cell(cfg, shape, mesh, n_micro=2)
rec = D.trace(fn, mk, mesh)
rec["roofline"] = R.roofline_seconds(rec["cost"])
print(json.dumps(rec))
"""


def dryrun_phase(grounding: dict) -> None:
    """(a) the dry run's cells and REPRO_DRYRUN on the 256- and 512-rank
    meshes, and (b) a world of one, each in a process of its own, started
    together: every one must trace; one line each.  (b) is held to the
    train phase's ``grounding``: the predicted argument bytes equal the
    bytes its state and batch held, and the traced FLOPs the counting
    mode's FLOPs on one real step of the card, exactly."""
    from repro_torch.configs import get_config

    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")
    env = dict(os.environ, PYTHONPATH=src)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        jobs = {}
        for arch, shape, mode in DRYRUN_CELLS:
            jobs[f"{arch} {shape}"] = (
                [sys.executable, "-m", "repro_torch.launch.dryrun",
                 "--arch", arch, "--shape", shape, "--mesh", "single",
                 "--mode", mode, "--device", "cuda", "--out", tmp], env)
        for mesh in ("single", "multi"):
            jobs[f"REPRO_DRYRUN {mesh}"] = (
                [sys.executable, "-m", "repro_torch.launch.reduce", "--mesh",
                 mesh, "--device", "cuda", "--out", tmp],
                dict(env, REPRO_DRYRUN="1"))
        jobs["world_of_one"] = ([sys.executable, "-c", DRYRUN_ONE, "cuda"],
                                env)
        procs = {}
        for name, (cmd, e) in jobs.items():
            log = open(os.path.join(tmp, name.replace(" ", "_") + ".log"),
                       "w+")
            procs[name] = (subprocess.Popen(cmd, env=e, stdout=log,
                                            stderr=subprocess.STDOUT), log)
        deadline = time.monotonic() + 600
        try:
            for name, (p, log) in procs.items():
                p.wait(timeout=max(deadline - time.monotonic(), 1))
        finally:
            for p, _ in procs.values():
                if p.poll() is None:
                    p.kill()
                    p.wait()
        outs = {}
        for name, (p, log) in procs.items():
            log.seek(0)
            text = log.read()
            log.close()
            check(p.returncode == 0, f"dryrun: {name} exited "
                  f"{p.returncode}: {text[-1500:]}")
            outs[name] = text
        for arch, shape, _ in DRYRUN_CELLS:
            with open(os.path.join(tmp, f"{arch}__{shape}__single.json")) \
                    as f:
                rec = json.load(f)
            full = rec.get("full", {})
            roof = rec["roofline"]
            emit("dryrun", cell=f"{arch} {shape} single", devices=256,
                 memory=full.get("memory"), cost=full.get("raw_cost"),
                 collective_detail=full.get("collective_detail"),
                 full_roofline=full.get("roofline"),
                 fitted=roof["fitted_per_device"], roofline=roof["roofline"],
                 useful_flop_ratio=roof["useful_flop_ratio"],
                 trace_s=full.get("trace_s"))
        for mesh in ("single", "multi"):
            with open(os.path.join(tmp, f"gw_greedy__{mesh}.json")) as f:
                rec = json.load(f)
            check(rec["per_device_cost"]["flops"]
                  >= rec["useful_flops_per_device"],
                  f"dryrun: REPRO_DRYRUN {mesh} traced fewer FLOPs than "
                  f"the useful 8 N M / P")
            emit("dryrun", cell=f"REPRO_DRYRUN {mesh}",
                 devices=rec["devices"], memory=rec["memory"],
                 cost=rec["per_device_cost"],
                 collective_detail=rec["collective_detail"],
                 roofline=rec["roofline"],
                 useful_flop_ratio=rec["useful_flop_ratio"])
        one = json.loads(outs["world_of_one"].strip().splitlines()[-1])
        args = one["memory"]["argument_size_in_bytes"]
        real = grounding["state_bytes"] + grounding["batch_bytes"]
        check(args == real,
              f"dryrun (b): predicted argument bytes {args} != the train "
              f"phase's state {grounding['state_bytes']} + batch "
              f"{grounding['batch_bytes']}")
        check(one["cost"]["flops"] == grounding["step_flops"],
              f"dryrun (b): traced FLOPs {one['cost']['flops']} != the "
              f"counting mode's {grounding['step_flops']} on a real step")
        peak = one["memory"]["peak_size_in_bytes"]
        emit("dryrun", cell="stablelm-3b world of one (train phase shape)",
             argument_bytes=args, state_bytes=grounding["state_bytes"],
             batch_bytes=grounding["batch_bytes"],
             traced_flops=one["cost"]["flops"],
             real_step_flops=grounding["step_flops"],
             analytic_flops=train_flops(get_config(TRAIN_ARCH), TRAIN_BATCH,
                                        TRAIN_SEQ),
             predicted_peak_bytes=peak,
             measured_peak_gb=grounding["peak_mem_gb"],
             peak_ratio=peak / 1e9 / grounding["peak_mem_gb"],
             roofline=one["roofline"],
             measured_step_ms=grounding["step_ms_mean"],
             roofline_step_ratio=one["roofline"]["bound_s"] * 1e3
             / grounding["step_ms_mean"])
    emit("dryrun", phase_s=time.perf_counter() - t0)


# ------------------------------------------- the pipeline and TP modes ----
# pipeline: stablelm-3b whole, 2 stages of 16 layers on 2 ranks sharing the
# card over gloo, 4 microbatches of 2 x 2,048 tokens (the train phase's
# global batch of 8 x 2,048), remat on
PIPE_ARCH = "stablelm-3b"
PIPE_STAGES, PIPE_MICRO, PIPE_B, PIPE_SEQ = 2, 4, 2, 2048
PIPE_LOSS_RTOL = 1e-3
PIPE_GRAD_RTOL = 1e-2
# tp_modes: 4 ranks sharing the card on a (2, 2) ("data", "model") mesh,
# a forward on 4 x 2,048 tokens a mode; (arch, layers (None: whole),
# modes, modes that also take a backward pass)
TP_BATCH, TP_SEQ = 4, 2048
TP_LOSS_ATOL = 5e-3
# the logits against the one-rank logits: the rows' (tokens') 90th
# percentile relative L2 for every mode, 1.7x the worst bf16 gap measured
# on the H100 (stablelm megatron's 1.72e-2); the whole relative L2 by
# family, where MoE routing flips on near-ties move a few rows by O(1)
# (mixtral megatron's whole 0.119 against its rows' 1.62e-2)
TP_ROW_RTOL = 3e-2
TP_LOGIT_RTOL = {"dense": 3e-2, "moe": 0.25}
TP_GRAD_RTOL = 1e-2
TP_CELLS = (("stablelm-3b", None, ("megatron", "ulysses", "megatron_rs"),
             ("megatron", "megatron_rs")),
            ("mixtral-8x7b", 2, ("megatron", "ulysses+ep"), ()))
TP_MODE_FIELDS = {"megatron": {}, "ulysses": {"tp_mode": "ulysses"},
                  "megatron_rs": {"tp_mode": "megatron_rs"},
                  "ulysses+ep": {"tp_mode": "ulysses", "moe_ep": True}}


def _ce(logits, labels):
    """The pipeline's microbatch loss: mean cross entropy in float32."""
    logits = logits.to(torch.float32)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return torch.mean(torch.logsumexp(logits, dim=-1) - gold)


def pipeline_batch(cfg, dev):
    """(tokens, labels), each (PIPE_MICRO, PIPE_B, PIPE_SEQ), from SEED."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    return tuple(torch.randint(0, cfg.vocab_size,
                               (PIPE_MICRO, PIPE_B, PIPE_SEQ),
                               generator=gen, device=dev) for _ in range(2))


def pipeline_reference(dev, grad_path) -> dict:
    """The one-process losses of the pipeline phase's microbatches on the
    same parameters: (a) under grad (the embedding gradient saved to
    ``grad_path``), (b) with flash under no_grad."""
    from repro_torch.configs import get_config
    from repro_torch.models import api
    from repro_torch.models import transformer as tfm

    cfg = get_config(PIPE_ARCH)
    params = api.init_params(cfg, SEED, device=dev)
    tokens, labels = pipeline_batch(cfg, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.enable_grad():
        embed = params.embed.detach().requires_grad_()
        p = params._replace(embed=embed)
        loss = sum(_ce(tfm.decoder_forward(p, cfg, tokens[i]), labels[i])
                   for i in range(PIPE_MICRO)) / PIPE_MICRO
        (g,) = torch.autograd.grad(loss, embed)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    torch.save(g.cpu(), grad_path)
    del g, embed, p
    fcfg = cfg.replace(attn_impl="flash")
    with torch.no_grad():
        loss_b = sum(_ce(tfm.decoder_forward(params, fcfg, tokens[i]),
                         labels[i]) for i in range(PIPE_MICRO)) / PIPE_MICRO
    out = {"loss": float(loss.detach()), "loss_flash": float(loss_b),
           "step_ms": step_ms}
    del params, loss, loss_b
    torch.cuda.empty_cache()
    return out


def timed_shifts(link) -> list:
    """Wrap a pipeline link's ``shift`` so that each shift is timed on the
    host clock from the moment the device has finished the tensor it
    sends.  Returns the log the wrapper fills: (direction, start, end) a
    shift."""
    log, shift = [], link.shift

    def timed(t, forward):
        if t.is_cuda:
            torch.cuda.synchronize(t.device)
        t0 = time.perf_counter()
        out = shift(t, forward)
        log.append((forward, t0, time.perf_counter()))
        return out

    link.shift = timed
    return log


def _ticks(log, start, stage):
    """Each tick's compute (ms, host clock) from the shift log of one
    forward begun at ``start``: the time from the start or the previous
    shift's end to the next shift's start; and whether the tick was in
    the bubble (the stage held no microbatch)."""
    ends = [start] + [e[2] for e in log]
    ms = [(e[1] - a) * 1e3 for a, e in zip(ends, log)]
    bubble = [not stage <= t < stage + PIPE_MICRO for t in range(len(ms))]
    return ms, bubble


def pipeline_rank(grad_path):
    """Rank program of the phase pipeline (spawned, the ranks sharing the
    card over gloo): (a) the pipelined loss and gradients, (b) the flash
    forward with launches counted from 0 just before it."""
    import torch.distributed as dist

    from repro_torch.compat import make_auto_mesh
    from repro_torch.configs import get_config
    from repro_torch.models import api
    from repro_torch.training.pipeline import (
        make_pipeline_forward, stage_blocks,
    )
    from repro_torch.tree import leaves, unflatten

    dev = torch.device("cuda", torch.cuda.current_device())
    cfg = get_config(PIPE_ARCH)
    mesh = make_auto_mesh((PIPE_STAGES,), ("pod",), "cuda")
    params = api.init_params(cfg, SEED, device=dev)
    loss_fn, _ = make_pipeline_forward(cfg, mesh, PIPE_MICRO)
    link = loss_fn.link
    log = timed_shifts(link)
    stage = link.stage
    own = stage_blocks(params.blocks, PIPE_STAGES)[stage]
    embed, norm_w, head = params.embed, params.final_norm, params.lm_head
    del params
    torch.cuda.empty_cache()
    tokens, labels = pipeline_batch(cfg, dev)
    out = {"rank": dist.get_rank(), "stage": stage,
           "backend": dist.get_backend()}

    # (a) under grad, einsum attention, remat
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.enable_grad():
        views = [t.detach().requires_grad_()
                 for t in [embed, norm_w, head, *leaves(own)]]
        blocks = [None] * PIPE_STAGES
        blocks[stage] = unflatten(own, views[3:])
        loss = loss_fn(views[0], blocks, views[1], views[2], tokens, labels)
        grads = torch.autograd.grad(loss, views)
    torch.cuda.synchronize()
    shift_ms = sum(e[2] - e[1] for e in log) * 1e3
    out["a"] = {"step_ms": (time.perf_counter() - t0) * 1e3,
                "loss": float(loss.detach()),
                "shifts": link.calls, "shift_ms": shift_ms,
                "shift_ms_each": shift_ms / link.calls,
                "bytes_staged": link.bytes_staged,
                "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    finite = [bool(torch.isfinite(g).all()) for g in grads]
    ref_g = torch.load(grad_path).to(dev).to(torch.float32)
    g = grads[0].to(torch.float32)
    out["a"].update(
        leaves=len(grads), finite_leaves=sum(finite),
        embed_grad_norm=float(torch.linalg.vector_norm(g)),
        embed_grad_rel_l2=float(torch.linalg.vector_norm(g - ref_g)
                                / torch.linalg.vector_norm(ref_g)))
    del grads, views, blocks, loss, g, ref_g
    torch.cuda.empty_cache()

    # (b) the flash forward, an evaluation loss
    loss_fn, _ = make_pipeline_forward(cfg.replace(attn_impl="flash"), mesh,
                                       PIPE_MICRO)
    link = loss_fn.link
    log = timed_shifts(link)
    blocks = [None] * PIPE_STAGES
    blocks[stage] = own
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    with torch.no_grad():
        loss = loss_fn(embed, blocks, norm_w, head, tokens, labels)
    torch.cuda.synchronize()
    ms, bubble = _ticks(log, t0, stage)
    shift_ms = sum(e[2] - e[1] for e in log) * 1e3
    out["b"] = {"forward_ms": (time.perf_counter() - t0) * 1e3,
                "loss": float(loss), "launches": read_counts(),
                "shifts": link.calls, "shift_ms": shift_ms,
                "shift_ms_each": shift_ms / link.calls,
                "bytes_staged": link.bytes_staged, "tick_ms": ms,
                "bubble_ticks": bubble,
                "bubble_share": sum(m for m, b in zip(ms, bubble) if b)
                / sum(ms),
                "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    return out


def pipeline_phase(dev, smi) -> dict:
    """stablelm-3b whole through training/pipeline.py on PIPE_STAGES ranks
    spawned on the card (gloo: ranks sharing a card cannot form an NCCL
    group), the stage shift staged through pinned host buffers: (a) under
    grad, the loss within PIPE_LOSS_RTOL of the one-process loss of the
    same microbatches on the same parameters (bitwise reported), the
    embedding gradient finite, nonzero and within PIPE_GRAD_RTOL relative
    L2 of the one-process one, every stage leaf's gradient finite; (b)
    with flash under no_grad, the loss within PIPE_LOSS_RTOL of the same
    one-process einsum loss (lm_kernel_phase holds the kernel itself to
    the plain attention at this shape), every flash launch on the sm90
    route (D 80): 5 ticks x 16 layers x 2 ranks.  Returns (b)'s
    launches summed over the ranks."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import spawn_ranks

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "embed_grad.pt")
        ref = pipeline_reference(dev, path)
        ranks = spawn_ranks(pipeline_rank, PIPE_STAGES, args=(path,),
                            device="cuda", timeout_s=600)
    n_ticks = PIPE_MICRO + PIPE_STAGES - 1
    for r in ranks:
        a, b = r["a"], r["b"]
        for name, got, want in (("(a)", a["loss"], ref["loss"]),
                                ("(b)", b["loss"], ref["loss"])):
            check(abs(got - want) <= PIPE_LOSS_RTOL * abs(want),
                  f"pipeline {name}: rank {r['rank']} loss {got} against "
                  f"the one-process {want}")
        check(a["finite_leaves"] == a["leaves"],
              f"pipeline (a): rank {r['rank']}: "
              f"{a['leaves'] - a['finite_leaves']} gradient leaves not "
              f"finite")
        check(a["embed_grad_norm"] > 0
              and a["embed_grad_rel_l2"] <= PIPE_GRAD_RTOL,
              f"pipeline (a): rank {r['rank']} embedding gradient norm "
              f"{a['embed_grad_norm']}, relative L2 {a['embed_grad_rel_l2']}")
        check(a["shifts"] == 2 * n_ticks - 1 and b["shifts"] == n_ticks,
              f"pipeline: rank {r['rank']} shifted {a['shifts']} / "
              f"{b['shifts']} times")
    launches = sum_counts([r["b"]["launches"] for r in ranks])
    # one launch a layer a tick on each stage: 5 x 16 x 2
    want = n_ticks * get_config(PIPE_ARCH).n_layers
    check(launches["flash_attention"] == want
          and launches["flash_attention_sm90"] == want,
          f"pipeline (b): {launches['flash_attention']} flash launches, "
          f"{launches['flash_attention_sm90']} on the sm90 route, not "
          f"{want} all sm90")
    emit("pipeline", arch=PIPE_ARCH, stages=PIPE_STAGES, micro=PIPE_MICRO,
         batch=PIPE_B, seq=PIPE_SEQ, backend=ranks[0]["backend"],
         reference=ref,
         loss_a=[r["a"]["loss"] for r in ranks],
         loss_a_bitwise=all(r["a"]["loss"] == ref["loss"] for r in ranks),
         loss_b=[r["b"]["loss"] for r in ranks],
         loss_b_bitwise=all(r["b"]["loss"] == ref["loss_flash"]
                            for r in ranks),
         flash_launches=launches["flash_attention"],
         flash_launches_sm90=launches["flash_attention_sm90"],
         flash_launches_general=launches["flash_attention_general"],
         schedule_bubble_share=(PIPE_STAGES - 1) / n_ticks,
         ranks=ranks, card=smi, phase_s=time.perf_counter() - t0)
    return launches


def tp_config(arch, layers):
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    return cfg if layers is None else cfg.replace(n_layers=layers)


class captured_logits:
    """Within the block, every call of ``api.loss_fn`` keeps its logits
    (detached) in the list the block receives: the modes' logits come
    from the same forward as their loss."""

    def __enter__(self):
        from repro_torch.models import api

        self.api, self.orig, kept = api, api.forward_logits, []

        def keep(*a, **kw):
            logits = self.orig(*a, **kw)
            kept.append(logits.detach())
            return logits

        api.forward_logits = keep
        return kept

    def __exit__(self, *exc):
        self.api.forward_logits = self.orig


def logits_error(got, ref) -> tuple:
    """(relative L2, max abs, the 90th percentile of the rows' relative
    L2) of logits ``got`` against ``ref``, in float32; a row is one
    token's logits.  On a DTensor each rank compares its own shard with
    the same slice of ``ref``, which every rank holds whole."""
    from torch.distributed.tensor import Replicate, distribute_tensor

    from repro_torch.sharding import is_dtensor

    if is_dtensor(got):
        pl = [Replicate() if p.is_partial() else p for p in got.placements]
        got = got.redistribute(placements=pl)
        ref = distribute_tensor(ref, got.device_mesh, pl, src_data_rank=None)
    d, r = got.float() - ref.float(), ref.float()
    norm = torch.linalg.vector_norm
    out = [norm(d), norm(r), d.abs().max(), norm(d, dim=-1), norm(r, dim=-1)]
    out = [x.full_tensor() if is_dtensor(x) else x for x in out]
    rows = (out[3] / out[4]).flatten()
    return (float(out[0] / out[1]), float(out[2]),
            float(torch.quantile(rows, 0.9)))


def tp_rank():
    """Rank program of the phase tp_modes (spawned, 4 ranks sharing the
    card over gloo on a (2, 2) ("data", "model") mesh).  Each cell's
    one-rank loss and logits (plain tensors, no mesh), computed on every
    rank, and on rank 0 the logits' relative L2 change from the blocks
    (the model without them against the model); then each mode, the
    parameters distributed with the production shardings: its loss, its
    logits' relative L2 and max abs error against the one-rank logits,
    and a backward pass's gradient norm for the modes that take one."""
    import torch.distributed as dist
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.compat import make_auto_mesh
    from repro_torch.launch.specs import distribute_params
    from repro_torch.models import api
    from repro_torch.optim.adamw import global_norm
    from repro_torch.sharding import placements, resolve, use_mesh
    from repro_torch.training.trainer import value_and_grad

    dev = torch.device("cuda", torch.cuda.current_device())
    mesh = make_auto_mesh((2, 2), ("data", "model"), "cuda")
    out = {"rank": dist.get_rank(), "backend": dist.get_backend()}
    for arch, layers, modes, backward in TP_CELLS:
        cfg = tp_config(arch, layers)
        params = api.init_params(cfg, SEED, device=dev)
        batch = api.make_batch(cfg, SEED, TP_BATCH, TP_SEQ, device=dev)
        with torch.no_grad(), captured_logits() as kept:
            out[arch] = {"loss": float(api.loss_fn(cfg, params, batch))}
            ref = kept[0]
            if out["rank"] == 0:
                bare = api.forward_logits(cfg, params._replace(blocks=[]),
                                          batch)
                out[arch]["blocks_rel_l2"] = logits_error(bare, ref)[0]
                del bare
        pl = placements(mesh, resolve(mesh, "dp", None), 2)
        dbatch = {k: distribute_tensor(v, mesh, pl, src_data_rank=None)
                  for k, v in batch.items()}
        for mode in modes:
            mcfg = cfg.replace(**TP_MODE_FIELDS[mode])
            dparams = distribute_params(mcfg, params, mesh)
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rec = {}
            with use_mesh(mesh), captured_logits() as kept:
                if mode in backward:
                    loss, grads = value_and_grad(mcfg, dparams, dbatch)
                    rec["grad_norm"] = float(global_norm(grads).full_tensor())
                    del grads
                else:
                    with torch.no_grad():
                        loss = api.loss_fn(mcfg, dparams, dbatch)
                rec["loss"] = float(loss.full_tensor())
                torch.cuda.synchronize()
                rec.update(ms=(time.perf_counter() - t0) * 1e3,
                           peak_gb=torch.cuda.max_memory_allocated() / 1e9)
                (rec["logits_rel_l2"], rec["logits_max_abs"],
                 rec["logits_p90_row_rel_l2"]) = logits_error(kept[0], ref)
            out[f"{arch} {mode}"] = rec
            del dparams, loss, kept
        del params, batch, dbatch, ref
        torch.cuda.empty_cache()
    return out


def tp_modes_phase(smi) -> None:
    """The tensor-parallel modes on 4 ranks spawned on the card (gloo) on a
    (2, 2) ("data", "model") mesh, a forward on TP_BATCH x TP_SEQ tokens
    a mode: stablelm-3b whole in megatron, ulysses and megatron_rs;
    mixtral-8x7b at full width cut to 2 of its 32 layers (its 32 at four
    copies, one a rank, would not fit the card) in megatron and ulysses +
    moe_ep.  Each mode's loss within TP_LOSS_ATOL of the model's one-rank
    loss, and its logits against the one-rank logits within TP_ROW_RTOL
    relative L2 at the rows' 90th percentile and within TP_LOGIT_RTOL
    whole; megatron and megatron_rs also take a backward pass, whose
    gradient norms agree within TP_GRAD_RTOL.  gloo runs every collective
    the modes need on CUDA tensors (all-gather through c10d's call,
    launch/mesh.py::route_functional_all_gather), so no mode is left
    out."""
    from repro_torch.launch.mesh import spawn_ranks

    t0 = time.perf_counter()
    ranks = spawn_ranks(tp_rank, 4, device="cuda", timeout_s=900)
    emit("tp_modes", mesh=[2, 2], backend=ranks[0]["backend"],
         batch=TP_BATCH, seq=TP_SEQ,
         one_rank={arch: ranks[0][arch] for arch, *_ in TP_CELLS},
         modes={k: v for k, v in ranks[0].items() if " " in k},
         peak_gb_by_rank={r["rank"]: max(v["peak_gb"] for k, v in r.items()
                                         if " " in k) for r in ranks},
         card=smi, phase_s=time.perf_counter() - t0)
    for arch, layers, modes, backward in TP_CELLS:
        whole_tol = TP_LOGIT_RTOL[tp_config(arch, layers).family]
        for mode in modes:
            got = [(r[f"{arch} {mode}"]["loss"], r[arch]["loss"])
                   for r in ranks]
            check(all(abs(x - want) <= TP_LOSS_ATOL for x, want in got),
                  f"tp_modes: {arch} {mode} losses against the one-rank "
                  f"ones: {got}")
            rec = ranks[0][f"{arch} {mode}"]
            rel, row = rec["logits_rel_l2"], rec["logits_p90_row_rel_l2"]
            check(rel <= whole_tol and row <= TP_ROW_RTOL,
                  f"tp_modes: {arch} {mode} logits against the one-rank "
                  f"logits: relative L2 {rel}, rows' 90th percentile {row}")
        if len(backward) == 2:
            a, b = (ranks[0][f"{arch} {m}"]["grad_norm"] for m in backward)
            check(abs(b - a) <= TP_GRAD_RTOL * abs(a),
                  f"tp_modes: {arch} grad norms {backward}: {a}, {b}")


def counters() -> dict:
    """Each kernel's wrapper module (its ``launches`` counters)."""
    from repro_torch.kernels.block_sweep import ops as bs_ops
    from repro_torch.kernels.column_norms import ops as cn_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.greedy_update import ops as gu_ops
    from repro_torch.kernels.greedy_update_lanes import ops as gl_ops
    from repro_torch.kernels.imgs_panel import ops as pp_ops
    from repro_torch.kernels.imgs_project import ops as ip_ops
    from repro_torch.kernels.llc_probe import ops as lp_ops
    from repro_torch.kernels.roq_apply import ops as ra_ops
    from repro_torch.kernels.sketch_omega import ops as so_ops
    from repro_torch.kernels.taylorf2 import ops as tf_ops

    return {"greedy_update": gu_ops, "greedy_update_lanes": gl_ops,
            "imgs_project": ip_ops, "block_sweep": bs_ops,
            "imgs_panel": pp_ops, "flash_attention": fa_ops,
            "roq_apply": ra_ops, "taylorf2_tile": tf_ops,
            "sketch_omega": so_ops, "column_norms": cn_ops,
            "llc_probe": lp_ops}


def reset_counts() -> None:
    mods = counters()
    for mod in mods.values():
        mod.launches = 0
    for name in ROUTED:
        mods[name].launches_sm90 = mods[name].launches_general = 0
    gl = mods["greedy_update_lanes"]
    gl.launches_lanes = gl.launches_per_lane = 0
    mods["flash_attention"].launches_noncausal = 0


def read_counts() -> dict:
    mods = counters()
    counts = {name: mod.launches for name, mod in mods.items()}
    for name in ROUTED:
        counts[name + "_sm90"] = mods[name].launches_sm90
        counts[name + "_general"] = mods[name].launches_general
    gl = mods["greedy_update_lanes"]
    counts["greedy_update_lanes_lanes"] = gl.launches_lanes
    counts["greedy_update_lanes_per_lane"] = gl.launches_per_lane
    counts["flash_attention_noncausal"] = \
        mods["flash_attention"].launches_noncausal
    return counts


def sum_counts(per_rank: list) -> dict:
    return {key: sum(c[key] for c in per_rank) for key in per_rank[0]}


# --------------------------------------------------------- distributed ----
DIST_RANKS = 4                    # ranks of the spawned group (b)-(d)
DIST_RESUME_RANKS = 2             # ranks that resume its checkpoint (d)
DIST_STOP_CHUNKS = 2              # chunks checkpointed before it stops
DIST_PROFILE_STEPS = 8            # steps of the split step profile


class _StopBuild(RuntimeError):
    """Raised by every rank's callback to end a build mid-way."""


def step_profile(S_loc, M_total, steps=DIST_PROFILE_STEPS) -> dict:
    """One distributed step taken apart, on a fresh state over this rank's
    shard: the local sweep (greedy_update) and GS (imgs_project passes)
    timed with CUDA events, the pivot exchange and the column fetch (the
    collectives) on the host's clock with the card synced around them,
    each after a barrier whose own time (``wait_ms``: the other ranks
    still sweeping, when they share the card) is kept apart.  Medians over
    ``steps`` steps, in ms."""
    import torch.distributed as dist

    from repro_torch.core import backend as B
    from repro_torch.core import distributed as D
    from repro_torch.core.greedy import imgs_orthogonalize

    lay = D._Layout(dist.get_world_size(), dist.get_rank(),
                    tuple(range(dist.get_world_size())),
                    M_total // dist.get_world_size())
    st = D.dist_greedy_init(S_loc, steps)
    times = {"wait_ms": [], "exchange_ms": [], "fetch_ms": [], "gs_ms": [],
             "sweep_ms": []}

    def host(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        D._barrier(S_loc.device)
        torch.cuda.synchronize()
        times["wait_ms"].append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    def card(fn):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn()
        b.record()
        b.synchronize()
        return out, a.elapsed_time(b)

    for step in range(steps):
        res = torch.clamp(st.norms_sq - st.acc, min=0.0)
        (_, j, j_loc, owner), t = host(lambda: D._exchange_pivot(res, lay))
        times["exchange_ms"].append(t)
        v, t = host(lambda: D._fetch_columns(S_loc, j_loc.view(1),
                                             owner.view(1)).squeeze(1))
        times["fetch_ms"].append(t)
        (q, _, _, _), t = card(lambda: imgs_orthogonalize(v, st.Q))
        times["gs_ms"].append(t)
        (c, acc, _, _), t = card(lambda: B.pivot_update(q, S_loc, st.acc,
                                                        st.norms_sq))
        times["sweep_ms"].append(t)
        st.Q[:, step] = q
        st.acc.copy_(acc)
    return {key: float(np.median(v)) for key, v in times.items()}


def time_checkpoints(times: list) -> None:
    """Time every checkpoint of the distributed driver in this process
    (the gather to the mesh's rank 0, its write, the barrier after), on
    the host's clock with the card synced around it: appends ``{"k",
    "ms"}`` to ``times`` per save."""
    from repro_torch.core import distributed as D

    save = D._save_dist_checkpoint

    def timed(directory, seq, state, *args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = save(directory, seq, state, *args, **kw)
        torch.cuda.synchronize()
        times.append({"k": int(state.k),
                      "ms": (time.perf_counter() - t0) * 1e3})
        return out

    D._save_dist_checkpoint = timed


def distributed_rank(f, m1, m2, part, ckpt_dir):
    """Rank program of the phase distributed (spawned, the ranks sharing
    the card over gloo): each rank generates only its own columns of the
    chirp grid with taylorf2_tile and builds through the front door.
    ``part`` "four": (b) the greedy build, its step profile, (c) the
    blocked build, (d) a build stopped after DIST_STOP_CHUNKS
    checkpointed chunks; "two": (d) its resume.  Launches are counted from
    0 just before each build, on each rank."""
    import torch.distributed as dist

    from repro_torch.api import build_basis, make_auto_mesh
    from repro_torch.data.providers import WaveformProvider

    dev = torch.device("cuda", torch.cuda.current_device())
    world, rank = dist.get_world_size(), dist.get_rank()
    prov = WaveformProvider(f, m1, m2, dtype=torch.complex64, device=dev)
    mesh = make_auto_mesh((world,), ("cols",), "cuda")
    common = dict(source=prov, tau=TAU, max_k=MAX_K, chunk=16, mesh=mesh,
                  device=dev)

    def build(**spec):
        reset_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        b = build_basis(**common, **spec)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        rec = {"k": b.k, "stop": b.provenance["stop"],
               "strategy": b.provenance["strategy"], "wall_s": wall,
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
               "pivots": np.asarray(b.pivots), "errs": np.asarray(b.errs),
               "launches": read_counts()}
        if rank == 0:
            rec["Q"] = b.Q.cpu().numpy()
        return rec

    out = {"rank": rank, "world": world, "backend": dist.get_backend(),
           "ckpt": []}
    time_checkpoints(out["ckpt"])
    if part == "two":
        out["resumed"] = build(checkpoint_dir=ckpt_dir, resume=True)
        return out
    out["greedy"] = build()
    lo, hi = rank * (M // world), (rank + 1) * (M // world)
    out["step"] = step_profile(prov.tile(lo, hi), M)
    torch.cuda.empty_cache()
    out["blocked"] = build(block_p=BLOCK_P)
    seen = []

    def stop_after(state):
        seen.append(int(state.k))
        if len(seen) > DIST_STOP_CHUNKS:
            raise _StopBuild

    try:
        build(checkpoint_dir=ckpt_dir, callback=stop_after)
    except _StopBuild:
        out["stopped_at_k"] = seen[DIST_STOP_CHUNKS - 1]
    return out


def distributed_phase(S, basis, f, m1, m2, dev, drive):
    """The column-distributed greedy on the GW cell's S: (a) one rank in
    this process over NCCL, greedy then blocked, through ``drive``; (b)
    four spawned ranks sharing the card over gloo, each generating its
    32,768 columns, bitwise (a); (c) their blocked build, its k and
    pivots (a)'s blocked ones; (d) a 4-rank build checkpointed after two
    chunks and resumed on 2 ranks, bitwise (b).  Returns the launches of
    the greedy and the blocked path, summed over the four ranks."""
    from repro_torch.compat import make_auto_mesh
    from repro_torch.launch.mesh import close_ranks, init_ranks, spawn_ranks
    from repro_torch.sums import column_norms_sq

    ref_sq = float(column_norms_sq(S).max())
    ranks = init_ranks(device="cuda")
    try:
        check(ranks.backend == "nccl" and ranks.world_size == 1,
              f"distributed: one rank took {ranks.backend}")
        mesh = make_auto_mesh((1,), ("cols",), "cuda")
        a, a_launches = drive("distributed_nccl", "greedy_update", True,
                              ("greedy_update", "imgs_project",
                               "column_norms"),
                              ("greedy_update", "imgs_project"), mesh=mesh)
        a_blk, a_blk_launches = drive(
            "distributed_blocked_nccl", "block_sweep", False,
            ("block_sweep", "imgs_panel", "imgs_project", "column_norms"),
            ("imgs_panel", "imgs_project"), mesh=mesh, block_p=BLOCK_P)
        a_step = step_profile(S, M)
    finally:
        close_ranks()
    check(a.provenance["strategy"] == a_blk.provenance["strategy"]
          == "distributed", "distributed: auto with a mesh did not pick it")
    # (a) against the greedy build: pivots on the shared prefix, errs
    # bitwise up to the first refresh (the first err^2 under the refresh
    # trigger, 100 eps ref^2, the drivers' default safety)
    shared = min(a.k, basis.k)
    eps = torch.finfo(torch.float32).eps
    trig = np.nonzero(basis.errs.astype(np.float64) ** 2
                      < 100.0 * eps * ref_sq)[0]
    first_refresh = int(trig[0]) + 1 if trig.size else basis.k
    check(np.array_equal(a.pivots[:shared], basis.pivots[:shared]),
          "distributed: (a)'s pivots are not the greedy build's")
    upto = min(shared, first_refresh)
    check(np.array_equal(a.errs[:upto], basis.errs[:upto]),
          "distributed: (a)'s errs are not the greedy build's before the "
          "first refresh")

    # spawn_ranks builds the kernels before the spawn: the ranks only load
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "ckpt")
        t0 = time.perf_counter()
        four = spawn_ranks(distributed_rank, DIST_RANKS,
                           (f, m1, m2, "four", ckpt), device="cuda",
                           timeout_s=420)
        four_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        two = spawn_ranks(distributed_rank, DIST_RESUME_RANKS,
                          (f, m1, m2, "two", ckpt), device="cuda",
                          timeout_s=300)
        two_s = time.perf_counter() - t0
    check(all(r["backend"] == "gloo" for r in four + two),
          "distributed: ranks sharing the card did not take gloo")
    b0 = four[0]["greedy"]
    for r in four:
        g = r["greedy"]
        check(g["strategy"] == "distributed" and g["k"] == a.k
              and g["stop"] == a.provenance["stop"]
              and np.array_equal(g["pivots"], a.pivots)
              and np.array_equal(g["errs"], a.errs),
              f"distributed: (b) rank {r['rank']} is not (a): k {g['k']} "
              f"vs {a.k}")
        for key in ("greedy", "blocked"):
            n = r[key]["launches"]
            check(n["greedy_update_sm90"] == n["greedy_update"]
                  and n["imgs_project_sm90"] == n["imgs_project"]
                  and n["imgs_panel_sm90"] == n["imgs_panel"],
                  f"distributed: (b) rank {r['rank']} left an sm90 route")
        c = r["blocked"]
        check(c["k"] == a_blk.k and np.array_equal(c["pivots"],
                                                   a_blk.pivots),
              f"distributed: (c) rank {r['rank']}'s blocked build is not "
              f"(a)'s: k {c['k']} vs {a_blk.k}")
        check(r["stopped_at_k"] == 16 * DIST_STOP_CHUNKS,
              f"distributed: (d) stopped at k {r['stopped_at_k']}")
    check(torch.equal(torch.from_numpy(b0["Q"]).to(dev), a.Q),
          "distributed: (b)'s Q is not (a)'s")
    for r in two:
        d = r["resumed"]
        check(d["k"] == b0["k"] and d["stop"] == b0["stop"]
              and np.array_equal(d["pivots"], b0["pivots"])
              and np.array_equal(d["errs"], b0["errs"]),
              f"distributed: (d) rank {r['rank']}'s resumed build is not "
              f"(b)'s")
    q_elastic = bool(np.array_equal(two[0]["resumed"]["Q"], b0["Q"]))
    dist_launches = sum_counts([r["greedy"]["launches"] for r in four])
    blk_launches = sum_counts([r["blocked"]["launches"] for r in four])
    for name, n in (("greedy", dist_launches), ("blocked", blk_launches)):
        check(n["column_norms"] > 0 and n["imgs_project"] > 0
              and (n["greedy_update"] > 0 if name == "greedy"
                   else n["block_sweep"] > 0 and n["imgs_panel"] > 0),
              f"distributed: a kernel of the {name} path was not launched "
              f"on the ranks: {n}")
    emit("distributed", cell="gw-distributed-h100-1chip", n=N, m=M,
         max_k=MAX_K, tau=TAU,
         a_nccl={"k": a.k, "stop": a.provenance["stop"],
                 "wall_s": a.provenance["wall_time_s"],
                 "greedy_k": basis.k, "shared_prefix": shared,
                 "first_refresh": first_refresh,
                 "errs_bitwise_to": upto,
                 "errs_bitwise_prefix": bool(np.array_equal(
                     a.errs[:shared], basis.errs[:shared])),
                 "step_ms": a_step, "launches": a_launches},
         b_gloo={"ranks": DIST_RANKS, "k": b0["k"], "stop": b0["stop"],
                 "bitwise_a": True,
                 "wall_s": [r["greedy"]["wall_s"] for r in four],
                 "step_ms": [r["step"] for r in four],
                 "peak_mem_gb": [r["greedy"]["peak_mem_gb"] for r in four],
                 "group_s": four_s},
         c_blocked={"block_p": BLOCK_P, "k_p1": a_blk.k,
                    "k_p4": four[0]["blocked"]["k"],
                    "stop_p4": four[0]["blocked"]["stop"],
                    "wall_s_p1": a_blk.provenance["wall_time_s"],
                    "wall_s_p4": [r["blocked"]["wall_s"] for r in four],
                    "pivots_equal": True},
         d_elastic={"stopped_at_k": four[0]["stopped_at_k"],
                    "resumed_on": DIST_RESUME_RANKS,
                    "k": two[0]["resumed"]["k"], "pivots_errs_equal": True,
                    "Q_bitwise": q_elastic, "group_s": two_s,
                    "ckpt_ms_p4": [r["ckpt"] for r in four],
                    "ckpt_ms_p2": [r["ckpt"] for r in two],
                    "peak_mem_gb_p2": [r["resumed"]["peak_mem_gb"]
                                       for r in two]},
         launches_by_rank=[r["greedy"]["launches"] for r in four],
         launches=dist_launches, blocked_launches=blk_launches)
    del a, a_blk
    torch.cuda.empty_cache()
    return dist_launches, blk_launches


# ---------------------------------------------------------------- main ----
def main() -> None:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(2)
    from repro_torch.api import ReducedBasis, build_basis
    from repro_torch.core.errors import per_column_errors
    from repro_torch.gw import build_snapshot_matrix, chirp_grid
    from repro_torch.gw import frequency_grid
    from repro_torch.gw.waveform import taylorf2_batch
    from repro_torch.kernels import _build
    from repro_torch.kernels.block_sweep import ops as bs_ops
    from repro_torch.kernels.column_norms import ops as cn_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.greedy_update import ops as gu_ops
    from repro_torch.kernels.greedy_update_lanes import ops as gl_ops
    from repro_torch.kernels.imgs_panel import ops as pp_ops
    from repro_torch.kernels.imgs_project import ops as ip_ops
    from repro_torch.kernels.llc_probe import ops as lp_ops
    from repro_torch.kernels.roq_apply import ops as ra_ops
    from repro_torch.kernels.sketch_omega import ops as so_ops
    from repro_torch.kernels.taylorf2 import ops as tf_ops

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    emit("env", torch=torch.__version__, cuda=torch.version.cuda,
         device=torch.cuda.get_device_name(0), nvidia_smi=smi)

    t0 = time.perf_counter()
    reports = _build.build_all()
    emit("build", seconds=time.perf_counter() - t0,
         ptxas=[ln.strip() for r in reports.values()
                for ln in r.splitlines() if "registers" in ln
                or "spill" in ln])

    # --- the roofline model's calibration, which "auto" plans against
    roof_launches = roofline_phase(dev, smi, reset_counts, read_counts)

    # --- snapshots: TaylorF2 over the chirp grid, generated on the card by
    # the taylorf2_tile kernel (the streamed cell's tiles have its bits)
    f = frequency_grid(F_MIN, F_MAX, N)
    m1, m2 = chirp_grid(n_mc=N_MC, n_eta=N_ETA)
    torch.cuda.synchronize()
    n0 = (tf_ops.launches, tf_ops.launches_sm90)
    t0 = time.perf_counter()
    S = build_snapshot_matrix(f, m1, m2, dtype=torch.complex64, device=dev)
    torch.cuda.synchronize()
    snap_s = time.perf_counter() - t0
    check(tf_ops.launches - n0[0] == tf_ops.launches_sm90 - n0[1] > 0,
          "snapshots: a taylorf2_tile launch left the sm90 route")
    norms = torch.linalg.vector_norm(S, dim=0)
    check(tuple(S.shape) == (N, M) and bool(torch.isfinite(norms).all()),
          "snapshots not finite / wrong shape")
    check(float((norms - 1).abs().max()) <= 1e-4, "snapshots not unit-norm")
    emit("snapshots", seconds=snap_s, shape=[N, M],
         dtype="complex64", gbytes=S.nbytes / 1e9,
         taylorf2_launches=tf_ops.launches - n0[0],
         taylorf2_launches_sm90=tf_ops.launches_sm90 - n0[1])

    timings = kernel_phase(S, dev)
    timings["greedy_update_lanes"] = greedy_update_lanes_phase(S, dev)
    timings.update(taylorf2_phase(dev))
    timings["sketch_omega"] = sketch_omega_phase(S, dev)
    timings["column_norms"] = column_norms_phase(S, dev)
    timings["llc_probe"] = llc_probe_phase(dev)

    cols = torch.randperm(M, generator=torch.Generator().manual_seed(SEED))[
        :8192].to(dev)
    walls = {}

    def drive(phase, sweeps_with, flagged, path_kernels, sm90_only,
              **spec):
        """One full-width build through the front door, its kernels'
        launches counted from 0 just before it; checks that every launch of
        the kernels in ``sm90_only`` took the sm90 route, orthogonality and
        the error on 8192 sampled columns; emits the phase line, with the
        sweeps (launches of ``sweeps_with``) that read S: with ``flagged``
        (the sweep takes the driver's active flag) those of the live
        steps."""
        reset_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        b = build_basis(source=S, tau=TAU, max_k=MAX_K, chunk=16, **spec)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        walls[phase] = wall
        launches = read_counts()
        k = b.k
        check(all(launches[n] > 0 for n in path_kernels),
              f"{phase}: a kernel of the path was not launched: {launches}")
        check(all(launches[n + "_sm90"] == launches[n]
                  and launches[n + "_general"] == 0 for n in sm90_only),
              f"{phase}: a launch of {sm90_only} left the sm90 route: "
              f"{launches}")
        check(5 <= k <= MAX_K and np.all(np.isfinite(b.errs)),
              f"{phase}: bad rank {k}")
        eps = torch.finfo(torch.float32).eps
        Q64 = b.Q.to(torch.complex128)
        defect = float(torch.linalg.matrix_norm(
            Q64.mH @ Q64 - torch.eye(k, dtype=Q64.dtype, device=dev),
            ord=2))
        defect_bound = 100 * 2.0 * eps * math.sqrt(k)
        check(defect <= defect_bound,
              f"{phase}: orthogonality {defect} > {defect_bound}")
        pce = float(per_column_errors(S.index_select(1, cols), b.Q).max())
        last = float(b.errs[-1])
        check(pce <= 1.5 * last,
              f"{phase}: per-column error {pce} > 1.5 * {last}")
        # the sweeps that read S: with ``flagged`` those of the steps up to
        # the latched stop (the later steps' flags are false), k plus the
        # latched step whose basis a rank or tau stop drops; else all
        read = launches[sweeps_with]
        if flagged:
            read = k + (b.provenance["stop"] in ("STOP_RANK", "STOP_TAU"))
        emit(phase, k=k, stop=b.provenance["stop"], tau=TAU,
             block_p=b.provenance["block_p"], wall_s=wall,
             s_per_basis=wall / k, sweeps_launched=launches[sweeps_with],
             sweeps_read_s=read,
             swept_gb_s=read * S.nbytes / wall / 1e9,
             launches=launches, orthogonality=defect,
             orthogonality_bound=defect_bound, max_sampled_col_err=pce,
             last_err=last, col_err_bound=1.5 * last,
             peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
             backend=b.provenance["backend"],
             device=b.provenance["device"])
        return b, launches

    # --- the greedy path: build_basis at full width
    basis, launches = drive("build_basis", "greedy_update", True,
                            ("greedy_update", "imgs_project",
                             "column_norms"),
                            ("greedy_update", "imgs_project"),
                            strategy="greedy")
    k = basis.k

    # --- artifact: save, load, bit-equal; EIM
    with tempfile.TemporaryDirectory() as tmp:
        basis.save(tmp)
        back = ReducedBasis.load(tmp)
    same = (torch.equal(back.Q, basis.Q)
            and np.array_equal(back.pivots, basis.pivots)
            and np.array_equal(back.errs, basis.errs)
            and np.array_equal(back.R, basis.R)
            and torch.equal(back.eim().nodes, basis.eim().nodes)
            and torch.equal(back.eim().B, basis.eim().B))
    check(same, "artifact save/load is not bit-equal")
    nodes = basis.eim().nodes
    check(len(set(nodes.tolist())) == k, "EIM nodes repeat")
    emit("artifact", bit_equal=same, k=k, eim_nodes=k,
         nodes_head=nodes[:8].tolist())

    # --- ROQ: 16 inner products <d, h> (the online stage's requests)
    rng = np.random.default_rng(SEED)
    fd = torch.as_tensor(f, device=dev)
    df = float(f[1] - f[0])
    w = torch.full((N,), df, dtype=torch.float64, device=dev)
    d = taylorf2_batch(fd, torch.tensor([9.0]), torch.tensor([7.0]),
                       dtype=torch.complex128)[:, 0]
    d = d + 0.05 / math.sqrt(N) * torch.complex(
        torch.as_tensor(rng.standard_normal(N), device=dev),
        torch.as_tensor(rng.standard_normal(N), device=dev))
    omega = basis.roq_weights(d.to(torch.complex64), w)
    mc = rng.uniform(5.5, 14.5, 16)
    eta = rng.uniform(0.11, 0.24, 16)
    mt = mc / eta ** 0.6
    disc = np.sqrt(1 - 4 * eta)
    h = taylorf2_batch(fd, torch.as_tensor(0.5 * mt * (1 + disc)),
                       torch.as_tensor(0.5 * mt * (1 - disc)),
                       dtype=torch.complex64)
    full = (w * d.conj()) @ h.to(torch.complex128)
    roq = (omega @ h[nodes]).to(torch.complex128)
    wd = float(torch.linalg.vector_norm(w * d))
    interp = basis.eim().B @ h[nodes]
    i_err = torch.linalg.vector_norm((h - interp).to(torch.complex128),
                                     dim=0)
    err = (roq - full).abs()
    # Cauchy-Schwarz: |<d, h - I h>| <= |w d| |h - I h|; slack for the
    # complex64 rounding of the k-term ROQ sum and of the interpolant
    cs_bound = 1.01 * wd * i_err + 1e-4 * wd
    check(bool((err <= cs_bound).all()), "ROQ error above Cauchy-Schwarz")
    rel = (err / wd).cpu().numpy()  # normalized by |w d| |h|, |h| = 1
    check(bool(np.all(np.isfinite(rel))) and float(np.max(rel)) <= 1e-2,
          f"ROQ relative error {float(np.max(rel))} > 1e-2")
    emit("roq", requests=16, median_rel_err=float(np.median(rel)),
         max_rel_err=float(np.max(rel)), rel_err_bound=1e-2,
         max_interp_err=float(i_err.max()), k=k)

    # --- the paper's oracles, then the served ROQ stage over two artifacts
    del back, omega, interp
    cut_basis, paper_launches = paper_phase(
        S, f, m1, m2, dev, cols, walls["build_basis"], smi, reset_counts,
        read_counts)
    cut_sg_launches = randomized_cut_phase(f, m1, m2, dev, smi,
                                           reset_counts, read_counts)
    roq_launches, roq_timings = roq_serve_phase(
        basis, cut_basis, dev, smi, reset_counts, read_counts)
    timings.update(roq_timings)

    # --- the blocked path: the bases freed first (the greedy basis kept on
    # the host side, for the streamed builds' parity)
    basis = ReducedBasis(Q=basis.Q, pivots=basis.pivots, errs=basis.errs,
                         k=basis.k, R=basis.R,
                         provenance={"stop": basis.provenance["stop"]})
    del cut_basis
    torch.cuda.empty_cache()
    blk, blk_launches = drive("block_build", "block_sweep", False,
                              ("block_sweep", "imgs_panel", "imgs_project",
                               "column_norms"),
                              ("imgs_panel", "imgs_project"),
                              strategy="block_greedy", block_p=BLOCK_P)
    # pivot staleness costs at most ~15% more bases (the reference's
    # bound, tests/test_block_greedy.py) plus one block of headroom
    check(5 <= blk.k <= int(1.15 * k) + BLOCK_P,
          f"block_build: k {blk.k} outside [5, 1.15 * {k} + {BLOCK_P}]")
    check(blk.provenance["block_p"] == BLOCK_P,
          f"block_build: provenance block_p {blk.provenance['block_p']}")
    del blk

    # --- "auto" on the resident S: the default call, the estimated rank,
    # a forced budget
    auto_launches = auto_phase(S, dev, cols, smi, reset_counts, read_counts)

    # --- the lockstep many-basis build on the resident S: a tau sweep
    # (shared), then a band split (stacked), each beside its scalar builds
    _, shared_launches, shared = batched_phase(
        "batched_shared", S, [S] * BATCH, sweep_taus(basis.errs, BATCH),
        dev, cols, smi, reset_counts, read_counts)
    ks = [r["k"] for r in shared["lanes"]]
    check(len(set(ks)) == BATCH
          and all(r["stop"] == "STOP_TAU" for r in shared["lanes"]),
          f"batched_shared: the sweep's lanes are not {BATCH} distinct "
          f"bases stopped on tau: {shared['lanes']}")
    torch.cuda.empty_cache()
    stacked_launches = batched_stacked_phase(S, dev, cols, smi, reset_counts,
                                             read_counts)

    # --- the column-distributed greedy on the resident S: one NCCL rank
    # here, then ranks spawned on the same card over gloo
    dist_launches, dist_blk_launches = distributed_phase(
        S, basis, f, m1, m2, dev, drive)

    # --- the streamed driver: parity at this M, then the paper's M with S
    # freed (its 262 GB are never formed: tiles are generated on the card)
    streamed_phase(S, basis, f, m1, m2, dev)
    del S, cols, basis
    torch.cuda.empty_cache()
    paper_launches_by_p, stream_err = paper_streamed(
        dev, f, smi, reset_counts, read_counts,
        timings["taylorf2_tile"]["ms"])
    stream_launches = paper_launches_by_p[1]
    stream_blk_launches = paper_launches_by_p[BLOCK_P]

    # --- the randomized range-finder: crash and resume at the resident M,
    # then the paper's M (power 0, power 1, sketch+greedy)
    randomized_resume_phase(f, m1, m2, dev)
    rand_launches, sg_launches, auto_paper_launches = randomized_paper(
        dev, f, smi, reset_counts, read_counts, stream_err)

    # --- the dense-LM serving path, with the GW S freed
    timings.update(lm_kernel_phase(dev))
    serve_launches = serve_phase(dev, reset_counts, read_counts)

    # --- the other dense cells (stablelm-3b, starcoder2-15b whole), then
    # the launcher's LM mode, then the other families (moe, hybrid, ssm,
    # vlm, encdec) at full width, each model freed before the next
    from repro_torch.configs import get_config
    family_launches = {
        phase: family_serve_phase(
            phase, get_config(arch).replace(attn_impl="flash"), batch,
            prompt, gen, dev, smi, reset_counts, read_counts,
            f32_layers=f32_layers, int8=int8)
        for phase, arch, batch, prompt, gen, f32_layers, int8
        in DENSE_CELLS[1:]}
    launcher_phase(dev)
    family_launches.update({
        phase: family_serve_phase(
            phase, get_config(arch).replace(attn_impl="flash", **over),
            batch, prompt, gen, dev, smi, reset_counts, read_counts)
        for phase, arch, over, batch, prompt, gen in FAMILY_CELLS})

    # --- the trainer: stablelm-3b whole on the card, the launcher's crash
    # and resume, the card against the CPU
    train_launches, grounding = train_phase()

    # --- the dry run: the sharded LM path and the GW step traced in fake
    # worlds of 256 / 512 ranks, and in a world of one (no kernel runs)
    dryrun_phase(grounding)

    # --- the GPipe pipeline (stablelm-3b in 2 stages) and the
    # tensor-parallel modes, each on ranks spawned on the card
    pipe_launches = pipeline_phase(dev, smi)
    tp_modes_phase(smi)

    # one entry per kernel; a wrapper that routes between two kernels has
    # an entry for each, which counts its own route's launches
    kernels = []
    for name, src, replaces, path, key in (
            ("greedy_update",
             "src/repro_torch/csrc/greedy_update_lanes_sm90.cu",
             "src/repro/kernels/greedy_update/kernel.py:108,147", launches,
             "greedy_update_sm90"),
            ("greedy_update_general", "src/repro_torch/csrc/greedy_update.cu",
             "src/repro/kernels/greedy_update/kernel.py:108,147", launches,
             "greedy_update_general"),
            ("greedy_update_lanes",
             "src/repro_torch/csrc/greedy_update_lanes_sm90.cu",
             "src/repro/core/backend.py:408-448 batched_pivot_update "
             "(pallas route: greedy_update_complex per lane)",
             shared_launches, "greedy_update_lanes_lanes"),
            ("imgs_project", "src/repro_torch/csrc/imgs_project_sm90.cu",
             "src/repro/kernels/imgs_project/kernel.py:67", launches,
             "imgs_project_sm90"),
            ("imgs_project_general", "src/repro_torch/csrc/imgs_project.cu",
             "src/repro/kernels/imgs_project/kernel.py:67", launches,
             "imgs_project_general"),
            ("block_sweep", "src/repro_torch/csrc/block_sweep.cu",
             "src/repro/kernels/block_sweep/kernel.py:86,119", blk_launches,
             "block_sweep"),
            ("imgs_panel", "src/repro_torch/csrc/imgs_panel_sm90.cu",
             "src/repro/kernels/imgs_panel/kernel.py:76", blk_launches,
             "imgs_panel_sm90"),
            ("imgs_panel_general", "src/repro_torch/csrc/imgs_panel.cu",
             "src/repro/kernels/imgs_panel/kernel.py:76", blk_launches,
             "imgs_panel_general"),
            ("flash_attention", "src/repro_torch/csrc/flash_attention_sm90.cu",
             "src/repro/kernels/flash_attention/kernel.py:96",
             serve_launches, "flash_attention_sm90"),
            ("flash_attention_general",
             "src/repro_torch/csrc/flash_attention.cu",
             "src/repro/kernels/flash_attention/kernel.py:96",
             serve_launches, "flash_attention_general"),
            ("roq_apply", "src/repro_torch/csrc/roq_apply_sm90.cu",
             "src/repro/serving/roq.py:115-122 (XLA GEMMs, not a Pallas "
             "kernel)", roq_launches, "roq_apply_sm90"),
            ("roq_apply_general", "src/repro_torch/csrc/roq_apply.cu",
             "src/repro/serving/roq.py:115-122 (XLA GEMMs, not a Pallas "
             "kernel)", roq_launches, "roq_apply_general"),
            ("taylorf2_tile", "src/repro_torch/csrc/taylorf2_sm90.cu",
             "src/repro/data/providers.py:193-199 (jax.jit of "
             "taylorf2_batch, not a Pallas kernel)", stream_launches,
             "taylorf2_tile_sm90"),
            ("taylorf2_tile_general", "src/repro_torch/csrc/taylorf2.cu",
             "src/repro/data/providers.py:193-199 (jax.jit of "
             "taylorf2_batch, not a Pallas kernel)", stream_launches,
             "taylorf2_tile_general"),
            ("sketch_omega", "src/repro_torch/csrc/sketch_omega.cu",
             "src/repro/core/randomized.py:99-123 (jax.random threefry "
             "draws, not a Pallas kernel)", rand_launches, "sketch_omega"),
            ("column_norms", "src/repro_torch/csrc/column_norms.cu",
             "src/repro/core/greedy.py:302 (XLA's jnp.sum(jnp.abs(S)**2, "
             "0), not a Pallas kernel)", auto_paper_launches,
             "column_norms"),
            ("llc_probe", "src/repro_torch/csrc/llc_probe.cu",
             "src/repro/api/roofline.py:165-183 (a jitted fori_loop of "
             "vdots, not a Pallas kernel)", roof_launches, "llc_probe")):
        t = timings[name]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": path[key],
                        "counter": key,
                        "launches_by_path": {
                            "greedy": launches[key],
                            "paper": paper_launches[key],
                            "roq_serve": roq_launches[key],
                            "block_greedy": blk_launches[key],
                            "streamed": stream_launches[key],
                            "streamed_blocked": stream_blk_launches[key],
                            "randomized": rand_launches[key],
                            "sketch_greedy": sg_launches[key],
                            "sketch_greedy_cut": cut_sg_launches[key],
                            "serve": serve_launches[key],
                            **{phase: n[key]
                               for phase, n in family_launches.items()},
                            "roofline": roof_launches[key],
                            "auto_resident": auto_launches[key],
                            "auto_paper": auto_paper_launches[key],
                            "batched_shared": shared_launches[key],
                            "batched_stacked": stacked_launches[key],
                            "distributed": dist_launches[key],
                            "distributed_blocked": dist_blk_launches[key],
                            "train": train_launches[key],
                            "pipeline": pipe_launches[key]},
                        "max_abs_err": t["max_abs_err"], "ms": t["ms"],
                        "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                        "bound_by": t["bound_by"],
                        "library_ms": t["library_ms"],
                        **{x: t[x] for x in ("by_batch", "stacked",
                                             "noncausal", "d80",
                                             "d80_pipeline", "d96")
                                   if x in t}})
        if name == "flash_attention":
            # the encoder's bidirectional launches (either route)
            kernels[-1]["noncausal_launches_by_path"] = {
                phase: n["flash_attention_noncausal"]
                for phase, n in family_launches.items()}
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--train"]:
        train_main(sys.argv[2])
    else:
        main()
