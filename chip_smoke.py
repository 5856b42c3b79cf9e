#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

  python3 chip_smoke.py

These main paths are driven: the campaign prescreen of the builtin
lm_full_pod campaign (qwen3-32b, 72 cells x 192 parameter vectors);
serving, each at full width and full depth, the dense decoder qwen2-1.5b,
the hybrid hymba-1.5b (attention and Mamba heads, sliding window with
meta-token sinks), the MoE qwen3-moe-30b-a3b (128 experts, top 8, in
bf16) and the xLSTM xlstm-125m (mLSTM and sLSTM cells); the VLM
llama-3.2-vision-90b at full width and 4 of its 20 groups (gated
cross-attention over 1024 image tokens, nested groups); the audio encoder
hubert-xlarge at full width and depth (non-causal, head dim 80); training
qwen2-1.5b, hymba-1.5b, hubert-xlarge and xlstm-125m, each at full width
and depth, qwen3-moe-30b-a3b at full width and 4 of its 48 layers, and the
VLM's train step at its reduced() width. Phases, each of which fails the
run (non-zero exit, no result line):

  1. card   — name and power limit from nvidia-smi;
  2. build  — one nvcc per CUDA source, all started together, and one link
     build the kernels from src/;
  2b. prescreen — prescreen_cell on the card over all 72 cells of
     lm_full_pod with one part memo: the list-schedule kernel must launch
     once per part screen (memo miss), and every launch's makespans and
     busy times must equal its plain version's on the card bit for bit;
     the same for one launch at N 6,122 (hlo/qwen2_1_5b_prefill_tp2).
     Wall time, kernel time (CUDA events) and plain time are printed. At
     the largest part (N 42, K 192) and at N 6,122, K 2, every variant of
     the kernel's plan (shared, global), forced, must equal
     the plain version bit for bit and is timed. Registers, spill and
     shared memory of each variant, ns per dependent step and the chain
     bound (N x an assumed latency of one step at the top SM clock) are
     printed in the log; the kernels line carries only measured numbers
     and bound_ms.
     Then the seven frozen campaign slices (tests/golden/) run through
     run_campaign(backend="inline") on the card, and their frozen records
     must equal the fixtures; one of them also through the pool (2 forked
     workers) and the spool (one spawned worker), byte-identical to inline;
  3. kernels — each kernel against its plain PyTorch version in f32 and
     bf16 at the main-path shapes of both models and at edge shapes; at
     the main-path shapes the kernel, the plain version and one library
     call (where one exists) are timed with CUDA events (median of 25, L2
     flushed before each launch). rmsnorm: at the main shapes the variant
     its plan chose, its registers and shared memory, the share of its
     bound, its ratios to F.rms_norm and to a device copy of x (the same
     bytes, no arithmetic); the two many-rows variants, forced, timed
     against each other at 4096 rows on either side of the plan's
     row-width limit; and the host us per call of the wrapper and of
     F.rms_norm at [4, 1536] bf16 (1000 calls back to back, wall clock,
     one synchronize). Flash: bf16 at hd 64/80/128 must run the
     tensor-core kernel, everything else the CUDA-core (SIMT) one (the
     VLM's self and cross shapes at 64 over 8 heads, Sq 1 among them);
     bf16 at hd 80 (HuBERT's, 32-byte swizzle) is held to the plain
     version at 2e-2 and at 2e-2 of max |want| (at HuBERT's shape beside
     two wrong kernels, a wrong scale and a dropped key tile, that must
     fail it), and to its tile twin flash_mha_tiled at 1e-2; at the
     main shapes the instance, its registers, spill and shared memory, the
     share of its bound and its ratio to SDPA are printed (the CUDA-core
     instance's blocks an SM from the card's occupancy calculator); in f32
     beside the previous (scalar) design's time; bf16 at hd 80 beside the
     CUDA-core bf16 instance (the earlier design), timed in this run; the
     fused selective scan (hymba's Mamba heads in prefill) at the serve
     cell's per-layer shape [8, 3146, 3200, 16] and ragged ones, z in f32
     and bf16, y and the last state against the plain version (1e-4 in f32,
     2e-2 in bf16; decay rates 1% off must fail the f32 check), timed beside
     its bound (bytes or the SFU's exponentials), the chain it replaces
     (expand, ssm_scan, readout) and the plain version, with its registers,
     spill and shared memory;
  3b. row offset — the query row offset (q_off) of the four flash kernels
     at full width: qwen2's causal heads in f32 (CUDA cores) and bf16
     (tensor cores), hymba's window and 128 sinks in f32 and bf16, HuBERT's
     non-causal hd 80 in bf16, each call's rows cut into 4 shards, each
     shard run against the whole K and V with its first row as q_off. The
     serve and autograd instances' outputs and dQ must equal the unsplit
     call's rows bit for bit where the shards' edges are multiples of the
     kernel's query tile, else hold to phase 3's and phase 7's tolerances;
     dK and dV summed over the shards must hold to phase 7's. q_off = 0 on
     every shard must fail a causal case's check and change no bit of the
     non-causal one. The unsplit serve call and its shards are timed;
  4. model  — each model in f32: prefill + 2 decode steps match forward
     logits (hymba's 1100-token prompt wraps its window ring; qwen3-moe at
     full width and 4 of its 48 layers; the VLM at 1 of its 20 groups, its
     gates opened, and images + 1.0 must move its output by more than
     1e-3); hubert-xlarge, which has no decode step, at full depth, B 2, T
     1500: its forward with the kernels against the forward with the plain
     versions (2e-3 of max |h|), and a late frame must move the first
     outputs;
  5. serve  — each decoder in bf16 through ServeEngine: 8 requests, one
     straggler evicted and re-queued (xlstm-125m: each batch's padded S
     and its mLSTM chunk length); the VLM through Model.prefill of 4 text
     prompts with 1024 image tokens each, then 16 decode steps (neither
     package gives it an engine path); hubert-xlarge as 8 encodes of B 4 x
     T 1500 frames. Every kernel's launch count, zeroed just before the run
     and read just after, must equal what the path implies
     (``path_counts``), and every bf16 flash launch (hd 64/80/128) must be
     the tensor-core kernel's, HuBERT's 384 among them (hymba: the fused
     selective scan once a layer a prefill, ssm_scan never); the
     peak memory must stay under 80 GB (qwen3-moe's weights are 61 GB);
  6. profile — wall vs device busy time of one prefill and of decode
     steps of each decoder (the VLM with its image tokens), and of one
     encode of hubert-xlarge, with the top kernels and flash attention's
     share of the device time (torch.profiler);
  7. train  — the backward kernels (rmsnorm: dx, dw; flash attention: dQ,
     dK, dV; bf16 at hd 64/80/128 on the tensor cores, with each launch's
     waves; HuBERT's hd 80 also against its tile twin, with its own L and
     with the kernel's, held to 1e-2, the same logged at hd 64/128; HuBERT's and
     the VLM's self and cross heads among the shapes) at the train shapes
     through the wrappers' autograd, against the plain versions' autograd
     on the card (bf16 flash against the plain backward in f32 of the same
     inputs, each gradient within a share of its max, beside the readings
     of two wrong kernels), and a second backward on the same inputs that
     must give the same bits; each timed alone (median of 25, L2 flushed)
     beside its bound, the previous design's time, the plain version's backward and the
     library call's backward (F.rms_norm, SDPA), with its plan or its
     kernels' registers, spill and shared memory; the flash forward under
     autograd (the instance that stores L) timed alone beside the serve
     instance, whose output it must equal bit for bit; launch/train.py::train for
     qwen2-1.5b, f32, B 4, S 1024, remat "full", 4 steps, with every
     kernel's count (forward and backward) zeroed just before and checked
     exactly just after, ms per step and peak memory, and one profiled
     step; 3 bf16 steps with the same exact counts, whose flash forwards
     and backwards must all be tensor-core launches, and one profiled bf16
     step; one step at full width and 4 layers with the kernels, then
     with the plain versions patched in, from the same state: loss, grad
     norm, each leaf's gradient (its first AdamW moment) and new parameters
     must agree, and a step with a wrong dK must fail the gradient check;
     the same with 2 microbatches and EF int8 compression (the gradient
     read as the moment plus the residual; besides, the int8 codes that the
     moments hold: each within one code of the plain step's, the share that
     differ under a cap, and the wrong backward must fail that);
     the ssm_scan backward kernel at hymba's train shape [4, 1152, 51200]
     and ragged ones, f32 and bf16, against the plain reverse scan and a
     second call's bits, timed beside its bound, the plain reverse scan and
     autograd through the plain forward;
  7b. hybrid train — launch/train.py::train for hymba-1.5b, f32, B 4, S
     1024 (+128 meta tokens), remat "full", 4 steps, exact counts of every
     kernel (the scan forward, with remat's recompute, and backward among
     them; the fused selective scan never), ms per step, peak memory, one profiled step; then the step at
     full width and 4 layers, kernels vs plain, whose check a plain
     backward with da x 1.1 in the scan must fail;
  7c. audio train — launch/train.py::train for hubert-xlarge at full width
     and depth, B 4 x T 1500, remat "full": 4 f32 steps and 3 bf16 steps
     with exact counts (bf16: every flash forward and backward on the tensor
     cores, 48 backwards a step), one profiled step of each; the step at 4
     layers kernels vs plain, whose check dK x 1.1 must fail;
  7d. xLSTM train — xlstm-125m at full width and depth, f32, B 4, S 1024,
     4 steps with exact rmsnorm counts, one profiled step; kernels vs plain
     at full depth and S 8, 16, 32 and 64, held to limits stated from
     step_rounding.py's ulp controls (at S 1024 rounding alone moves the
     gradient as far as a wrong backward), which rmsnorm's dx x 1.1 must
     fail;
  7e. MoE train — qwen3-moe-30b-a3b at full width and 4 of 48 layers, f32,
     B 4, S 1024, 3 steps with exact counts; kernels vs plain at 2 layers
     and B 1 (dK x 1.1 must fail);
  7f. VLM train — llama-3.2-vision-90b's step at its reduced() width
     (gates opened), kernels vs plain (dK x 1.1 must fail): one group at
     full width holds ~102 GB of f32 train state, more than one card;
  8. cli    — python -m repro_torch.sweep run on a golden slice's spec on the
     card (a subprocess): its frozen records must equal the fixture.
  9. program — launch/programs.py on a one-rank mesh (NCCL over a HashStore,
     a 1x1 DeviceMesh ("data", "model"), destroyed after each part): 9a,
     after qwen3-moe's profile and on its bf16 weights, the program's prefill
     (B 4, prompt 1024, smax 2048) and 32 decode steps at full depth, every
     MoE FFN through moe_ep, with the share of (token, expert) pairs dropped
     at capacity factor 1.25, ms, peak memory and exact launch counts (every
     flash on the tensor cores) beside the dense oracle at the same shapes,
     and one full-width MoE layer, moe_ep at capacity factor E/k against
     moe_dense (relative 2-norm 2e-2); 9c, the 4-layer f32 model of phase 4
     at capacity factor E/k: the program's prefill logits against the dense
     path (2e-3); 9b, qwen2-1.5b's f32 train step (B 4, S 1024, full depth)
     through build_program, then through the plain make_train_step from the
     same seed, one state at a time: loss, grad norm and new state bit for
     bit (else each moment leaf at STEP_GRAD_TOL, the leaves that differ
     named), phase 7's exact counts, ms per step and peak memory both ways;
     9d, one dry-run cell (python -m repro_torch.launch.dryrun, fake process
     group and fake tensors on the host; run beside phase 7's kernel
     timings, which are CUDA events behind a device-side sleep): per-device
     memory, FLOPs, time.
  10. examples — examples/torch_quickstart.py, torch_serve_lm.py and
     torch_train_lm.py on the card as subprocesses, each with exit 0; the
     train example runs 24 steps, then again to 32, which must resume from
     step 24's checkpoint and data cursor; wall time of each and the train
     losses.
  11. capture — the port's programs as simulator workloads
     (graph/capture.py): qwen2-1.5b's 1x1 prefill (B 1, S 128) and decode
     (B 4, cache 256) programs on the one-rank mesh at full width and depth
     in bf16 (random weights, seed 0) run once each under the recorder, the
     rmsnorm and flash kernels launching (exact counts, every flash on the
     tensor cores); each capture's structural hash and SHA-256 must equal
     the checked-in fixture's (configs/torch_graphs/) and those of a fake-CPU
     capture made in the same run (tools/gen_torch_fixtures.py in a
     subprocess, which also captures the 1x2 program under the fake process
     group); seconds, tasks, product FLOPs and HBM bytes of each; the three
     torch/ workloads, the hlo/ captures and the lm/ twins through the
     simulator's analytic prescreen (the crosscheck spec), each torch/
     fixture inside its manifest band.

The line before the last is a JSON object {"kernels": [...]} (list_schedule,
which replaces the prescreen's XLA program and no Pallas kernel; hymba's
fused selective scan, which replaces the chain around the ssm_scan kernel
in mamba_mix, with the chain's time beside its own; the train paths' rows: dense and HuBERT in f32 and bf16, the hybrid and xLSTM
in f32, the backward kernels among them); the
last line is {"ok": true, "device": {...}}. Needs one CUDA card of compute capability
>= 9.0 and nvcc; exits 1 without them.
"""
from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

HBM_BYTES_PER_S = 3.35e12                 # H100 SXM data sheet
F32_FLOPS = 67e12                          # f32 outside the tensor cores
BF16_FLOPS = 989e12                        # bf16 tensor cores, dense
SFU_EXP_PER_S = 16 * 132 * 1.98e9          # ex2 on the SFUs: 16 a clock an SM
TOL = {("rmsnorm", "float32"): 1e-5, ("rmsnorm", "bfloat16"): 2e-2,
       ("flash", "float32"): 1e-4, ("flash", "bfloat16"): 3e-2,
       ("ssm_scan", "float32"): 1e-4, ("ssm_scan", "bfloat16"): 2e-2}
# backward kernels vs the plain versions' autograd on the card: f32 differs in
# sum order; bf16 rmsnorm by one rounding of each gradient
BWD_TOL = {("rmsnorm", "float32"): 1e-4, ("rmsnorm", "bfloat16"): 3e-2,
           ("flash", "float32"): 1e-4}
# bf16 flash backward: max |got - want| <= BWD_FLASH_BF16 * max |want| for each
# of dQ, dK, dV, with want the plain backward in f32 of the same bf16 inputs.
# A sound kernel differs by the rounding of each gradient to bf16 and of the
# saved output that D = rowsum(dO * O) reads (the tensor-core forward rounds
# P); a dQ 10% off or a dS without D reads far above it (both are shown)
BWD_FLASH_BF16 = 2e-2
# the 4-layer train step, kernels vs plain: each leaf's first AdamW moment
# (0.1 x its clipped gradient) within this share of the leaf's max; the
# step's peak learning rate
STEP_GRAD_TOL = 1e-4
# the same step under EF int8 compression: the share of the codes the
# moments hold that may differ from the plain step's (each by one at most),
# and how far a recovered code may sit from an integer (and |e'| beyond
# half a code step, as a share of it)
EF_FLIP_SHARE = 1e-3
EF_CODE_OFF = 1e-2
STEP_LR = 3e-4
DENSE, HYBRID, MOE, CAMPAIGN = "qwen2-1.5b", "hymba-1.5b", "qwen3-moe-30b-a3b", "lm_full_pod"
XLSTM, VLM, AUDIO = "xlstm-125m", "llama-3.2-vision-90b", "hubert-xlarge"
TRAIN = dict(arch=DENSE, steps=4, batch=4, seq=1024, bf16_steps=3, check_layers=4)
# hybrid training: full width and depth, f32; the kernels-vs-plain step keeps
# 4 layers, a global-attention layer at each end and two windowed ones
HYBRID_TRAIN = dict(arch=HYBRID, steps=4, batch=4, seq=1024,
                    check=dict(n_layers=4, global_attn_layers=(0, 3)))
# HuBERT training: full width and depth, B 4 x T 1500 (phase 5's encode
# shape), f32 then bf16; the kernels-vs-plain step at 4 layers
AUDIO_TRAIN = dict(steps=4, bf16_steps=3, batch=4, seq=1500, check=dict(n_layers=4))
# xLSTM training: full width and depth, f32. Its f32 gradient is
# ill-conditioned at full width: on the H100, step_rounding.py's controls
# (the plain step with rmsnorm's output and input gradient moved by one ulp,
# 8 seeds) move a leaf's first moment by up to 1.264e-3 of its max and the
# grad norm by up to 1.68e-4 at S 8-64, 3.5e-2 at S 256 and 1.25 at S 1024,
# where they pass a wrong backward (0.76). So kernels vs plain runs at full
# depth and each S of 8-64, held to twice those largest readings (PERF.md §6)
XLSTM_TRAIN = dict(steps=4, batch=4, seq=1024, check_seqs=(8, 16, 32, 64),
                   grad_tol=2.5e-3, norm_tol=3.5e-4)
# qwen3-moe training: full width, 4 of 48 layers (~50 GB of f32 train state)
# at B 4 x S 1024: the dense oracle's intermediates grow with the tokens, but
# a step's peak, 58.1 GiB at B 2, 3 and 4 alike on the H100, comes after
# them; kernels vs plain at 2 layers and B 1, the plain step's state beside
# the kernel step's (~60 GB)
MOE_TRAIN = dict(steps=3, batch=4, seq=1024, layers=4,
                 check=dict(n_layers=2), check_batch=1)
# the ssm_scan backward's main shape: hymba's train step, [B, S + meta, di * n]
SCAN_MAIN = (4, 1152, 51200)
# the fused selective scan's main shape: hymba's prefill in the serve cell,
# B 8, S 3,018 + 128 meta, di 3,200, n 16
SEL_MAIN = (8, 3146, 3200, 16)
REPLACES = {"rmsnorm": "src/repro/kernels/rmsnorm/kernel.py:36",
            "flash_attention": "src/repro/kernels/flash_attention/kernel.py:99",
            "ssm_scan": "src/repro/kernels/ssm_scan/kernel.py:53",
            # no pl.pallas_call: the chain around the ssm_scan kernel in mamba_mix
            "selective_scan": "src/repro/models/mamba.py:74",
            # no pl.pallas_call: the XLA program of the vmapped list schedule
            "list_schedule": "src/repro/core/vectorized.py:239"}
# the backward kernels (no pl.pallas_call: each replaces jax.grad of the jnp
# function the Pallas kernel's forward computes)
REPLACES["rmsnorm_bwd"] = "src/repro/kernels/rmsnorm/kernel.py:36"
REPLACES["flash_attention_bwd"] = "src/repro/kernels/flash_attention/kernel.py:99"
REPLACES["ssm_scan_bwd"] = "src/repro/kernels/ssm_scan/kernel.py:53"
# the route and source of each kernel on the main paths (bf16 flash at hd 64,
# 80 and 128 runs the tensor-core kernel). The kernels line allows only the
# routes "cuda" and "triton"; the source names which flash kernel it was.
ROUTES = {"rmsnorm": ("cuda", "src/repro_torch/kernels/csrc/rmsnorm.cu"),
          "flash_attention": ("cuda",
                              "src/repro_torch/kernels/csrc/flash_attention_wgmma.cu"),
          "ssm_scan": ("cuda", "src/repro_torch/kernels/csrc/ssm_scan.cu"),
          "selective_scan": ("cuda", "src/repro_torch/kernels/csrc/selective_scan.cu"),
          "list_schedule": ("cuda", "src/repro_torch/kernels/csrc/list_schedule.cu"),
          "rmsnorm_bwd": ("cuda", "src/repro_torch/kernels/csrc/rmsnorm_bwd.cu"),
          "flash_attention_bwd": ("cuda",
                                  "src/repro_torch/kernels/csrc/flash_attention_bwd.cu"),
          "ssm_scan_bwd": ("cuda", "src/repro_torch/kernels/csrc/ssm_scan.cu")}
# f32 flash attention (the train path's dtype) runs the CUDA-core kernel:
# register-tiled f32 products (SIMT)
SIMT_FLASH = "src/repro_torch/kernels/csrc/flash_attention.cu"
SIMT_DESIGN = "simt register tiles (64 x 64 tiles, 16 x 16 threads, 4 x 4 a thread)"
# per model: phase-4 batch, prompt, cache (and depth, where cut); phase-5
# prompt range, new tokens and cache
PATHS = {
    DENSE: dict(model_B=2, model_S=256, model_smax=512, lo=512, hi=1024, max_new=32,
                deadline=8, smax=2048, profile_S=1024),
    HYBRID: dict(model_B=2, model_S=1100, model_smax=1200, lo=512, hi=2048, max_new=32,
                 deadline=8, smax=4096, profile_S=1024),
    # the f32 model check at full width keeps 4 of 48 layers (12.5 GB)
    MOE: dict(model_B=2, model_S=256, model_smax=512, model_layers=4, lo=256, hi=1024,
              max_new=16, deadline=4, smax=2048, profile_S=1024),
    XLSTM: dict(model_B=2, model_S=256, model_smax=512, lo=512, hi=1024, max_new=32,
                deadline=8, smax=2048, profile_S=1024),
    # the f32 model check keeps 1 of 20 groups (4 self + 1 cross layers, 25 GB);
    # the bf16 serve run 4 of 20 (20 of 100 layers, 38 GB of weights): Model.prefill
    # with 1024 image tokens a request, then decode steps (no engine path)
    VLM: dict(model_B=2, model_S=256, model_smax=512, model_layers=5, serve_layers=20,
              lo=512, hi=1024, max_new=16, profile_S=1024),
    # an encoder: 30 s of audio at 20 ms a frame; forward only (no decode step)
    AUDIO: dict(model_B=2, model_S=1500, encodes=8, batch=4, profile_S=1500),
}
# HuBERT's flash shape: bf16 on the tensor-core kernel at hd 80, f32 on the
# CUDA-core one
HUBERT_FA = (4, 1500, 1500, 16, 16, 80, False, 0, 0)
# a tensor-core flash kernel against its tile twin (flash_mha_tiled: the same
# tiles, P rounded to bf16): sum order and the hardware exp2 are left, one
# bf16 rounding of the output (2^-8)
TWIN_TOL = 1e-2
# bf16 at hd 80 against the plain version, either design (the tensor-core
# kernel rounds P to bf16, the CUDA-core one keeps it in f32): atol and rtol
# of one bf16 rounding of the output; besides, the tensor-core kernel's
# max |got - want| within FWD_HD80_SHARE of max |want| (HuBERT's outputs
# are small: std ~ sqrt(e / 1500)), beside two wrong kernels that must fail it
HD80_BF16_TOL = 2e-2
FWD_HD80_SHARE = 2e-2
# the VLM's attention: self (causal) and cross (text queries over 1024 image
# tokens, at prefill and at a decode step), 64 q heads over 8 kv heads
VLM_FA = [(4, 1024, 1024, 64, 8, 128, True, 0, 0), (4, 1024, 1024, 64, 8, 128, False, 0, 0),
          (4, 1, 1024, 64, 8, 128, False, 0, 0)]
CARD_BYTES = 80e9                          # the serve runs must fit one 80 GB card
# the flash backward's train shapes, ((B, S, H, KV, hd, window, n_sink),
# causal): qwen2; hymba's window and sinks; HuBERT (hd 80, non-causal); the
# VLM's self (causal) and cross (Sq 1024 over its 1024 image tokens) heads
QWEN_BWD, HYMBA_BWD = (4, 1024, 12, 2, 128, 0, 0), (4, 1152, 25, 5, 64, 1024, 128)
HUBERT_BWD, VLM_BWD = (4, 1500, 16, 16, 80, 0, 0), (4, 1024, 64, 8, 128, 0, 0)
FLASH_BWD_CASES = [(QWEN_BWD, True), (HYMBA_BWD, True), (HUBERT_BWD, False), (VLM_BWD, True),
                   (VLM_BWD, False)]

# phase 3b, the query row offset (sequence-parallel attention): each case's
# rows cut into ROW_SHARDS shards, each run against the whole K and V with
# its first row as q_off. (label, (B, S, H, KV, hd), causal, window, n_sink,
# dtype): qwen2's causal heads in f32 (the CUDA-core kernels) and bf16 (the
# tensor-core ones), hymba's window and 128 sinks in f32 and bf16, HuBERT's
# non-causal hd 80 in bf16 (q_off must change nothing)
ROW_SHARDS = 4
ROW_OFFSET_CASES = [("qwen2", (4, 1024, 12, 2, 128), True, 0, 0, "float32"),
                    ("qwen2", (4, 1024, 12, 2, 128), True, 0, 0, "bfloat16"),
                    ("hymba", (4, 1152, 25, 5, 64), True, 1024, 128, "float32"),
                    ("hymba", (4, 1152, 25, 5, 64), True, 1024, 128, "bfloat16"),
                    ("hubert", (4, 1500, 16, 16, 80), False, 0, 0, "bfloat16")]
# phase 10, the port's examples on the card (subprocesses): torch_train_lm.py
# runs EXAMPLE_STEPS[0] steps, then resumes from its newest checkpoint to
# EXAMPLE_STEPS[1]
EXAMPLE_STEPS = (24, 32)
EXAMPLE_TIMEOUT = 300


def log(msg: str) -> None:
    print(msg, flush=True)


# -- timing -------------------------------------------------------------------

class Timer:
    """Median device time of one call, by CUDA events around each launch,
    with the 50 MB L2 flushed (a 128 MB memset) before every launch. A
    device-side sleep after the flush holds the stream until the host has
    queued the call, so host launch overhead stays out of the reading."""

    def __init__(self, torch, reps: int = 25):
        self.torch, self.reps = torch, reps
        self.flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")

    def __call__(self, fn) -> float:
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(self.reps):
            self.flush.zero_()
            torch.cuda._sleep(1_000_000)       # ~0.5 ms of device cycles
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times)


def rms_bound(rows: int, d: int, esize: int):
    byts = (2 * rows * d + d) * esize          # x read, y written, w read
    ops = 4 * rows * d                         # square, sum, *rsqrt, *w (f32)
    t_b, t_o = byts / HBM_BYTES_PER_S, ops / F32_FLOPS
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations"), byts, ops


def visible_pairs(Sq: int, Sk: int, window: int = 0, n_sink: int = 0) -> int:
    """(row, col) pairs the causal mask lets through: col <= row (top-left),
    col < Sk and, under a window, col > row - window or col < n_sink."""
    total = 0
    for r in range(Sq):
        hi = min(r, Sk - 1)                     # cols 0..hi are causal
        if hi < 0:
            continue
        if window == 0:
            total += hi + 1
            continue
        lo = max(r - window + 1, 0)             # the band is lo..hi
        total += max(hi - lo + 1, 0) + max(0, min(n_sink, lo, hi + 1))
    return total


def flash_bound(B, Sq, Sk, H, KV, hd, causal, esize, peak, window=0, n_sink=0):
    pairs = B * H * (visible_pairs(Sq, Sk, window, n_sink) if causal else Sq * Sk)
    ops = 4 * hd * pairs                       # QK^T and PV, 2 flops per MAC
    byts = (2 * B * Sq * H * hd + 2 * B * Sk * KV * hd) * esize
    t_b, t_o = byts / HBM_BYTES_PER_S, ops / peak
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations"), byts, ops


# f32 operations of one task's duration, by engine class (MXU, VPU, DMA,
# ICI), as csrc/list_schedule.cu computes it; then 11 for its schedule step
# (7 max over the dependency slots, 1 with the engine, 1 add, the makespan
# max, the busy add), and 8 per parameter vector (2 rates, 5 x repeats)
SCHED_DUR_OPS = (16, 4, 2, 3)
SCHED_STEP_OPS, SCHED_VECTOR_OPS = 11, 8


def sched_bound(ints, K: int):
    """The list schedule's bound from this call's tasks: each task record
    (80 B) and parameter vector (52 B) read once, makespan and busy (20 B a
    vector) written once; the operations its tasks' classes need."""
    N = ints.shape[0]
    per_class = ints[:, 0].bincount(minlength=4).tolist()
    ops = K * (sum(n * (SCHED_DUR_OPS[c] + SCHED_STEP_OPS)
                   for c, n in enumerate(per_class)) + SCHED_VECTOR_OPS)
    byts = N * 80 + K * (13 * 4 + 5 * 4)
    t_b, t_o = byts / HBM_BYTES_PER_S, ops / F32_FLOPS
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations"), byts, ops


# the dependent latency of one step of the list schedule's chain, in SM
# cycles: a shared-memory load to its use, one max, one add (assumed from
# published microbenchmarks of Hopper and its predecessors; not measured here)
SMEM_LOAD_CYCLES, FP32_DEP_CYCLES = 30, 4
CHAIN_STEP_CYCLES = SMEM_LOAD_CYCLES + 2 * FP32_DEP_CYCLES


def sm_clocks() -> dict:
    """The SM clock now and its maximum, MHz (nvidia-smi)."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
                        "--format=csv,noheader,nounits"], capture_output=True, text=True,
                       timeout=60, check=True)
    now, top = (float(x) for x in r.stdout.strip().splitlines()[0].split(","))
    return {"sm_mhz": now, "max_mhz": top}


def sched_chain_bound(N: int, clock: dict) -> float:
    """ms: N dependent steps of CHAIN_STEP_CYCLES at the card's top SM clock."""
    return N * CHAIN_STEP_CYCLES / (clock["max_mhz"] * 1e6) * 1e3


def rms_bwd_bound(rows: int, d: int, esize: int):
    """The function's bound: x, g and w read and dx and dw written once;
    ~10 f32 operations an element. (The kernel's dw partial rows are its
    design's overhead, not the function's, and stay out.)"""
    byts = (3 * rows * d + 2 * d) * esize
    ops = 10 * rows * d
    t_b, t_o = byts / HBM_BYTES_PER_S, ops / F32_FLOPS
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations"), byts, ops


def flash_bwd_bound(B, S, H, KV, hd, causal, esize, peak, window=0, n_sink=0):
    """Five products over the visible pairs (q.k, dO.v, P.dO, dS.k, dS.q),
    2 * hd flops each; q, o, dO read and dq written, k, v read and dk, dv
    written once."""
    pairs = B * H * (visible_pairs(S, S, window, n_sink) if causal else S * S)
    ops = 10 * hd * pairs
    byts = (4 * B * S * H * hd + 4 * B * S * KV * hd) * esize
    t_b, t_o = byts / HBM_BYTES_PER_S, ops / peak
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations"), byts, ops


def scan_bound(B, S, C, esize):
    byts = 3 * B * S * C * esize               # a, b read, h written
    ops = 2 * B * S * C                        # one FMA per element (f32)
    t_b, t_o = byts / HBM_BYTES_PER_S, ops / F32_FLOPS
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations"), byts, ops


def sel_scan_bound(B, S, di, n, esize):
    # x and dt read (f32), z read and y written (esize), B and C read (f32),
    # A and D read, the state written (f32); one exponential a state a step
    byts = B * S * di * (8 + 2 * esize) + 8 * B * S * n + 4 * di * (n + 1) + 4 * B * di * n
    exps = B * S * di * n
    t_b, t_e = byts / HBM_BYTES_PER_S, exps / SFU_EXP_PER_S
    return max(t_b, t_e) * 1e3, ("bytes" if t_b >= t_e else "exponentials"), byts, exps


def scan_bwd_bound(B, S, C, esize):
    byts = 5 * B * S * C * esize               # a, h, dh read, da, db written
    ops = 3 * B * S * C                        # one FMA and one multiply (f32)
    t_b, t_o = byts / HBM_BYTES_PER_S, ops / F32_FLOPS
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations"), byts, ops


def compare(name, got, want, tol):
    import torch

    torch.cuda.synchronize()
    g, w = got.float(), want.float()
    if not bool(torch.isfinite(g).all()):
        raise AssertionError(f"{name}: non-finite kernel output")
    err = float((g - w).abs().max()) if g.numel() else 0.0
    ok = bool(torch.allclose(g, w, rtol=tol, atol=tol))
    log(f"  {name}: max_abs_err={err:.3e} tol={tol:g} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    return err


def host_us(torch, calls: int = 1000, rounds: int = 5) -> dict:
    """Host wall time per call (us) of the rmsnorm wrapper and of F.rms_norm
    at the decode shape [4, 1536] bf16: `calls` calls back to back, no
    flush, one synchronize at the end; the median of `rounds`, taken in
    turns."""
    import torch.nn.functional as F

    from repro_torch.kernels.rmsnorm.ops import rmsnorm

    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((4, 1536), generator=gen, device="cuda").to(torch.bfloat16)
    w = torch.randn((1536,), generator=gen, device="cuda").to(torch.bfloat16)
    fns = {"rmsnorm": lambda: rmsnorm(x, w, 1e-6),
           "F.rms_norm": lambda: F.rms_norm(x, (1536,), w, 1e-6)}
    got = {name: [] for name in fns}
    for fn in fns.values():
        for _ in range(100):
            fn()
    torch.cuda.synchronize()
    for _ in range(rounds):
        for name, fn in fns.items():
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            got[name].append((time.perf_counter() - t0) / calls * 1e6)
    out = {name: statistics.median(v) for name, v in got.items()}
    log(f"[host] rmsnorm [4,1536] bf16, {calls} calls back to back, median of "
        f"{rounds}: wrapper {out['rmsnorm']:.2f} us/call, F.rms_norm "
        f"{out['F.rms_norm']:.2f} us/call "
        f"({', '.join(f'{n} ' + ' '.join(f'{t:.2f}' for t in v) for n, v in got.items())})")
    return out


def rms_variant_race(torch, timer, randn) -> None:
    """The plan sends rows narrower than STREAM_MIN_BYTES to the two-pass
    rows variant and the others to the stream variant. Time both, forced, at
    4096 rows (a B=4 S=1024 prefill) and row widths on either side of that
    limit in both dtypes, among them the d of every dense config of the
    port, beside a device copy of x; each output is checked first."""
    from repro_torch.kernels.rmsnorm.kernel import rmsnorm_variant_cuda
    from repro_torch.kernels.rmsnorm.ref import ROWS, STREAM, STREAM_MIN_BYTES, rmsnorm_ref

    log(f"[kernels] rmsnorm rows vs stream, forced (the plan streams rows of "
        f"{STREAM_MIN_BYTES} B or more)")
    ds = {torch.bfloat16: (1536, 2048, 2304, 3072, 4096, 5120, 8192),
          torch.float32: (576, 1024, 1152, 1536, 2048, 2304)}
    for dt, widths in ds.items():
        dn = str(dt).split(".")[1]
        for d in widths:
            x, w = randn((4096, d), dt), randn((d,), dt)
            y = torch.empty_like(x)
            want = rmsnorm_ref(x, w, 1e-6)
            got = {}
            for v, name in ((ROWS, "rows"), (STREAM, "stream")):
                def fn(v=v):
                    rmsnorm_variant_cuda(x, w, y, 4096, d, 1e-6, v)
                y.zero_()
                fn()
                compare(f"rmsnorm [4096,{d}] {dn} forced {name}", y, want,
                        TOL[("rmsnorm", dn)])
                got[name] = timer(fn)
            copy = timer(lambda: y.copy_(x))
            bound = rms_bound(4096, d, x.element_size())[0]
            log(f"    [4096,{d}] {dn} ({d * x.element_size()} B rows): rows "
                f"{got['rows'] * 1e3:.2f} us, stream {got['stream'] * 1e3:.2f} us, copy of x "
                f"{copy * 1e3:.2f} us, bound {bound * 1e3:.2f} us; stream/rows "
                f"{got['stream'] / got['rows']:.3f}")
            del x, w, y, want


# -- phases -------------------------------------------------------------------

def phase_card():
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True, text=True,
                       timeout=60, check=True)
    card = r.stdout.strip().splitlines()[0].strip()
    log(f"[card] {card}")
    return card


def phase_build():
    from repro_torch.kernels import _build

    built = not _build.library_path().exists()
    t0 = time.perf_counter()
    _build.load(verbose=True)
    log(f"[build] {_build.library_path().name} "
        f"{'built' if built else 'found built'} in {time.perf_counter() - t0:.1f}s")


def _same_bits(torch, got, want) -> bool:
    return all(g.dtype == w.dtype == torch.float32 and g.shape == w.shape
               and torch.equal(g.view(torch.int32), w.view(torch.int32))
               for g, w in zip(got, want))


def phase_prescreen(torch):
    """The campaign prescreen on the card: every cell of lm_full_pod through
    prescreen_cell with one memo, each launch of the list-schedule kernel
    held bit for bit against its plain version on the same inputs; one
    launch at N 6,122; then the frozen campaign slices through run_campaign.
    Returns the kernels-line row, the main run's launch count and its
    launches by variant."""
    import numpy as np

    from repro_torch.core import vectorized
    from repro_torch.core.vectorized import from_tasks, params_of
    from repro_torch.graph.compiler import CompileOptions, compile_ops
    from repro_torch.graph.workloads import resolve_workload
    from repro_torch.kernels.list_schedule.kernel import kernel_attrs, kernel_plan
    from repro_torch.kernels.list_schedule.ops import list_schedule
    from repro_torch.kernels.list_schedule.ref import VARIANTS, list_schedule_ref
    from repro_torch.sweep import prescreen
    from repro_torch.sweep.runner import run_campaign
    from repro_torch.sweep.spec import RefineSpec, SweepSpec, load_builtin_spec

    spec = load_builtin_spec(CAMPAIGN)
    cells = spec.cells()
    # the inputs and outputs of every launch of the main run, to hold each
    # against the plain version afterwards, and the host time spent in each
    # step of prescreen_cell
    calls, spent, originals = [], {}, []

    def recorded(feats, ints, params, n_units, repeats=1):
        out = originals[0][2](feats, ints, params, n_units, repeats)
        calls.append((feats, ints, params, n_units, repeats, out))
        return out

    def timed(mod, name):
        fn = getattr(mod, name)

        def run(*args, **kwargs):
            t = time.perf_counter()
            out = fn(*args, **kwargs)
            spent[name] = spent.get(name, 0.0) + time.perf_counter() - t
            return out
        return run

    originals.append((vectorized, "list_schedule", vectorized.list_schedule))
    vectorized.list_schedule = recorded
    for name in ("compile_ops", "from_tasks", "schedule_many_stats", "analytic_power_w"):
        originals.append((prescreen, name, getattr(prescreen, name)))
        setattr(prescreen, name, timed(prescreen, name))
    memo = {}
    torch.cuda.synchronize()
    list_schedule.launches = 0
    list_schedule.variant_launches = dict.fromkeys(VARIANTS, 0)
    t0 = time.perf_counter()
    screens = [prescreen.prescreen_cell(cell, memo=memo) for cell in cells]
    wall = time.perf_counter() - t0
    launches = list_schedule.launches
    variants = {v: n for v, n in list_schedule.variant_launches.items() if n}
    for mod, name, fn in originals:
        setattr(mod, name, fn)
    K = len(cells[0].points)
    log(f"[prescreen] {CAMPAIGN}: {len(cells)} cells x {K} vectors, {len(memo)} part "
        f"screens, {launches} kernel launches, wall {wall:.3f} s; host time in "
        + ", ".join(f"{n} {t:.3f} s" for n, t in spent.items())
        + f", the rest {wall - sum(spent.values()):.3f} s")
    if launches != len(memo) or len(calls) != len(memo):
        raise AssertionError(f"list_schedule launched {launches} times for {len(memo)} "
                             f"part screens")
    for scr in screens:
        if scr.time_ns.shape != (K,) or not (np.isfinite(scr.time_ns).all()
                                             and (scr.time_ns > 0).all()):
            raise AssertionError(f"{scr.cell.label}: bad makespans")
        if not ((scr.util >= 0).all() and (scr.util <= 1).all()
                and np.isfinite(scr.energy_j).all()):
            raise AssertionError(f"{scr.cell.label}: bad utilization or energy")

    timer = Timer(torch, reps=5)
    kernel_ms = plain_ms = err = 0.0
    for feats, ints, params, n_units, repeats, out in calls:
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        want = list_schedule_ref(feats, ints, params, n_units, repeats)
        torch.cuda.synchronize()
        plain_ms += (time.perf_counter() - t1) * 1e3
        if not _same_bits(torch, out, want):
            raise AssertionError(f"list_schedule N {feats.shape[0]} K {params.shape[0]}: "
                                 f"kernel != plain version")
        err = max([err] + [float((g - w).abs().max()) for g, w in zip(out, want)])
        kernel_ms += timer(lambda: list_schedule(feats, ints, params, n_units, repeats))
    log(f"[prescreen] all {len(calls)} launches equal the plain version bit for bit "
        f"(variants {variants}); kernel {kernel_ms:.3f} ms in all (CUDA events, median "
        f"of 5 each, L2 flushed; {100 * kernel_ms / 1e3 / wall:.3f}% of the wall time), "
        f"plain version {plain_ms:.1f} ms in all (wall, synchronized)")

    clock = sm_clocks()
    log(f"[prescreen] SM clock {clock['sm_mhz']} MHz now, {clock['max_mhz']} MHz at most "
        f"(nvidia-smi); chain bound = N x {CHAIN_STEP_CYCLES} cycles (shared load-to-use "
        f"{SMEM_LOAD_CYCLES} + max {FP32_DEP_CYCLES} + add {FP32_DEP_CYCLES}) at "
        f"{clock['max_mhz']} MHz")
    for v in VARIANTS:
        a = kernel_attrs(v)
        log(f"[prescreen] variant {v}: {a['registers']} registers/thread, "
            f"{a['spill_bytes']} B spilled, {a['smem_bytes']} B static shared")

    # the main shape: the largest part graph of the run (a prefill layer body);
    # every variant, forced, against the plain version and timed
    feats, ints, params, n_units, repeats, _ = max(calls, key=lambda c: c[0].shape[0])
    N = feats.shape[0]
    timer = Timer(torch)
    times = sched_variants(torch, timer, feats, ints, params, n_units, repeats,
                           VARIANTS, clock)
    planned = kernel_plan(N, K, n_units).variant
    plain = timer(lambda: list_schedule_ref(feats, ints, params, n_units, repeats))
    bound, by, byts, ops = sched_bound(ints, K)
    chain = sched_chain_bound(N, clock)
    ms = times[planned]
    log(f"[prescreen] list_schedule N {N} K {K} ({planned}): time {ms * 1e3:.2f} us "
        f"({ms * 1e6 / N:.1f} ns per dependent step; global variant "
        f"{times['global'] * 1e3:.2f} us) | bound {bound * 1e6:.2f} ns ({by}: {byts} B, "
        f"{ops} f32 operations) | chain bound {chain * 1e3:.3f} us (assumed latencies) | "
        f"plain {plain:.3f} ms "
        f"| no library call computes a list schedule")
    row = dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bound, bound_by=by,
               library_ms=None, shape=[N, K], dtype="float32", variant=planned,
               ns_per_step=ms * 1e6 / N, variant_ms=times, sm_clock_mhz=clock,
               **kernel_attrs(planned))

    # the largest task graph of any builtin campaign
    tp2 = SweepSpec(name="hlo_tp2", workloads=["hlo/qwen2_1_5b_prefill_tp2"],
                    preset="v5e", axes={"clock_ghz": [0.6, 0.94]}, n_tiles=[2],
                    refine=RefineSpec(mode="none"))
    (cell,) = tp2.cells()
    cw = compile_ops(resolve_workload(cell.workload)(), cell.base_cfg(),
                     CompileOptions(n_tiles=cell.n_tiles))
    arrays = from_tasks(cw.tasks)
    feats, ints = vectorized.task_tensors(arrays, torch.device("cuda"))
    pm = np.stack([params_of(p.cfg(tp2)) for p in cell.points]).astype(np.float32)
    params = torch.from_numpy(pm).cuda()
    N6, K6 = len(cw.tasks), params.shape[0]
    want6 = list_schedule_ref(feats, ints, params, arrays.n_units, 6)
    if not _same_bits(torch, list_schedule(feats, ints, params, arrays.n_units, 6), want6):
        raise AssertionError(f"list_schedule N {N6} repeats 6: kernel != plain version")
    planned6 = kernel_plan(N6, K6, arrays.n_units).variant
    times6 = sched_variants(torch, timer, feats, ints, params, arrays.n_units, 1,
                            VARIANTS, clock)
    plain6 = Timer(torch, reps=3)(lambda: list_schedule_ref(feats, ints, params,
                                                            arrays.n_units, 1))
    bound6, by6, byts6, ops6 = sched_bound(ints, K6)
    chain6 = sched_chain_bound(N6, clock)
    ms6 = times6[planned6]
    log(f"[prescreen] list_schedule N {N6} K {K6} (hlo/qwen2_1_5b_prefill_tp2, "
        f"{arrays.n_units} units, {planned6}): equal to the plain version bit for bit at "
        f"repeats 1 and 6; time {ms6:.3f} ms ({ms6 * 1e6 / N6:.1f} ns per dependent step; "
        f"global variant {times6['global']:.3f} ms) | bound {bound6 * 1e6:.2f} ns ({by6}: "
        f"{byts6} B, {ops6} f32 operations) | chain bound {chain6 * 1e3:.3f} us (assumed "
        f"latencies) | plain "
        f"{plain6:.1f} ms")
    row.update(n6122_ms=ms6, n6122_variant=planned6, n6122_global_ms=times6["global"],
               n6122_ns_per_step=ms6 * 1e6 / N6, n6122_plain_ms=plain6,
               n6122_bound_ms=bound6,
               prescreen_wall_s=wall, prescreen_kernel_ms=kernel_ms,
               prescreen_plain_ms=plain_ms, part_screens=len(memo),
               prescreen_host_s=spent)

    sys.path.insert(0, os.path.join(HERE, "tests"))
    import _torch_golden

    for name, gspec in sorted(_torch_golden.specs().items()):
        t1 = time.perf_counter()
        res = run_campaign(gspec, backend="inline", use_cache=False)
        took = time.perf_counter() - t1
        if _torch_golden.freeze(res.records) != _torch_golden.golden(name):
            raise AssertionError(f"{name}: records differ from tests/golden/{name}.json")
        log(f"[prescreen] golden {name}: {len(res.records)} records equal the "
            f"fixture, {took:.2f} s (prescreen {res.summary['prescreen_s']:.2f} s)")
    backends_on_the_card(run_campaign, _torch_golden)
    log(f"[prescreen] {json.dumps(dict(name='list_schedule', launches=launches, **row))}")
    return row, launches, variants


def sched_variants(torch, timer, feats, ints, params, n_units, repeats, variants, clock):
    """Each variant, forced, equal to the plain version bit for bit; its
    median time (ms)."""
    from repro_torch.kernels.list_schedule.ops import list_schedule
    from repro_torch.kernels.list_schedule.kernel import kernel_plan
    from repro_torch.kernels.list_schedule.ref import list_schedule_ref

    N, K = feats.shape[0], params.shape[0]
    want = list_schedule_ref(feats, ints, params, n_units, repeats)
    times = {}
    for v in variants:
        if not _same_bits(torch, list_schedule(feats, ints, params, n_units, repeats,
                                               variant=v), want):
            raise AssertionError(f"list_schedule N {N} K {K} {v}: kernel != plain version")
        times[v] = timer(lambda v=v: list_schedule(feats, ints, params, n_units, repeats,
                                                   variant=v))
        p = kernel_plan(N, K, n_units, v)
        log(f"  list_schedule N {N} K {K} {v} (T {p.vectors}, grid {p.grid}, "
            f"{p.threads} threads, {p.smem} B dynamic shared): bit for bit the plain "
            f"version; {times[v] * 1e3:.2f} us, {times[v] * 1e6 / N:.1f} ns per step, "
            f"{times[v] * 1e-3 * clock['max_mhz'] * 1e6 / N:.0f} cycles per step at "
            f"{clock['max_mhz']} MHz")
    return times


def backends_on_the_card(run_campaign, golden):
    """One golden slice through inline, pool (2 forked workers, after the
    pre-screen has initialised CUDA in this process) and spool (one spawned
    worker): byte-identical records, equal to the fixture."""
    import shutil

    from repro_torch.exec import SpoolBackend

    name = "lm_decode_kv_slice"
    spec = golden.specs()[name]
    root = os.path.join(HERE, "build", "chip_smoke_spool")
    shutil.rmtree(root, ignore_errors=True)
    blobs = {}
    try:
        for bk, kw in (("inline", dict(backend="inline")), ("pool", dict(workers=2)),
                       ("spool", dict(backend=SpoolBackend(root, workers=1, poll_s=0.05,
                                                           timeout_s=300)))):
            t1 = time.perf_counter()
            res = run_campaign(spec, use_cache=False, **kw)
            if res.summary["backend"] != bk:
                raise AssertionError(f"{name}: ran {res.summary['backend']}, not {bk}")
            blobs[bk] = json.dumps(res.records, sort_keys=True)
            log(f"[prescreen] {name} through {bk}: {len(res.records)} records, "
                f"{time.perf_counter() - t1:.2f} s")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if not blobs["inline"] == blobs["pool"] == blobs["spool"]:
        raise AssertionError(f"{name}: inline, pool and spool records differ")
    if golden.freeze(json.loads(blobs["inline"])) != golden.golden(name):
        raise AssertionError(f"{name}: records differ from tests/golden/{name}.json")
    log(f"[prescreen] {name}: inline, pool and spool records byte-identical on the card, "
        f"equal to the fixture")


def phase_kernels(torch):
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.kernel import (WGMMA_HEAD_DIMS,
                                                            flash_attention_cuda,
                                                            flash_kernel_attrs,
                                                            wgmma_kernel_attrs)
    from repro_torch.kernels.flash_attention.ops import flash_mha
    from repro_torch.kernels.flash_attention.ref import flash_mha_ref, flash_mha_tiled
    from repro_torch.kernels.rmsnorm.kernel import kernel_attrs, kernel_plan
    from repro_torch.kernels.rmsnorm.ops import rmsnorm
    from repro_torch.kernels.rmsnorm.ref import VARIANTS, rmsnorm_ref
    from repro_torch.kernels.selective_scan.kernel import selective_scan_kernel_attrs
    from repro_torch.kernels.selective_scan.ops import selective_scan_fused
    from repro_torch.kernels.selective_scan.ref import selective_scan_fused_ref
    from repro_torch.kernels.ssm_scan.ops import ssm_scan_batched
    from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref
    from repro_torch.models.mamba import _ssm_states

    gen = torch.Generator(device="cuda").manual_seed(0)
    timer = Timer(torch)
    rows = {}

    def randn(shape, dt):
        return torch.randn(shape, generator=gen, device="cuda").to(dt)

    log("[kernels] rmsnorm vs plain")
    # qwen2: prefill B=4 S=1024, decode B=4, qk-norm-sized rows;
    # hymba: prefill B=4 S=1024+128 meta, decode B=4; qwen3-moe (qk-norm,
    # 32 q and 4 kv heads of 128): prefill B=4 S=1024 (ln1/ln2, q_norm,
    # k_norm), decode B=4 (the same four)
    # xlstm: prefill B=4 S=1024 and decode B=4 at d 768; hubert: an encode
    # of B=4 T=1500 at d 1280; the VLM at d 8192 (the plan's MAX_D): prefill
    # B=4 S=1024, its cross q-norm [B*S*64, 128] and k-norm over the image
    # tokens [B*1024*8, 128], decode B=4 and the decode q-norm [4*64, 128]
    main_rms = [(4 * 1024, 1536), (4, 1536), (4 * 1024 * 12, 128),
                (4 * 1152, 1600), (4, 1600),
                (4 * 1024, 2048), (4 * 1024 * 32, 128), (4 * 1024 * 4, 128),
                (4, 2048), (4 * 32, 128), (4 * 4, 128),
                (4 * 1024, 768), (4, 768), (4 * 1500, 1280),
                (4 * 1024, 8192), (4 * 1024 * 64, 128), (4 * 1024 * 8, 128), (4, 8192),
                (4 * 64, 128)]
    # every variant of the plan: narrow rows several to a warp, the widest
    # across warps, d that rules out 16-byte loads, x at an odd element
    # offset (the last element of a case says so)
    edge_rms = [(1, 16), (37, 100), (5, 8192), (3 * 50, 512), (2 * 20 * 4, 16),
                (300, 8192), (1000, 24), (600, 1536), (4, 1536, 1), (4096, 1536, 1)]
    for dt in (torch.float32, torch.bfloat16):
        dn = str(dt).split(".")[1]
        for case in main_rms + edge_rms:
            shape, offset = case[:2], (case[2] if len(case) > 2 else 0)
            x = randn((shape[0] * shape[1] + offset,), dt)[offset:].view(shape)
            w = randn(shape[-1:], dt)
            plan = kernel_plan(*shape, dt, offset == 0)
            before = rmsnorm.launches
            got = rmsnorm(x, w, 1e-6)
            if rmsnorm.launches != before + 1:
                raise AssertionError(f"rmsnorm {list(shape)}: no launch counted")
            err = compare(f"rmsnorm {list(shape)}{' offset %d' % offset if offset else ''} "
                          f"{dn} ({VARIANTS[plan.variant]})", got,
                          rmsnorm_ref(x, w, 1e-6), TOL[("rmsnorm", dn)])
            if case not in main_rms:
                continue
            ms = timer(lambda: rmsnorm(x, w, 1e-6))
            plain = timer(lambda: rmsnorm_ref(x, w, 1e-6))
            lib = timer(lambda: F.rms_norm(x, (shape[-1],), w, 1e-6))
            # a device copy of x moves the same bytes with no arithmetic: the
            # floor of this timer for a kernel bound by bytes
            y = torch.empty_like(x)
            copy = timer(lambda: y.copy_(x))
            bound, by, byts, ops = rms_bound(shape[0], shape[1], x.element_size())
            attrs = kernel_attrs(plan, dt)
            log(f"    time {ms * 1e3:.2f} us | bound {bound * 1e3:.2f} us ({by}: "
                f"{byts / 1e6:.2f} MB, {ops / 1e6:.1f} MFLOP) | plain "
                f"{plain * 1e3:.1f} us | F.rms_norm {lib * 1e3:.2f} us | copy of x "
                f"{copy * 1e3:.2f} us (kernel/copy {ms / copy:.2f}x)")
            log(f"    variant {VARIANTS[plan.variant]} (grid {plan.grid} x "
                f"{plan.threads} threads, {plan.tpr} threads per row"
                + (f", {plan.stages} stages of {plan.tile_rows} rows" if plan.stages else "")
                + f") | {attrs['registers']} registers/thread, {attrs['spill_bytes']} B "
                f"spilled, {attrs['smem_bytes'] / 1024:.1f} KiB shared/block | "
                f"kernel/F.rms_norm {ms / lib:.2f}x | {100 * bound / ms:.1f}% of its bound")
            rows[("rmsnorm", shape, dn)] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bound,
                bound_by=by, library_ms=lib, copy_ms=copy, variant=VARIANTS[plan.variant],
                **attrs)
    rms_variant_race(torch, timer, randn)
    host = host_us(torch)
    rows[("rmsnorm", (4, 1536), "bfloat16")].update(
        host_us=host["rmsnorm"], library_host_us=host["F.rms_norm"])

    log("[kernels] flash attention vs plain")
    # (B, Sq, Sk, H, KV, hd, causal, window, n_sink)
    main_fa = [(4, 1024, 1024, 12, 2, 128, True, 0, 0),       # qwen2 prefill
               (4, 1152, 1152, 25, 5, 64, True, 1024, 128),   # hymba, S = w + sinks
               (4, 2176, 2176, 25, 5, 64, True, 1024, 128),   # hymba, 2048 + 128
               (4, 1024, 1024, 32, 4, 128, True, 0, 0),       # qwen3-moe prefill
               HUBERT_FA, *VLM_FA]
    edge_fa = [(2, 300, 300, 12, 2, 128, True, 0, 0),     # ragged S
               (2, 300, 300, 12, 2, 128, False, 0, 0),    # non-causal
               (2, 200, 500, 12, 2, 128, True, 0, 0),     # Sq < Sk, top-left mask
               (2, 500, 200, 12, 2, 128, True, 0, 0),     # Sq > Sk
               (1, 256, 256, 8, 1, 64, True, 0, 0),       # MQA
               (2, 384, 384, 9, 3, 64, True, 0, 0),       # hd 64 (smollm heads)
               (2, 130, 130, 4, 2, 32, False, 0, 0),
               (2, 130, 130, 4, 2, 16, True, 0, 0),       # reduced-config hd
               (1, 5, 0, 2, 1, 16, True, 0, 0),           # no key: rows come out 0
               (1, 700, 700, 25, 5, 64, True, 256, 128),  # skipped key tiles
               (2, 300, 300, 4, 2, 64, True, 100, 7),     # ragged window and sinks
               (2, 40, 40, 4, 2, 16, True, 16, 8),        # hymba reduced
               (1, 130, 130, 4, 1, 32, True, 5, 0),       # window < key tile
               # tensor-core kernel in bf16: tails of neither tile, Sq != Sk
               # both ways, non-causal MQA, windows that skip tiles, no key
               (2, 333, 517, 6, 2, 128, True, 0, 0),
               (2, 517, 333, 6, 2, 64, False, 0, 0),
               (1, 77, 300, 5, 1, 64, False, 0, 0),
               (1, 600, 600, 6, 2, 128, True, 200, 64),
               (2, 427, 427, 5, 5, 64, True, 5, 0),
               (1, 900, 900, 5, 1, 64, True, 128, 300),
               (1, 5, 0, 2, 1, 128, True, 0, 0),
               # hd 80 (bf16: five 16-column boxes, 32-byte swizzle): causal
               # GQA with Sq < Sk, window and sinks, Sq > Sk MQA, no key
               (2, 333, 517, 6, 2, 80, True, 0, 0),
               (1, 300, 300, 4, 2, 80, True, 100, 7),
               (1, 517, 77, 4, 1, 80, False, 0, 0),
               (1, 5, 0, 2, 1, 80, False, 0, 0)]
    for dt in (torch.float32, torch.bfloat16):
        dn = str(dt).split(".")[1]
        for case in main_fa + edge_fa:
            B, Sq, Sk, H, KV, hd, causal, win, ns = case
            q = randn((B, Sq, H, hd), dt)
            k, v = randn((B, Sk, KV, hd), dt), randn((B, Sk, KV, hd), dt)
            kw = dict(causal=causal, window=win, n_sink=ns)
            name = (f"flash B={B} Sq={Sq} Sk={Sk} H={H} KV={KV} hd={hd} "
                    f"{'causal' if causal else 'full'} window={win} sinks={ns} {dn}")
            before = flash_mha.launches, flash_mha.wgmma_launches
            got = flash_mha(q, k, v, **kw)
            ran = (flash_mha.launches - before[0], flash_mha.wgmma_launches - before[1])
            tc = dt == torch.bfloat16 and hd in WGMMA_HEAD_DIMS
            if ran != ((0, 0) if tc and Sk == 0 else (1, int(tc))):
                raise AssertionError(f"{name}: (launches, wgmma launches) rose by {ran}")
            want = flash_mha_ref(q, k, v, **kw)
            err = compare(name, got, want, HD80_BF16_TOL if tc and hd == 80
                          else TOL[("flash", dn)])
            if tc and hd == 80:
                compare(f"{name} vs its tile twin", got, flash_mha_tiled(q, k, v, **kw),
                        TWIN_TOL)
                _flash_hd80_share_check(torch, name, q, k, v, kw, got, want,
                                        faults=case in main_fa)
            if case not in main_fa:
                continue
            ms = timer(lambda: flash_mha(q, k, v, **kw))
            plain = timer(lambda: flash_mha_ref(q, k, v, **kw))
            qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            if win:
                r = torch.arange(Sq, device="cuda")[:, None]
                c = torch.arange(Sk, device="cuda")[None, :]
                mask = (c <= r) & ((c > r - win) | (c < ns))
                lib = timer(lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mask, enable_gqa=True))
            else:
                lib = timer(lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=causal, enable_gqa=True))
            peak = BF16_FLOPS if dt == torch.bfloat16 else F32_FLOPS
            bound, by, byts, ops = flash_bound(B, Sq, Sk, H, KV, hd, causal,
                                               q.element_size(), peak, win, ns)
            log(f"    time {ms:.3f} ms | bound {bound * 1e3:.2f} us ({by}: "
                f"{byts / 1e6:.2f} MB, {ops / 1e9:.2f} GFLOP at {peak / 1e12:g} "
                f"TFLOP/s) | plain {plain:.3f} ms | SDPA{' (bool mask)' if win else ''} "
                f"{lib:.3f} ms")
            if tc:
                inst = wgmma_kernel_attrs(hd, causal and win > 0)
                log(f"    instance wgmma ({_attrs_str(inst)}) | kernel/SDPA {ms / lib:.2f}x | "
                    f"{100 * bound / ms:.1f}% of its bound ({ops / ms / 1e9:.1f} TFLOP/s)")
                if hd == 80:
                    # the earlier design: the CUDA-core kernel's bf16 instance,
                    # which flash_mha no longer reaches, called directly
                    simt = torch.empty_like(q)
                    flash_attention_cuda(q, k, v, simt, **kw)
                    compare(f"{name} CUDA-core instance (the earlier design)", simt, want,
                            HD80_BF16_TOL)
                    simt_ms = timer(lambda: flash_attention_cuda(q, k, v, simt, **kw))
                    log(f"    before (the CUDA-core bf16 instance, this run): {simt_ms:.3f} ms, "
                        f"{100 * bound / simt_ms:.1f}% of its bound; now "
                        f"{simt_ms / ms:.2f}x faster")
                    inst = dict(inst, earlier_design_ms=simt_ms)
                    del simt
            else:
                inst = dict(flash_kernel_attrs(hd, dt), design=SIMT_DESIGN)
                log(f"    instance {SIMT_DESIGN}, {inst['blocks_per_sm']} blocks an SM "
                    f"(occupancy calculator; {_attrs_str(inst)}) | kernel/SDPA "
                    f"{ms / lib:.2f}x | {100 * bound / ms:.1f}% of its bound "
                    f"({ops / ms / 1e9:.1f} TFLOP/s)")
                prev = BEFORE_MS.get(("flash_attention_fwd_serve", case, dn))
                if prev is not None:
                    log(f"    before (scalar design, serve instance): {prev:.3f} ms, "
                        f"{100 * bound / prev:.1f}% of its bound; now {prev / ms:.2f}x faster")
            rows[("flash", case, dn)] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bound,
                bound_by=by, library_ms=lib, **inst)
            del qt, kt, vt, want

    log("[kernels] ssm_scan vs plain")
    main_scan = [(4, 1152, 51200)]                 # hymba: [B, S, di * n]
    edge_scan = [(4, 2176, 51200), (37, 100), (1, 4097), (3, 45, 130),
                 (2, 1, 333), (1, 1, 1)]
    for dt in (torch.float32, torch.bfloat16):
        dn = str(dt).split(".")[1]
        for shape in main_scan + edge_scan:
            a = torch.sigmoid(randn(shape, torch.float32)).to(dt)
            b = randn(shape, dt)
            err = compare(f"ssm_scan {list(shape)} {dn}", ssm_scan_batched(a, b),
                          ssm_scan_ref(a, b), TOL[("ssm_scan", dn)])
            if shape not in main_scan:
                continue
            ms = timer(lambda: ssm_scan_batched(a, b))
            plain = timer(lambda: ssm_scan_ref(a, b))
            bound, by, byts, ops = scan_bound(*shape, a.element_size())
            log(f"    time {ms:.3f} ms | bound {bound:.3f} ms ({by}: "
                f"{byts / 1e9:.3f} GB, {ops / 1e9:.2f} GFLOP) | plain {plain:.3f} ms "
                f"| no single library call computes a linear recurrence")
            rows[("ssm_scan", shape, dn)] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bound,
                bound_by=by, library_ms=None)
            del a, b
    torch.cuda.empty_cache()

    log("[kernels] selective_scan vs plain")
    # the serve cell's per-layer shape (no carried state: a fresh prefill);
    # edge shapes ragged in S and di, n 8, a carried state, B and C at odd
    # offsets: (B, S, di, n, carried, dt_rank)
    main_sel = [SEL_MAIN + (False, 100)]
    edge_sel = [(2, 257, 333, 16, True, 3), (4, 130, 128, 8, True, 3),
                (1, 1, 16, 16, False, 4), (3, 9, 40, 16, True, 4)]
    slow = Timer(torch, reps=1)

    def chain(xc, dt, A, Bm, Cm, D, z, state):
        """What the kernel replaces: mamba_mix's chain around ssm_scan."""
        h = _ssm_states(xc, dt, Bm, A, state)
        y = torch.einsum("bsdn,bsn->bsd", h, Cm) + D * xc
        return (y * F.silu(z.float())).to(z.dtype), h[:, -1]

    with torch.no_grad():
        for dt in (torch.float32, torch.bfloat16):
            dn = str(dt).split(".")[1]
            for case in main_sel + edge_sel:
                ins = sel_scan_inputs(torch, gen, *case, dt)
                B, S, di, n = case[:4]
                before = selective_scan_fused.launches
                y, last = selective_scan_fused(*ins)
                if selective_scan_fused.launches != before + 1:
                    raise AssertionError(f"selective_scan {list(case[:4])}: no launch counted")
                want = selective_scan_fused_ref(*ins)
                name = f"selective_scan {list(case[:4])}{' carried' if case[4] else ''} {dn}"
                err = compare(name, y, want[0], TOL[("ssm_scan", dn)])
                err_last = compare(name + " last state", last, want[1],
                                   TOL[("ssm_scan", "float32")])
                if case not in main_sel:
                    continue
                tol = TOL[("ssm_scan", dn)]
                if dt == torch.float32:
                    # control: decay rates 1% off must fail the same check
                    off = selective_scan_fused_ref(ins[0], ins[1], ins[2] * 1.01, *ins[3:])[0]
                    bad = float((off - want[0]).abs().max())
                    if torch.allclose(off, want[0], rtol=tol, atol=tol):
                        raise AssertionError(f"{name}: A x 1.01 passes the check")
                    log(f"    control: A x 1.01 max_abs_err={bad:.3e} FAIL as it must")
                    del off
                ms = timer(lambda: selective_scan_fused(*ins))
                chain_ms = timer(lambda: chain(*ins))
                plain = slow(lambda: selective_scan_fused_ref(*ins))
                bound, by, byts, exps = sel_scan_bound(B, S, di, n, y.element_size())
                attrs = selective_scan_kernel_attrs(dt, n)
                log(f"    time {ms:.3f} ms | bound {bound:.3f} ms ({by}: {byts / 1e9:.3f} GB, "
                    f"{exps / 1e9:.2f} G exponentials) | chain (expand, ssm_scan, readout) "
                    f"{chain_ms:.3f} ms | plain {plain:.1f} ms | max |y| "
                    f"{float(want[0].float().abs().max()):.3g} | {attrs['registers']} "
                    f"registers/thread, {attrs['spill_bytes']} B spilled, "
                    f"{attrs['smem_bytes'] / 1024:.1f} KiB shared/block | "
                    f"{100 * bound / ms:.1f}% of its bound | no library call")
                rows[("selective_scan", case[:4], dn)] = dict(
                    max_abs_err=err, last_state_max_abs_err=err_last, ms=ms, plain_ms=plain,
                    bound_ms=bound, bound_by=by, library_ms=None, chain_ms=chain_ms, **attrs)
                del ins, y, last, want
                torch.cuda.empty_cache()
    return rows


def sel_scan_inputs(torch, gen, B, S, di, n, carried, dtr, dtype):
    """The fused scan's inputs as mamba_mix hands them over: xc after the
    conv and SiLU, dt after softplus, A = -exp(.), z the second half of a
    [B, S, 2di] product in ``dtype``, B and C slices of one [B, S, dtr + 2n]
    projection (``dtr`` sets their alignment), a carried state or None."""
    import torch.nn.functional as F

    def r(*shape):
        return torch.randn(*shape, device="cuda", generator=gen)

    xc = F.silu(r(B, S, di))
    dt = F.softplus(r(B, S, di) - 1.0)
    A = -torch.exp(0.5 * r(di, n))
    proj = r(B, S, dtr + 2 * n)
    z = r(B, S, 2 * di).to(dtype)[..., di:]
    return (xc, dt, A, proj[..., dtr:dtr + n], proj[..., dtr + n:], 1.0 + 0.1 * r(di), z,
            r(B, di, n) if carried else None)


def _flash_grads(torch, flash_mha, q, k, v, do, mask):
    """The forward under autograd (the instance that stores L) and the
    backward kernels: (out, dq, dk, dv) of fresh leaves."""
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    out = flash_mha(*leaves, **mask)
    return (out.detach(),) + tuple(torch.autograd.grad(out, leaves, do))


def _row_shards(torch, flash_mha, q, k, v, do, mask, offsets):
    """The rows of q in ROW_SHARDS shards, shard i run with q_off =
    offsets[i] against the whole K and V: the serve instance's rows, the
    autograd instance's rows and dQ (each in q's dtype, concatenated), and
    dK and dV summed over the shards in f32."""
    n = q.shape[1] // ROW_SHARDS
    serve, out, dq, dk, dv = [], [], [], 0.0, 0.0
    for i, off in enumerate(offsets):
        rows = slice(i * n, (i + 1) * n)
        with torch.no_grad():
            serve.append(flash_mha(q[:, rows], k, v, q_off=off, **mask))
        o, gq, gk, gv = _flash_grads(torch, flash_mha, q[:, rows], k, v, do[:, rows],
                                     dict(mask, q_off=off))
        out.append(o)
        dq.append(gq)
        dk, dv = dk + gk.float(), dv + gv.float()
    torch.cuda.synchronize()
    return dict(serve=torch.cat(serve, 1), out=torch.cat(out, 1), dq=torch.cat(dq, 1),
                dk=dk, dv=dv)


def _shard_readings(torch, got, want, dt, bits):
    """Each tensor of ``got`` against the unsplit call's: (max abs error,
    passed). Where ``bits`` names a tensor it must be the same bits; else
    the forward to phase 3's tolerance, the gradients to phase 7's (f32:
    BWD_TOL; bf16: max |err| within BWD_FLASH_BF16 of max |want|)."""
    res = {}
    for key, g in got.items():
        w = want[key]
        err = float((g.float() - w.float()).abs().max())
        if not bool(torch.isfinite(g).all()):
            ok = False
        elif key in bits:
            ok = bool(torch.equal(g, w))
        elif key in ("serve", "out"):
            ok = bool(torch.allclose(g.float(), w.float(), rtol=TOL[("flash", dt)],
                                     atol=TOL[("flash", dt)]))
        elif dt == "float32":
            ok = bool(torch.allclose(g.float(), w.float(), rtol=BWD_TOL[("flash", dt)],
                                     atol=BWD_TOL[("flash", dt)]))
        else:
            ok = err <= BWD_FLASH_BF16 * float(w.float().abs().max())
        res[key] = (err, ok)
    return res


def phase_row_offset(torch):
    """3b: the query row offset of the four flash kernels at full width.
    Each case's rows in ROW_SHARDS shards, each shard against the whole K
    and V with its first row as q_off: the serve instance's and the autograd
    instance's outputs and dQ must be the unsplit call's rows bit for bit
    where the shards' edges are multiples of the kernel's query tile (128
    rows on the tensor cores' forward, 64 on the CUDA cores' and in every
    backward), else within phase 3's and phase 7's tolerances; dK and dV
    summed over the shards within phase 7's. q_off = 0 on every shard must
    fail the check of a causal case, and change no bit of a non-causal one.
    The unsplit serve call and its shards are timed (CUDA events)."""
    from repro_torch.kernels.flash_attention.kernel import (SIMT_TILE, WGMMA_BLOCK_Q,
                                                            WGMMA_HEAD_DIMS)
    from repro_torch.kernels.flash_attention.ops import flash_mha

    timer = Timer(torch)
    gen = torch.Generator(device="cuda").manual_seed(26)
    t0 = time.perf_counter()
    for label, (B, S, H, KV, hd), causal, window, n_sink, dt in ROW_OFFSET_CASES:
        dtype = getattr(torch, dt)
        tc = dtype == torch.bfloat16 and hd in WGMMA_HEAD_DIMS
        q, do = (torch.randn(B, S, H, hd, generator=gen, device="cuda").to(dtype)
                 for _ in range(2))
        k, v = (torch.randn(B, S, KV, hd, generator=gen, device="cuda").to(dtype)
                for _ in range(2))
        mask = dict(causal=causal, window=window, n_sink=n_sink)
        with torch.no_grad():
            serve = flash_mha(q, k, v, **mask)
        out, dq, dk, dv = _flash_grads(torch, flash_mha, q, k, v, do, mask)
        want = dict(serve=serve, out=out, dq=dq, dk=dk, dv=dv)
        n = S // ROW_SHARDS
        offsets = [i * n for i in range(ROW_SHARDS)]
        bits = (("serve", "out") if n % (WGMMA_BLOCK_Q if tc else SIMT_TILE) == 0 else ()) + \
            (("dq",) if n % SIMT_TILE == 0 else ())
        name = (f"{label} {dt} {'wgmma' if tc else 'simt'} (B {B}, S {S} in {ROW_SHARDS} x {n} "
                f"rows, H {H}/{KV}, hd {hd}, causal {causal}, window {window}, sinks {n_sink})")
        got = _row_shards(torch, flash_mha, q, k, v, do, mask, offsets)
        res = _shard_readings(torch, got, want, dt, bits)
        log(f"[row_offset] {name}: " + ", ".join(
            f"{key} {err:.3e}{' (bits)' if key in bits else ''} {'ok' if ok else 'FAIL'}"
            for key, (err, ok) in res.items()))
        if not all(ok for _, ok in res.values()):
            raise AssertionError(f"row offset, {name}: a shard disagrees with the unsplit call")
        zero = _row_shards(torch, flash_mha, q, k, v, do, mask, [0] * ROW_SHARDS)
        if causal:
            wrong = _shard_readings(torch, zero, want, dt, bits)
            log(f"  q_off = 0 on every shard (must fail): " + ", ".join(
                f"{key} {err:.3e} {'ok' if ok else 'FAIL'}" for key, (err, ok) in wrong.items()))
            if wrong["out"][1] or wrong["dq"][1]:
                raise AssertionError(f"row offset, {name}: a wrong offset passes the check")
        else:
            same = all(torch.equal(zero[key], got[key]) for key in got)
            log(f"  non-causal: q_off = 0 on every shard gives the same bits: {same}")
            if not same:
                raise AssertionError(f"row offset, {name}: q_off changed a non-causal call")
        whole_ms = timer(lambda: flash_mha(q, k, v, **mask))
        shard_ms = [timer(lambda i=i: flash_mha(q[:, i * n:(i + 1) * n], k, v, q_off=i * n,
                                                **mask)) for i in range(ROW_SHARDS)]
        log(f"  serve instance, q_off 0, unsplit: {whole_ms:.4f} ms; shards at their q_off: "
            f"{', '.join(f'{t:.4f}' for t in shard_ms)} ms (sum {sum(shard_ms):.4f})")
        del q, k, v, do, serve, out, dq, dk, dv, want, got, zero
        torch.cuda.empty_cache()
    log(f"[row_offset] phase 3b: {time.perf_counter() - t0:.1f}s")


# phase 11: the port's programs captured as simulator workloads: the 1x1
# fixtures run on the card (fixture name -> rmsnorm, flash launches a run
# from path_counts), the generator's fake-CPU captures in a subprocess
CAPTURE = dict(card=("qwen2_1_5b_prefill", "qwen2_1_5b_decode"), seed=0, host_timeout=600)


def _capture_digest(tasks):
    """(structural hash of the lowered ops, SHA-256 of the fixture text)."""
    import hashlib

    from repro_torch.graph.capture import dumps
    from repro_torch.graph.ingest import lower_tasks

    return lower_tasks(tasks)[1].structural_hash, hashlib.sha256(dumps(tasks)).hexdigest()


def _first_difference(got, want) -> str:
    """Where two captures part: the first task that differs, as JSON rows."""
    from repro_torch.graph.capture import tasks_to_json

    got, want = tasks_to_json(got), tasks_to_json(want)
    for i, (a, b) in enumerate(zip(got, want)):
        if a != b:
            return f"task {i}: {a} against {b}"
    return f"{len(got)} tasks against {len(want)}"


def phase_capture(torch):
    """11. The 1x1 fixtures' programs on the card under the recorder, held
    to the checked-in fixtures and to fake-CPU captures of this run; the
    torch/ workloads through the simulator beside hlo/ and lm/."""
    import shutil
    import tempfile

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.graph import torch_ingest
    from repro_torch.graph.capture import TaskRecorder
    from repro_torch.graph.ingest import lower_tasks
    from repro_torch.launch.programs import build_program
    from repro_torch.models.layers import init_params
    from repro_torch.sweep.runner import run_campaign
    from repro_torch.sweep.spec import load_spec

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="captures_", dir=os.path.join(HERE, "build"))
    host = subprocess.Popen([sys.executable, os.path.join(HERE, "tools", "gen_torch_fixtures.py"),
                             "--out", tmp], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, cwd=HERE,
                            env=dict(os.environ, PYTHONPATH=os.path.join(HERE, "src")))
    try:
        fixtures = {c[0]: c for c in torch_ingest.CAPTURES}
        cfg = get_config(DENSE)
        (pf_norms, pf_flash), (dc_norms, _) = path_counts(cfg)
        want_counts = {"qwen2_1_5b_prefill": (pf_norms, pf_flash),
                       "qwen2_1_5b_decode": (dc_norms, 0)}
        card, failed = {}, []
        with one_rank_mesh(torch) as mesh:
            params = None
            for fx in CAPTURE["card"]:
                _, arch, seq, batch, kind, _, _ = fixtures[fx]
                prog = build_program(cfg, ShapeSpec(f"fx_{fx}", seq, batch, kind), mesh)
                if params is None:
                    gen = torch.Generator(device="cuda").manual_seed(CAPTURE["seed"])
                    params = init_params(prog.model.template(), gen, dtype=torch.bfloat16,
                                         device="cuda")
                rng = np.random.default_rng(CAPTURE["seed"])
                if kind == "prefill":
                    toks = rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32)
                    args = prog.place(params, {"tokens": torch.from_numpy(toks).cuda()})
                else:
                    toks = rng.integers(0, cfg.vocab_size, (batch, 1)).astype(np.int32)
                    cache = prog.model.init_cache(batch, seq, torch.bfloat16, "cuda")
                    args = prog.place(params, cache, torch.from_numpy(toks).cuda())
                torch.cuda.synchronize()
                _zero_counts()
                rec = TaskRecorder()
                t0 = time.perf_counter()
                with rec:
                    logits, _ = prog.fn(*args)
                torch.cuda.synchronize()
                secs = time.perf_counter() - t0
                counts = _read_counts()
                logits = logits.full_tensor() if hasattr(logits, "full_tensor") else logits
                norms, flash = want_counts[fx]
                got = (counts["rmsnorm"], counts["flash_attention"], counts["wgmma"])
                if got != (norms, flash, flash):
                    failed.append(f"{fx}: launches (rmsnorm, flash, wgmma) {got}, want "
                                  f"{(norms, flash, flash)}")
                if not bool(torch.isfinite(logits.float()).all()):
                    failed.append(f"{fx}: non-finite logits")
                _, rep = lower_tasks(rec.tasks)
                card[fx] = dict(tasks=rec.tasks, digest=_capture_digest(rec.tasks))
                log(f"[capture] {fx} on the card ({kind}, B {batch}, {seq}, bf16, full depth): "
                    f"{secs:.3f} s under the recorder, {len(rec.tasks)} tasks, {rep.n_layers} "
                    f"layer blocks of {rep.layer_ops}, mxu FLOPs {rep.mxu_flops:.6e}, HBM bytes "
                    f"{rep.hbm_bytes:.6e}; launches rmsnorm {got[0]}, flash {got[1]} "
                    f"(tensor cores {got[2]}); structural hash {card[fx]['digest'][0][:16]}")
                del args, logits, rec
            del params
        torch.cuda.empty_cache()
        stdout, stderr = host.communicate(timeout=CAPTURE["host_timeout"])
        if host.returncode != 0:
            raise AssertionError(f"gen_torch_fixtures.py failed: {stderr[-3000:]}")
        for fx in fixtures:
            fake = torch_ingest.load_tasks(fx, fixture_dir=tmp)
            fixed = torch_ingest.load_tasks(fx)
            fake_d, fixed_d = _capture_digest(fake), _capture_digest(fixed)
            if fake_d != fixed_d:
                failed.append(f"{fx}: the fake-CPU capture of this run is not the fixture "
                              f"({_first_difference(fake, fixed)})")
            if fx in card and card[fx]["digest"] != fixed_d:
                failed.append(f"{fx}: the card's capture is not the fixture "
                              f"({_first_difference(card[fx]['tasks'], fixed)})")
            log(f"[capture] {fx}: fixture {fixed_d[0][:16]}, fake-CPU capture of this run "
                f"{fake_d[0][:16]}" + (f", the card's {card[fx]['digest'][0][:16]}"
                                       if fx in card else " (host only: 1x2 fake group)"))
        if failed:
            raise AssertionError("; ".join(failed))
        t0 = time.perf_counter()
        spec = load_spec(os.path.join(torch_ingest.FIXTURE_DIR, "crosscheck.json"))
        res = run_campaign(spec, workers=0, use_cache=False, backend="inline")
        xck = res.summary.get("torch_crosscheck") or {}
        for r in res.records:
            log(f"[capture] simulator {r['workload']} at {r['overrides']}: analytic "
                f"{r['analytic_time_ns'] / 1e6:.4f} ms, FLOPs {r['total_flops']:.4e}, HBM bytes "
                f"{r['hbm_bytes']:.4e}")
        for fx in fixtures:
            s = xck.get(fx)
            if s is None or s["in_band"] != s["cells"]:
                raise AssertionError(f"torch/{fx} outside its band: {s}")
            log(f"[capture] torch/{fx}: {s['in_band']}/{s['cells']} cells in band {s['band']}, "
                f"analytic {s['analytic_ratio_min']:.4f}-{s['analytic_ratio_max']:.4f} of "
                f"{s['twin']}, {s['hlo_analytic_ratio_min']:.4f}-"
                f"{s['hlo_analytic_ratio_max']:.4f} of hlo/{fx} "
                f"[campaign {time.perf_counter() - t0:.1f}s]")
    finally:
        if host.poll() is None:
            host.kill()
            host.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"[capture] phase 11: {time.perf_counter() - t_phase:.1f}s")


def phase_examples(torch):
    """10: the port's examples on the card, each a subprocess that must exit
    0 (torch_quickstart.py, torch_serve_lm.py, torch_train_lm.py run to
    EXAMPLE_STEPS[0] steps and then again to EXAMPLE_STEPS[1], which must
    resume from the first run's last checkpoint and data cursor): wall time
    of each, and the train losses."""
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix="examples_", dir=os.path.join(HERE, "build"))
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
    first, last = EXAMPLE_STEPS
    ckpt = os.path.join(tmp, "ckpt")
    runs = [("torch_quickstart.py", []), ("torch_serve_lm.py", []),
            ("torch_train_lm.py", ["--steps", str(first), "--ckpt-dir", ckpt]),
            ("torch_train_lm.py", ["--steps", str(last), "--ckpt-dir", ckpt])]
    try:
        for script, extra in runs:
            t0 = time.perf_counter()
            r = subprocess.run([sys.executable, os.path.join(HERE, "examples", script)] + extra,
                               capture_output=True, text=True, timeout=EXAMPLE_TIMEOUT,
                               env=env, cwd=tmp)
            wall = time.perf_counter() - t0
            if r.returncode != 0:
                raise AssertionError(f"examples/{script} {' '.join(extra)} exited "
                                     f"{r.returncode}: {r.stdout[-2000:]} {r.stderr[-2000:]}")
            lines = r.stdout.splitlines()
            losses = [float(m.group(1)) for m in
                      (re.search(r"loss (\d+\.\d+)", ln) for ln in lines if "step" in ln) if m]
            log(f"[examples] {script} {' '.join(extra)}: exit 0, {wall:.1f} s"
                + (f"; losses {losses}" if losses else "") + f"; last line: {lines[-1]!r}")
            if script == "torch_train_lm.py" and extra[1] == str(last):
                want = f"[resume] restored step {first}, data cursor {first}"
                if want not in r.stdout:
                    raise AssertionError(f"examples/{script}: no '{want}' in {r.stdout[-2000:]}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _open_gates(params) -> None:
    """gate_attn = gate_ffn = 1 in every VLM group (they start at 0, and
    tanh(0) would hide the image path)."""
    for grp in params["segments"]:
        for g in ("gate_attn", "gate_ffn"):
            grp["cross"][g].fill_(1.0)


def _cut(cfg, key):
    """The config at PATHS[cfg.name][key] layers, where the path cuts depth."""
    import dataclasses

    n = PATHS[cfg.name].get(key)
    return dataclasses.replace(cfg, n_layers=n) if n else cfg


def phase_model(torch, arch):
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    import numpy as np

    t_phase = time.perf_counter()
    cfg = _cut(get_config(arch), "model_layers")
    model = build_model(cfg)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = model.init(gen, torch.float32, "cuda")
    if cfg.family == "audio":
        _encoder_check(torch, model, params, PATHS[arch]["model_B"], PATHS[arch]["model_S"],
                       t_phase)
        del params
        torch.cuda.empty_cache()
        return
    B, S, SMAX = (PATHS[arch][k] for k in ("model_B", "model_S", "model_smax"))
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (B, S + 2))).cuda()
    extra = {}
    if cfg.family == "vlm":
        _open_gates(params)
        extra["images"] = torch.randn((B, cfg.n_image_tokens, cfg.d_model), generator=gen,
                                      device="cuda")
    tol = 2e-3  # the bound of tests/test_models_smoke.py; paths differ in f32 sum order
    with torch.inference_mode():
        got = []
        lg, cache = model.prefill(params, {"tokens": toks[:, :S], **extra}, SMAX)
        got.append(lg)
        for n in (S, S + 1):
            lg, cache = model.decode_step(params, cache, toks[:, n:n + 1])
            got.append(lg)
        worst = 0.0
        for lg, n in zip(got, (S, S + 1, S + 2)):
            h = model.forward(params, {"tokens": toks[:, :n], **extra})
            want = model._logits(params, h[:, -1])
            if not bool(torch.isfinite(lg).all()) or lg.shape != (B, cfg.padded_vocab):
                raise AssertionError(f"bad logits at n={n}: {tuple(lg.shape)}")
            err = float((lg - want).abs().max())
            worst = max(worst, err)
            if not bool(torch.allclose(lg, want, rtol=tol, atol=tol)):
                raise AssertionError(f"decode != forward at n={n}: {err:.3e}")
        if cfg.family == "vlm":
            # tests/test_models_smoke.py::test_vlm_needs_images
            moved = model.forward(params, {"tokens": toks[:, :S],
                                           "images": extra["images"] + 1.0})
            delta = float((model.forward(params, {"tokens": toks[:, :S], **extra})
                           - moved).abs().max())
            log(f"[model] {cfg.name}: images + 1.0 move the output by {delta:.3e} (must "
                f"exceed 1e-3; gates opened)")
            if not delta > 1e-3:
                raise AssertionError("the image path does not reach the output")
    log(f"[model] {cfg.name} f32 L={cfg.n_layers} d={cfg.d_model} B={B}: prefill {S} "
        f"(+{cfg.n_meta_tokens} meta) + 2 decode steps match forward, "
        f"max_abs_err={worst:.3e} (tol {tol:g}) [{time.perf_counter() - t_phase:.1f}s]")
    del params, cache
    torch.cuda.empty_cache()


def _encoder_check(torch, model, params, B, T, t_phase):
    """The audio encoder in f32 at full depth: its forward with the kernels
    against the forward with the plain versions patched in (here, not by a
    switch in the package), within 2e-3 of max |h|; and 10.0 added to the
    last frame must move the first 4 outputs by more than 1e-4
    (tests/test_models_smoke.py::test_encoder_bidirectional)."""
    from repro_torch.kernels.flash_attention.ref import flash_mha_ref
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
    from repro_torch.models import attention as attention_mod
    from repro_torch.models import layers as layers_mod

    cfg = model.cfg
    gen = torch.Generator(device="cuda").manual_seed(3)
    frames = torch.randn((B, T, cfg.d_model), generator=gen, device="cuda")
    late = frames.clone()
    late[:, -1] += 10.0
    with torch.inference_mode():
        _zero_counts()
        h = model.forward(params, {"frames": frames})
        ran = _read_counts()
        h_late = model.forward(params, {"frames": late})
        saved = layers_mod.rmsnorm, attention_mod.flash_mha
        try:
            layers_mod.rmsnorm, attention_mod.flash_mha = rmsnorm_ref, flash_mha_ref
            _zero_counts()
            plain = model.forward(params, {"frames": frames})
            plain_ran = _read_counts()
        finally:
            layers_mod.rmsnorm, attention_mod.flash_mha = saved
    torch.cuda.synchronize()
    if not bool(torch.isfinite(h).all()) or h.shape != (B, T, cfg.d_model):
        raise AssertionError(f"bad encoder output {tuple(h.shape)}")
    err, top = float((h - plain).abs().max()), float(plain.abs().max())
    early = float((h - h_late)[:, :4].abs().max())
    log(f"[model] {cfg.name} f32 L={cfg.n_layers} d={cfg.d_model} B={B} T={T}: forward with "
        f"the kernels vs with the plain versions max_abs_err={err:.3e} (tol 2e-3 x max |h| = "
        f"{2e-3 * top:.3e}); the last frame + 10.0 moves the first 4 outputs by {early:.3e} "
        f"(must exceed 1e-4); launches {ran['rmsnorm']} rmsnorm, {ran['flash_attention']} "
        f"flash [{time.perf_counter() - t_phase:.1f}s]")
    (n_norms, n_flash), _ = path_counts(cfg)
    if ran["rmsnorm"] != n_norms or ran["flash_attention"] != n_flash or any(plain_ran.values()):
        raise AssertionError(f"kernel forward launched {ran}, plain forward {plain_ran}")
    if err > 2e-3 * top:
        raise AssertionError("the encoder with the kernels disagrees with the plain versions")
    if not early > 1e-4:
        raise AssertionError("a late frame does not reach the early outputs")


def path_counts(cfg):
    """Kernel launches the path implies: (rmsnorm, flash) a prefill and a
    decode step. ln1 + ln2 per attention layer (+ norm_attn, norm_ssm in a
    hybrid layer, + q_norm, k_norm under qk-norm); ln + norm_cell per mLSTM
    layer, + ln2 per sLSTM layer; ln1, q_norm, k_norm (prefill only: decode
    reads the cached image K) and ln2 per cross layer; audio's input norm;
    the final norm. Flash: one a layer at prefill (self and cross), and at
    decode one a cross layer (self decode attends the cache in plain torch)."""
    from repro_torch.models.model import plan_segments

    L = cfg.n_layers
    if cfg.family == "ssm":
        n_s = sum(g.n for g in plan_segments(cfg) if g.kind == "slstm")
        norms = 2 * (L - n_s) + 3 * n_s + 1
        return (norms, 0), (norms, 0)
    if cfg.family == "vlm":
        n_x = cfg.n_cross_layers
        n_self = L - n_x
        return ((2 * n_self + 4 * n_x + 1, L), (2 * n_self + 3 * n_x + 1, n_x))
    per = (2 + 2 * (cfg.family == "hybrid") + 2 * cfg.qk_norm) * L + 1
    return (per + (cfg.family == "audio"), L), (per, 0)


def phase_serve(torch, arch):
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.ops import flash_mha
    from repro_torch.kernels.rmsnorm.ops import rmsnorm
    from repro_torch.kernels.selective_scan.ops import selective_scan_fused
    from repro_torch.kernels.ssm_scan.ops import ssm_scan_batched
    from repro_torch.models import build_model
    from repro_torch.models.ssm import chunk_len
    from repro_torch.serve import ServeEngine

    t_phase = time.perf_counter()
    cfg = get_config(arch)
    path = PATHS[arch]
    model = build_model(cfg)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = model.init(gen, torch.bfloat16, "cuda")
    eng = ServeEngine(model, params, smax=path["smax"])
    rng = np.random.default_rng(0)
    lengths = rng.integers(path["lo"], path["hi"] + 1, 8)
    straggler = None
    max_new, deadline = path["max_new"], path["deadline"]
    for i, n in enumerate(lengths):
        rid = eng.submit(rng.integers(0, cfg.vocab_size, n), max_new=max_new,
                         deadline_steps=deadline if i == 2 else None)
        straggler = rid if i == 2 else straggler

    calls = {"prefill": [], "decode": []}
    padded = []

    def timed(kind, fn):
        def run(*args):
            if kind == "prefill":
                padded.append(int(args[1]["tokens"].shape[1]))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            calls[kind].append((time.perf_counter() - t0) * 1e3)
            return out
        return run

    eng.prefill_fn = timed("prefill", eng.prefill_fn)
    eng.decode_fn = timed("decode", eng.decode_fn)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rmsnorm.launches = 0
    flash_mha.launches = 0
    flash_mha.wgmma_launches = 0
    ssm_scan_batched.launches = 0
    selective_scan_fused.launches = 0
    t0 = time.perf_counter()
    out = eng.run(batch_size=4)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"rmsnorm": rmsnorm.launches, "flash_attention": flash_mha.launches,
                "ssm_scan": ssm_scan_batched.launches,
                "selective_scan": selective_scan_fused.launches}
    wgmma = flash_mha.wgmma_launches

    n_pf, n_dc = len(calls["prefill"]), len(calls["decode"])
    tokens = sum(len(v) for v in out.values())
    completed = len(eng.completed)
    log(f"[serve] {cfg.name} bf16 prompts {sorted(int(n) for n in lengths)}: "
        f"{completed} completed, {len(eng.evicted)} evicted {eng.evicted}, "
        f"{tokens} tokens in {wall:.2f}s ({tokens / wall:.1f} tok/s)")
    log(f"[serve] prefill {n_pf} calls, median {statistics.median(calls['prefill']):.1f} ms"
        f" per batch ({', '.join('%.1f' % t for t in calls['prefill'])}); decode "
        f"{n_dc} steps, median {statistics.median(calls['decode']):.2f} ms per step")
    if cfg.family == "ssm":
        log(f"[serve] padded S of each prefill batch and its mLSTM chunk length L: "
            + ", ".join(f"S {n} L {chunk_len(n)} ({n // chunk_len(n)} chunks, "
                        f"{t:.1f} ms)" for n, t in zip(padded, calls["prefill"])))
    peak = torch.cuda.max_memory_allocated()
    log(f"[serve] max_memory_allocated {peak / 2**30:.2f} GiB ({peak / 1e9:.2f} GB)")
    if peak >= CARD_BYTES:
        raise AssertionError(f"serve peak memory {peak / 1e9:.2f} GB >= {CARD_BYTES / 1e9:g} GB")
    hybrid = cfg.family == "hybrid"
    (per_step, fa_pf), _ = path_counts(cfg)
    want = {"rmsnorm": per_step * (n_pf + n_dc), "flash_attention": fa_pf * n_pf,
            "ssm_scan": 0, "selective_scan": cfg.n_layers * n_pf if hybrid else 0}
    if cfg.is_moe:
        log(f"[serve] MoE FFN: the dense oracle (every expert on every token, an "
            f"exact 0 weight where a token was not routed), {cfg.n_experts} experts, "
            f"top {cfg.experts_per_token}")
    log(f"[serve] launches: rmsnorm {launches['rmsnorm']} (want {per_step} x "
        f"{n_pf + n_dc}), flash_attention {launches['flash_attention']} (want "
        f"{fa_pf} x {n_pf}; tensor-core kernel {wgmma}), fused selective scan "
        f"{launches['selective_scan']} (want {want['selective_scan']}), ssm_scan "
        f"{launches['ssm_scan']} (want 0) "
        f"[{time.perf_counter() - t_phase:.1f}s]")
    for name, n in want.items():
        if launches[name] != n:
            raise AssertionError(f"{name} launches do not match the path")
    if wgmma != want["flash_attention"]:
        raise AssertionError("a bf16 flash launch of the serve path missed the "
                             "tensor-core kernel")
    if completed != 7 or eng.evicted != [straggler]:
        raise AssertionError("expected 7 completed and the straggler evicted")
    # the straggler runs out of its deadline twice (one retry)
    if len(out[straggler]) != 2 * deadline or tokens != 7 * max_new + 2 * deadline:
        raise AssertionError(f"unexpected token counts: {tokens}")
    if not all(0 <= t < cfg.vocab_size for v in out.values() for t in v):
        raise AssertionError("token outside the vocabulary")
    return launches, model, params


def phase_serve_vlm(torch):
    """The VLM in bf16 at full width and PATHS depth (4 of 20 groups), gates
    opened: Model.prefill of B=4 text prompts of 512-1024 tokens (left-padded
    with token 0, as the engine pads) with 1024 image tokens a row, then
    max_new greedy decode steps (the engine passes tokens only, in both
    packages, so the VLM has no engine path). Exact launches, every flash
    launch on the tensor cores, peak memory under 80 GB."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.train.optim import tree_leaves

    t_phase = time.perf_counter()
    path = PATHS[VLM]
    cfg = _cut(get_config(VLM), "serve_layers")
    model = build_model(cfg)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = model.init(gen, torch.bfloat16, "cuda")
    _open_gates(params)
    rng = np.random.default_rng(0)
    lengths = rng.integers(path["lo"], path["hi"] + 1, 4)
    S, steps = int(lengths.max()), path["max_new"]
    toks = np.zeros((4, S), np.int64)
    for i, n in enumerate(lengths):
        toks[i, S - n:] = rng.integers(0, cfg.vocab_size, n)
    batch = {"tokens": torch.from_numpy(toks).cuda(),
             "images": torch.randn((4, cfg.n_image_tokens, cfg.d_model), generator=gen,
                                   device="cuda").to(torch.bfloat16)}
    weights = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, out = [], []
    _zero_counts()
    with torch.inference_mode():
        t0 = time.perf_counter()
        lg, cache = model.prefill(params, batch, S + steps)
        torch.cuda.synchronize()
        pf = (time.perf_counter() - t0) * 1e3
        for _ in range(steps):
            nxt = lg.argmax(-1, keepdim=True)
            out.append(nxt)
            t0 = time.perf_counter()
            lg, cache = model.decode_step(params, cache, nxt)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
    ran = _read_counts()
    peak = torch.cuda.max_memory_allocated()
    (n_pf, fa_pf), (n_dc, fa_dc) = path_counts(cfg)
    want = {"rmsnorm": n_pf + steps * n_dc, "flash_attention": fa_pf + steps * fa_dc}
    toks_out = torch.cat(out, 1)
    log(f"[serve] {cfg.name} bf16 at {cfg.n_layers} of 100 layers ({cfg.n_self_layers} self "
        f"+ {cfg.n_cross_layers} cross; {weights / 1e9:.2f} GB of weights), gates opened, "
        f"prompts {sorted(int(n) for n in lengths)} padded to {S} + "
        f"{cfg.n_image_tokens} image tokens a row: prefill {pf:.1f} ms, {steps} decode steps "
        f"median {statistics.median(times):.2f} ms per step ({', '.join('%.1f' % t for t in times)})")
    log(f"[serve] max_memory_allocated {peak / 2**30:.2f} GiB ({peak / 1e9:.2f} GB)")
    log(f"[serve] launches: rmsnorm {ran['rmsnorm']} (want {n_pf} + {steps} x {n_dc}), "
        f"flash_attention {ran['flash_attention']} (want {fa_pf} + {steps} x {fa_dc}; "
        f"tensor-core kernel {ran['wgmma']}) [{time.perf_counter() - t_phase:.1f}s]")
    if peak >= CARD_BYTES:
        raise AssertionError(f"serve peak memory {peak / 1e9:.2f} GB >= {CARD_BYTES / 1e9:g} GB")
    for name, n in want.items():
        if ran[name] != n:
            raise AssertionError(f"{name} launches do not match the path")
    if ran["wgmma"] != want["flash_attention"]:
        raise AssertionError("a bf16 flash launch of the VLM missed the tensor-core kernel")
    if not bool(torch.isfinite(lg).all()) or not bool(((toks_out >= 0)
                                                       & (toks_out < cfg.vocab_size)).all()):
        raise AssertionError("non-finite logits or a token outside the vocabulary")
    launches = {"rmsnorm": ran["rmsnorm"], "flash_attention": ran["flash_attention"]}
    return launches, model, params


def phase_encode_audio(torch):
    """The audio encoder in bf16 at full width and depth: PATHS encodes of
    B=4 x T=1500 frames (30 s of audio at 20 ms a frame), each timed; exact
    launches, every flash launch on the tensor cores (hd 80)."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    t_phase = time.perf_counter()
    path = PATHS[AUDIO]
    cfg = get_config(AUDIO)
    model = build_model(cfg)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = model.init(gen, torch.bfloat16, "cuda")
    B, T, n = path["batch"], path["profile_S"], path["encodes"]
    frames = torch.randn((n, B, T, cfg.d_model), generator=gen, device="cuda").to(torch.bfloat16)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    _zero_counts()
    with torch.inference_mode():
        for i in range(n):
            t0 = time.perf_counter()
            h = model.forward(params, {"frames": frames[i]})
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            if not bool(torch.isfinite(h).all()) or h.shape != (B, T, cfg.d_model):
                raise AssertionError(f"bad encoder output {tuple(h.shape)}")
    ran = _read_counts()
    peak = torch.cuda.max_memory_allocated()
    (per, fa), _ = path_counts(cfg)
    log(f"[serve] {cfg.name} bf16 L={cfg.n_layers}: {n} encodes of B={B} x T={T} frames, "
        f"median {statistics.median(times):.1f} ms a batch ({', '.join('%.1f' % t for t in times)}); "
        f"max_memory_allocated {peak / 2**30:.2f} GiB")
    log(f"[serve] launches: rmsnorm {ran['rmsnorm']} (want {per} x {n}), flash_attention "
        f"{ran['flash_attention']} (want {fa} x {n}; tensor-core kernel {ran['wgmma']}, want "
        f"{fa * n}) [{time.perf_counter() - t_phase:.1f}s]")
    if ran["rmsnorm"] != per * n or not ran["flash_attention"] == ran["wgmma"] == fa * n:
        raise AssertionError("launches do not match the encoder path")
    launches = {"rmsnorm": ran["rmsnorm"], "flash_attention": ran["flash_attention"]}
    return launches, model, params


def _device_ms(torch, fn, steps: int, keys=("flash_attention",)):
    """Device kernel time per step (ms), kernels launched per step and the
    top kernels (and those whose name holds one of ``keys``, wherever they
    rank), from torch.profiler with CUDA activity only; None if it saw no
    kernel."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows, launched = [], 0
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0:
            rows.append((us / 1e3 / steps, e.key))
            launched += e.count
    if not rows:
        return None, 0, []
    rows.sort(reverse=True)
    shown = rows[:6] + [r for r in rows[6:] if any(k in r[1] for k in keys)]
    return sum(ms for ms, _ in rows), launched / steps, shown


def phase_profile(torch, model, params):
    """Wall time vs device busy time of one prefill (B=4, S=1024 prompt
    tokens; the VLM with 1024 image tokens a row) and of 8 decode steps
    after it, or of one encode (audio, B=4, T=1500 frames): where the
    serving time goes."""
    import numpy as np

    cfg = model.cfg
    path = PATHS[cfg.name]
    S = path["profile_S"]
    dt = params["final_norm"].dtype
    gen = torch.Generator(device="cuda").manual_seed(1)
    if cfg.family == "audio":
        batch = {"frames": torch.randn((4, S, cfg.d_model), generator=gen,
                                       device="cuda").to(dt)}
    else:
        batch = {"tokens": torch.from_numpy(np.random.default_rng(1).integers(
            0, cfg.vocab_size, (4, S))).cuda()}
    if cfg.family == "vlm":
        batch["images"] = torch.randn((4, cfg.n_image_tokens, cfg.d_model), generator=gen,
                                      device="cuda").to(dt)
    state = {}

    def prefill():
        state["lg"], state["cache"] = model.prefill(params, batch, path.get("smax", S + 16))

    def encode():
        state["h"] = model.forward(params, batch)

    def decode(steps=8):
        nxt = state["lg"].argmax(-1, keepdim=True)
        for _ in range(steps):
            lg, state["cache"] = model.decode_step(params, state["cache"], nxt)
            nxt = lg.argmax(-1, keepdim=True)

    runs = ([(f"{cfg.name} encode B=4 T={S}", encode, 1)] if cfg.family == "audio" else
            [(f"{cfg.name} prefill B=4 S={S}", prefill, 1),
             (f"{cfg.name} decode B=4 x8 steps", decode, 8)])
    with torch.inference_mode():
        for name, fn, steps in runs:
            fn()                                    # warm (and refill the cache)
            if fn is decode:
                prefill()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / steps
            if fn is decode:
                prefill()
            busy, kernels, top = _device_ms(torch, fn, steps)
            if busy is None:
                log(f"[profile] {name}: wall {wall:.2f} ms/step; device time not "
                    f"measured (the profiler saw no CUDA kernel)")
                continue
            flash = sum(ms for ms, key in top if "flash_attention" in key)
            log(f"[profile] {name}: wall {wall:.2f} ms/step, device busy "
                f"{busy:.2f} ms/step ({100 * busy / wall:.1f}% busy, "
                f"{100 - 100 * busy / wall:.1f}% idle), {kernels:.0f} kernels/step; "
                f"flash attention {flash:.2f} ms/step ({100 * flash / busy:.1f}% of busy)")
            for ms, key in top:
                log(f"    {ms:8.3f} ms {100 * ms / busy:5.1f}%  {key[:90]}")
        if cfg.family == "ssm":
            _chunk_cost(torch, model, params, batch["tokens"], path["smax"])


def _chunk_cost(torch, model, params, toks, smax):
    """What the reference's mLSTM chunk rule costs: a prefill at S 1024
    (L 256, 4 chunks) beside one at the prime S 1021 (L 1, 1021 chunks),
    both timed on the host clock after a warm call; the same prompt, cut."""
    from repro_torch.models.ssm import chunk_len

    got = []
    for S in (toks.shape[1], 1021):
        batch = {"tokens": toks[:, :S]}
        model.prefill(params, batch, smax)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.prefill(params, batch, smax)
        torch.cuda.synchronize()
        got.append(f"S {S} L {chunk_len(S)} ({S // chunk_len(S)} chunks) "
                   f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
    log(f"[profile] {model.cfg.name} prefill B=4 by the mLSTM chunk rule: " + "; ".join(got))


def _bwd_time(torch, timer, out, inputs, grad):
    """Median time of the backward alone: autograd.grad through a graph
    built once (retain_graph), for the plain version and the library call."""
    return timer(lambda: torch.autograd.grad(out, inputs, grad, retain_graph=True))


def _flash_bwd_dense(torch, q, k, v, do, kw, drop_d=False):
    """The attention backward written out in f32, P, dP and dS materialised
    (dS = P (dP - D), D = rowsum(dO O)); with drop_d, dS = P dP: a kernel
    that left out D."""
    from repro_torch.kernels.flash_attention.ref import visible

    B, S, H, hd = q.shape
    G = H // k.shape[2]
    scale = 1.0 / math.sqrt(hd)
    qf, df = (t.float().permute(0, 2, 1, 3) for t in (q, do))                 # [B,H,S,hd]
    kh, vh = (t.float().permute(0, 2, 1, 3).repeat_interleave(G, 1) for t in (k, v))
    idx = torch.arange(S, device=q.device)
    seen = visible(idx[:, None], idx[None, :], S, **kw)
    p = torch.softmax((qf @ kh.transpose(-1, -2) * scale).masked_fill(~seen, float("-inf")), -1)
    delta = 0.0 if drop_d else (df * (p @ vh)).sum(-1, keepdim=True)
    ds = p * (df @ vh.transpose(-1, -2) - delta)
    dq = ds @ kh * scale
    dk = (ds.transpose(-1, -2) @ qf * scale).unflatten(1, (-1, G)).sum(2)
    dv = (p.transpose(-1, -2) @ df).unflatten(1, (-1, G)).sum(2)
    return tuple(t.permute(0, 2, 1, 3) for t in (dq, dk, dv))


def _flash_hd80_share_check(torch, name, q, k, v, kw, got, want, faults):
    """bf16 flash forward at hd 80: max |got - want| within FWD_HD80_SHARE of
    max |want|. With ``faults`` (a non-causal call without window), beside
    it the readings of two wrong kernels made from the plain version on the
    same inputs, each of which must fail the limit: the scale 1/sqrt(64) in
    place of 1/sqrt(80), and the keys of the second 128-key tile dropped."""
    from repro_torch.kernels.flash_attention.ref import flash_mha_ref

    w = want.float()
    top = float(w.abs().max()) if w.numel() else 0.0
    if top == 0.0:                 # no key: compare() held the zeros exactly
        return

    def share(t):
        return float((t.float() - w).abs().max()) / top

    sound = share(got)
    ok = sound <= FWD_HD80_SHARE
    line = (f"  {name}: max|err| / max|want| {sound:.3e} (limit {FWD_HD80_SHARE:g}, "
            f"max|want| {top:.3e}) {'ok' if ok else 'FAIL'}")
    wrong = []
    if faults:
        assert not kw["causal"] and not kw["window"] and q.shape[1] > 256
        qf, kf, vf = (t.float() for t in (q, k, v))
        scale = share(flash_mha_ref(qf * math.sqrt(80 / 64), kf, vf, **kw))
        drop = torch.cat((kf[:, :128], kf[:, 256:]), 1), torch.cat((vf[:, :128], vf[:, 256:]), 1)
        dropped = share(flash_mha_ref(qf, *drop, **kw))
        wrong = [scale, dropped]
        line += f" | wrong kernels: scale 1/sqrt(64) {scale:.3e}, a key tile dropped {dropped:.3e}"
        del qf, kf, vf, drop
    log(line)
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    if any(r <= FWD_HD80_SHARE for r in wrong):
        raise AssertionError(f"{name}: the limit would pass a wrong kernel")


def _flash_bf16_check(torch, name, inputs, kw, grads) -> float:
    """bf16 flash backward: each of dQ, dK, dV within BWD_FLASH_BF16 of the
    max |want|, want the plain backward in f32 of the same bf16 inputs.
    Beside each reading, those of two wrong kernels on the same inputs (the
    kernel's gradient x 1.1; dS without D, which leaves dV alone), each of
    which must fail the limit, and of the written-out f32 backward that
    computes the second (a check of that harness). Returns the max abs
    error."""
    from repro_torch.kernels.flash_attention.ref import flash_mha_bwd_ref

    f32 = [t.float() for t in inputs]
    want = flash_mha_bwd_ref(*f32[:3], f32[3], **kw)
    dense = _flash_bwd_dense(torch, *f32, kw)
    no_d = _flash_bwd_dense(torch, *f32, kw, drop_d=True)
    torch.cuda.synchronize()
    worst = 0.0
    for g, got, w, t_dense, t_no_d in zip(("dQ", "dK", "dV"), grads, want, dense, no_d):
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{name} {g}: non-finite kernel output")
        top = float(w.abs().max())

        def share(t):
            return float((t.float() - w).abs().max()) / top

        sound, scaled, dropped, harness = (share(got), share(got.float() * 1.1),
                                           share(t_no_d), share(t_dense))
        ok = sound <= BWD_FLASH_BF16
        log(f"  {name} {g}: max|err| / max|want| {sound:.3e} (limit {BWD_FLASH_BF16:g}, "
            f"max|want| {top:.3e}) {'ok' if ok else 'FAIL'} | wrong kernels: x1.1 "
            f"{scaled:.3e}, dS without D {dropped:.3e} | f32 written-out backward {harness:.1e}")
        if harness > 1e-4:
            raise AssertionError(f"{name} {g}: the written-out backward disagrees with autograd")
        if not ok:
            raise AssertionError(f"{name} {g}: kernel disagrees with its plain version")
        if scaled <= BWD_FLASH_BF16 or (g != "dV" and dropped <= BWD_FLASH_BF16):
            raise AssertionError(f"{name} {g}: the limit would pass a wrong kernel")
        worst = max(worst, sound * top)
    del want, dense, no_d
    return worst


# the previous design's readings of the backward kernels (scalar, one warp a
# row; at HuBERT's hd 80 in bf16, the CUDA-core kernels that the tensor-core
# ones replaced), of the forward under autograd (then the serve instance) and
# of the f32 forward's serve instance (the scalar kernel, four threads a row,
# before the CUDA-core kernel's register tiles), as PERF.md §6 records them
# (NVIDIA H100 80GB HBM3, 700.00 W), printed beside this run's
BEFORE_MS = {("rmsnorm_bwd", (4096, 1536), "float32"): 0.07658,
           ("rmsnorm_bwd", (4096, 1536), "bfloat16"): 0.05462,
           ("rmsnorm_bwd", (49152, 128), "float32"): 0.05875,
           ("rmsnorm_bwd", (49152, 128), "bfloat16"): 0.05088,
           ("flash_attention_bwd", (4, 1024, 12, 2, 128, 0, 0), "float32"): 6.147,
           ("flash_attention_bwd", (4, 1024, 12, 2, 128, 0, 0), "bfloat16"): 6.075,
           ("flash_attention_bwd", (4, 1152, 25, 5, 64, 1024, 128), "float32"): 5.417,
           ("flash_attention_bwd", (4, 1152, 25, 5, 64, 1024, 128), "bfloat16"): 5.421,
           ("flash_attention_bwd", (4, 1500, 16, 16, 80, 0, 0), "bfloat16"): 5.995,
           ("flash_attention_fwd", (4, 1024, 12, 2, 128, 0, 0), "float32"): 1.577,
           ("flash_attention_fwd", (4, 1024, 12, 2, 128, 0, 0), "bfloat16"): 0.056,
           ("flash_attention_fwd", (4, 1152, 25, 5, 64, 1024, 128), "float32"): 1.576,
           ("flash_attention_fwd", (4, 1152, 25, 5, 64, 1024, 128), "bfloat16"): 0.098,
           ("flash_attention_fwd_serve", (4, 1024, 1024, 12, 2, 128, True, 0, 0),
            "float32"): 1.577,
           ("flash_attention_fwd_serve", (4, 1152, 1152, 25, 5, 64, True, 1024, 128),
            "float32"): 1.576,
           ("flash_attention_fwd_serve", (4, 2176, 2176, 25, 5, 64, True, 1024, 128),
            "float32"): 4.295}


def _attrs_str(a: dict) -> str:
    return (f"{a['registers']} registers/thread at launch, {a['spill_bytes']} B spilled, "
            f"{a['smem_bytes'] / 1024:.1f} KiB shared/block")


def train_kernels(torch):
    """The backward kernels at the train path's shapes, forward and backward
    through the wrappers against the plain versions' autograd on the card
    (and a second backward on the same inputs, which must give the same
    bits), then timed alone beside their bound, the plain version's backward
    and the library call's backward; the flash forward under autograd (the
    instance that stores L) timed alone beside the serve instance. Returns
    kernels-line rows."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.kernel import (
        SIMT_TILE, WGMMA_BWD_HEAD_DIMS, WGMMA_HEAD_DIMS, bwd_kernel_attrs, bwd_slots,
        flash_attention_bwd_cuda, flash_attention_cuda,
        flash_attention_wgmma_cuda, flash_kernel_attrs, lse_rows, wgmma_kernel_attrs)
    from repro_torch.kernels.flash_attention.ops import flash_mha
    from repro_torch.kernels.flash_attention.ref import (flash_mha_bwd_ref, flash_mha_bwd_tiled,
                                                         flash_mha_ref)
    from repro_torch.kernels.rmsnorm import kernel as rms_kernel
    from repro_torch.kernels.rmsnorm.ops import rmsnorm
    from repro_torch.kernels.rmsnorm.ref import BWD_VARIANTS, rmsnorm_bwd_ref, rmsnorm_ref

    gen = torch.Generator(device="cuda").manual_seed(1)
    timer = Timer(torch)
    rows = {}
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count

    def randn(shape, dt, scale=1.0, shift=0.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale + shift).to(dt)

    def same_bits(what, first, again):
        if not all(torch.equal(a, b) for a, b in zip(first, again)):
            raise AssertionError(f"{what}: two backward calls on the same inputs differ")

    log("[train] rmsnorm backward vs plain (dx, dw)")
    # qwen2 at B 4, S 1024: ln1/ln2/final rows, and the [B*S*H, hd] rows of
    # a qk-norm model; hymba at B 4, S 1024 + 128 meta tokens; HuBERT at B 4,
    # T 1500; xlstm-125m at B 4, S 1024
    for shape in ((4 * 1024, 1536), (4 * 1024 * 12, 128), (4 * 1152, 1600), (4 * 1500, 1280),
                  (4 * 1024, 768)):
        for dt in (torch.float32, torch.bfloat16):
            dn = str(dt).split(".")[1]
            x, w, g = randn(shape, dt), randn(shape[-1:], dt, 0.1, 1.0), randn(shape, dt)
            xr, wr = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
            before = rmsnorm.bwd_launches
            rmsnorm(xr, wr, 1e-6).backward(g)
            if rmsnorm.bwd_launches != before + 1:
                raise AssertionError(f"rmsnorm backward {list(shape)}: no launch counted")
            want = rmsnorm_bwd_ref(x, w, g, 1e-6)
            tol = BWD_TOL[("rmsnorm", dn)]
            err = max(compare(f"rmsnorm_bwd {list(shape)} {dn} dx", xr.grad, want[0], tol),
                      compare(f"rmsnorm_bwd {list(shape)} {dn} dw", wr.grad, want[1], tol))
            first = xr.grad.clone(), wr.grad.clone()
            xr.grad = wr.grad = None
            rmsnorm(xr, wr, 1e-6).backward(g)
            same_bits(f"rmsnorm_bwd {list(shape)} {dn}", first, (xr.grad, wr.grad))
            dx, dw = torch.empty_like(x), torch.empty_like(w)
            rows_, d = shape
            code = 0 if dt == torch.float32 else 1
            blocks = rms_kernel.bwd_blocks(rows_, 0)
            plan = rms_kernel.bwd_kernel_plan(rows_, d, dt, True, blocks)
            attrs = rms_kernel.bwd_kernel_attrs(plan, dt)
            ms = timer(lambda: rms_kernel.rmsnorm_bwd_cuda(x, w, g, dx, dw, rows_, d, 1e-6,
                                                           code))
            # the partial rows' count: the wrapper's one block an SM, against
            # two (timed, not on the path)
            two = rms_kernel.bwd_kernel_plan(rows_, d, dt, True, min(rows_, 2 * n_sm))
            ms_two = timer(lambda: rms_kernel.rmsnorm_bwd_cuda(x, w, g, dx, dw, rows_, d, 1e-6,
                                                               code, blocks=2 * n_sm))
            xp, wp = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
            plain = _bwd_time(torch, timer, rmsnorm_ref(xp, wp, 1e-6), (xp, wp), g)
            yl = F.rms_norm(xp, (d,), wp, 1e-6)
            lib = _bwd_time(torch, timer, yl, (xp, wp), g)
            bound, by, byts, ops = rms_bwd_bound(rows_, d, x.element_size())
            extra = 2 * plan.blocks * d * 4      # the partial rows, written and read
            prev = BEFORE_MS.get(("rmsnorm_bwd", shape, dn))
            log(f"    plan {BWD_VARIANTS[plan.variant]}: {plan.tpr} lanes a row, {plan.vpt} "
                f"loads of {plan.vec} a lane, {plan.blocks} blocks ({_attrs_str(attrs)})")
            log(f"    time {ms * 1e3:.2f} us"
                + (f" (before: {prev * 1e3:.2f} us)" if prev else "") + " | bound "
                f"{bound * 1e3:.2f} us ({by}: {byts / 1e6:.2f} MB, {ops / 1e6:.1f} MFLOP) | "
                f"design overhead: {plan.blocks} dw partial rows, {extra / 1e6:.2f} MB, "
                f"{extra / HBM_BYTES_PER_S * 1e6:.2f} us | with {two.blocks} blocks "
                f"{ms_two * 1e3:.2f} us | plain backward {plain * 1e3:.1f} us | F.rms_norm "
                f"backward {lib * 1e3:.2f} us | {100 * bound / ms:.1f}% of its bound, "
                f"kernel/library {ms / lib:.2f}x")
            rows[("rmsnorm_bwd", shape, dn)] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bound, bound_by=by,
                library_ms=lib, **attrs)
            del x, w, g, xr, wr, xp, wp, yl, dx, dw, want, first

    log("[train] flash attention backward vs plain (dQ, dK, dV)")
    # (B, S, H, KV, hd, window, n_sink), causal: qwen2; hymba's window and
    # sinks; HuBERT's non-causal hd 80 (bf16: forward and backward on the
    # tensor cores; f32 on the CUDA cores); the VLM's self and cross attention at full width (text
    # queries over its 1024 image tokens)
    names = ("launches", "wgmma_launches", "bwd_launches", "wgmma_bwd_launches")
    for case, causal in FLASH_BWD_CASES:
        B, S, H, KV, hd, win, ns = case
        kw = dict(causal=causal, window=win, n_sink=ns)
        for dt in (torch.float32, torch.bfloat16):
            dn = str(dt).split(".")[1]
            tc = dt == torch.bfloat16 and hd in WGMMA_BWD_HEAD_DIMS
            tc_fwd = dt == torch.bfloat16 and hd in WGMMA_HEAD_DIMS
            q, k, v = randn((B, S, H, hd), dt), randn((B, S, KV, hd), dt), randn((B, S, KV, hd), dt)
            do = randn((B, S, H, hd), dt)
            qr, kr, vr = (t.clone().requires_grad_(True) for t in (q, k, v))
            before = [getattr(flash_mha, n) for n in names]
            out = flash_mha(qr, kr, vr, **kw)
            out.backward(do)
            rose = [getattr(flash_mha, n) - b for n, b in zip(names, before)]
            if rose != [1, int(tc_fwd), 1, int(tc)]:
                raise AssertionError(f"flash {case} {dn}: counts {names} rose by {rose}")
            name = (f"flash_bwd B={B} S={S} H={H} KV={KV} hd={hd} "
                    f"{'causal' if causal else 'full'} window={win} sinks={ns} {dn}")
            grads = (qr.grad, kr.grad, vr.grad)
            if dt == torch.float32:
                want = flash_mha_bwd_ref(q, k, v, do, **kw)
                err = max(compare(f"{name} {g}", got, w, BWD_TOL[("flash", dn)])
                          for g, got, w in zip(("dQ", "dK", "dV"), grads, want))
                del want
            else:
                err = _flash_bf16_check(torch, name, (q, k, v, do), kw, grads)
            first = tuple(t.clone() for t in grads)
            qr.grad = kr.grad = vr.grad = None
            flash_mha(qr, kr, vr, **kw).backward(do)
            same_bits(name, first, (qr.grad, kr.grad, vr.grad))
            # the forward under autograd (stores L) and the serve instance,
            # then the backward, each alone
            fwd = flash_attention_wgmma_cuda if tc_fwd else flash_attention_cuda
            o, o2 = torch.empty_like(q), torch.empty_like(q)
            lse = torch.empty((B * H, lse_rows(S)), dtype=torch.float32, device="cuda")
            fwd_ms = timer(lambda: fwd(q, k, v, o, lse=lse, **kw))
            serve_ms = timer(lambda: fwd(q, k, v, o2, **kw))
            if not torch.equal(o, o2):
                raise AssertionError(f"{name}: the forward that stores L changed the output")
            if hd == 80 or tc:
                # the kernels against their twin on the same output (bf16: P
                # and dS rounded as the tensor cores take them; f32: kept in
                # f32, as on the CUDA cores), the twin with its own L and
                # with the kernel's: what rounding of L moves (held at hd 80,
                # logged at hd 64/128)
                own = flash_mha_bwd_tiled(q, k, v, out.detach(), do, tensor_cores=tc, **kw)
                kl = (flash_mha_bwd_tiled(q, k, v, out.detach(), do, tensor_cores=tc,
                                          lse=lse.view(B, H, -1)[:, :, :S], **kw) if tc
                      else own)
                # at hd 80 in bf16, the twin itself against the f32 plain
                # backward: how far P's bf16 rounding alone moves each gradient
                exact = (flash_mha_bwd_ref(q.float(), k.float(), v.float(), do.float(), **kw)
                         if tc and hd == 80 else own)
                for g, got, w, w_kl, w_x in zip(("dQ", "dK", "dV"), grads, own, kl, exact):
                    if dt == torch.float32:
                        compare(f"{name} {g} vs its tile twin", got, w, BWD_TOL[("flash", dn)])
                        continue
                    share, share_kl = (float((got.float() - t.float()).abs().max()
                                             / t.float().abs().max()) for t in (w, w_kl))
                    ok = max(share, share_kl) <= TWIN_TOL or hd != 80
                    log(f"  {name} {g} vs its tile twin: max|err| / max|want| {share:.3e}, "
                        f"the twin on the kernel's L {share_kl:.3e}"
                        + (f" (limit {TWIN_TOL:g}) {'ok' if ok else 'FAIL'}; the twin vs the "
                           f"f32 plain backward "
                           f"{float((w.float() - w_x).abs().max() / w_x.abs().max()):.3e}"
                           if hd == 80 else " (logged)"))
                    if not ok:
                        raise AssertionError(f"{name} {g}: kernel disagrees with its tile twin")
                del own, kl, exact
            dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)

            def bwd():
                flash_attention_bwd_cuda(q, k, v, o, do, lse, dq, dk, dv, **kw)

            ms = timer(bwd)
            # where the backward's time goes: its kernels by name (profiler,
            # 5 calls back to back, L2 warm)
            busy, _, top = _device_ms(torch, lambda: [bwd() for _ in range(5)], 5,
                                      keys=("fa_bwd",))
            split = ("; ".join(f"{re.search(r'fa_bwd_[a-z_]+', key).group(0)} {t * 1e3:.1f} us"
                               for t, key in top if "fa_bwd" in key)
                     if busy is not None else "not measured (the profiler saw no kernel)")
            qp, kp, vp = (t.clone().requires_grad_(True) for t in (q, k, v))
            plain = _bwd_time(torch, timer, flash_mha_ref(qp, kp, vp, **kw), (qp, kp, vp), do)
            qt, kt, vt = (t.detach().transpose(1, 2).contiguous().requires_grad_(True)
                          for t in (q, k, v))
            if win:
                r = torch.arange(S, device="cuda")[:, None]
                c = torch.arange(S, device="cuda")[None, :]
                mask = (c <= r) & ((c > r - win) | (c < ns))
                yl = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, enable_gqa=True)
            else:
                yl = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                                    enable_gqa=True)
            lib = _bwd_time(torch, timer, yl, (qt, kt, vt), do.transpose(1, 2).contiguous())
            peak = BF16_FLOPS if dt == torch.bfloat16 else F32_FLOPS
            bound, by, byts, ops = flash_bwd_bound(B, S, H, KV, hd, causal, q.element_size(),
                                                   peak, win, ns)
            prev = BEFORE_MS.get(("flash_attention_bwd", case, dn))
            prev_fwd = BEFORE_MS.get(("flash_attention_fwd", case, dn))
            attrs = {kn: bwd_kernel_attrs(kn, hd, dt) for kn in ("dkdv", "dq")}
            # waves: the blocks of a launch over the blocks the card holds at once
            blocks = {"dkdv": bwd_slots(S, S, H, KV, **kw) * B * KV,
                      "dq": B * H * -(-S // SIMT_TILE)}
            waves = {kn: blocks[kn] / (attrs[kn]["blocks_per_sm"] * n_sm) for kn in blocks}
            log(f"    {'tensor-core (wgmma)' if tc else 'CUDA-core (SIMT)'} kernels: dK/dV "
                f"{_attrs_str(attrs['dkdv'])}; dQ {_attrs_str(attrs['dq'])}"
                + "; forward that stores L "
                + ("(wgmma) " + _attrs_str(wgmma_kernel_attrs(hd, win > 0, True)) if tc_fwd
                   else "(SIMT) " + _attrs_str(flash_kernel_attrs(hd, dt, True))))
            log("    waves: " + "; ".join(
                f"{'dK/dV' if kn == 'dkdv' else 'dQ'} {blocks[kn]} blocks at "
                f"{attrs[kn]['blocks_per_sm']} an SM over {n_sm} SMs, {waves[kn]:.2f}"
                for kn in blocks))
            log(f"    backward {ms:.3f} ms"
                + (f" (before: {prev:.3f} ms, {prev / ms:.1f}x)" if prev else "") + " | bound "
                f"{bound * 1e3:.2f} us ({by}: the function's 5 products, {byts / 1e6:.2f} MB, "
                f"{ops / 1e9:.2f} GFLOP at {peak / 1e12:g} TFLOP/s; the kernels compute 7, "
                f"{ops * 1.4 / 1e9:.2f} GFLOP, {bound * 1.4e3:.2f} us) | plain backward "
                f"{plain:.3f} ms | SDPA{' (bool mask)' if win else ''} backward {lib:.3f} ms | "
                f"{100 * bound / ms:.1f}% of its bound, kernel/SDPA {ms / lib:.2f}x")
            log(f"    backward by kernel (profiler, L2 warm): {split}")
            prev_serve = BEFORE_MS.get(("flash_attention_fwd_serve",
                                        (B, S, S, H, KV, hd, causal, win, ns), dn))
            log(f"    forward under autograd (stores L) {fwd_ms:.3f} ms, serve instance "
                f"{serve_ms:.3f} ms, the same bits | forward + backward {fwd_ms + ms:.3f} ms"
                + (f" (before: the forward under autograd {prev_fwd:.3f} ms"
                   + (f", the serve instance {prev_serve:.3f} ms" if prev_serve else "")
                   + f"; forward + backward {prev_fwd + prev:.3f} ms)" if prev_fwd else ""))
            rows[("flash_attention_bwd", case + (causal,), dn)] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bound, bound_by=by,
                library_ms=lib, forward_autograd_ms=fwd_ms, forward_serve_ms=serve_ms,
                **{f"{kn}_waves": w for kn, w in waves.items()},
                **{f"{kn}_{key}": val for kn, a in attrs.items() for key, val in a.items()})
            del q, k, v, do, qr, kr, vr, out, o, o2, lse, dq, dk, dv, qp, kp, vp, qt, kt, vt
            del yl, grads, first
    torch.cuda.empty_cache()
    rows.update(scan_backward(torch, timer, randn))
    return rows


def scan_backward(torch, timer, randn):
    """The ssm_scan backward kernel through the wrapper's autograd against
    the plain reverse scan on the card, in f32 and bf16 at hymba's train
    shape and at ragged ones; a second backward must give the same bits. At
    the main shape (f32) the kernel alone is timed (median of 25, L2
    flushed) beside its bound, the plain reverse scan and autograd through
    the plain forward (each one run after a warm-up: a loop over S on the
    host, thousands of times slower than the kernel); no single PyTorch
    call computes it. Returns kernels-line rows."""
    from repro_torch.kernels.ssm_scan.kernel import scan_kernel_attrs, ssm_scan_bwd_cuda
    from repro_torch.kernels.ssm_scan.ops import ssm_scan_batched
    from repro_torch.kernels.ssm_scan.ref import ssm_scan_bwd_ref, ssm_scan_ref

    slow = Timer(torch, reps=1)
    rows = {}
    log("[train] ssm_scan backward vs plain (da, db)")
    for shape in (SCAN_MAIN, (37, 100), (1, 4097), (3, 45, 130), (2, 1, 333), (1, 1, 1)):
        for dt in (torch.float32, torch.bfloat16):
            dn = str(dt).split(".")[1]
            a = torch.sigmoid(randn(shape, torch.float32)).to(dt)
            b, g = randn(shape, dt), randn(shape, dt)
            ar, br = a.clone().requires_grad_(True), b.clone().requires_grad_(True)
            before = ssm_scan_batched.launches, ssm_scan_batched.bwd_launches
            ssm_scan_batched(ar, br).backward(g)
            if (ssm_scan_batched.launches - before[0],
                    ssm_scan_batched.bwd_launches - before[1]) != (1, 1):
                raise AssertionError(f"ssm_scan_bwd {list(shape)} {dn}: launches not counted")
            h = ssm_scan_ref(a, b)
            want = ssm_scan_bwd_ref(a, h, g)
            tol = TOL[("ssm_scan", dn)]
            err = max(compare(f"ssm_scan_bwd {list(shape)} {dn} {n}", got, w, tol)
                      for n, got, w in zip(("da", "db"), (ar.grad, br.grad), want))
            first = ar.grad.clone(), br.grad.clone()
            ar.grad = br.grad = None
            ssm_scan_batched(ar, br).backward(g)
            if not (torch.equal(ar.grad, first[0]) and torch.equal(br.grad, first[1])):
                raise AssertionError(f"ssm_scan_bwd {list(shape)} {dn}: two backward calls "
                                     f"on the same inputs differ")
            if shape != SCAN_MAIN or dt != torch.float32:
                del a, b, g, ar, br, h, want, first
                continue
            da, db = torch.empty_like(a), torch.empty_like(a)
            ms = timer(lambda: ssm_scan_bwd_cuda(a, h, g, da, db))
            fwd_ms = timer(lambda: ssm_scan_batched(a, b))
            plain = slow(lambda: ssm_scan_bwd_ref(a, h, g))
            ap, bp = a.clone().requires_grad_(True), b.clone().requires_grad_(True)
            autograd_plain = _bwd_time(torch, slow, ssm_scan_ref(ap, bp), (ap, bp), g)
            bound, by, byts, ops = scan_bwd_bound(*shape, a.element_size())
            attrs = scan_kernel_attrs(dt, True)
            log(f"    backward {ms:.3f} ms | bound {bound:.3f} ms ({by}: {byts / 1e9:.3f} GB, "
                f"{ops / 1e9:.2f} GFLOP), {100 * bound / ms:.1f}% of it | plain reverse scan "
                f"{plain:.3f} ms | autograd through the plain forward {autograd_plain:.3f} ms | "
                f"library: none (no single PyTorch call computes a linear recurrence's "
                f"gradient) | forward {fwd_ms:.3f} ms")
            log(f"    backward kernel {_attrs_str(attrs)}; forward kernel "
                f"{_attrs_str(scan_kernel_attrs(dt, False))}")
            rows[("ssm_scan_bwd", shape, dn)] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bound, bound_by=by,
                library_ms=None, autograd_plain_ms=autograd_plain, **attrs)
            del a, b, g, ar, br, h, want, first, da, db, ap, bp
    torch.cuda.empty_cache()
    return rows


def _zero_counts():
    from repro_torch.kernels.flash_attention.ops import flash_mha
    from repro_torch.kernels.rmsnorm.ops import rmsnorm
    from repro_torch.kernels.selective_scan.ops import selective_scan_fused
    from repro_torch.kernels.ssm_scan.ops import ssm_scan_batched

    rmsnorm.launches = rmsnorm.bwd_launches = 0
    flash_mha.launches = flash_mha.wgmma_launches = flash_mha.bwd_launches = 0
    flash_mha.wgmma_bwd_launches = 0
    ssm_scan_batched.launches = ssm_scan_batched.bwd_launches = 0
    selective_scan_fused.launches = 0


def _read_counts() -> dict:
    from repro_torch.kernels.flash_attention.ops import flash_mha
    from repro_torch.kernels.rmsnorm.ops import rmsnorm
    from repro_torch.kernels.selective_scan.ops import selective_scan_fused
    from repro_torch.kernels.ssm_scan.ops import ssm_scan_batched

    return {"rmsnorm": rmsnorm.launches, "rmsnorm_bwd": rmsnorm.bwd_launches,
            "flash_attention": flash_mha.launches, "flash_attention_bwd": flash_mha.bwd_launches,
            "wgmma": flash_mha.wgmma_launches, "wgmma_bwd": flash_mha.wgmma_bwd_launches,
            "ssm_scan": ssm_scan_batched.launches,
            "ssm_scan_bwd": ssm_scan_batched.bwd_launches,
            "selective_scan": selective_scan_fused.launches}


def _check_run(history, what):
    for i, rec in enumerate(history):
        if not all(math.isfinite(rec[k]) for k in ("loss", "grad_norm", "lr")):
            raise AssertionError(f"{what}: non-finite metrics at step {i}: {rec}")
        if rec["grad_norm"] <= 0:
            raise AssertionError(f"{what}: grad_norm {rec['grad_norm']} at step {i}")
    if len(history) > 1 and history[0]["loss"] == history[1]["loss"]:
        raise AssertionError(f"{what}: the loss did not change from step 1 to step 2")


def _train_full(torch, arch, per_step, steps, B, S, dtype, rule, layers=None):
    """launch/train.py::train for ``arch`` (remat "full"; ``layers``: its
    depth cut to that many layers), every kernel's count zeroed just before
    and held to ``per_step`` x steps just after (a kernel it leaves out must
    not launch); the losses, grad norms, ms per step and peak memory are
    logged. Returns the trained state and the run's launches and
    numbers."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch.train import train

    cfg = get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    dn = str(dtype).split(".")[1]
    # the earlier phases leave hundreds of thousands of Python objects
    # (campaign records, profiler events): a full collection over them is
    # slow and would land inside a timed step, so collect them now and
    # exempt the survivors from later collections
    gc.collect()
    gc.freeze()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    state, history = train(arch, steps=steps, batch=B, seq=S, layers=layers, dtype=dtype,
                           log_every=1, device="cuda")
    torch.cuda.synchronize()
    launches = _read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    _check_run(history, f"{cfg.name} {dn}")
    step_ms = [1e3 * h["step_s"] for h in history]
    med = statistics.median(step_ms[1:])
    M = cfg.n_meta_tokens
    log(f"[train] {cfg.name} {dn} L={cfg.n_layers} d={cfg.d_model} B={B} S={S}"
        + (f" (+{M} meta tokens)" if M else "") + ", remat full: losses "
        + ", ".join(f"{h['loss']:.4f}" for h in history) + "; grad norms "
        + ", ".join(f"{h['grad_norm']:.3f}" for h in history))
    log(f"[train] ms per step {', '.join(f'{t:.1f}' for t in step_ms)} (median of steps 2-"
        f"{steps}: {med:.1f} ms, {B * S / med * 1e3:,.0f} tok/s); "
        f"max_memory_allocated {peak:.2f} GiB")
    want = {k: per_step.get(k, 0) * steps for k in launches}
    log(f"[train] launches: " + ", ".join(f"{k} {launches[k]} (want {per_step.get(k, 0)} x "
                                          f"{steps})" for k in launches if want[k] or launches[k])
        + f"; per step {rule} at L={cfg.n_layers}")
    if launches != want:
        raise AssertionError(f"{cfg.name} {dn} train: launches {launches}, want {want}")
    return state, dict(launches=launches, step_ms=step_ms, peak_gib=peak,
                       losses=[h["loss"] for h in history])


def phase_train(torch):
    """The dense train path at full width: launch/train.py::train for
    qwen2-1.5b, f32 (the launcher's default), remat "full", B 4, S 1024, 4
    steps with exact counts and one profiled step; then 3 bf16 steps with
    the same counts, whose flash forwards and backwards must all be
    tensor-core launches, and one profiled bf16 step. Returns the two runs'
    launches and numbers."""
    from repro_torch.configs import get_config

    cfg = get_config(TRAIN["arch"])
    L, steps, n16 = cfg.n_layers, TRAIN["steps"], TRAIN["bf16_steps"]
    B, S = TRAIN["batch"], TRAIN["seq"]
    # per step: the forward runs ln1, ln2 per layer and the final norm and one
    # attention per layer; remat "full" recomputes each layer's forward once
    # in the backward (the final norm sits outside the layers and is not
    # recomputed); the backward runs each norm's and attention's once
    per_step = {"rmsnorm": 2 * L + 1 + 2 * L, "rmsnorm_bwd": 2 * L + 1,
                "flash_attention": 2 * L, "flash_attention_bwd": L}
    rule = "rmsnorm 4L+1, rmsnorm_bwd 2L+1, flash 2L, flash_bwd L"
    state, f32 = _train_full(torch, DENSE, per_step, steps, B, S, torch.float32, rule)
    _profile_train_step(torch, cfg, state, B, S, "f32", steps)
    del state
    torch.cuda.empty_cache()
    # bf16 (init_state's default): every flash forward and backward on the
    # tensor cores
    state, b16 = _train_full(torch, DENSE, dict(per_step, wgmma=2 * L, wgmma_bwd=L), n16, B, S,
                             torch.bfloat16, rule + ", every flash launch on the tensor cores")
    _profile_train_step(torch, cfg, state, B, S, "bf16", n16)
    del state
    gc.unfreeze()
    torch.cuda.empty_cache()
    return f32, b16


def _profile_train_step(torch, cfg, state, B, S, dtype_name, steps_done):
    """One more step on the trained state under torch.profiler: where a
    step's time goes, by kernel."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.models import build_model
    from repro_torch.train import SyntheticData, make_train_step, schedule_for

    model = build_model(cfg)
    step_fn = make_train_step(model, lr_schedule=schedule_for(cfg, 3e-4, 1, steps_done))
    data = SyntheticData(cfg, ShapeSpec("cli", S, B, "train"), seed=0, device="cuda")
    batch = data.batch_at(steps_done)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    busy, kernels, top = _device_ms(torch, lambda: step_fn(state, batch), 1,
                                    keys=("fa_bwd", "flash_attention", "rmsnorm", "ssm_scan"))
    wall = (time.perf_counter() - t0) * 1e3
    if busy is None:
        log(f"[profile] {cfg.name} train step {dtype_name}: device time not measured "
            f"(the profiler saw no CUDA kernel)")
        return
    log(f"[profile] {cfg.name} train step {dtype_name} B={B} S={S}: wall {wall:.1f} ms "
        f"under the profiler, device busy {busy:.1f} ms ({100 * busy / wall:.1f}% busy), "
        f"{kernels:.0f} kernels")
    for ms, key in top:
        log(f"    {ms:8.3f} ms {100 * ms / busy:5.1f}%  {key[:90]}")


def phase_train_hybrid(torch):
    """7b: launch/train.py::train for hymba-1.5b at full width and depth,
    f32, remat "full", B 4, S 1024 (+128 meta tokens), 4 steps with exact
    counts, one profiled step. Returns the run's launches and numbers."""
    from repro_torch.configs import get_config

    cfg = get_config(HYBRID_TRAIN["arch"])
    L, steps = cfg.n_layers, HYBRID_TRAIN["steps"]
    B, S = HYBRID_TRAIN["batch"], HYBRID_TRAIN["seq"]
    # per step: each hybrid layer runs ln1, norm_attn, norm_ssm and ln2, one
    # attention and one scan, the final norm sits outside the layers; remat
    # "full" recomputes each layer's forward once in the backward, and the
    # backward runs each norm's, attention's and scan's once
    per_step = {"rmsnorm": 4 * L + 1 + 4 * L, "rmsnorm_bwd": 4 * L + 1,
                "flash_attention": 2 * L, "flash_attention_bwd": L,
                "ssm_scan": 2 * L, "ssm_scan_bwd": L}
    state, run = _train_full(torch, HYBRID, per_step, steps, B, S, torch.float32,
                             "rmsnorm 8L+1, rmsnorm_bwd 4L+1, flash 2L, flash_bwd L, "
                             "ssm_scan 2L, ssm_scan_bwd L")
    _profile_train_step(torch, cfg, state, B, S, "f32", steps)
    del state
    gc.unfreeze()
    torch.cuda.empty_cache()
    return run


def phase_train_audio(torch):
    """7c: launch/train.py::train for hubert-xlarge at full width and depth
    (1.26 B parameters), remat "full", B 4 x T 1500 (30 s of audio a row):
    4 f32 steps and 3 bf16 steps, each with exact counts (bf16: every flash
    forward and every backward on the tensor cores, L of each), and one
    profiled step of each. Returns the two runs' launches and numbers."""
    from repro_torch.configs import get_config

    cfg = get_config(AUDIO)
    L, a = cfg.n_layers, AUDIO_TRAIN
    # per step: the input norm (outside the layers, not recomputed), ln1
    # and ln2 of each layer, the final norm; remat "full" recomputes each
    # layer once; one attention a layer, and each norm's and attention's
    # backward once
    per_step = {"rmsnorm": 4 * L + 2, "rmsnorm_bwd": 2 * L + 2,
                "flash_attention": 2 * L, "flash_attention_bwd": L}
    rule = "rmsnorm 4L+2, rmsnorm_bwd 2L+2, flash 2L, flash_bwd L"
    runs = []
    for dtype, steps, extra, note in (
            (torch.float32, a["steps"], {}, ""),
            (torch.bfloat16, a["bf16_steps"], dict(wgmma=2 * L, wgmma_bwd=L),
             ", every flash forward and backward on the tensor cores")):
        state, run = _train_full(torch, AUDIO, dict(per_step, **extra), steps, a["batch"],
                                 a["seq"], dtype, rule + note)
        _profile_train_step(torch, cfg, state, a["batch"], a["seq"],
                            "f32" if dtype == torch.float32 else "bf16", steps)
        del state
        gc.unfreeze()
        torch.cuda.empty_cache()
        runs.append(run)
    return runs


def phase_train_xlstm(torch):
    """7d: launch/train.py::train for xlstm-125m at full width and depth,
    f32, remat "full", B 4, S 1024, 4 steps with exact rmsnorm counts (no
    attention: no flash launch), one profiled step. Returns the run's
    launches and numbers."""
    from repro_torch.configs import get_config

    cfg = get_config(XLSTM)
    n_s = len(cfg.slstm_layers)
    n_m = cfg.n_layers - n_s
    # per step: an mLSTM layer runs ln and norm_cell, an sLSTM layer also
    # ln2, the final norm sits outside the layers; remat "full" recomputes
    # each layer once, and the backward runs each norm's once
    norms = 2 * n_m + 3 * n_s
    per_step = {"rmsnorm": 2 * norms + 1, "rmsnorm_bwd": norms + 1}
    x = XLSTM_TRAIN
    state, run = _train_full(torch, XLSTM, per_step, x["steps"], x["batch"], x["seq"],
                             torch.float32, f"rmsnorm 2N+1, rmsnorm_bwd N+1 with N = 2 x "
                             f"{n_m} mLSTM + 3 x {n_s} sLSTM layers = {norms}")
    _profile_train_step(torch, cfg, state, x["batch"], x["seq"], "f32", x["steps"])
    del state
    gc.unfreeze()
    torch.cuda.empty_cache()
    return run


def phase_train_moe(torch):
    """7e: f32 steps of qwen3-moe-30b-a3b at full width and 4 of its 48
    layers (12.5 GB of parameters, ~50 GB with gradients and both AdamW
    moments) through launch/train.py::train, at the batch that leaves room
    for the dense oracle's [E, T, 768] f32 intermediates (0.4 GB each per
    1024 tokens), with exact counts. Returns the run's launches and
    numbers."""
    m = MOE_TRAIN
    L = m["layers"]
    # per step: ln1, q_norm, k_norm and ln2 of each layer and the final norm;
    # remat "full" recomputes each layer once; one attention a layer
    per_step = {"rmsnorm": 8 * L + 1, "rmsnorm_bwd": 4 * L + 1,
                "flash_attention": 2 * L, "flash_attention_bwd": L}
    state, run = _train_full(torch, MOE, per_step, m["steps"], m["batch"], m["seq"],
                             torch.float32, "rmsnorm 8L+1, rmsnorm_bwd 4L+1, flash 2L, "
                             "flash_bwd L", layers=L)
    del state
    gc.unfreeze()
    torch.cuda.empty_cache()
    return run


def _leaf_names(tree, prefix: str = "") -> list:
    """The path of each leaf, in the order of train.optim.tree_leaves."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in _leaf_names(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [n for i, t in enumerate(tree) for n in _leaf_names(t, f"{prefix}{i}/")]
    return [prefix.rstrip("/")]


def plain_versions(torch, dk=1.0, dx=1.0, da=1.0):
    """The plain versions (rmsnorm, flash_mha, ssm_scan_batched) that the
    train checks patch into the model modules (here, not by a switch in the
    package). A scale other than 1 multiplies one gradient in their backward,
    a wrong backward: dK in attention, dx in rmsnorm, da in the scan."""
    from repro_torch.kernels.flash_attention.ref import flash_mha_ref
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
    from repro_torch.kernels.ssm_scan.ref import ssm_scan_bwd_ref, ssm_scan_ref

    class Scale(torch.autograd.Function):
        @staticmethod
        def forward(ctx, t, s):
            ctx.s = s
            return t.clone()

        @staticmethod
        def backward(ctx, g):
            return g * ctx.s, None

    class PlainScan(torch.autograd.Function):
        @staticmethod
        def forward(ctx, a, b):
            h = ssm_scan_ref(a, b)
            ctx.save_for_backward(a, h)
            return h

        @staticmethod
        def backward(ctx, g):
            d_a, d_b = ssm_scan_bwd_ref(*ctx.saved_tensors, g)
            return d_a * da, d_b

    def rmsnorm(x, w, eps):
        return rmsnorm_ref(Scale.apply(x, dx), w, eps)

    def flash(q, k, v, **kw):
        return flash_mha_ref(q, Scale.apply(k, dk), v, **kw)

    return (rmsnorm_ref if dx == 1.0 else rmsnorm, flash_mha_ref if dk == 1.0 else flash,
            PlainScan.apply)


@contextlib.contextmanager
def patched(fns):
    """Within it, the model modules call ``fns`` (rmsnorm, flash_mha,
    ssm_scan_batched) in place of the kernels' wrappers."""
    from repro_torch.models import attention, layers, mamba

    mods = ((layers, "rmsnorm"), (attention, "flash_mha"), (mamba, "ssm_scan_batched"))
    saved = [getattr(m, n) for m, n in mods]
    for (m, n), f in zip(mods, fns):
        setattr(m, n, f)
    try:
        yield
    finally:
        for (m, n), f in zip(mods, saved):
            setattr(m, n, f)


def step_setup(torch, arch, cut, B, S, reduced=False, microbatches=1, compress=False):
    """The config (``reduced``: its reduced() one, then the fields ``cut``
    replaced), the f32 step function (``microbatches``, EF ``compress``), a
    function that draws the train state anew from one seed (the VLM's gates
    opened) and one batch."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.models import build_model
    from repro_torch.train import SyntheticData, init_state, make_train_step, schedule_for

    cfg = get_config(arch)
    cfg = dataclasses.replace(cfg.reduced() if reduced else cfg, **cut)
    model = build_model(cfg)
    step_fn = make_train_step(model, lr_schedule=schedule_for(cfg, STEP_LR, 0, 100),
                              microbatches=microbatches, compress=compress)

    def fresh():
        state = init_state(model, torch.Generator(device="cuda").manual_seed(2),
                           dtype=torch.float32, compress=compress, device="cuda")
        if cfg.family == "vlm":
            _open_gates(state["params"])
        return state

    batch = SyntheticData(cfg, ShapeSpec("cli", S, B, "train"), seed=1,
                          device="cuda").batch_at(0)
    return cfg, step_fn, fresh, batch


def one_step(torch, step_fn, fresh, batch, fns=None):
    """One step from a fresh state, with the kernels or (``fns``) with
    those functions patched in: the state after it (the step updates it in
    place), its metrics, the launches it made and the sum of each parameter
    as drawn."""
    from repro_torch.train.optim import tree_leaves

    with patched(fns) if fns else contextlib.nullcontext():
        state = fresh()
        drawn = [float(t.sum(dtype=torch.float64)) for t in tree_leaves(state["params"])]
        _zero_counts()
        _, metrics = step_fn(state, batch)
        launches = _read_counts()
    return state, metrics, launches, drawn


def moment_shares(want, got, ef=False) -> dict:
    """Each leaf's max |m - m_want| over want's max |m| (m: the first AdamW
    moment, 0.1 x the clipped gradient after one step from zero). ``ef``:
    the step compressed that gradient to int8 with error feedback, so m is
    0.1 x its quantized form and the state's residual e' holds the rest; m +
    0.1 e' is then 0.1 x the clipped gradient again, the quantity compared."""
    from repro_torch.train.optim import tree_leaves

    def moments(state):
        m = tree_leaves(state["opt"]["m"])
        return [a + 0.1 * e for a, e in zip(m, tree_leaves(state["ef"]))] if ef else m

    return {n: float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
            for n, a, b in zip(_leaf_names(want["opt"]["m"]), moments(got), moments(want))}


def ef_codes(torch, state):
    """The int8 codes that EF compression gave each gradient element, read
    back from one step's first AdamW moments (m = 0.1 x code x the block's
    scale, the block's largest |code| 127), by leaf, with the largest
    distance of a recovered code from an integer and the largest |e'| in
    half code steps (e' is what rounding to the nearest code left: at most
    one half step when the quantizer is sound)."""
    import torch.nn.functional as F

    from repro_torch.train.compress import BLOCK
    from repro_torch.train.optim import tree_leaves

    codes, off, resid = [], 0.0, 0.0
    for m, e in zip(tree_leaves(state["opt"]["m"]), tree_leaves(state["ef"])):
        n = m.numel()

        def blocks(t):
            return F.pad(t.reshape(-1), (0, -n % BLOCK)).view(-1, BLOCK)

        step = blocks(m).abs().amax(-1, keepdim=True) / 127      # 0.1 x the block's scale
        x = torch.where(step > 0, blocks(m) / step, torch.zeros((), device=m.device))
        c = x.round()
        off = max(off, float((x - c).abs().max()))
        half = torch.where(step > 0, 0.2 / step, torch.zeros((), device=m.device))
        resid = max(resid, float((blocks(e).abs() * half).max()))
        codes.append((c.reshape(-1)[:n], (step > 0).expand(-1, BLOCK).reshape(-1)[:n]))
    return codes, off, resid


def ef_code_diffs(torch, want, got) -> dict:
    """The codes of ``got``'s step against ``want``'s (``ef_codes``): the
    codes held (elements of blocks that are not all zero in ``want``), how
    many differ, how many by more than one, the largest distance, and each
    state's checks of its own quantization."""
    cw, off_w, res_w = ef_codes(torch, want)
    cg, off_g, res_g = ef_codes(torch, got)
    held = flips = far = 0
    most = 0.0
    for (a, _), (b, live) in zip(cg, cw):
        d = (a - b).abs()[live]
        held += int(live.sum())
        flips += int((d > 0).sum())
        far += int((d > 1).sum())
        most = max(most, float(d.max()) if d.numel() else 0.0)
    return dict(held=held, flips=flips, far=far, most=most, off=max(off_w, off_g),
                resid=max(res_w, res_g))


def train_step_vs_plain(torch, arch, cut, B=TRAIN["batch"], S=TRAIN["seq"], reduced=False,
                        grad_tol=STEP_GRAD_TOL, norm_tol=1e-4, microbatches=1, compress=False):
    """One f32 train step of ``arch`` at full width (``reduced``: its
    reduced() config), cut by the config fields ``cut`` (``microbatches``
    and EF ``compress`` as make_train_step takes them), with the kernels,
    then the same step from the same state with the plain versions patched
    in: loss at rel 1e-4 and grad norm at rel ``norm_tol``; each leaf's
    gradient, read from its first AdamW moment, within ``grad_tol`` of the
    leaf's max; new parameters at atol 2 lr. One Adam step moves each
    element by about lr sign(g), so the parameters alone compare signs; the
    moments compare values. A third step, the plain versions with a wrong
    backward (dK x 1.1 in attention; in a hybrid model da x 1.1 in the scan;
    in xLSTM, which has no attention, dx x 1.1 in rmsnorm), must fail the
    moment check by 10x. Each step starts from a state drawn anew from one
    seed, so at most two states are held at once. Under ``compress`` the
    gradient is read as the moment plus 0.1 x the EF residual
    (``moment_shares``); beside it the moments alone, which hold the int8
    codes, and the count of codes that differ are logged."""
    from repro_torch.train.optim import tree_leaves

    cfg, step_fn, fresh, batch = step_setup(torch, arch, cut, B, S, reduced, microbatches,
                                            compress)
    hybrid, attention = cfg.family == "hybrid", cfg.family != "ssm"
    lr = STEP_LR
    state, mk, ran, drawn = one_step(torch, step_fn, fresh, batch)
    twin, mp, plain_ran, drawn_twin = one_step(torch, step_fn, fresh, batch,
                                               plain_versions(torch))
    torch.cuda.synchronize()
    if drawn_twin != drawn:
        raise AssertionError(f"{cfg.name}: two draws of the state from one seed differ")
    need = ("rmsnorm", "rmsnorm_bwd") + (
        ("flash_attention", "flash_attention_bwd") if attention else ()) + (
        ("ssm_scan", "ssm_scan_bwd") if hybrid else ())
    if min(ran[k] for k in need) == 0 or any(plain_ran.values()):
        raise AssertionError(f"kernel step launched {ran}, plain step {plain_ran}")
    rel = {k: abs(float(mk[k]) - float(mp[k])) / abs(float(mp[k])) for k in ("loss", "grad_norm")}
    diffs = [(a - b).abs() for a, b in zip(tree_leaves(state["params"]),
                                           tree_leaves(twin["params"]))]
    worst = max(float(d.max()) for d in diffs)
    mean = float(sum(float(d.sum()) for d in diffs) / sum(d.numel() for d in diffs))
    del diffs
    grads_k = moment_shares(twin, state, compress)
    if compress:
        codes = moment_shares(twin, state)
        leaf_c = max(codes, key=codes.get)
        # elements whose moment moved by more than the limit: an int8 code
        # that flipped, where the block's scaled gradient sat within
        # rounding of a half-step
        beyond = sum(int(((a - b).abs() > grad_tol * b.abs().max()).sum())
                     for a, b in zip(tree_leaves(state["opt"]["m"]),
                                     tree_leaves(twin["opt"]["m"])))
        cd_k = ef_code_diffs(torch, twin, state)
        log(f"[train] EF int8 compression, microbatches {microbatches}: the moments alone "
            f"(0.1 x the quantized gradient) differ by up to {codes[leaf_c]:.3e} of a leaf's "
            f"max (worst leaf {leaf_c}; {beyond:,} elements beyond {grad_tol:.0e} of their "
            f"leaf's max); read with the residual, below")
    del state
    torch.cuda.empty_cache()
    if hybrid:
        wrong_what, wrong_fns = "da x 1.1 in the scan", plain_versions(torch, da=1.1)
    elif attention:
        wrong_what, wrong_fns = "dK x 1.1", plain_versions(torch, dk=1.1)
    else:
        wrong_what, wrong_fns = "dx x 1.1 in rmsnorm", plain_versions(torch, dx=1.1)
    wrong = one_step(torch, step_fn, fresh, batch, wrong_fns)[0]
    grads_w = moment_shares(twin, wrong, compress)
    if compress:
        cd_w = ef_code_diffs(torch, twin, wrong)
    del wrong
    leaf_k, leaf_w = max(grads_k, key=grads_k.get), max(grads_w, key=grads_w.get)
    n_params = sum(t.numel() for t in tree_leaves(twin["params"]))
    log(f"[train] {cfg.name} at {cfg.n_layers} layers ({n_params / 1e6:.1f} M parameters), "
        f"B={B} S={S}" + (f", {microbatches} microbatches" if microbatches > 1 else "")
        + (", EF int8 compression" if compress else "") + ", one f32 step, kernels vs plain on the "
        f"card: loss {float(mk['loss']):.6f} / {float(mp['loss']):.6f} (rel {rel['loss']:.2e}), "
        f"grad_norm {float(mk['grad_norm']):.6f} / {float(mp['grad_norm']):.6f} (rel "
        f"{rel['grad_norm']:.2e}, limit {norm_tol:.1e}); new params max |diff| {worst:.3e} "
        f"(atol 2 lr = {2 * lr:g}), mean {mean:.3e} (at most 1e-3 lr = {1e-3 * lr:g}); kernel "
        f"launches {ran}")
    log(f"[train] gradients (first AdamW moments), {len(grads_k)} leaves, max |diff| / max "
        f"|plain| (limit {grad_tol:.1e}): kernels {grads_k[leaf_k]:.3e} (worst leaf "
        f"{leaf_k}); a wrong backward ({wrong_what}, plain versions) {grads_w[leaf_w]:.3e} "
        f"(worst leaf {leaf_w})")
    del twin
    torch.cuda.empty_cache()
    if compress:
        def codes_ok(cd):
            return cd["most"] <= 1 and cd["flips"] <= EF_FLIP_SHARE * cd["held"]

        for who, cd in (("kernels", cd_k), (f"a wrong backward ({wrong_what})", cd_w)):
            log(f"[train] EF int8 codes, {who} vs plain: {cd['held']:,} codes held, "
                f"{cd['flips']:,} differ ({cd['flips'] / cd['held']:.3e} of them; cap "
                f"{EF_FLIP_SHARE:g}), {cd['far']:,} by more than one (largest {cd['most']:g}); "
                f"limits: every code within one of the plain step's and the share under the "
                f"cap | quantization of each state: recovered codes off an integer by "
                f"{cd['off']:.1e} (limit {EF_CODE_OFF:g}), |e'| up to {cd['resid']:.4f} of a "
                f"half step (limit {1 + EF_CODE_OFF:g})")
        for cd in (cd_k, cd_w):
            if cd["off"] > EF_CODE_OFF or cd["resid"] > 1 + EF_CODE_OFF:
                raise AssertionError("a step's moments and residuals are not one per-block "
                                     "int8 rounding of its gradient")
        if not codes_ok(cd_k):
            raise AssertionError("the kernel step's int8 codes disagree with the plain step's")
        if codes_ok(cd_w):
            raise AssertionError(f"the int8 code check would pass a backward with {wrong_what}")
    if (rel["loss"] > 1e-4 or rel["grad_norm"] > norm_tol or worst > 2 * lr
            or mean > 1e-3 * lr):
        raise AssertionError("the kernel step and the plain step disagree")
    if grads_k[leaf_k] > grad_tol:
        raise AssertionError(f"the kernel step's gradient of {leaf_k} disagrees with the plain "
                             f"step's")
    if grads_w[leaf_w] <= 10 * grad_tol:
        raise AssertionError(f"the gradient check would pass a backward with {wrong_what} or "
                             f"come within 10x of it")


# -- the program over a DeviceMesh --------------------------------------------

# phase 9: the program (launch/programs.py) on a one-rank mesh. qwen2-1.5b's
# train step at phase 7's shape; qwen3-moe-30b-a3b served at full depth in
# bf16 through moe_ep (phase 6's prefill shape, then decode steps), one
# full-width MoE layer and the 4-layer f32 model (phase 4's) at a capacity
# factor of E/k, where no (token, expert) pair drops; one dry-run cell
PROGRAM = dict(train_batch=4, train_seq=1024, moe_batch=4, moe_prompt=1024, moe_smax=2048,
               moe_steps=32, moe_layer_tol=2e-2, moe_model_tol=2e-3,
               dryrun=("qwen3-moe-30b-a3b", "train_4k", "single"), dryrun_timeout=600)


@contextlib.contextmanager
def one_rank_mesh(torch):
    """A one-rank NCCL process group (a HashStore: no port, no environment
    variables) and its 1x1 DeviceMesh ("data", "model"), destroyed on exit."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import single_device_mesh

    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield single_device_mesh("cuda")
    finally:
        dist.destroy_process_group()


def _host_leaves(state):
    from repro_torch.train.optim import tree_leaves

    return [(t.to_local() if hasattr(t, "to_local") else t).cpu() for t in tree_leaves(state)]


def phase_program_train(torch):
    """9b. qwen2-1.5b at full width and depth, f32, B 4 x S 1024: one train
    step through build_program on a one-rank mesh, then one through the
    plain make_train_step from the same seed (each state drawn, stepped and
    freed in turn; the program's copied to the host), with phase 7's exact
    counts each. Loss, grad norm and the new state (parameters and AdamW
    moments) must be equal bit for bit; where they are not, every moment
    leaf is held to STEP_GRAD_TOL of its max and the loss and grad norm to
    1e-4, and the leaves that differ are named. ms per step both ways (the
    host cost of DTensor dispatch) and each run's peak memory."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.programs import build_program
    from repro_torch.train import SyntheticData, init_state, make_train_step
    from repro_torch.train.optim import tree_leaves

    t_phase = time.perf_counter()
    cfg = get_config(DENSE)
    L, B, S = cfg.n_layers, PROGRAM["train_batch"], PROGRAM["train_seq"]
    want = {"rmsnorm": 4 * L + 1, "rmsnorm_bwd": 2 * L + 1, "flash_attention": 2 * L,
            "flash_attention_bwd": L}
    batch = SyntheticData(cfg, ShapeSpec("cli", S, B, "train"), seed=1,
                          device="cuda").batch_at(0)

    def fresh(model):
        return init_state(model, torch.Generator(device="cuda").manual_seed(2),
                          dtype=torch.float32, device="cuda")

    def run(step, state, batch):
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_counts()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        counts = {k: v for k, v in _read_counts().items() if v}
        if counts != want:
            raise AssertionError(f"train step launches {counts}, want {want}")
        m = {k: float(v.full_tensor() if hasattr(v, "full_tensor") else v)
             for k, v in m.items()}
        return state, m, ms, torch.cuda.max_memory_allocated() / 2**30

    with one_rank_mesh(torch) as mesh:
        prog = build_program(cfg, ShapeSpec("train_4k", S, B, "train"), mesh)
        state, placed = prog.place(fresh(prog.model), batch, src_data_rank=None)
        state, mp, ms_p, peak_p = run(prog.fn, state, placed)
        host = _host_leaves(state)
        del state, placed
        torch.cuda.empty_cache()
    model = prog.model
    state, mq, ms_q, peak_q = run(make_train_step(model), fresh(model), batch)
    names = ([f"params{n}" for n in _leaf_names(state["params"])]
             + [f"m{n}" for n in _leaf_names(state["opt"]["m"])]
             + [f"v{n}" for n in _leaf_names(state["opt"]["v"])] + ["step"])
    leaves = (tree_leaves(state["params"]) + tree_leaves(state["opt"]["m"])
              + tree_leaves(state["opt"]["v"]) + [state["opt"]["step"]])
    # the program's host leaves are in tree order of the whole state: opt
    # (m, step, v) before params
    host_by = dict(zip(
        [f"m{n}" for n in _leaf_names(state["opt"]["m"])] + ["step"]
        + [f"v{n}" for n in _leaf_names(state["opt"]["v"])]
        + [f"params{n}" for n in _leaf_names(state["params"])], host))
    differ, shares = [], {}
    for name, leaf in zip(names, leaves):
        h = host_by[name].to("cuda")
        if not torch.equal(h, leaf):
            differ.append(name)
            if name.startswith("m"):
                shares[name] = float((h - leaf).abs().max()) / max(float(leaf.abs().max()), 1e-30)
        del h
    n_params = sum(t.numel() for t in tree_leaves(state["params"]))
    del state, host, leaves
    torch.cuda.empty_cache()
    same = not differ and mp["loss"] == mq["loss"] and mp["grad_norm"] == mq["grad_norm"]
    log(f"[program] {cfg.name} f32 L={L} ({n_params / 1e6:.1f} M parameters) B={B} S={S}, one "
        f"train step through build_program on a 1x1 mesh (NCCL, one rank) vs the plain "
        f"make_train_step: loss {mp['loss']!r} / {mq['loss']!r}, grad_norm "
        f"{mp['grad_norm']!r} / {mq['grad_norm']!r}; new state (params, m, v, step: "
        f"{len(names)} leaves) {'equal bit for bit' if same else f'{len(differ)} leaves differ'}"
        f"; launches {want} each")
    log(f"[program] ms per step: program {ms_p:.1f}, plain {ms_q:.1f} (DTensor dispatch on "
        f"the host: {ms_p - ms_q:+.1f} ms); max_memory_allocated program {peak_p:.2f} GiB, plain "
        f"{peak_q:.2f} GiB [{time.perf_counter() - t_phase:.1f}s]")
    if not same:
        worst = max(shares, key=shares.get) if shares else None
        log(f"[program] leaves that differ: {', '.join(differ[:12])}"
            + (" ..." if len(differ) > 12 else "")
            + (f"; worst moment {worst} at {shares[worst]:.3e} of its max (limit "
               f"{STEP_GRAD_TOL:.0e})" if worst else ""))
        rel = {k: abs(mp[k] - mq[k]) / abs(mq[k]) for k in ("loss", "grad_norm")}
        if max(rel.values()) > 1e-4 or (worst and shares[worst] > STEP_GRAD_TOL):
            raise AssertionError("the program's train step disagrees with the plain step")
    return dict(ms_program=ms_p, ms_plain=ms_q, peak_program=peak_p, peak_plain=peak_q,
                bitwise=same)


def _serve_run(torch, prefill, decode, steps):
    """One prefill, then ``steps`` greedy decode steps: ms of each, the
    launches, the peak memory and the logits of the prefill and the last
    step."""
    def whole(t):
        return t.full_tensor() if hasattr(t, "full_tensor") else t

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    t0 = time.perf_counter()
    logits, cache = prefill()
    torch.cuda.synchronize()
    pf_ms = (time.perf_counter() - t0) * 1e3
    first = whole(logits).float()
    dc_ms = []
    for _ in range(steps):
        nxt = whole(logits).argmax(-1, keepdim=True)
        t0 = time.perf_counter()
        logits, cache = decode(cache, nxt)
        torch.cuda.synchronize()
        dc_ms.append((time.perf_counter() - t0) * 1e3)
    last = whole(logits).float()
    for t in (first, last):
        if not bool(torch.isfinite(t).all()):
            raise AssertionError("non-finite logits")
    return dict(prefill_ms=pf_ms, decode_ms=statistics.median(dc_ms), counts=_read_counts(),
                peak_gib=torch.cuda.max_memory_allocated() / 2**30, first=first, last=last)


def phase_program_moe(torch, model, params):
    """9a. qwen3-moe-30b-a3b at full depth in bf16 (phase 5's parameters)
    through the program's prefill (B 4, prompt 1024, smax 2048) and 32
    greedy decode steps on a one-rank mesh: every MoE FFN through moe_ep
    (capacity factor 1.25), the share of (token, expert) pairs it drops,
    ms, peak memory and exact launch counts (every flash on the tensor
    cores), beside the dense oracle (the port's one-device path) at the
    same shapes. Then one full-width MoE layer: moe_ep at capacity factor
    16 = E/k (nothing drops) against moe_dense, within moe_layer_tol in
    relative 2-norm."""
    import numpy as np

    from repro_torch.configs.base import ShapeSpec
    from repro_torch.distributed.sharding import to_mesh, use_rules
    from repro_torch.launch.programs import build_program
    from repro_torch.models import moe as moe_mod
    from repro_torch.serve.engine import make_decode_fn, make_prefill_fn

    t_phase = time.perf_counter()
    cfg = model.cfg
    B, S, smax, steps = (PROGRAM[k] for k in ("moe_batch", "moe_prompt", "moe_smax",
                                               "moe_steps"))
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab_size, (B, S))).cuda()
    (per_step, fa_pf), _ = path_counts(cfg)
    want = {"rmsnorm": per_step * (1 + steps), "flash_attention": fa_pf, "wgmma": fa_pf}
    with one_rank_mesh(torch) as mesh:
        pp = build_program(cfg, ShapeSpec("prefill_2k", smax, B, "prefill"), mesh)
        pd = build_program(cfg, ShapeSpec("decode_2k", smax, B, "decode"), mesh)
        if (pp.rules.moe_impl, pp.rules.ep_axis) != ("ep", "model"):
            raise AssertionError(f"rules {pp.rules.moe_impl} {pp.rules.ep_axis}: not EP")
        dparams, dbatch = pp.place(params, {"tokens": toks}, src_data_rank=None)
        moe_mod.DROP_STATS = []
        try:
            ep = _serve_run(torch, lambda: pp.fn(dparams, dbatch),
                            lambda c, t: pd.fn(dparams, c, t), steps)
            stats = [(p, int(k)) for p, k in moe_mod.DROP_STATS]
        finally:
            moe_mod.DROP_STATS = None
        L = cfg.n_layers
        if len(stats) != L * (1 + steps):
            raise AssertionError(f"{len(stats)} moe_ep calls, want {L} x {1 + steps}")

        def dropped(part):
            return 1.0 - sum(k for _, k in part) / sum(p for p, _ in part)

        # one full-width MoE layer (layer 0's experts), nothing dropped
        p0 = {k: params["segments"][0][k][0] for k in ("router", "we_gate", "we_up", "we_down")}
        x = torch.randn((B, S, cfg.d_model), generator=torch.Generator(device="cuda")
                        .manual_seed(4), device="cuda").to(p0["router"].dtype)
        w = (p0["router"], p0["we_gate"], p0["we_up"], p0["we_down"])
        kw = dict(k=cfg.experts_per_token, n_experts=cfg.n_experts,
                  capacity_factor=cfg.n_experts / cfg.experts_per_token)
        with torch.no_grad():
            with use_rules(pp.rules):
                moe_mod.DROP_STATS = []
                y_ep = moe_mod.moe_ffn(to_mesh(x, mesh), *w, **kw).full_tensor()
                kept = sum(int(k) for _, k in moe_mod.DROP_STATS)
                moe_mod.DROP_STATS = None
            y_dense = moe_mod.moe_dense(x.reshape(-1, cfg.d_model), *w,
                                        k=cfg.experts_per_token).reshape(x.shape)
        err = float((y_ep.float() - y_dense.float()).norm() / y_dense.float().norm())
        del dparams, dbatch, x, y_ep, y_dense
    dense = _serve_run(torch, lambda: make_prefill_fn(model, smax)(params, {"tokens": toks}),
                       lambda c, t: make_decode_fn(model)(params, c, t), steps)
    got = {k: ep["counts"][k] for k in want}
    log(f"[program] {cfg.name} bf16 L={L} B={B} prompt {S} smax {smax}, prefill + {steps} "
        f"greedy decode steps through build_program (1x1 mesh, NCCL): every MoE FFN through "
        f"moe_ep (capacity factor {cfg.capacity_factor}), {len(stats)} calls; (token, expert) "
        f"pairs dropped: prefill {dropped(stats[:L]):.4%} (layers 0, 1, {L // 2}, {L - 1}: "
        + ", ".join(f"{dropped(stats[i:i + 1]):.2%}" for i in (0, 1, L // 2, L - 1))
        + f"), decode {dropped(stats[L:]):.4%}")
    log(f"[program] moe_ep: prefill {ep['prefill_ms']:.1f} ms, decode {ep['decode_ms']:.2f} ms "
        f"per step (median of {steps}), max_memory_allocated {ep['peak_gib']:.2f} GiB | dense "
        f"oracle (plain path, same shapes): prefill {dense['prefill_ms']:.1f} ms, decode "
        f"{dense['decode_ms']:.2f} ms per step, max_memory_allocated {dense['peak_gib']:.2f} GiB")
    log(f"[program] launches: rmsnorm {got['rmsnorm']} (want {per_step} x {1 + steps}), "
        f"flash_attention {got['flash_attention']} (want {fa_pf} x 1), tensor-core "
        f"{got['wgmma']}; argmax of the prefill logits equal to the oracle's in "
        f"{float((ep['first'].argmax(-1) == dense['first'].argmax(-1)).float().mean()):.0%} "
        f"of the rows")
    log(f"[program] one full-width MoE layer, x [{B}, {S}, {cfg.d_model}] {str(w[0].dtype)[6:]}, "
        f"capacity "
        f"factor {kw['capacity_factor']:g} = E/k: moe_ep vs moe_dense rel 2-norm {err:.3e} "
        f"(limit {PROGRAM['moe_layer_tol']:g}); pairs kept {kept} of "
        f"{B * S * cfg.experts_per_token} [{time.perf_counter() - t_phase:.1f}s]")
    if got != want:
        raise AssertionError(f"program serve launches {got}, want {want}")
    if kept != B * S * cfg.experts_per_token:
        raise AssertionError("moe_ep dropped a pair at capacity factor E/k")
    if not err <= PROGRAM["moe_layer_tol"]:
        raise AssertionError("moe_ep disagrees with moe_dense on a full-width layer")
    return dict(ep=ep, dense=dense, dropped_prefill=dropped(stats[:L]),
                dropped_decode=dropped(stats[L:]), layer_err=err)


def phase_program_moe_model(torch):
    """9c. qwen3-moe-30b-a3b at full width and 4 of 48 layers in f32 (phase
    4's model, 12.5 GB), capacity factor E/k: the program's prefill logits
    against the dense path's (plain model.prefill), within moe_model_tol."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.programs import build_program

    t_phase = time.perf_counter()
    base = get_config(MOE)
    cfg = dataclasses.replace(_cut(base, "model_layers"),
                              capacity_factor=base.n_experts / base.experts_per_token)
    B, S, smax = (PATHS[MOE][k] for k in ("model_B", "model_S", "model_smax"))
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S))).cuda()
    tol = PROGRAM["moe_model_tol"]
    with one_rank_mesh(torch) as mesh:
        pp = build_program(cfg, ShapeSpec("prefill", smax, B, "prefill"), mesh)
        params = pp.model.init(torch.Generator(device="cuda").manual_seed(0), torch.float32,
                               "cuda")
        with torch.inference_mode():
            want, _ = pp.model.prefill(params, {"tokens": toks}, smax)
        dparams, dbatch = pp.place(params, {"tokens": toks}, src_data_rank=None)
        got = pp.fn(dparams, dbatch)[0].full_tensor()
        del dparams, dbatch
    err = float((got - want).abs().max())
    ok = bool(torch.isfinite(got).all()) and bool(torch.allclose(got, want, rtol=tol, atol=tol))
    log(f"[program] {cfg.name} f32 L={cfg.n_layers} B={B} prompt {S}, capacity factor "
        f"{cfg.capacity_factor:g}: the program's prefill logits (moe_ep) vs the dense path's, "
        f"max_abs_err={err:.3e} (tol {tol:g}) [{time.perf_counter() - t_phase:.1f}s]")
    del params, got, want
    torch.cuda.empty_cache()
    if not ok:
        raise AssertionError("the program's MoE prefill disagrees with the dense path")


def start_dryrun():
    """9d, started at phase 7's kernel timings: one dry-run cell on the card
    machine's host (python -m repro_torch.launch.dryrun: a fake process
    group and fake tensors, no device), a process beside them."""
    import tempfile

    arch, shape, mesh = PROGRAM["dryrun"]
    out = tempfile.mkdtemp(prefix="dryrun_")
    proc = subprocess.Popen([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
                             "--shape", shape, "--mesh", mesh, "--out", out, "--no-hlo"],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=HERE,
                            env=dict(os.environ, PYTHONPATH=os.path.join(HERE, "src")))
    return proc, out, time.perf_counter()


def program_dryrun(started):
    """9d: the dry-run cell's per-device memory, product FLOPs and time."""
    import shutil

    proc, out, t0 = started
    stdout, stderr = proc.communicate(timeout=PROGRAM["dryrun_timeout"])
    wall = time.perf_counter() - t0
    cell = {}
    for name in os.listdir(out):
        with open(os.path.join(out, name)) as f:
            cell = json.load(f)
    shutil.rmtree(out, ignore_errors=True)
    if proc.returncode != 0 or cell.get("status") != "ok":
        raise AssertionError(f"dry-run cell failed: {stdout[-2000:]} {stderr[-2000:]} "
                             f"{cell.get('error', '')}")
    mem = cell["memory_analysis"]
    log(f"[program] dry-run {cell['arch']} x {cell['shape']} x {cell['mesh']} ({cell['devices']} "
        f"devices, fake tensors on the host): per device argument "
        f"{mem['argument_size_in_bytes'] / 2**30:.2f} GiB, output "
        f"{mem['output_size_in_bytes'] / 2**30:.2f} GiB, peak of live tensors "
        f"{mem['peak_memory_in_bytes'] / 2**30:.2f} GiB; product FLOPs per device "
        f"{cell['cost_analysis']['flops']:.4e}; build {cell['build_s']}s, run {cell['run_s']}s, "
        f"{wall:.1f}s from its start to here (phase 7's kernel timings ran beside it)")
    return cell


def cli_on_the_card():
    """python -m repro_torch.sweep run on a golden slice's spec, on the card
    (the default device), in a subprocess: its frozen records must equal the
    fixture."""
    import shutil
    import tempfile

    sys.path.insert(0, os.path.join(HERE, "tests"))
    import _torch_golden

    name = "lm_decode_kv_slice"
    tmp = tempfile.mkdtemp(prefix="cli_", dir=os.path.join(HERE, "build"))
    try:
        spec = os.path.join(tmp, "spec.json")
        with open(spec, "w") as f:
            json.dump(_torch_golden.specs()[name].to_dict(), f)
        out = os.path.join(tmp, "out.json")
        env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", "repro_torch.sweep", "run", spec,
                            "--workers", "0", "--no-cache", "--out", out],
                           capture_output=True, text=True, timeout=300, env=env, cwd=tmp)
        if r.returncode != 0:
            raise AssertionError(f"sweep CLI failed ({r.returncode}): {r.stderr[-2000:]}")
        with open(out) as f:
            records = json.load(f)["records"]
        if _torch_golden.freeze(records) != _torch_golden.golden(name):
            raise AssertionError(f"sweep CLI: {name} records differ from tests/golden/")
        line = next((ln for ln in r.stdout.splitlines() if ln.startswith("prescreen_s,")), "")
        log(f"[cli] python -m repro_torch.sweep run {name} (the card, --workers 0): "
            f"{len(records)} records equal the fixture, {time.perf_counter() - t0:.1f} s; {line}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs an NVIDIA card",
              file=sys.stderr)
        return 1
    try:
        import repro_torch.device
    except ImportError as e:
        print(f"chip_smoke: cannot import the port from {HERE}/src: {e}",
              file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    dryrun = None
    try:
        repro_torch.device.resolve_device(None)
        log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
            f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} "
            f"capability {torch.cuda.get_device_capability(0)}")
        card = phase_card()
        phase_build()
        sched_row, sched_launches, sched_variants_launched = phase_prescreen(torch)
        rows = phase_kernels(torch)
        phase_row_offset(torch)
        launches = {}
        for arch in (DENSE, HYBRID, MOE, XLSTM, VLM, AUDIO):
            phase_model(torch, arch)
            serve = {VLM: phase_serve_vlm, AUDIO: phase_encode_audio}.get(
                arch, lambda torch: phase_serve(torch, arch))
            launches[arch], model, params = serve(torch)
            t0 = time.perf_counter()
            phase_profile(torch, model, params)
            log(f"[profile] {arch}: {time.perf_counter() - t0:.1f}s")
            if arch == MOE:           # phase 9a on phase 5's weights
                phase_program_moe(torch, model, params)
            del model, params
            torch.cuda.empty_cache()
            if arch == MOE:
                phase_program_moe_model(torch)
        # 9d beside phase 7's kernel timings: CUDA events behind a device-side
        # sleep, which a busy host core does not enter
        dryrun = start_dryrun()
        rows.update(train_kernels(torch))
        program_dryrun(dryrun)
        dense_runs = phase_train(torch)
        train_step_vs_plain(torch, DENSE, dict(n_layers=TRAIN["check_layers"]))
        train_step_vs_plain(torch, DENSE, dict(n_layers=TRAIN["check_layers"]),
                            microbatches=2, compress=True)
        hybrid_run = phase_train_hybrid(torch)
        train_step_vs_plain(torch, HYBRID, HYBRID_TRAIN["check"])
        t0 = time.perf_counter()
        audio_runs = phase_train_audio(torch)
        train_step_vs_plain(torch, AUDIO, AUDIO_TRAIN["check"], S=AUDIO_TRAIN["seq"])
        log(f"[train] phase 7c (hubert-xlarge): {time.perf_counter() - t0:.1f}s")
        t0 = time.perf_counter()
        xlstm_run = phase_train_xlstm(torch)
        for S in XLSTM_TRAIN["check_seqs"]:
            train_step_vs_plain(torch, XLSTM, {}, S=S, grad_tol=XLSTM_TRAIN["grad_tol"],
                                norm_tol=XLSTM_TRAIN["norm_tol"])
        log(f"[train] phase 7d (xlstm-125m): {time.perf_counter() - t0:.1f}s")
        t0 = time.perf_counter()
        phase_train_moe(torch)
        train_step_vs_plain(torch, MOE, MOE_TRAIN["check"], B=MOE_TRAIN["check_batch"])
        log(f"[train] phase 7e (qwen3-moe-30b-a3b): {time.perf_counter() - t0:.1f}s")
        t0 = time.perf_counter()
        train_step_vs_plain(torch, VLM, {}, reduced=True)
        log(f"[train] phase 7f (llama-3.2-vision-90b, reduced): {time.perf_counter() - t0:.1f}s")
        cli_on_the_card()
        t0 = time.perf_counter()
        phase_program_train(torch)
        log(f"[program] phase 9b: {time.perf_counter() - t0:.1f}s")
        t0 = time.perf_counter()
        phase_examples(torch)
        log(f"[examples] phase 10: {time.perf_counter() - t0:.1f}s")
        phase_capture(torch)
    except Exception:
        traceback.print_exc()
        return 1
    finally:
        if dryrun is not None and dryrun[0].poll() is None:
            dryrun[0].kill()
            dryrun[0].wait()

    from repro_torch.kernels.flash_attention.kernel import WGMMA_HEAD_DIMS

    # one entry per kernel and main path; the row is timed at that path's
    # main shape, and the launches are that path's serve run
    entries = [
        (DENSE, "rmsnorm", ("rmsnorm", (4096, 1536), "bfloat16")),
        (DENSE, "flash_attention",
         ("flash", (4, 1024, 1024, 12, 2, 128, True, 0, 0), "bfloat16")),
        (HYBRID, "rmsnorm", ("rmsnorm", (4608, 1600), "bfloat16")),
        (HYBRID, "flash_attention",
         ("flash", (4, 1152, 1152, 25, 5, 64, True, 1024, 128), "bfloat16")),
        (HYBRID, "selective_scan", ("selective_scan", SEL_MAIN, "bfloat16")),
        (MOE, "rmsnorm", ("rmsnorm", (4096, 2048), "bfloat16")),
        (MOE, "flash_attention",
         ("flash", (4, 1024, 1024, 32, 4, 128, True, 0, 0), "bfloat16")),
        (XLSTM, "rmsnorm", ("rmsnorm", (4096, 768), "bfloat16")),
        (VLM, "rmsnorm", ("rmsnorm", (4096, 8192), "bfloat16")),
        (VLM, "flash_attention", ("flash", VLM_FA[0], "bfloat16")),
        (AUDIO, "rmsnorm", ("rmsnorm", (6000, 1280), "bfloat16")),
        (AUDIO, "flash_attention", ("flash", HUBERT_FA, "bfloat16")),
    ]
    kernels = [
        dict(name=name, route=ROUTES[name][0],
             source=ROUTES[name][1],
             replaces=REPLACES[name], launches=launches[arch][name], path=arch,
             shape=list(key[1]), dtype=key[2], **rows[key])
        for arch, name, key in entries]

    def sub(arch, name, extra):
        """More shapes of a path's kernel, timed beside its main row."""
        k = next(k for k in kernels if k["path"] == arch and k["name"] == name)
        for label, key in extra.items():
            k[label] = dict(shape=list(key[1]), dtype=key[2], **rows[key])

    # the decode rows (B=4), and the VLM's cross shapes
    sub(MOE, "rmsnorm", {"decode": ("rmsnorm", (4, 2048), "bfloat16")})
    sub(XLSTM, "rmsnorm", {"decode": ("rmsnorm", (4, 768), "bfloat16")})
    sub(VLM, "rmsnorm", {"q_norm": ("rmsnorm", (262144, 128), "bfloat16"),
                         "k_norm": ("rmsnorm", (32768, 128), "bfloat16"),
                         "decode": ("rmsnorm", (4, 8192), "bfloat16"),
                         "decode_q_norm": ("rmsnorm", (256, 128), "bfloat16")})
    sub(VLM, "flash_attention", {"cross": ("flash", VLM_FA[1], "bfloat16"),
                                 "cross_decode": ("flash", VLM_FA[2], "bfloat16")})
    kernels.append(dict(name="list_schedule", route=ROUTES["list_schedule"][0],
                        source=ROUTES["list_schedule"][1],
                        replaces=REPLACES["list_schedule"], launches=sched_launches,
                        variants_launched=sched_variants_launched, path=CAMPAIGN,
                        **sched_row))
    def train_path(arch, dt, counts, rms_shape, fa=None, scan=False, **stats):
        """The rows of one train path in dtype dt: its forward kernels
        (rmsnorm at rms_shape; the flash forward in the instance that stores
        L, timed under autograd in phase 7, at fa = (its phase-3 key, its
        backward case, causal); ssm_scan) and its backward kernels at the
        same shapes; launches from the path's full-width run; ``stats`` on
        the last row."""
        fwd, bwd = [], []
        fwd.append(("rmsnorm", rows[("rmsnorm", rms_shape, dt)], ROUTES["rmsnorm"][1],
                    rms_shape))
        bwd.append(("rmsnorm_bwd", rows[("rmsnorm_bwd", rms_shape, dt)],
                    ROUTES["rmsnorm_bwd"][1], rms_shape))
        if fa:
            fwd_key, case, causal = fa
            b = rows[("flash_attention_bwd", case + (causal,), dt)]
            tc = dt == "bfloat16" and case[4] in WGMMA_HEAD_DIMS
            fwd.append(("flash_attention",
                        dict(rows[("flash", fwd_key, dt)], ms=b["forward_autograd_ms"],
                             serve_instance_ms=b["forward_serve_ms"]),
                        ROUTES["flash_attention"][1] if tc else SIMT_FLASH, case))
            bwd.append(("flash_attention_bwd", b, ROUTES["flash_attention_bwd"][1], case))
        if scan:
            fwd.append(("ssm_scan", rows[("ssm_scan", SCAN_MAIN, dt)], ROUTES["ssm_scan"][1],
                        SCAN_MAIN))
            bwd.append(("ssm_scan_bwd", rows[("ssm_scan_bwd", SCAN_MAIN, dt)],
                        ROUTES["ssm_scan_bwd"][1], SCAN_MAIN))
        for name, row, source, shape in fwd + bwd:
            kernels.append(dict(name=name, route="cuda", source=source, replaces=REPLACES[name],
                                launches=counts[name], path=f"train/{arch}/{dt}",
                                shape=list(shape), dtype=dt, **row))
        kernels[-1].update(stats)

    # the train paths, f32 (the launcher's default) and bf16 (f32 flash runs
    # the CUDA-core kernel, bf16 at hd 64/80/128 the tensor-core one, both
    # ways); launches from the full-width runs of phases 7 to 7d
    qwen = ((4, 1024, 1024, 12, 2, 128, True, 0, 0), QWEN_BWD, True)
    f32, b16 = dense_runs
    train_path(DENSE, "float32", f32["launches"], (4096, 1536), qwen,
               train_step_ms=f32["step_ms"])
    train_path(DENSE, "bfloat16", b16["launches"], (4096, 1536), qwen,
               train_step_ms=b16["step_ms"], train_peak_gib_f32=f32["peak_gib"])
    train_path(HYBRID, "float32", hybrid_run["launches"], (4608, 1600),
               ((4, 1152, 1152, 25, 5, 64, True, 1024, 128), HYMBA_BWD, True), scan=True,
               train_step_ms=hybrid_run["step_ms"], train_peak_gib_f32=hybrid_run["peak_gib"])
    for dt, run in zip(("float32", "bfloat16"), audio_runs):
        train_path(AUDIO, dt, run["launches"], (6000, 1280), (HUBERT_FA, HUBERT_BWD, False),
                   train_step_ms=run["step_ms"], train_peak_gib=run["peak_gib"])
    train_path(XLSTM, "float32", xlstm_run["launches"], (4096, 768),
               train_step_ms=xlstm_run["step_ms"], train_peak_gib=xlstm_run["peak_gib"])
    log(f"[wall] chip_smoke.py {time.perf_counter() - t_start:.1f}s, the build included")
    log(f"[card] {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
