"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``vision_toolbox_tpu_torch/csrc`` (nvcc,
sm_90a, one process per source) and drives the port's paths:

- serving (slice 1): holds the fused attention/MLP kernels against their
  plain PyTorch versions at the vit_b_16 shapes the model gives them, runs a
  seeded bf16 vit_b_16 (224 px, random weights) eagerly and through its plain
  versions, then serves it: export → load → requests at batch 1, 8 and 32,
  each checked against eager;
- training (slice 2): holds the three-shear warp kernel (K1) against its
  plain version at bs256@176 and at 32 px, then runs the full-recipe
  cspdarknet53 train step (bs256, 176 px, TrivialAugment, RandomErasing 0.1,
  CutMix⊕MixUp, bf16 compute, f32 params, SGD) for 3 warm-up and 10 timed
  steps, and one step through K1 against one through its plain version;
- transformer training (slice 3): holds the backward-save forward and the
  backward kernels of the MLP and attention half-blocks against their plain
  versions at the vit_b_16 shapes (and T = 512 for attention), times each
  backward against its plain version, runs the vit_b_16 train step (bs128,
  224 px, CutMix⊕MixUp, label smoothing 0.1, bf16 compute, f32 params, SGD)
  for 3 warm-up and 10 timed steps, one step through the kernels against
  one through the plain versions, and a few deit3_b_16 steps with
  stochastic depth 0.1 (the LayerScale and drop-path branches);
- CaiT (slice 4): holds the talking-head attention kernels (K5 forward and
  backward) against their plain versions at the cait_s_24 shapes and
  others, f32 and bf16 (at cait_s_24 b128 also the bf16 rel L2 within
  twice the first design's and a second backward bit-equal), times both
  against their plain versions at batch 128, serves a seeded bf16 cait_s_24 (eager vs plain path, then export →
  load → requests at batch 1, 8 and 32), and runs the cait_s_24 train step
  at bs128@224 with ViT's recipe for 3 warm-up and 10 timed steps, then
  one step through the kernels against one through the plain versions and
  an f32 reference. CaiT's LayerScale γs are spread around 0.1 on both
  paths: at their init, 1e-6, every residual branch rounds away in bf16;
- SigLIP at 512 px (slice 5): holds the flash-attention kernels (K6 forward,
  with and without a bias, and backward, a second backward bit-equal)
  against their plain versions at the siglip vit_b_16 shapes (T = S =
  1024, 12 heads of 64) and others, f32 and bf16, and the packed
  (B, T, N, H) layout, read in place, bit-equal to the flat one; times both
  on the packed layout and torch's scaled_dot_product_attention on the same
  memory (the library yardstick, used nowhere in the port) at batch 32 and
  reads K6's peak extra memory there, serves a seeded bf16 vit_b_16 SigLIP at 512 px
  (its position table carried from 224 px by ``resize_pe``; eager vs plain
  path, then export → load → requests at batch 1, 8 and 32), runs its
  train step at bs64@512 with ViT's recipe for 3 warm-up and 10 timed
  steps, and one step at bs8 through the kernels against one through the
  plain versions and an f32 reference;
- ConvNeXt (slice 6): holds the depthwise-conv kernels (K9 forward and
  backward) against their plain versions at convnext_t's four stage shapes
  and others, f32 and bf16, times both, their plain versions and cuDNN's
  grouped conv (the library yardstick, used nowhere in the port) at bs128,
  holds the fused MLP kernels at the widths their 32-column tiles serve (96,
  288) and times them at convnext_t stage 1, serves a seeded bf16
  convnext_t (LayerScale γs spread around 0.1; eager vs plain path, then
  export → load → requests at batch 1, 8 and 32), runs its train step at
  bs128@224 with ViT's recipe and stochastic depth 0.1 for 3 warm-up and
  10 timed steps and one step at bs8 through the kernels against the plain
  versions and an f32 reference; then the repaired faults: cait_s_24 at
  384 px served (its attention beyond K5's rule) and K6 at head 72;
- Swin (slice 7): holds the window-attention kernels (K7 forward and
  backward, with the dPE sum) against their plain versions at swin_t's four
  stage shapes, window 8 at head 128, window 14 and T = 256, f32 and bf16,
  and the shifted-window relayout kernels (K8) bit for bit, times them at
  swin_t stage 1, bs128 (K7 beside torch's scaled_dot_product_attention),
  serves a seeded bf16 swin_t (eager vs plain path, then export → load →
  requests at batch 1, 8, 32 and 128), runs its train step at bs128@224
  with stochastic depth 0.2 for 3 warm-up and 10 timed steps and one step
  at bs8 through the kernels against the plain versions and an f32
  reference; then the repaired head widths: K5 at heads of 32, 96 and 160
  and at (T, S, heads) = (64, 512, 16), and K6 at head 256, timed beside
  scaled_dot_product_attention;
- short attention (slice 8): holds the short-attention kernels (K2 forward
  and backward, a second backward bit-equal) against their plain versions at
  vit_b_16's shapes (batch 8 and 128), vit_l_16's, vit_h_14's (head 80,
  T = 257, through the ``short_attention`` entry), the rule's corner
  (T = S = 512, head 128), T ≠ S, T = S = 2 and a head of 40, f32 and bf16,
  times both, their plain versions and scaled_dot_product_attention at
  vit_b_16 bs128, serves a seeded bf16 vit_b_16 built with dropout 0.1 (both
  halves of every block on the module chain: 12 K2 launches a request at
  batch 8 and 32, none at batch 1; eager vs plain path and an f32 reference,
  then export → load → requests at batch 1, 8 and 32), and runs the vit_b_16
  step on the unfused block chain (``force_unfused``, the JAX package's chain
  under token sharding) at bs128@224 for 3 warm-up and 10 timed steps, and
  one step at bs8 through the kernels against the plain versions and an f32
  reference;
- K2 redesigned for Hopper (slice 10): phases 34–37 run the register-tile
  K2 kernels; phase 34 adds the second-plane control (in bf16 the kernels
  lie at most half as far from their plain versions as
  ``dense_attention``, which rounds p to bf16 once, and
  ``short_attention_bwd_one_plane``, which rounds p and ds once), phase 35
  prints the earlier wmma design's times and the kernels' registers and
  spills (none at bf16 head 64), phase 37 K2's 12 + 12 launches a step, and
  phases 17 and 33 print K6's times beside PERF.md §6's;
- K7 redesigned for Hopper (slice 11): phase 28 runs the register-tile K7
  kernels at every case, window 14 in bf16 included, and adds the
  second-plane control (as phase 34's for K2); phase 29 prints stage 1's
  times beside the earlier wmma design's (K7_EARLIER_MS), times window 14
  (swin_s3_t stage 3 at batch 128) with both bounds beside
  scaled_dot_product_attention, and prints the kernels' registers and spills;
  phase 38 times the K3/K4 half-blocks through the port's module chain at
  vit_b_16's and ConvNeXt-T stage 1's shapes (the yardstick of their
  redesign; several calls, so "chain ms");
- K9 redesigned for Hopper (slice 12): phase 21 runs the redesigned
  depthwise-conv kernels at every case, with the route each launch takes
  (16-byte staging, or one element at a time for C = 20 and an offset
  view), adds 7 × 7 and 14 × 14 regions, one-wide and one-high maps, a
  run-time k and the gate's top k, holds bf16 out and dx bit-equal to the
  plain versions (the count of differing elements, bound 0) and a second
  backward bit-equal at stage 1; phase 22 prints each stage's route and
  launch geometry, and stage 1's times beside the first design's
  (K9_EARLIER_MS), then holds every stage's timed operands (and stage 1's
  in f32) against the plain versions in the same way, with a second
  backward bit-equal: at batch 128 a block walks several regions through
  its ring, which stage 1's geometry must show;
- the K3/K4 template redesigned for Hopper (slice 13): phases 3 and 9 hold
  K3 and K4 at the wgmma template's other tiles and M tails too
  (TILE_MLP_CASES: 384 / 1536 and 160 / 640, the 32-column tile;
  TILE_ATTN_CASES: the three-product q/k/v launch at D = 192 and 320),
  phases 10 and 23 hold a second K3 and K4 backward bit-equal to the first
  at vit_b_16 b128 and convnext_t stage 1 b128 (the column sums leave
  partial rows for a fixed-order sum), and phase 38 times the fused kernels
  beside the module chain, their bound and their first design's times
  (K3K4_EARLIER_MS);
- K1 redesigned for Hopper: phase 6 holds K1 bit for bit (0
  differing elements) against its plain version on the mixed program, an
  all-rotation batch (k90 = ±1) and an all-identity batch at bs256@176, and
  times each; the K4 gate admits what the kernels run (head 128 above
  T = 480 too), and phase 39 holds and times the core at head 128, T = 512
  (K4_HEAD128).
- K4's attention core redesigned for Hopper (slice 15): phase 2 holds the
  wrapper's partial-row count to the library's; phase 39 prints the core
  kernels' registers and spills, holds the core at K4_CORE_CASES (T = 2,
  vit_b_16, T = 512, head 128 at T = 480) and at vit_b_16 b128 against the
  plain versions (the saved p too) with a second backward bit-equal, holds
  the bf16 rel L2 at b128 to twice the first design's
  (K4_FIRST_CORE_REL_L2), and times the core's launches apart beside the
  first design's (K4_FIRST_CORE_MS), its bound and phase 38's chain;
- MLP-Mixer, PatchConvNet and VoVNet (slice 17): phase 40 serves
  mixer_b_16 (12 K3 a request), runs its bs128@224 step with ViT's recipe
  (12 + 12 K3 a step) and one step at bs8 against the plain versions and an
  f32 reference, holds mixer_s_8 (N = 784 tokens) against its plain path
  and times K3 at its channel half, b128; phase 41 times K9 at k = 3 on
  patchconvnet_s's trunk (b128) beside cuDNN's grouped conv and its bound,
  serves patchconvnet_s (60 K9 a request) and runs its bs128@224 step with
  drop-path 0.3 (60 + 60 K9 a step) and one step at bs8 against the plain
  versions and an f32 reference; phase 42 runs vovnet57 on
  configs/base.yaml's recipe at bs512@176 (K1 once a step, its peak
  memory) and serves it. Each of the three prints its wall seconds, and
  the script its total;
- EfficientNet, MobileNetV3, ResNet, RegNet and the necks (slice 18):
  phase 21 holds K9 at the MBConv shapes too (k = 3 and 5, 112² to 7²
  maps, C = 16, 72, 144, 120, 200, 1152); phase 43 serves efficientnet_b0
  (12 K9 a request, the program's node count printed), runs its bs128@224
  step with drop-path 0.2 (12 + 12 K9 a step) and one step at bs8 against
  the plain versions and an f32 reference, and times K9 at each of its
  distinct stride-1 MBConv shapes at batch 128 beside cuDNN and the bound,
  the timed operands held; phase 44 serves mobilenet_v3_large (11 K9 a
  request), resnet50 (and runs its bs256@224 step: no kernel, one bf16
  step against an f32 one printed), regnet_y_1_6gf and resnext50_32x4d;
  phase 45 runs BiFPN(64, 3 layers) on efficientnet_b0's five taps at
  bs8@224 forward and backward through K9 (12 + 24 a forward) against the
  plain versions and an f32 reference, PAN(256) on darknet_yolov5s's last
  four maps and DeformableConv2d (v2, stride 1 and 2) on the card against
  the CPU in f32. Each prints its wall seconds.
- the trainer and the data plane: phase 46 runs ``python -m
  vision_toolbox_tpu_torch.train fit --config configs/base.yaml`` on 6
  synthetic steps (vovnet57 bs512@176, bf16, the full recipe) and reads its
  metrics.jsonl back (a finite loss and the schedule's lr at every step,
  K1 once a step, train_ips, peak memory, val/*, a profiler trace of 3
  steps for the idle share), its checkpoint and best/, then ``validate`` on
  the checkpoint (the same val metrics within 1e-6); phase 47 writes a
  seeded raw-shard corpus with the port's ``write_shard`` (4,096 images at
  200 px in 2 shards, 512 at 224, 100 classes) and trains
  configs/synth_hard_dev.yaml's cspdarknet53 at bs256@176 on it for 2
  epochs with the uint8 store on the card (K1 exactly once a step, the
  feed carrying the index vector alone), holds
  ``random_resized_crop_flip`` on the card against the CPU, and resumes
  from the epoch-1 checkpoint in a fresh Trainer (parameters, BN buffers
  and momentum bit-equal, start_epoch 1); phase 48 feeds the same step from
  the host's ``RawShardLoader`` through ``prefetch_to_device``, copies 4
  fed batches back bit-equal to the host's, and prints the step times
  (CUDA events), where the host waited and the idle share of both runs
  beside the bare steps of phases 7 and 42. Each prints its wall seconds.
- checkpoint interop and the serving utilities: phase 49 writes
  vit_b_16 (AugReg ``.npz``), deit_b_16, cait_s_24 (FB ``.pth``), swin_t
  (MS ``.pth``) and convnext_t (FB ``.pth``) in their releases' layouts at
  full size, seeded (``tests/official_ckpts.py``, torch and numpy only),
  into a temporary ``VTT_CACHE_DIR``, loads each with ``load_pretrained``
  in bf16 on the card and in f32 on the CPU (state dicts equal), holds the
  bf16 logits at batch 8 against the plain path and the CPU's f32 plain
  path (max(1e-2, 2× the plain bf16 path's own distance)) with exact
  launches, and serves each (3 requests at batch 8; vit_b_16 at 1, 8 and
  32, timed); phase 50 serves ``quantize_model`` of that vit_b_16 (72
  ``Int8Linear``, its blocks on the module chain: 12 K2 a request at 8 and
  32, none at 1, no K3/K4; one int8 product a quantized module a request
  and no float one; mean |int8 − f32| / mean |f32| < 0.05), times it in
  turns with the bf16 program, and holds one ``Int8Linear`` per shape class
  on the card bit-equal to the CPU's (weights, x8, the int32 product, the
  output; padded rows, k and n included); phase 51 runs ``profile_model``
  on vit_b_16 and convnext_t at bs32 bf16 and holds its GFLOPs equal to the
  plain path's count (the depthwise taps counted as the grouped
  convolution). Each prints its wall seconds.

Every phase prints what it found; any failure raises and exits non-zero.
Needs a CUDA card: without one it exits 1 and prints no result.

The last three lines are: the kernels as JSON (route, source, the TPU kernel
each replaces, launches in its path's run, error against the plain version,
time of kernel and plain version, the least time the card could take for
the same work and whether bytes or operations set it, and the time of one
PyTorch call computing the same function where there is one), the card's
name and power limit, and ``{"ok": true, "device": {...}}``. Details go to
``chiprun_out/chip_smoke.json`` beside this file.
"""

from __future__ import annotations

import copy
import contextlib
import functools
import inspect
import json
import math
import os
import re
import subprocess
import sys
import time
from pathlib import Path
from typing import NamedTuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

ROOT = Path(__file__).resolve().parent
KERNELS = {
    "block_mlp": {
        "route": "cuda",
        "source": "vision_toolbox_tpu_torch/csrc/block_mlp.cu",
        "replaces": "vision_toolbox_tpu/ops/block_mlp.py:365",
    },
    "block_attention": {
        "route": "cuda",
        "source": "vision_toolbox_tpu_torch/csrc/block_attention.cu",
        "replaces": "vision_toolbox_tpu/ops/block_attention.py:317",
    },
    "block_mlp_bwd": {
        "route": "cuda",
        "source": "vision_toolbox_tpu_torch/csrc/block_mlp_bwd.cu",
        "replaces": "vision_toolbox_tpu/ops/block_mlp.py:420",
    },
    "block_attention_bwd": {
        "route": "cuda",
        "source": "vision_toolbox_tpu_torch/csrc/block_attention_bwd.cu",
        "replaces": "vision_toolbox_tpu/ops/block_attention.py:358",
    },
    "warp_shear3": {
        "route": "cuda",
        "source": "vision_toolbox_tpu_torch/csrc/warp_shear3.cu",
        "replaces": "vision_toolbox_tpu/ops/warp_pallas.py:166",
    },
    "talking_head": {
        "route": "cuda",
        "source": "vision_toolbox_tpu_torch/csrc/talking_head.cu",
        "replaces": "vision_toolbox_tpu/ops/cait_attention.py:177",
    },
    "talking_head_bwd": {
        "route": "cuda",
        "source": "vision_toolbox_tpu_torch/csrc/talking_head_bwd.cu",
        "replaces": "vision_toolbox_tpu/ops/cait_attention.py:205",
    },
    "flash_attention": {
        "route": "cuda",
        "source": "vision_toolbox_tpu_torch/csrc/flash_attention.cu",
        "replaces": "vision_toolbox_tpu/ops/flash_attention.py:120",
    },
    "flash_attention_bwd": {
        "route": "cuda",
        "source": "vision_toolbox_tpu_torch/csrc/flash_attention_bwd.cu",
        "replaces": "vision_toolbox_tpu/ops/flash_attention.py:226",
    },
    "depthwise_conv": {
        "route": "cuda",
        "source": "vision_toolbox_tpu_torch/csrc/depthwise_conv.cu",
        "replaces": "vision_toolbox_tpu/ops/depthwise_conv.py:101",
    },
    "depthwise_conv_bwd": {
        "route": "cuda",
        "source": "vision_toolbox_tpu_torch/csrc/depthwise_conv_bwd.cu",
        "replaces": "vision_toolbox_tpu/ops/depthwise_conv.py:124",
    },
    "swin_attention": {
        "route": "cuda",
        "source": "vision_toolbox_tpu_torch/csrc/swin_attention.cu",
        "replaces": "vision_toolbox_tpu/ops/swin_attention.py:161",
    },
    "swin_attention_bwd": {
        "route": "cuda",
        "source": "vision_toolbox_tpu_torch/csrc/swin_attention_bwd.cu",
        "replaces": "vision_toolbox_tpu/ops/swin_attention.py:189",
    },
    "swin_partition": {
        "route": "cuda",
        "source": "vision_toolbox_tpu_torch/csrc/swin_relayout.cu",
        "replaces": "vision_toolbox_tpu/ops/swin_relayout.py:82",
    },
    "swin_unpartition": {
        "route": "cuda",
        "source": "vision_toolbox_tpu_torch/csrc/swin_relayout.cu",
        "replaces": "vision_toolbox_tpu/ops/swin_relayout.py:95",
    },
    "short_attention": {
        "route": "cuda",
        "source": "vision_toolbox_tpu_torch/csrc/short_attention.cu",
        "replaces": "vision_toolbox_tpu/ops/short_attention.py:312 (flat: :147)",
    },
    "short_attention_bwd": {
        "route": "cuda",
        "source": "vision_toolbox_tpu_torch/csrc/short_attention_bwd.cu",
        "replaces": "vision_toolbox_tpu/ops/short_attention.py:330 (flat: :168)",
    },
}
SERVE_KERNELS = ("block_mlp", "block_attention")
BLOCK_KERNELS = ("block_mlp", "block_attention", "block_mlp_bwd", "block_attention_bwd")
NO_LAUNCHES = dict.fromkeys(KERNELS, 0)
CAIT_S = dict(D=384, H=8, T=196)  # cait_s_24 at 224 px: 8 heads of 48, 196 patch tokens
# K5 cases (B, T, S, heads, head width): cait_s_24 at batch 8 and 128,
# cait_xxs and cait_m widths, a ragged T, T ≠ S, and head width 64
TALKING_HEAD_CASES = ((8, 196, 196, 8, 48), (128, 196, 196, 8, 48), (4, 196, 196, 4, 48),
                      (2, 196, 196, 16, 48), (3, 50, 50, 8, 48), (2, 24, 72, 4, 48),
                      (2, 40, 40, 4, 64))
# bf16 rel L2 to the plain versions of K5's first design (CUDA cores, f32
# throughout) at cait_s_24 b128 (scripts/ab_talking_head.py, PERF.md §6,
# NVIDIA H100 80GB HBM3): phase 13 holds the kernels to twice these
K5_FIRST_DESIGN_REL_L2 = {"out": 2.866e-5, "dq": 3.101e-5, "dk": 3.264e-5, "dv": 2.457e-5}
# CaiT's LayerScale init (1e-6) rounds every residual branch away in bf16;
# its paths run with γ drawn around this value, as a trained CaiT has them
CAIT_LAYER_SCALE = 0.1
CAIT_TRAIN = dict(batch=128, img=224, classes=1000, warmup=3, steps=10, lr=0.1,
                  layer_scale=CAIT_LAYER_SCALE)
# vit_b_16 SigLIP at 512 px: no cls token, MAP head, T = (512 / 16)² = 1024
SIGLIP = dict(img_size=512, weights="siglip")
SIGLIP_HEADS, SIGLIP_T = 12, 1024
# K6 cases (B, N, T, S, head width, dtype, biased): siglip at batch 8 and 32,
# one f32 shape, a ragged T ≠ S straight through the op, head widths 128
# and 80 (vit_h_14's)
FLASH_CASES = ((8, 12, 1024, 1024, 64, torch.bfloat16, True),
               (32, 12, 1024, 1024, 64, torch.bfloat16, False),
               (2, 12, 1024, 1024, 64, torch.float32, True),
               (2, 4, 1000, 1100, 64, torch.bfloat16, True),
               (2, 8, 1024, 1024, 128, torch.bfloat16, True),
               (2, 16, 1024, 1024, 80, torch.bfloat16, False))
FLASH_TIME_BATCH = 32
SIGLIP_TRAIN = dict(batch=64, img=512, classes=1000, warmup=3, steps=10, lr=0.1,
                    compare_batch=8)
# convnext_t: its four stages' depthwise-conv shapes (H = W, C) at 224 px,
# 3/3/9/3 blocks; K9 cases (B, H, W, C, k, offset): each stage at batch 8
# (the 7 × 7 and 14 × 14 regions among them), k = 3 and 5, a C that is no
# multiple of 8 (convnext_a's 40 is; 20 is not), a one-wide and a one-high
# map, a run-time k (9) and the gate's top (21), and stage 1 as a view one
# element into its buffer: C = 20 and the offset view take the scalar route
CONVNEXT_STAGES = ((56, 96, 3), (28, 192, 3), (14, 384, 9), (7, 768, 3))
DEPTHWISE_CASES = tuple((8, h, h, c, 7, 0) for h, c, _ in CONVNEXT_STAGES) + (
    (4, 28, 28, 64, 3, 0), (4, 19, 23, 48, 5, 0), (3, 13, 17, 20, 7, 0), (4, 11, 1, 64, 7, 0),
    (2, 1, 13, 40, 5, 0), (2, 12, 20, 16, 9, 0), (1, 9, 9, 32, 21, 0), (8, 56, 56, 96, 7, 1),
    # the MBConv nets' (slice 18): k = 3 and 5, 112² to 7² maps, channel
    # counts that are no multiple of K9's 32-channel group
    (8, 112, 112, 16, 3, 0), (8, 56, 56, 72, 3, 0), (8, 56, 56, 144, 3, 0),
    (8, 28, 28, 120, 5, 0), (8, 14, 14, 200, 3, 0), (8, 7, 7, 1152, 5, 0))
DEPTHWISE_TIME_BATCH = 128
# convnext_t's LayerScale init (1e-6) rounds every residual branch away in
# bf16, as CaiT's does; its paths run with γ drawn around CAIT_LAYER_SCALE
CONVNEXT_TRAIN = dict(batch=128, img=224, classes=1000, warmup=3, steps=10, lr=0.1,
                      layer_scale=0.1, compare_batch=8)
CONVNEXT_KW = dict(stochastic_depth=0.1)  # the published ConvNeXt-T recipe's drop path
# K3 at the widths 32-column tiles serve: convnext_t stage 1 (T = 56², D = 96)
# and cait_xs (T = 197, D = 288), (B, T, D, Dh). In f32 K3's error is the
# tail of bf16 rounding flips of h and g (a flip times a large W2 entry
# can reach ~1e-3·max|out|), which grows with the element count: stage 1 at
# batch 8 (9.6 M hidden elements) read 1.02e-3; batch 2 (2.4 M) stays below
# vit_b_16 at batch 8 (4.8 M), the case the f32 bound was set on
NARROW_MLP_CASES = ((2, 3136, 96, 384), (8, 197, 288, 1152))
# K3/K4 at the wgmma template's other tiles and tails: cait_s_24's MLP
# widths (384 / 1536, 128-column tiles, M = 784 ends 16 rows into a 128-row
# tile) and 160 / 640, a width only the 32-column tile takes (B_KN at the
# 64-byte swizzle); K4's three-product q/k/v launch at D = 192 (96-column
# tiles) and 320 (32-column), 64-wide heads, ragged T. (B, T, D, Dh) and
# (B, T, D, heads).
TILE_MLP_CASES = ((4, 196, 384, 1536), (3, 50, 160, 640))
TILE_ATTN_CASES = ((3, 50, 192, 3), (2, 77, 320, 5))
# swin_t at 224 px (window 7, T = 49, 32-wide heads): per stage the map side,
# windows, heads, blocks and shifted blocks (stage 4's 7×7 map never shifts)
SWIN_STAGES = ((56, 64, 3, 2, 1), (28, 16, 6, 2, 1), (14, 4, 12, 6, 3), (7, 1, 24, 2, 0))
# K7 cases (B, nW, T, heads, head width, masked): each swin_t stage at batch
# 8 (shifted stages with their mask), window 8 at head 128 (the tensor-core
# kernels' widest), window 14 (T = 196, the S3 variants) with and without a
# mask, one image a block and (batch 32 and 64) two and three, and T = 256 at
# head 128, whose operands stay in device memory
SWIN_ATTENTION_CASES = tuple((8, nw, 49, n, 32, k > 0) for _, nw, n, _, k in SWIN_STAGES) + (
    (4, 4, 64, 2, 128, True), (8, 1, 196, 12, 32, False), (2, 16, 196, 3, 32, True),
    (32, 1, 196, 12, 32, False), (64, 4, 196, 3, 32, True), (2, 2, 256, 2, 128, True))
# K8 cases (B, H, W, C, window, shift): swin_t's three shifted stages at
# batch 8, window 14, and channels whose bytes take narrower copies
SWIN_RELAYOUT_CASES = tuple((8, h, h, 96 * 2**i, 7, 3) for i, (h, *_) in
                            enumerate(SWIN_STAGES[:3])) + ((2, 28, 28, 96, 14, 7),
                                                           (3, 8, 12, 5, 4, 2))
SWIN_TIME_BATCH = 128
SWIN_SERVE_BATCHES = (1, 8, 32, 128)  # 128: the JAX package's v5e serving "cliff"
SWIN_TRAIN = dict(batch=128, img=224, classes=1000, warmup=3, steps=10, lr=0.1,
                  compare_batch=8)
SWIN_KW = dict(stochastic_depth=0.2)  # Swin-T's published drop-path rate
# the repaired head widths: K5 at 32, 96 and 160 wide heads and at the JAX
# rule's (T, S, N) = (64, 512, 16) corner; K6 at head 256, (B, N, T, H)
REPAIRED_TALKING_HEAD_CASES = ((2, 40, 40, 4, 32), (2, 40, 56, 4, 96), (2, 24, 40, 4, 160),
                               (2, 64, 512, 16, 48), (8, 64, 512, 16, 48))
WIDE_FLASH = (8, 4, 1024, 256)
# K2 cases (B, T, S, N, H, entry): vit_b_16 at batch 8 and 128, vit_l_16 (16
# heads of 64), vit_h_14 (16 heads of 80, T = 257) through the flat entry,
# the rule's corner, T ≠ S, T = S = 2 at 64 pairs, a head of 40
SHORT_CASES = ((8, 197, 197, 12, 64, "packed"), (128, 197, 197, 12, 64, "packed"),
               (8, 197, 197, 16, 64, "packed"), (4, 257, 257, 16, 80, "flat"),
               (1, 512, 512, 64, 128, "packed"), (8, 50, 197, 12, 64, "packed"),
               (64, 2, 2, 1, 64, "packed"), (4, 197, 197, 16, 40, "packed"))
SHORT_TIME_BATCH = 128
# the second-plane control's cases (B, T, S, N, H), bf16: vit_b_16 at batch 8
# and a head of 40; the kernels lie at most SECOND_PLANE of the controls'
# distance (rel L2) from the plain versions
SHORT_CONTROL_CASES = ((8, 197, 197, 12, 64), (4, 197, 197, 16, 40))
SECOND_PLANE = 0.5
VIT_DROPOUT = dict(dropout=0.1)  # ViT-B/16's ImageNet rate (Dosovitskiy et al., Table 3)
VIT_UNFUSED_TRAIN = dict(batch=128, img=224, classes=1000, warmup=3, steps=10, lr=0.1,
                         compare_batch=8)
UNFUSED = dict(force_unfused=True)
# PERF.md §6's times of the K6 kernels (SigLIP vit_b_16 b32 and head 256, bf16;
# NVIDIA H100 80GB HBM3, 700 W), which phases 17 and 33 print beside this run's:
# kernels the K2 and K7 redesigns leave as they were; and the times of K2's and
# K7's earlier wmma designs (vit_b_16 b128; swin_t stage 1 b128, PERF.md §6),
# which phases 35 and 29 print beside the redesigned kernels'
SECTION6_MS = {"flash_attention": 0.6930, "flash_attention_bwd": 2.1940,
               "flash_attention_head256": 0.3777, "flash_attention_bwd_head256": 1.2760}
K2_EARLIER_MS = {"short_attention": 0.8728, "short_attention_bwd": 2.6521}
K7_EARLIER_MS = {"swin_attention": 1.3428, "swin_attention_bwd": 2.4855}
# K9's first design's times at convnext_t stage 1 b128 bf16 (PERF.md §6),
# which phase 22 prints beside the redesigned kernels'
K9_EARLIER_MS = {"depthwise_conv": 0.3935, "depthwise_conv_bwd": 1.2059}
# K3/K4's first design's times (PERF.md §6), which phase 38 prints beside
# the redesigned kernels' and the module chain's: (half, batch) → (forward,
# backward or None); the batch-128 transformer forwards are the save
# variants, the others serve
K3K4_EARLIER_MS = {("block_mlp", 8): (0.2905, None), ("block_attention", 8): (0.2536, None),
                   ("block_mlp", 128): (3.8642, 2.3551),
                   ("block_attention", 128): (3.0497, 2.7959),
                   ("block_mlp_convnext", 128): (2.6220, 2.6481)}
# K4's attention core in its first design (wmma tiles; PERF.md §6, measured
# with scripts/ab_block_kernels.py --core on an NVIDIA H100 80GB HBM3, 700 W):
# the bf16 rel L2 to the plain versions at vit_b_16 b128, which phase 39
# holds the register-tile core to twice of, and its device ms a call there
# (the served and the save forward's core, the backward's rows and keys
# passes), printed beside this run's
K4_FIRST_CORE_REL_L2 = {"out": 5.093e-4, "p": 2.889e-4, "dx": 3.772e-4, "dq": 2.103e-4,
                        "dk": 3.406e-4, "dv": 1.527e-4}
K4_FIRST_CORE_MS = {"forward": 0.6875, "save_forward": 0.7217, "rows": 0.9760, "keys": 0.6181}
# the core's corners (B, T, D, heads), bf16, held against the plain versions
# in phase 39: one mostly masked 16-row tile, vit_b_16 (two warps share a row
# tile's keys), T = 512 (four) and head 128 at T = 480 (eight, V following K
# into one buffer)
K4_CORE_CASES = ((4, 2, 128, 2), (2, 197, 768, 12), (2, 512, 768, 12), (1, 480, 256, 2))
# head 128 at T = 512 (d_model 768, 6 heads, batch 8): the gate admits it
# (its shape term is the core's own shared memory); phase 39 holds it as the
# b128 case (rel L2 within twice K4_FIRST_CORE_REL_L2) and times its core
K4_HEAD128 = (8, 512, 768, 6)
# K7's second-plane control cases (B, nW, T, N, hd, masked), bf16: swin_t stage
# 1 at batch 8 and window 14 (swin_s3_t stage 3); held as K2's (SECOND_PLANE)
SWIN_CONTROL_CASES = ((8, 64, 49, 3, 32, True), (8, 1, 196, 12, 32, False))
# window 14 timed beside stage 1: swin_s3_t stage 3 at batch 128
SWIN_WINDOW14 = (SWIN_TIME_BATCH, 1, 196, 12, 32, False)
# the K3/K4 half-blocks through the port's module chain (phase 38): vit_b_16's
# at batch 8 and 128, ConvNeXt-T stage 1's MLP half (γ, residual) at batch 128
CHAIN_CASES = (("block_mlp", 8, 197, 768), ("block_attention", 8, 197, 768),
               ("block_mlp", 128, 197, 768), ("block_attention", 128, 197, 768),
               ("block_mlp_convnext", 128, 56 * 56, 96))
# MLP-Mixer (slice 17): mixer_b_16 at 224 px, 12 blocks of d 768 on N = 196
# tokens, each channel half K3 (3072 hidden), the token halves torch.matmul;
# mixer_s_8 (8 blocks, d 512) has N = 784; K3 is timed at its channel half
# at batch 128, (B, T, D, Dh)
MIXER_TRAIN = dict(batch=128, img=224, classes=1000, warmup=3, steps=10, lr=0.1,
                   compare_batch=8)
MIXER_S8 = dict(name="mixer_s_8", batch=8, blocks=8)
MIXER_S8_MLP = (128, 784, 512, 2048)
# PatchConvNet (slice 17): patchconvnet_s, 60 blocks on a 14 × 14 × 384 map,
# each K9 at k = 3; drop-path 0.3 in every block (the published recipe's);
# LayerScale γs spread around 0.1 as convnext_t's (1e-6 rounds away in bf16);
# K9 timed at its trunk at batch 128, (B, H = W, C, k)
PATCHCONV_TRAIN = dict(batch=128, img=224, classes=1000, warmup=3, steps=10, lr=0.1,
                       compare_batch=8, layer_scale=0.1)
PATCHCONV_DEPTHWISE = (128, 14, 384, 3)
# VoVNet (slice 17): vovnet57, the backbone of configs/base.yaml, on its recipe
# at its batch, 512 at 176 px (14.2 GiB at cell (b)'s 256 on an H100 80 GB:
# 512 fits)
VOVNET_TRAIN = dict(model="vovnet57", batch=512, img=176, classes=1000, warmup=3, steps=10)
# EfficientNet-B0 (slice 18, cell (r)): 16 MBConvs, 12 of them stride 1 with
# their depthwise conv on K9; drop-path 0.2·i/16 (the model's published
# rate); served at SERVE_BATCHES and trained at bs128@224 with the convnet
# recipe of the other cells. Its distinct stride-1 depthwise shapes at
# 224 px, (H = W, C, k, blocks), timed at batch 128
EFFICIENTNET_TRAIN = dict(batch=128, img=224, classes=1000, warmup=3, steps=10, lr=0.1,
                          compare_batch=8)
EFFICIENTNET_KW = dict(stochastic_depth=0.2)
EFFICIENTNET_DEPTHWISE = ((112, 32, 3, 1), (56, 144, 3, 1), (28, 240, 5, 1), (14, 480, 3, 2),
                          (14, 480, 5, 1), (14, 672, 5, 2), (7, 1152, 5, 3), (7, 1152, 3, 1))
# the other families at full width (slice 18, cell (s)): resnet50's step at
# bs256@224 on the same recipe (no kernel in the model: bf16 against f32)
RESNET_TRAIN = dict(batch=256, img=224, classes=1000, warmup=3, steps=10, lr=0.1,
                    compare_batch=8)
# the necks (slice 18): BiFPN(64, 3 layers) on efficientnet_b0's five taps at
# bs8@224 (8 K9 a layer); PAN(256) on darknet_yolov5s's last four maps, the
# README's composition (bs2@224, card vs CPU, f32); DeformableConv2d (v2, 3 ×
# 3) at stride 1 and 2 on a 56² × 64 map, card vs CPU, f32
BIFPN = dict(batch=8, out_channels=64, num_layers=3)
PAN_NECK = dict(backbone="darknet_yolov5s", out_channels=256, batch=2)
DEFORM_CASES = ((4, 56, 64, 128, 1), (4, 56, 64, 128, 2))  # (B, H = W, C, Co, stride)
CARD_VS_CPU_REL_L2 = 1e-4  # f32 on both: summation order only
BOUND = {torch.float32: 1e-3, torch.bfloat16: 2e-2}  # × max|plain|
# K6 in f32 keeps every operand as three bf16 planes and p and ds as three,
# so it is held closer (measured 1.07e-5); a control that rounds p and ds to
# bf16 once, as a one-plane kernel would, must fail this bound
FLASH_BOUND = BOUND | {torch.float32: 1e-4}
VIT_B = dict(D=768, H=12, Dh=3072)
SERVE_BATCHES = (1, 8, 32)
REL_L2_BOUND = 1e-2
WARP_BOUND = 1e-5  # max abs, [0, 1] images: same f32 operations on both sides
TRAIN = dict(model="cspdarknet53", batch=256, img=176, classes=1000, warmup=3, steps=10)
LOSS_REL_BOUND = 1e-3  # kernel-path vs plain-path step: bf16 rounding flips only
BWD_REL_L2 = 1e-2  # reduced and weight gradients of a backward kernel vs its plain version
GRAD_REL_L2 = 2e-2  # every parameter gradient, kernel-path step vs plain-path step
VIT_TRAIN = dict(batch=128, img=224, classes=1000, warmup=3, steps=10, lr=0.1)
DEIT3 = dict(batch=16, img=224, classes=1000, steps=3, stochastic_depth=0.1)
# Published peaks of one H100 SXM (NVIDIA's data sheet, dense): bf16 tensor
# cores, f32 on the CUDA cores, and device memory; the least time of a
# kernel is the larger of its operations and its bytes over these.
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12


def log(msg: str) -> None:
    print(msg, flush=True)


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def alternate(plain, kernel, **kw) -> tuple[float, float]:
    """Times in turns (plain, kernel, kernel, plain); mean of each pair."""
    p1, k1, k2, p2 = time_ms(plain, **kw), time_ms(kernel, **kw), time_ms(kernel, **kw), \
        time_ms(plain, **kw)
    return (p1 + p2) / 2, (k1 + k2) / 2


def against_section6(name: str, ms: float) -> str:
    """This run's time of a kernel beside PERF.md §6's (SECTION6_MS)."""
    ref = SECTION6_MS[name]
    return f"PERF.md §6 {ref:.4f} ms, this run / §6 = {ms / ref:.3f}"


def rel_l2(a: torch.Tensor, b: torch.Tensor, ref: torch.Tensor | None = None) -> float:
    """‖a − b‖ / ‖ref‖ (ref defaults to b); 0 where a equals b, a zero
    reference included (CaiT's first class-attention query weights get an
    exactly zero gradient from the zero cls token)."""
    diff = (a.float() - b.float()).norm()
    if diff == 0:
        return 0.0
    return (diff / (b if ref is None else ref).float().norm()).item()


def bound(flops: float, nbytes: float, f32_flops: float = 0.0) -> tuple[float, str]:
    """(least ms on the card, what sets it): operations against bytes (each
    input read once, each output written once) over the memory rate. The
    products of bf16-typed operands count at the bf16 tensor-core peak,
    ``f32_flops`` (elementwise f32 work such as K5's head mixes) at the
    f32 peak; the two units run side by side, so the larger counts."""
    t_ops = max(flops / PEAK_BF16_FLOPS, f32_flops / PEAK_F32_FLOPS) * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def talking_head_work(name: str, B: int, T: int, S: int, H: int, D: int,
                      x_bytes: int) -> tuple[float, float, float]:
    """(product operations, bytes, f32 operations) of one K5 call: the
    forward's q·kᵀ and pw·v per head and its two head mixes; the
    backward's five products (the recomputed logits, dout·vᵀ, dv, dq, dk),
    four mixes and the two mix-parameter sums. Bytes: q/k/v (and dout) in,
    o (dq/dk/dv) out, the f32 mixes (and their gradients)."""
    mix_bytes = (2 * H * H + 2 * H) * 4
    if name == "talking_head":
        return (4 * B * T * S * D, (2 * T + 2 * S) * B * D * x_bytes + mix_bytes,
                4 * B * H * H * T * S)
    return (10 * B * T * S * D, (3 * T + 4 * S) * B * D * x_bytes + 2 * mix_bytes,
            12 * B * H * H * T * S)


def block_work(name: str, B: int, T: int, x_bytes: int, ls: bool = False,
               widths: dict = VIT_B) -> tuple[float, float]:
    """(operations, bytes) of one call of a half-block kernel at ``widths``
    (vit_b_16's by default): the products the kernel runs and the tensors it
    must read and write (x/dout/dx in ``x_bytes`` per element, saves and
    weights bf16)."""
    D, Dh, H = widths["D"], widths["Dh"], widths.get("H", 1)
    M, vec = B * T, 4 * D
    if name == "block_mlp":  # x, out; W1, W2; biases, LN
        return 4 * M * D * Dh, 2 * M * D * x_bytes + 4 * D * Dh + 4 * vec + 4 * Dh
    if name == "block_attention":  # x, out; Wq/k/v/o; q·kᵀ and p·v per image
        return 8 * M * D * D + 4 * B * T * T * D, 2 * M * D * x_bytes + 8 * D * D + 6 * vec
    if name == "block_mlp_bwd":  # dout, xhat, rstd, h (, mlpout); W1, W2 → dx, dh, 5 sums
        flops = 4 * M * D * Dh
        nbytes = (2 * M * D * x_bytes + 2 * M * D + 4 * M + 4 * M * Dh + 4 * D * Dh
                  + 2 * M * D * ls + 6 * vec + 4 * Dh)
        return flops, nbytes
    # block_attention_bwd: dout, xhat, rstd, q, k, v, p (, proj); Wo, Wq/k/v
    #   → dx, dq, dk, dv, 7 sums; do = douts·Wo, dy over 3·D, 4 attention products
    flops = 2 * M * D * D + 6 * M * D * D + 8 * B * T * T * D
    nbytes = (2 * M * D * x_bytes + 2 * M * D + 4 * M + 12 * M * D + 2 * B * H * T * T
              + 2 * M * D * ls + 8 * D * D + 8 * vec)
    return flops, nbytes


def mlp_args(g, B, T, D, Dh, dtype, extras, residual):
    r = lambda *s, scale=1.0, shift=0.0: (torch.randn(s, generator=g) * scale + shift)
    a = dict(
        x=r(B, T, D), ln_scale=r(D, scale=0.1, shift=1.0), ln_bias=r(D, scale=0.1),
        w1=r(Dh, D, scale=D**-0.5), b1=r(Dh, scale=0.1),
        w2=r(D, Dh, scale=Dh**-0.5), b2=r(D, scale=0.1),
        ls_gamma=r(D, scale=0.2, shift=0.5) if extras else None,
        residual=r(B, T, D) if residual else None,
    )
    a = {k: None if v is None else v.to("cuda", dtype) for k, v in a.items()}
    a["dp_scale"] = ((torch.rand(B, 1, generator=g) < 0.8).float() / 0.8).cuda() if extras else None
    return a


def attn_args(g, B, T, D, H, dtype, extras):
    r = lambda *s, scale=1.0, shift=0.0: (torch.randn(s, generator=g) * scale + shift)
    a = dict(x=r(B, T, D), ln_scale=r(D, scale=0.1, shift=1.0), ln_bias=r(D, scale=0.1))
    for n in ("q", "k", "v", "o"):
        a[f"w{n}"], a[f"b{n}"] = r(D, D, scale=D**-0.5), r(D, scale=0.1)
    a["ls_gamma"] = r(D, scale=0.2, shift=0.5) if extras else None
    a = {k: None if v is None else v.to("cuda", dtype) for k, v in a.items()}
    a["n_heads"] = H
    a["dp_scale"] = ((torch.rand(B, 1, generator=g) < 0.8).float() / 0.8).cuda() if extras else None
    return a


def mlp_cases(variants: tuple[str, ...]) -> list[tuple]:
    """(B, T, D, Dh, dtype, variant) of the K3 comparisons: vit_b_16's
    widths at batch 8 and 3 in ``variants``, then NARROW_MLP_CASES (the
    32-column tiles), plain and in ConvNeXt's form (γ_ls, dp, residual);
    f32 and bf16 each."""
    dtypes = (torch.float32, torch.bfloat16)
    return ([(B, T, VIT_B["D"], VIT_B["Dh"], dt, v) for B, T in ((8, 197), (3, 50))
             for dt in dtypes for v in variants]
            + [(B, T, D, Dh, dt, v) for B, T, D, Dh in NARROW_MLP_CASES + TILE_MLP_CASES
               for dt in dtypes for v in ("plain", "ls+dp+residual")])


def attn_tile_cases() -> list[tuple]:
    """(B, T, D, heads, dtype, variant) of the K4 comparisons at the
    template's narrower tiles (TILE_ATTN_CASES), f32 and bf16."""
    return [(B, T, D, H, dt, v) for B, T, D, H in TILE_ATTN_CASES
            for dt in (torch.float32, torch.bfloat16) for v in ("plain", "ls+dp")]


def is_main_case(B: int, T: int, D: int, dtype: torch.dtype, variant: str) -> bool:
    """The main path's comparison case: vit_b_16, batch 8, bf16, no γ/dp."""
    return (B, T, D, dtype, variant) == (8, 197, VIT_B["D"], torch.bfloat16, "plain")


def compare_kernels(report: dict) -> dict[str, float]:
    """Phase 3: each forward kernel vs its plain version, K3 at every width
    of ``mlp_cases`` and K4 at vit_b_16's and ``attn_tile_cases``; returns
    the max abs error at the main path's case."""
    from vision_toolbox_tpu_torch.ops import block_attention as ba
    from vision_toolbox_tpu_torch.ops import block_mlp as bm

    g = torch.Generator().manual_seed(0)
    main_err = {}
    rows = []
    runs = [(*c, "mlp") for c in mlp_cases(("plain", "ls+dp", "ls+dp+residual"))]
    runs += [(B, T, D, H, dt, v, "attention") for B, T, D, H, dt, v in attn_tile_cases()]
    for B, T, D, Dh, dtype, variant, kind in runs:
        cases = []
        if kind == "mlp":
            a = mlp_args(g, B, T, D, Dh, dtype, variant != "plain", variant.endswith("residual"))
            cases.append(("block_mlp", bm.fused_mlp_block_plain(**a), bm.fused_mlp_block(**a)))
        if kind == "attention" or variant != "ls+dp+residual" and D == VIT_B["D"]:
            a = attn_args(g, B, T, D, Dh if kind == "attention" else VIT_B["H"], dtype,
                          variant != "plain")
            cases.append(("block_attention", ba.fused_attention_block_plain(**a),
                          ba.fused_attention_block(**a)))
        torch.cuda.synchronize()
        for name, want, got in cases:
            err = (got.float() - want.float()).abs().max().item()
            scale = want.float().abs().max().item()
            ok = bool(torch.isfinite(got.float()).all()) and err <= BOUND[dtype] * scale
            row = dict(kernel=name, B=B, T=T, D=D, dtype=str(dtype).split(".")[-1],
                       variant=variant, max_abs_err=err, max_abs_plain=scale,
                       bound=BOUND[dtype] * scale, ok=ok)
            rows.append(row)
            log(f"[compare] {name:15s} B={B} T={T} D={D} {row['dtype']:8s} {variant:15s} "
                f"max|err|={err:.3e} bound={row['bound']:.3e} "
                f"({err / scale:.2e}·max|plain|) {'ok' if ok else 'FAIL'}")
            if is_main_case(B, T, D, dtype, variant):
                main_err[name] = err
    report["compare"] = rows
    bad = [r for r in rows if not r["ok"]]
    if bad:
        raise AssertionError(f"{len(bad)} kernel comparisons out of bounds: {bad}")
    return main_err


def time_kernels(report: dict) -> dict[str, tuple[float, float]]:
    """Kernel vs plain time at vit_b_16 shapes, bf16, batch 8 and 128."""
    from vision_toolbox_tpu_torch.ops import block_attention as ba
    from vision_toolbox_tpu_torch.ops import block_mlp as bm

    g = torch.Generator().manual_seed(1)
    out, rows = {}, []
    for B in (8, 128):
        m = mlp_args(g, B, 197, VIT_B["D"], VIT_B["Dh"], torch.bfloat16, False, False)
        a = attn_args(g, B, 197, VIT_B["D"], VIT_B["H"], torch.bfloat16, False)
        for name, plain, kernel in (
            ("block_mlp", lambda: bm.fused_mlp_block_plain(**m), lambda: bm.fused_mlp_block(**m)),
            ("block_attention", lambda: ba.fused_attention_block_plain(**a),
             lambda: ba.fused_attention_block(**a)),
        ):
            plain_ms, ms = alternate(plain, kernel, iters=10 if B == 128 else 20)
            rows.append(dict(kernel=name, B=B, T=197, dtype="bfloat16", ms=ms, plain_ms=plain_ms))
            log(f"[time] {name:15s} B={B:3d} T=197 bf16 kernel {ms:.4f} ms  plain {plain_ms:.4f} ms")
            if B == 8:
                out[name] = (ms, plain_ms)
    report["kernel_times"] = rows
    return out


def warp_case(g, B, S):
    """[0, 1] images and a program mix: identity, ±shear X/Y, ±translate,
    rotations at k90 = −1, 0, +1 and near ±45° and ±135°, then random ops."""
    from vision_toolbox_tpu_torch.ops import trivial_augment as ta

    fixed = [(ta.OP_IDENTITY, 0.0), (ta.OP_SHEAR_X, 0.9), (ta.OP_SHEAR_X, -0.5),
             (ta.OP_SHEAR_Y, 0.7), (ta.OP_SHEAR_Y, -1.0), (ta.OP_TRANSLATE_X, 0.6),
             (ta.OP_TRANSLATE_Y, -0.8), (ta.OP_ROTATE, 1.0), (ta.OP_ROTATE, -1.0),
             (ta.OP_ROTATE, 1 / 3), (ta.OP_ROTATE, -1 / 3 - 1e-3), (ta.OP_ROTATE, 0.2),
             (ta.OP_ROTATE, 0.98), (ta.OP_EQUALIZE, 0.5)]
    op = torch.randint(0, ta.NUM_OPS, (B,), generator=g)
    mag = torch.rand(B, generator=g) * 2 - 1
    n = min(B, len(fixed))
    op[:n] = torch.tensor([o for o, _ in fixed[:n]])
    mag[:n] = torch.tensor([m for _, m in fixed[:n]])
    return torch.rand(B, S, S, 3, generator=g).cuda(), op.cuda(), mag.cuda()


# K1's one-kind batches (scripts/ab_warp.py times each): the op and the
# magnitudes, signs alternating image by image; a pixel op is an identity warp
WARP_KINDS = {"identity": ("OP_SOLARIZE", 0.5), "shear_x": ("OP_SHEAR_X", 0.9),
              "shear_y": ("OP_SHEAR_Y", 0.9), "translate": ("OP_TRANSLATE_X", 0.8),
              "rotate_45": ("OP_ROTATE", 1 / 3), "rotate_135": ("OP_ROTATE", 1.0)}


def warp_kind_case(g, B, S, kind):
    """[0, 1] images under one kind of program (WARP_KINDS): rotate_45 turns
    by ±45° (k90 = 0), rotate_135 by ±135° (k90 = ±1: the footprint read
    transposed), translate moves along x and y in turn."""
    from vision_toolbox_tpu_torch.ops import trivial_augment as ta

    name, m = WARP_KINDS[kind]
    op = torch.full((B,), getattr(ta, name))
    if kind == "translate":
        op[1::2] = ta.OP_TRANSLATE_Y
    mag = torch.where(torch.arange(B) % 2 == 0, m, -m)
    return torch.rand(B, S, S, 3, generator=g).cuda(), op.cuda(), mag.cuda()


def compare_warp(report: dict) -> tuple[float, float, float]:
    """Phase 6: K1 vs its plain version (same program), bit for bit, at
    bs256@176 on the mixed program (warp_case), an all-rotation batch
    (k90 = ±1) and an all-identity batch, and B=5 at 32 px; time both at
    bs256@176, each batch: the kernel's launch on operands made once, and
    beside it the wrapper, which builds the program's operands each call
    (a dozen small launches, host-bound). Returns (err, ms, plain_ms) of the
    mixed one."""
    from vision_toolbox_tpu_torch.ops import _cuda, warp

    g = torch.Generator().manual_seed(6)
    rows, main = [], None
    for B, S, kind in ((256, 176, "mixed"), (5, 32, "mixed"), (256, 176, "rotate_135"),
                       (256, 176, "identity")):
        x, op, mag = warp_case(g, B, S) if kind == "mixed" else warp_kind_case(g, B, S, kind)
        program = warp.shear3_params(op, mag)
        want = warp.shear3_warp_plain(x, program)
        got = warp.shear3_warp_cuda(x, program)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        differ = int((got != want).sum().item())
        ok = bool(torch.isfinite(got).all()) and got.shape == x.shape and differ == 0
        rows.append(dict(B=B, S=S, kind=kind, max_abs_err=err, differing=differ, ok=ok,
                         k90=sorted(set(program[0].tolist()))))
        log(f"[warp] K1 vs plain B={B} {S}px {kind}: {differ} differing elements, "
            f"max|err|={err:.3e} k90 {rows[-1]['k90']} {'ok' if ok else 'FAIL'}")
        if B == 256:
            flags, coef = warp.program_operands(program)
            out = torch.empty_like(x)
            canvas = warp.canvas_size(S)

            def kernel():
                _cuda.check(_cuda.lib().vtt_warp_shear3(
                    _cuda.ptr(x), _cuda.ptr(out), _cuda.ptr(flags), _cuda.ptr(coef), B, S, S, 3,
                    canvas, (canvas - S) // 2, _cuda.stream()), "shear3_warp")

            plain_ms, ms = alternate(lambda: warp.shear3_warp_plain(x, program), kernel, iters=10)
            wrapper_ms = time_ms(lambda: warp.shear3_warp_cuda(x, program), iters=10)
            rows[-1] |= dict(ms=ms, plain_ms=plain_ms, wrapper_ms=wrapper_ms)
            if kind == "mixed":
                main = (err, ms, plain_ms)
            log(f"[warp] bs256@176 f32 {kind}: kernel {ms:.4f} ms (through the wrapper "
                f"{wrapper_ms:.4f})  plain {plain_ms:.4f} ms")
    report["warp"] = dict(compare=rows, ms=main[1], plain_ms=main[2],
                          wrapper_ms=rows[0]["wrapper_ms"])
    if not all(r["ok"] for r in rows):
        raise AssertionError(f"K1 differs from its plain version: {rows}")
    return main


@contextlib.contextmanager
def plain_warp():
    """Route the three-shear warp through its plain version on the card."""
    from vision_toolbox_tpu_torch.ops import warp

    kernel = warp.shear3_warp_cuda
    warp.shear3_warp_cuda = warp.shear3_warp_plain
    try:
        yield
    finally:
        warp.shear3_warp_cuda = kernel


def recipe_step_parts(cfg: dict):
    """A seeded bf16 classifier on ``cfg["model"]`` (built on the card),
    its SGD state (three groups, warmup-cosine at lr 0.5·B/1024) and the
    full-recipe train step (TrivialAugment through K1, RandomErasing 0.1,
    CutMix⊕MixUp, label smoothing 0.1), uint8 images and labels made on the
    card, and the step's generator."""
    import vision_toolbox_tpu_torch as vtt
    from vision_toolbox_tpu_torch.train import (
        ImageClassifier, TrainState, make_train_step, sgd_with_param_groups,
        warmup_cosine_schedule,
    )

    B, S, classes = cfg["batch"], cfg["img"], cfg["classes"]
    gen = torch.Generator().manual_seed(0)
    backbone = vtt.create_backbone(cfg["model"], dtype=torch.bfloat16, device="cuda",
                                   generator=gen)
    model = ImageClassifier(backbone, classes, dtype=torch.bfloat16, generator=gen)
    schedule = warmup_cosine_schedule(0.5 * B / 1024, 100, 1_281_167 // B)
    opt = sgd_with_param_groups(model, schedule, momentum=0.9, weight_decay=2e-5)
    step = make_train_step(classes, label_smoothing=0.1, mixup_alpha=0.2, cutmix_alpha=1.0,
                           trivial_augment=True, random_erasing_p=0.1,
                           compute_dtype=torch.bfloat16)
    data = torch.Generator(device="cuda").manual_seed(1)
    images = torch.randint(0, 256, (B, S, S, 3), dtype=torch.uint8, device="cuda", generator=data)
    labels = torch.randint(0, classes, (B,), device="cuda", generator=data)
    g = torch.Generator(device="cuda").manual_seed(2)
    return TrainState(model, opt), step, images, labels, g


def train(report: dict, name_power: str) -> int:
    """Phase 7 (the training path): the full-recipe cspdarknet53 step at
    bs256@176, 3 warm-up + 10 timed steps; then phase 8, one step through K1
    against one through its plain version from one state and one set of
    draws. Returns K1's launches in the training run."""
    watched = ("head.weight", "backbone.stem.conv.weight", "backbone.stem.norm.running_mean",
               "backbone.stage_4.out_conv.norm.running_var")
    return train_recipe(report, "train", TRAIN, watched, name_power)


def train_recipe(report: dict, key: str, cfg: dict, watched: tuple[str, ...],
                 name_power: str) -> int:
    """The full-recipe step of ``cfg["model"]`` (``recipe_step_parts``) at
    ``cfg``'s batch and size, warm-up and timed steps, K1 launched once a
    step, peak memory from the first step; then one step through K1 against
    one through its plain version from one state and one set of draws.
    Returns K1's launches in the timed run."""
    from vision_toolbox_tpu_torch.ops import _cuda

    state, step, images, labels, g = recipe_step_parts(cfg)
    model, B, S, classes, tag = state.model, cfg["batch"], cfg["img"], cfg["classes"], key
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[{tag}] {cfg['model']} + head {classes}: {n_params / 1e6:.2f} M f32 params, bf16 "
        f"compute, bs{B}@{S}, TA + RE 0.1 + CutMix⊕MixUp, SGD 0.9, wd 2e-5 (3 groups), cudnn "
        "TF32 off")
    before = {k: model.state_dict()[k].detach().clone() for k in watched}

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # the main path: counts from 0 just before, read just after
    _cuda.reset_launch_counts()
    losses = []
    for _ in range(cfg["warmup"]):
        losses.append(step(state, images, labels, g)["loss"])
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(cfg["steps"]):
        losses.append(step(state, images, labels, g)["loss"])
    end.record()
    end.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / cfg["steps"]
    launches = dict(_cuda.LAUNCHES)
    ms = start.elapsed_time(end) / cfg["steps"]
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = [float(v) for v in losses]
    n_steps = cfg["warmup"] + cfg["steps"]
    log(f"[{tag}] losses {['%.4f' % v for v in losses]}")
    log(f"[{tag}] {ms:.2f} ms/step, {B / ms * 1e3:.1f} img/s (CUDA events over {cfg['steps']} "
        f"steps; host clock {wall_ms:.2f} ms/step); peak memory {peak:.1f} GiB  [{name_power}]")
    log(f"[{tag}] launches in {n_steps} steps: {launches}")
    changed = {k: not torch.equal(v, model.state_dict()[k]) for k, v in before.items()}
    report[key] = dict(ms_per_step=ms, img_per_s=B / ms * 1e3, host_ms_per_step=wall_ms,
                       losses=losses, launches=launches, changed=changed, peak_gib=peak)
    if not all(map(math.isfinite, losses)):
        raise AssertionError(f"non-finite loss: {losses}")
    if not all(changed.values()):
        raise AssertionError(f"parameters or BN statistics did not change: {changed}")
    if launches != NO_LAUNCHES | {"warp_shear3": n_steps}:
        raise AssertionError(f"expected {n_steps} K1 launches and no other kernel: {launches}")

    # phase 8: one step through K1 vs one through its plain version
    draws = step.sample_draws(g, (B, S, S, 3))
    x_kernel, _ = step.augment(images, labels, draws)
    with plain_warp():
        x_plain, _ = step.augment(images, labels, draws)
    states = [copy.deepcopy(state) for _ in range(2)]
    loss_kernel = float(step(states[0], images, labels, draws=draws)["loss"])
    with plain_warp():
        loss_plain = float(step(states[1], images, labels, draws=draws)["loss"])
    batch_err = (x_kernel.float() - x_plain.float()).abs().max().item()
    loss_rel = abs(loss_kernel - loss_plain) / abs(loss_plain)
    report[f"{key}_vs_plain"] = dict(batch_max_abs_err=batch_err, loss_kernel=loss_kernel,
                                     loss_plain=loss_plain, loss_rel=loss_rel)
    log(f"[{tag}] kernel vs plain path, one step from one state and draws: augmented batch "
        f"max|err| {batch_err:.3e} (bound {WARP_BOUND}), loss {loss_kernel:.6f} vs "
        f"{loss_plain:.6f}, rel {loss_rel:.3e} (bound {LOSS_REL_BOUND})")
    if not batch_err <= WARP_BOUND or not loss_rel <= LOSS_REL_BOUND:
        raise AssertionError("the kernel path and the plain path disagree")
    return launches["warp_shear3"]


class Checks:
    """Kernel-vs-plain comparisons of one phase: elementwise tensors by max
    abs error against BOUND[dtype]·max|plain| (bf16 tensors get the bf16
    bound: one bf16 ulp is 2⁻⁸…2⁻⁷ of a value), reduced and weight gradients
    by rel L2 ≤ BWD_REL_L2 (their column sums add block partials in another
    order than the plain versions')."""

    def __init__(self):
        self.rows: list[dict] = []

    def elementwise(self, case: dict, name: str, got: torch.Tensor, want: torch.Tensor,
                    bounds: dict = BOUND) -> float:
        err = (got.float() - want.float()).abs().max().item()
        scale = want.float().abs().max().item()
        ok = (got.shape == want.shape and bool(torch.isfinite(got.float()).all())
              and err <= bounds[want.dtype] * scale)
        self.rows.append(dict(**case, tensor=name, max_abs_err=err, rel=err / max(scale, 1e-30),
                              bound=bounds[want.dtype], ok=ok))
        return err

    def reduced(self, case: dict, name: str, got: torch.Tensor, want: torch.Tensor,
                ref: torch.Tensor | None = None) -> float:
        err = rel_l2(got, want, ref)
        ok = bool(torch.isfinite(got.float()).all()) and err <= BWD_REL_L2
        self.rows.append(dict(**case, tensor=name, rel_l2=err, bound=BWD_REL_L2, ok=ok))
        return err

    def exact(self, case: dict, name: str, got: torch.Tensor, want: torch.Tensor) -> int:
        """Bit-equality (a permutation, or a kernel run twice): the number of
        differing elements, which must be 0."""
        differ = int((got != want).sum().item()) if got.shape == want.shape else got.numel()
        self.rows.append(dict(**case, tensor=name, differing=differ, ok=differ == 0))
        return differ

    def summary(self, case: dict) -> str:
        rows = [r for r in self.rows if all(r.get(k) == v for k, v in case.items())]
        bad = [r["tensor"] for r in rows if not r["ok"]]
        graded = [r for r in rows if "bound" in r]
        exact = [r["tensor"] for r in rows if "differing" in r]
        text = f"{len(rows)} tensors"
        if graded:
            worst = max(graded, key=lambda r: r.get("rel", 0.0) / r["bound"] if "rel" in r
                        else r["rel_l2"] / r["bound"])
            key = "rel" if "rel" in worst else "rel_l2"
            text += f", worst {worst['tensor']} {worst[key]:.2e} (bound {worst['bound']:.0e})"
        if exact:
            text += f", bit-equal: {[t for t in exact if t not in bad]}"
        return f"{text} {'ok' if not bad else 'FAIL ' + str(bad)}"


def compare_backward(report: dict) -> dict[str, float]:
    """Phase 9: the backward-save forwards and the backward kernels vs their
    plain versions at the vit_b_16 shapes (B=8, T=197 and B=3, T=50; f32
    and bf16 x; plain, γ_ls + dp and, for the MLP, a separate residual), at
    T=512 for attention, the MLP's at the other widths of ``mlp_cases`` and
    the attention's at ``attn_tile_cases``. One set of saves (the kernel
    forward's) and one dout feed both backward versions. Returns
    max|dx − plain| of the main path's case per kernel."""
    from vision_toolbox_tpu_torch.ops import block_attention as ba
    from vision_toolbox_tpu_torch.ops import block_mlp as bm

    g = torch.Generator().manual_seed(9)
    checks, main_err = Checks(), {}
    cases = mlp_cases(("plain", "ls+dp", "ls+dp+residual"))
    cases.append((2, 512, VIT_B["D"], VIT_B["Dh"], torch.bfloat16, "ls+dp"))
    heads = {D: H for _, _, D, H in TILE_ATTN_CASES}
    cases += [(B, T, D, None, dt, v) for B, T, D, _, dt, v in attn_tile_cases()]
    for B, T, D, Dh, dtype, variant in cases:
        extras, res = variant != "plain", variant.endswith("residual")
        kernels = ["block_attention_bwd"] if T == 512 or Dh is None else (
            ["block_mlp_bwd"] + ([] if res or D != VIT_B["D"] else ["block_attention_bwd"]))
        for kernel in kernels:
            case = dict(kernel=kernel, B=B, T=T, D=D, dtype=str(dtype).split(".")[-1],
                        variant=variant)
            if kernel == "block_mlp_bwd":
                a = mlp_args(g, B, T, D, Dh, dtype, extras, res)
                ops = [a[k] for k in ("ln_scale", "ln_bias", "w1", "b1", "w2", "b2")]
                fwd = (a["x"], *ops, a["ls_gamma"], a["dp_scale"], a["residual"])
                want_out, want_saves = bm.fused_mlp_save_plain(*fwd)
                out, saves = bm.fused_mlp_save_cuda(*fwd)
                dout = torch.randn(a["x"].shape, generator=g).to("cuda", dtype)
                bwd = (dout, saves, a["w1"], a["w2"], a["ln_scale"], a["ls_gamma"], a["dp_scale"],
                       res)
                got, want = bm.fused_mlp_bwd_cuda(*bwd), bm.fused_mlp_bwd_plain(*bwd)
                elementwise = ("dx", "dh")
                reduced = ["db1", "db2", "dln_scale", "dln_bias"] + (["dls"] if extras else [])
                y2 = (saves.xhat.float() * a["ln_scale"].float() + a["ln_bias"].float()).bfloat16()
                weights = [("dW1", got.dh, want.dh, y2, a["w1"])]
                fields = bm.MLPSaves._fields
            else:
                a = attn_args(g, B, T, D, heads.get(D, VIT_B["H"]), dtype, extras)
                wb = [a[k] for n in "qkvo" for k in (f"w{n}", f"b{n}")]
                fwd = (a["x"], a["ln_scale"], a["ln_bias"], *wb, a["n_heads"], a["ls_gamma"],
                       a["dp_scale"])
                want_out, want_saves = ba.fused_attention_save_plain(*fwd)
                out, saves = ba.fused_attention_save_cuda(*fwd)
                dout = torch.randn(a["x"].shape, generator=g).to("cuda", dtype)
                bwd = (dout, saves, a["wq"], a["wk"], a["wv"], a["wo"], a["ln_scale"],
                       a["ls_gamma"], a["dp_scale"], a["n_heads"])
                got, want = ba.fused_attention_bwd_cuda(*bwd), ba.fused_attention_bwd_plain(*bwd)
                elementwise = ("dx", "dq", "dk", "dv")
                reduced = ["dbq", "dbv", "dbo", "dln_scale", "dln_bias"] + (
                    ["dls"] if extras else [])
                y = (saves.xhat.float() * a["ln_scale"].float() + a["ln_bias"].float()).bfloat16()
                weights = [(f"dW{n}", getattr(got, f"d{n}"), getattr(want, f"d{n}"), y, a[f"w{n}"])
                           for n in "qkv"]
                fields = ba.AttnSaves._fields
            torch.cuda.synchronize()
            checks.elementwise(case, "out", out, want_out)
            for name, s_got, s_want in zip(fields, saves, want_saves):
                if s_want is not None:
                    checks.elementwise(case, name, s_got, s_want)
            for name in elementwise:
                err = checks.elementwise(case, name, getattr(got, name).contiguous(),
                                         getattr(want, name))
                if name == "dx" and is_main_case(B, T, D, dtype, variant):
                    main_err[kernel] = err
            for name in reduced:
                checks.reduced(case, name, getattr(got, name), getattr(want, name))
            if kernel == "block_attention_bwd":  # zero in exact arithmetic: rounding noise of ds
                checks.reduced(case, "dbk (vs ‖dbv‖)", got.dbk, want.dbk, ref=want.dbv)
            for name, d_got, d_want, act, w in weights:
                checks.reduced(case, name, bm.weight_grad(d_got, act, w),
                               bm.weight_grad(d_want, act, w))
            log(f"[backward] {kernel:19s} B={B} T={T} D={D} {case['dtype']:8s} {variant:15s} "
                f"{checks.summary(case)}")
    report["compare_backward"] = checks.rows
    bad = [r for r in checks.rows if not r["ok"]]
    if bad:
        raise AssertionError(f"{len(bad)} backward comparisons out of bounds: {bad[:8]}")
    return main_err


def second_backward_bit_equal(report: dict, label: str, backward) -> None:
    """Runs a backward kernel twice on the same operands and fails unless
    every output (dx, dh or dq/dk/dv and each column sum) is bit-equal: the
    column sums leave partial rows for a fixed-order sum, no atomics."""
    first = backward()
    second = backward()
    torch.cuda.synchronize()
    differ = {f: int((a != b).sum().item()) for f, a, b in zip(first._fields, first, second)
              if a is not None}
    report.setdefault("second_backward", {})[label] = differ
    log(f"[bit-equal] {label}: second backward, differing elements {differ}")
    if any(differ.values()):
        raise AssertionError(f"{label}: a second backward differs from the first: {differ}")


def time_backward(report: dict) -> dict[str, tuple[float, float]]:
    """Each backward kernel against its plain version, in turns, at the main
    path's shapes (vit_b_16, batch 128, bf16, no γ/dp), and a second
    backward of each bit-equal to the first."""
    from vision_toolbox_tpu_torch.ops import block_attention as ba
    from vision_toolbox_tpu_torch.ops import block_mlp as bm

    g = torch.Generator().manual_seed(10)
    B, T, out, rows = VIT_TRAIN["batch"], 197, {}, []
    m = mlp_args(g, B, T, VIT_B["D"], VIT_B["Dh"], torch.bfloat16, False, False)
    ops = [m[k] for k in ("ln_scale", "ln_bias", "w1", "b1", "w2", "b2")]
    _, mlp_saves = bm.fused_mlp_save_cuda(m["x"], *ops)
    dout = torch.randn(m["x"].shape, generator=g).to("cuda", torch.bfloat16)
    mlp = (dout, mlp_saves, m["w1"], m["w2"], m["ln_scale"], None, None, False)
    a = attn_args(g, B, T, VIT_B["D"], VIT_B["H"], torch.bfloat16, False)
    wb = [a[k] for n in "qkvo" for k in (f"w{n}", f"b{n}")]
    _, attn_saves = ba.fused_attention_save_cuda(a["x"], a["ln_scale"], a["ln_bias"], *wb,
                                                 a["n_heads"])
    attn = (dout, attn_saves, a["wq"], a["wk"], a["wv"], a["wo"], a["ln_scale"], None, None,
            a["n_heads"])
    second_backward_bit_equal(report, f"block_mlp_bwd vit_b_16 b{B}",
                              lambda: bm.fused_mlp_bwd_cuda(*mlp))
    second_backward_bit_equal(report, f"block_attention_bwd vit_b_16 b{B}",
                              lambda: ba.fused_attention_bwd_cuda(*attn))
    for name, plain, kernel in (
        ("block_mlp_bwd", lambda: bm.fused_mlp_bwd_plain(*mlp),
         lambda: bm.fused_mlp_bwd_cuda(*mlp)),
        ("block_attention_bwd", lambda: ba.fused_attention_bwd_plain(*attn),
         lambda: ba.fused_attention_bwd_cuda(*attn)),
    ):
        plain_ms, ms = alternate(plain, kernel, iters=10)
        rows.append(dict(kernel=name, B=B, T=T, dtype="bfloat16", ms=ms, plain_ms=plain_ms))
        log(f"[time] {name:19s} B={B:3d} T={T} bf16 kernel {ms:.4f} ms  plain {plain_ms:.4f} ms")
        out[name] = (ms, plain_ms)
    report["backward_times"] = rows
    return out


def spread_layer_scale(model: torch.nn.Module, center: float, seed: int = 3) -> None:
    """Every LayerScale γ of ``model``, then every parameter named
    ``layer_scale*`` (PatchConvNet's), ← center·(1 + U(0, 1)), seeded."""
    from vision_toolbox_tpu_torch.nn.layers import LayerScale

    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, LayerScale):
                m.gamma.copy_(center * (1 + torch.rand(m.gamma.shape, generator=g)))
        for name, p in model.named_parameters():
            if name.rsplit(".", 1)[-1].startswith("layer_scale"):
                p.copy_(center * (1 + torch.rand(p.shape, generator=g)))


def vit_step_parts(name: str, cfg: dict, forward_kw: dict | None = None, **model_kw):
    """A seeded bf16 classifier on ``name`` (built on the card by default;
    LayerScale γs spread around ``cfg["layer_scale"]`` where given; its
    backbone's forward called with ``forward_kw``), its SGD state and train
    step (label smoothing 0.1, CutMix⊕MixUp 1.0/0.2), uint8 images and
    labels made on the card, and the step's generator."""
    import vision_toolbox_tpu_torch as vtt
    from vision_toolbox_tpu_torch.train import (
        ImageClassifier, TrainState, make_train_step, sgd_with_param_groups,
    )

    B, S, classes = cfg["batch"], cfg["img"], cfg["classes"]
    gen = torch.Generator().manual_seed(0)
    backbone = vtt.create_backbone(name, dtype=torch.bfloat16, generator=gen, **model_kw)
    if forward_kw:
        backbone.forward = functools.partial(type(backbone).forward, backbone, **forward_kw)
    if cfg.get("layer_scale"):
        spread_layer_scale(backbone, cfg["layer_scale"])
    model = ImageClassifier(backbone, classes, dtype=torch.bfloat16, generator=gen)
    opt = sgd_with_param_groups(model, cfg.get("lr", 0.1), momentum=0.9, weight_decay=2e-5)
    step = make_train_step(classes, label_smoothing=0.1, mixup_alpha=0.2, cutmix_alpha=1.0,
                           compute_dtype=torch.bfloat16)
    data = torch.Generator(device="cuda").manual_seed(1)
    images = torch.randint(0, 256, (B, S, S, 3), dtype=torch.uint8, device="cuda", generator=data)
    labels = torch.randint(0, classes, (B,), device="cuda", generator=data)
    g = torch.Generator(device="cuda").manual_seed(2)
    return TrainState(model, opt), step, images, labels, g


def train_vit(report: dict, name_power: str) -> dict[str, int]:
    """Phase 10 (the transformer training path): the vit_b_16 step at
    bs128@224, 3 warm-up + 10 timed steps, every block through the forward
    and backward kernels; then phase 11, one step through the kernels
    against one through the plain versions from one state and one set of
    draws. Returns the launches of the training run."""
    watched = ("head.weight", "backbone.pe", "backbone.blocks.0.mha.q_proj.weight",
               "backbone.blocks.5.mlp_norm.weight", "backbone.blocks.11.mlp.linear2.bias")
    per_step = NO_LAUNCHES | dict.fromkeys(BLOCK_KERNELS, 12)
    return train_transformer(report, "vit_train", "vit_b_16", VIT_TRAIN, per_step, watched,
                             name_power)


def train_cait(report: dict, name_power: str) -> dict[str, int]:
    """Phase 15: the cait_s_24 step at bs128@224 with ViT's recipe, 3
    warm-up + 10 timed steps, each of the 24 self-attention blocks through
    K5 and K3 forward and backward; then phase 16, one step through the
    kernels against one through the plain versions and an f32 reference,
    the four head-mix parameters and the LayerScale γs included."""
    watched = ("head.weight", "backbone.pe", "backbone.sa_blocks.0.mha.proj_l_kernel",
               "backbone.sa_blocks.23.mha.proj_w_bias", "backbone.sa_blocks.5.mlp_scale.gamma",
               "backbone.ca_blocks.1.mlp.linear2.bias", "backbone.cls_token")
    per_step = NO_LAUNCHES | dict.fromkeys(
        ("talking_head", "talking_head_bwd", "block_mlp", "block_mlp_bwd"), 24)
    return train_transformer(report, "cait_train", "cait_s_24", CAIT_TRAIN, per_step, watched,
                             name_power)


def train_transformer(report: dict, key: str, name: str, cfg: dict, per_step: dict[str, int],
                      watched: tuple[str, ...], name_power: str,
                      forward_kw: dict | None = None, **model_kw) -> dict[str, int]:
    """The transformer train step of ``name`` (built with ``model_kw``, its
    forward called with ``forward_kw``) at ``cfg``'s batch and size: warm-up
    and timed steps with each kernel launched ``per_step`` times a step,
    then one step through the kernels against one through the plain
    versions (``kernel_vs_plain_step``), on the first ``cfg["compare_batch"]``
    images where given. Returns the launches of the run."""
    from vision_toolbox_tpu_torch.ops import _cuda

    state, step, images, labels, g = vit_step_parts(name, cfg, forward_kw, **model_kw)
    model, B, tag = state.model, cfg["batch"], key.replace("_", "-")
    assert next(model.parameters()).is_cuda, "the default device is the card"
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[{tag}] {name} + head {cfg['classes']}: {n_params / 1e6:.2f} M f32 params, bf16 "
        f"compute, bs{B}@{cfg['img']}, CutMix⊕MixUp, LS 0.1, SGD 0.9 lr {cfg['lr']}, "
        "wd 2e-5 (3 groups)")
    before = {k: model.state_dict()[k].detach().clone() for k in watched}
    initial = copy.deepcopy(state)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launch_counts()  # the main path: counts from 0 just before, read just after
    losses = [step(state, images, labels, g)["loss"] for _ in range(cfg["warmup"])]
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(cfg["steps"]):
        losses.append(step(state, images, labels, g)["loss"])
    end.record()
    end.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / cfg["steps"]
    launches = dict(_cuda.LAUNCHES)
    ms = start.elapsed_time(end) / cfg["steps"]
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = [float(v) for v in losses]
    n_steps = cfg["warmup"] + cfg["steps"]
    changed = {k: not torch.equal(v, model.state_dict()[k]) for k, v in before.items()}
    log(f"[{tag}] losses {['%.4f' % v for v in losses]}")
    log(f"[{tag}] {ms:.2f} ms/step, {B / ms * 1e3:.1f} img/s (CUDA events over {cfg['steps']} "
        f"steps; host clock {wall_ms:.2f} ms/step); peak memory {peak:.1f} GiB  [{name_power}]")
    log(f"[{tag}] launches in {n_steps} steps: {launches}")
    report[key] = dict(ms_per_step=ms, img_per_s=B / ms * 1e3, host_ms_per_step=wall_ms,
                       losses=losses, launches=launches, changed=changed, peak_gib=peak)
    if not all(map(math.isfinite, losses)):
        raise AssertionError(f"non-finite loss: {losses}")
    if not all(changed.values()):
        raise AssertionError(f"parameters did not change: {changed}")
    if launches != {k: n * n_steps for k, n in per_step.items()}:
        raise AssertionError(f"expected {per_step} launches per step: {launches}")

    # one step through the kernels vs one through the plain
    # versions, from the seeded initial state and one set of draws
    n = cfg.get("compare_batch", B)
    images, labels = images[:n], labels[:n]
    draws = step.sample_draws(g, tuple(images.shape))
    if not any(per_step.values()):  # no kernel in the model: bf16 against f32 only
        bf16_vs_f32_step(report, key, name, cfg, initial, step, images, labels, draws,
                         **model_kw)
        return launches
    res = kernel_vs_plain_step(name, cfg, initial, step, images, labels, draws, forward_kw,
                               **model_kw)
    report[f"{key}_vs_plain"] = res
    loss_rel = abs(res["loss_kernel"] - res["loss_plain"]) / abs(res["loss_plain"])
    worst = sorted(res["grads"].items(), key=lambda kv: -kv[1]["kernel_vs_plain"])[:4]
    wide = {n: r for n, r in res["grads"].items() if r["bound"] > GRAD_REL_L2}
    log(f"[{tag}] kernel vs plain path, one step at bs{n} from the seeded state and one set of "
        "draws: "
        f"loss {res['loss_kernel']:.6f} vs {res['loss_plain']:.6f}, rel {loss_rel:.3e} (bound "
        f"{LOSS_REL_BOUND}); gradient rel L2, worst of {len(res['grads'])}: "
        f"{[(n, '%.2e' % r['kernel_vs_plain'], 'bound %.2e' % r['bound']) for n, r in worst]}")
    log(f"[{tag}] {len(wide)} gradients whose plain bf16 version is itself > {GRAD_REL_L2 / 2} "
        f"from the f32 reference (bound 2× that): "
        f"{[(n, '%.2e' % r['plain_vs_f32']) for n, r in list(wide.items())[:8]]}")
    closer = sorted(r["kernel_vs_f32"] / r["plain_vs_f32"] for r in res["grads"].values()
                    if r["plain_vs_f32"] > 0)
    log(f"[{tag}] each path against the f32 reference: kernel / plain rel L2 per gradient, "
        f"median {closer[len(closer) // 2]:.3f}, max {closer[-1]:.3f}")
    bad = {n: r for n, r in res["grads"].items() if not r["kernel_vs_plain"] <= r["bound"]}
    if not loss_rel <= LOSS_REL_BOUND or bad:
        raise AssertionError(f"the kernel path and the plain path disagree: {bad}")
    return launches


def zero_gradient_ref(name: str) -> str | None:
    """The parameter whose gradient a zero-in-exact-arithmetic gradient is
    held against, else None: a key-projection bias shifts each query's
    logits by a constant, and CaiT's pre-softmax mix bias shifts whole
    logit rows, both removed by the softmax; they are held against the
    value bias and the pre-softmax mix. The Mixer's token-mixing output
    bias adds one value to all channels of a token, which every LayerNorm
    after it removes; it is held against the channel-mixing output bias."""
    if name.endswith("k_proj.bias"):
        return name.replace("k_proj", "v_proj")
    if name.endswith("proj_l_bias"):
        return name.replace("proj_l_bias", "proj_l_kernel")
    if name.endswith("token_mixing.linear2.bias"):
        return name.replace("token_mixing", "channel_mixing")
    return None


def reference_kw(model) -> dict[str, bool]:
    """The forward options that put ``model`` on its f32 reference route:
    ``plain`` (the kernels' plain versions) and, where the model has fused
    half-blocks, ``force_unfused`` (the unfused module chain)."""
    params = inspect.signature(model.forward).parameters
    return {k: True for k in ("force_unfused", "plain") if k in params}


def kernel_vs_plain_step(name: str, cfg: dict, state, step, images, labels, draws,
                         forward_kw: dict | None = None, **model_kw) -> dict:
    """One step through the kernels and one through the plain versions (the
    backbone's forward called with ``forward_kw`` on both), each from a copy
    of ``state``, and the f32 reference gradient: the same model in f32 on
    the unfused module chain, CaiT's talking-head attention through its
    plain f32 version and short and flash attention through their plain
    versions (no bf16 rounding, TF32 off). Every
    parameter's gradient is held to rel L2 ≤ GRAD_REL_L2 against the plain
    path's, or to twice the plain path's own bf16 error where that is larger:
    the softmax backward rounds ds to bf16, and where the keys (queries) of a
    block are nearly alike the query (key) gradient Σ ds·k cancels down to
    that rounding noise, in the JAX kernel as in both versions here; two
    independent bf16 roundings differ by about √2 times either's error.
    Gradients that are zero in exact arithmetic are held against a
    neighbour's (``zero_gradient_ref``)."""
    import vision_toolbox_tpu_torch as vtt
    from vision_toolbox_tpu_torch.train import ImageClassifier, TrainState, sgd_with_param_groups

    states = [copy.deepcopy(state) for _ in range(2)]
    backbone = states[1].model.backbone
    backbone.forward = functools.partial(type(backbone).forward, backbone, **(forward_kw or {}),
                                         plain=True)
    ref_backbone = vtt.create_backbone(name, **model_kw)  # f32 compute
    ref_model = ImageClassifier(ref_backbone, cfg["classes"])
    ref_model.load_state_dict(state.model.state_dict())
    ref_backbone.forward = functools.partial(type(ref_backbone).forward, ref_backbone,
                                             **reference_kw(ref_backbone))
    states.append(TrainState(ref_model, sgd_with_param_groups(ref_model, 0.0)))
    drop = lambda: torch.Generator(device="cuda").manual_seed(5)  # the model's own draws
    losses = [float(step(st, images, labels, drop(), draws=draws)["loss"]) for st in states]
    kernel, plain, f32 = ({n: p.grad for n, p in st.model.named_parameters()} for st in states)
    grads = {}
    for n in kernel:
        v = zero_gradient_ref(n)
        own = rel_l2(plain[n], f32[n], f32[v] if v else None)
        grads[n] = dict(kernel_vs_plain=rel_l2(kernel[n], plain[n], plain[v] if v else None),
                        plain_vs_f32=own, bound=max(GRAD_REL_L2, 2 * own),
                        kernel_vs_f32=rel_l2(kernel[n], f32[n], f32[v] if v else None))
    return dict(loss_kernel=losses[0], loss_plain=losses[1], loss_f32=losses[2], grads=grads)


def bf16_vs_f32_step(report: dict, key: str, name: str, cfg: dict, state, step, images,
                     labels, draws, **model_kw) -> None:
    """For a model that runs no kernel: one bf16 step and one f32 step (the
    same weights, TF32 off) from ``state`` and one set of draws; prints the
    loss of each and every parameter gradient's rel L2 between them (there
    is no plain path to hold: both are the plain ops), and fails on a
    non-finite loss or gradient."""
    import vision_toolbox_tpu_torch as vtt
    from vision_toolbox_tpu_torch.train import ImageClassifier, TrainState, sgd_with_param_groups

    ref_model = ImageClassifier(vtt.create_backbone(name, **model_kw), cfg["classes"])
    ref_model.load_state_dict(state.model.state_dict())
    states = [copy.deepcopy(state), TrainState(ref_model, sgd_with_param_groups(ref_model, 0.0))]
    losses = [float(step(st, images, labels, draws=draws)["loss"]) for st in states]
    bf16, f32 = ({n: p.grad for n, p in st.model.named_parameters()} for st in states)
    errs = sorted((rel_l2(bf16[n], f32[n]), n) for n in f32)
    finite = all(torch.isfinite(g).all() for g in bf16.values()) and all(map(math.isfinite, losses))
    report[f"{key}_vs_f32"] = dict(loss_bf16=losses[0], loss_f32=losses[1],
                                   grads={n: e for e, n in errs})
    log(f"[{key.replace('_', '-')}] bf16 vs f32 step at bs{images.shape[0]} from one state and "
        f"draws (no kernel in the model): loss {losses[0]:.6f} vs {losses[1]:.6f}; gradient rel "
        f"L2 median {errs[len(errs) // 2][0]:.3e}, worst {[(n, '%.2e' % e) for e, n in errs[-3:]]}")
    if not finite:
        raise AssertionError(f"{name}: non-finite bf16 loss or gradient")


def train_deit3(report: dict) -> None:
    """Phase 12: deit3_b_16 (LayerScale 1e-6) with stochastic depth 0.1, a
    few steps at a small batch: the γ_ls and drop-path branches of both
    backward kernels launch and give finite losses and changing parameters,
    the LayerScale γs included."""
    from vision_toolbox_tpu_torch.ops import _cuda

    cfg = DEIT3
    state, step, images, labels, g = vit_step_parts(
        "deit3_b_16", cfg, stochastic_depth=cfg["stochastic_depth"])
    model = state.model
    watched = ("backbone.blocks.0.mha_scale.gamma", "backbone.blocks.11.mlp_scale.gamma",
               "backbone.blocks.6.mha.out_proj.weight", "head.weight")
    before = {k: model.state_dict()[k].detach().clone() for k in watched}
    _cuda.reset_launch_counts()
    losses = [float(step(state, images, labels, g)["loss"]) for _ in range(cfg["steps"])]
    torch.cuda.synchronize()
    launches = dict(_cuda.LAUNCHES)
    changed = {k: not torch.equal(v, model.state_dict()[k]) for k, v in before.items()}
    report["deit3_train"] = dict(losses=losses, launches=launches, changed=changed)
    log(f"[deit3] deit3_b_16 bs{cfg['batch']}@{cfg['img']}, stochastic depth "
        f"{cfg['stochastic_depth']}: losses {['%.4f' % v for v in losses]}, launches {launches}, "
        f"changed {changed}")
    if not all(map(math.isfinite, losses)) or not all(changed.values()):
        raise AssertionError("deit3_b_16 training failed")
    if any(launches[k] != 12 * cfg["steps"] for k in BLOCK_KERNELS):
        raise AssertionError(f"expected 12 launches of each block kernel per step: {launches}")


def talking_head_args(g, B, T, S, H, hd, dtype):
    """q (B, T, H·hd), k and v (B, S, H·hd) in ``dtype``, f32 head mixes
    near the identity with small biases, and a cotangent like q."""
    D = H * hd
    r = lambda *s, scale=1.0: torch.randn(s, generator=g) * scale
    eye = torch.eye(H)
    a = dict(q=r(B, T, D), k=r(B, S, D), v=r(B, S, D))
    a = {n: t.to("cuda", dtype) for n, t in a.items()}
    a |= dict(ml=r(H, H, scale=0.3) + eye, mlb=r(H, scale=0.1), mw=r(H, H, scale=0.3) + eye,
              mwb=r(H, scale=0.1))
    a = {n: t.cuda() for n, t in a.items()}
    return a, r(B, T, D).to("cuda", dtype)


class TalkingHeadGrads(NamedTuple):
    """K5's backward outputs as one tuple of tensors (for the bit-equality
    check)."""

    dq: torch.Tensor
    dk: torch.Tensor
    dv: torch.Tensor
    dml: torch.Tensor
    dmlb: torch.Tensor
    dmw: torch.Tensor
    dmwb: torch.Tensor


def compare_talking_head(report: dict) -> dict[str, float]:
    """Phase 13: K5 forward and backward vs their plain versions at
    TALKING_HEAD_CASES, f32 and bf16 inputs. Tensors by max abs error
    against BOUND·max|plain|, the four mix-parameter gradients by rel L2
    ≤ BWD_REL_L2 (the pre-softmax bias's, zero in exact arithmetic,
    relative to the pre-softmax mix's). At cait_s_24's training shapes
    (batch 128, bf16) also: out, dq, dk and dv within twice the first
    design's rel L2 to the plain versions (K5_FIRST_DESIGN_REL_L2), and a
    second backward bit-equal to the first (dq, dk, dv and the four mix
    gradients: no atomics). Returns the max abs error of the forward and of
    the backward (worst of dq, dk, dv) there, where they are also timed."""
    from vision_toolbox_tpu_torch.ops import cait_attention as ca

    g = torch.Generator().manual_seed(13)
    checks, main_err = Checks(), {}
    for B, T, S, H, hd in TALKING_HEAD_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            a, dout = talking_head_args(g, B, T, S, H, hd, dtype)
            args = tuple(a.values())
            case = dict(kernel="talking_head", B=B, T=T, S=S, H=H, hd=hd,
                        dtype=str(dtype).split(".")[-1])
            err = checks.elementwise(case, "out", ca.talking_head_cuda(*args),
                                     ca.talking_head_plain(*args))
            got, want = ca.talking_head_bwd_cuda(*args, dout), ca.talking_head_bwd_plain(*args, dout)
            torch.cuda.synchronize()
            errs = [checks.elementwise(case, n, got[i], want[i]) for i, n in enumerate("qkv")]
            for n in ("ml", "mw", "mwb"):
                checks.reduced(case, f"d{n}", getattr(got[3], n), getattr(want[3], n))
            # zero in exact arithmetic (the bias shifts whole softmax rows): noise, held to ‖dml‖
            checks.reduced(case, "dmlb (vs ‖dml‖)", got[3].mlb, want[3].mlb, ref=want[3].ml)
            log(f"[talking-head] B={B:3d} T={T} S={S} H={H:2d} hd={hd} {case['dtype']:8s} "
                f"{checks.summary(case)}")
            if (B, T, H, dtype) == (CAIT_TRAIN["batch"], 196, 8, torch.bfloat16):
                main_err["talking_head"], main_err["talking_head_bwd"] = err, max(errs)
                out = ca.talking_head_cuda(*args)
                for n, g_, w_ in zip(("out", "dq", "dk", "dv"), (out, *got[:3]),
                                     (ca.talking_head_plain(*args), *want[:3])):
                    l2, bound_ = rel_l2(g_, w_), 2 * K5_FIRST_DESIGN_REL_L2[n]
                    checks.rows.append(dict(**case, tensor=f"{n} rel L2", rel_l2=l2, bound=bound_,
                                            ok=l2 <= bound_))
                log(f"[talking-head] B={B} bf16 rel L2 to plain: " + ", ".join(
                    f"{r['tensor']} {r['rel_l2']:.3e} (≤ {r['bound']:.3e})"
                    for r in checks.rows[-4:]))
                def k5_backward(args=args, dout=dout):
                    dq, dk, dv, mix_grads = ca.talking_head_bwd_cuda(*args, dout)
                    return TalkingHeadGrads(dq, dk, dv, *mix_grads)

                second_backward_bit_equal(report, "talking_head_bwd", k5_backward)
    report["compare_talking_head"] = checks.rows
    bad = [r for r in checks.rows if not r["ok"]]
    if bad:
        raise AssertionError(f"{len(bad)} K5 comparisons out of bounds: {bad[:8]}")
    return main_err


def time_talking_head(report: dict) -> dict[str, tuple[float, float]]:
    """K5 forward and backward against their plain versions, in turns, at
    cait_s_24's training shapes (batch 128, bf16)."""
    from vision_toolbox_tpu_torch.ops import cait_attention as ca

    g = torch.Generator().manual_seed(14)
    B, (D, H, T) = CAIT_TRAIN["batch"], CAIT_S.values()
    a, dout = talking_head_args(g, B, T, T, H, D // H, torch.bfloat16)
    args, out, rows = tuple(a.values()), {}, []
    for name, plain, kernel in (
        ("talking_head", lambda: ca.talking_head_plain(*args), lambda: ca.talking_head_cuda(*args)),
        ("talking_head_bwd", lambda: ca.talking_head_bwd_plain(*args, dout),
         lambda: ca.talking_head_bwd_cuda(*args, dout)),
    ):
        plain_ms, ms = alternate(plain, kernel, iters=10)
        rows.append(dict(kernel=name, B=B, T=T, dtype="bfloat16", ms=ms, plain_ms=plain_ms))
        log(f"[time] {name:19s} B={B:3d} T={T} bf16 kernel {ms:.4f} ms  plain {plain_ms:.4f} ms")
        out[name] = (ms, plain_ms)
    report["talking_head_times"] = rows
    return out


def serve_cait(report: dict, name_power: str) -> int:
    """Phase 14: a seeded bf16 cait_s_24 (224 px, LayerScale γs around
    CAIT_LAYER_SCALE), eager through the kernels against its plain versions
    (24 K5 and 24 K3 forward launches per forward; logits rel L2 ≤
    REL_L2_BOUND or twice the plain bf16 path's own distance from an f32
    forward of the same weights, whichever is larger: over 24 residual
    blocks with γ ≈ 0.1, bf16 rounding flips in either path add up), then
    served: export → load → three requests at each of
    SERVE_BATCHES, each against eager and launching no backward kernel.
    Returns K5's launches in the served requests."""
    import vision_toolbox_tpu_torch as vtt
    from vision_toolbox_tpu_torch.ops import _cuda
    from vision_toolbox_tpu_torch.utils.export import export_model, load_exported

    model = vtt.create_backbone("cait_s_24", dtype=torch.bfloat16,
                                generator=torch.Generator().manual_seed(0))
    spread_layer_scale(model, CAIT_LAYER_SCALE)
    model.eval()
    depth, width = len(model.sa_blocks), model.last_out_channels
    per_forward = NO_LAUNCHES | {"talking_head": depth, "block_mlp": depth}
    images = torch.rand(32, 224, 224, 3, generator=torch.Generator().manual_seed(1)).cuda()
    ref = vtt.create_backbone("cait_s_24")  # f32 compute, the same weights
    ref.load_state_dict(model.state_dict())
    with torch.inference_mode():
        _cuda.reset_launch_counts()
        logits = model(images[:8])
        torch.cuda.synchronize()
        counts = dict(_cuda.LAUNCHES)
        plain_logits = model(images[:8], plain=True)
        f32_logits = ref(images[:8], force_unfused=True, plain=True)
    err, own = rel_l2(logits, plain_logits), rel_l2(plain_logits, f32_logits)
    bound = max(REL_L2_BOUND, 2 * own)
    log(f"[cait-serve] cait_s_24 bf16 bs8 forward: launches {counts}; logits kernel vs plain "
        f"path rel L2 {err:.3e} (bound {bound:.3e}: the plain bf16 path is {own:.3e} from the "
        f"f32 reference; the kernel path {rel_l2(logits, f32_logits):.3e})")
    if counts != per_forward:
        raise AssertionError(f"expected {per_forward}, got {counts}")
    if logits.shape != (8, width) or not torch.isfinite(logits.float()).all() \
            or not err <= bound:
        raise AssertionError(f"cait_s_24 logits: shape {tuple(logits.shape)}, rel L2 {err}")
    del ref

    t0 = time.perf_counter()
    blob = export_model(model, (8, 224, 224, 3))
    served = load_exported(blob)
    log(f"[cait-serve] export+load {time.perf_counter() - t0:.1f} s, artifact "
        f"{len(blob) / 2**20:.1f} MiB")
    with torch.inference_mode():
        eager = {b: model(images[:b]) for b in SERVE_BATCHES}
        _cuda.reset_launch_counts()
        answers = {b: [served(images[:b]) for _ in range(3)] for b in SERVE_BATCHES}
        torch.cuda.synchronize()
        launches = dict(_cuda.LAUNCHES)
    n_forwards = 3 * len(SERVE_BATCHES)
    log(f"[cait-serve] {n_forwards} requests at batch {SERVE_BATCHES}: launches {launches}")
    if launches != {k: n_forwards * v for k, v in per_forward.items()}:
        raise AssertionError(f"served path launched {launches}, expected {n_forwards}× "
                             f"{per_forward}")
    rows = []
    for b in SERVE_BATCHES:
        for out in answers[b]:
            e = rel_l2(out, eager[b])
            if out.shape != (b, width) or not torch.isfinite(out.float()).all() or e > 1e-3:
                raise AssertionError(f"served batch {b} disagrees with eager: rel L2 {e}")
        with torch.inference_mode():
            ms = time_ms(lambda: served(images[:b]), iters=10)
        rows.append(dict(batch=b, ms_per_batch=ms, rel_l2_vs_eager=e))
        log(f"[cait-serve] batch {b:2d}: {ms:.3f} ms/batch ({b / ms * 1e3:.1f} img/s), "
            f"rel L2 vs eager {e:.2e}  [{name_power}]")
    report["cait_serve"] = dict(launches_per_forward=counts, rel_l2_vs_plain=err,
                                plain_vs_f32=own, bound=bound, requests=rows)
    return launches["talking_head"]


def flash_work(name: str, BN: int, T: int, S: int, H: int, x_bytes: int) -> tuple[float, float]:
    """(product operations, bytes) of one K6 call on (B·N, T, H) operands:
    the forward's q·kᵀ and p·v; the backward's five products (the
    recomputed logits, g·vᵀ, dv, dk, dq). Bytes: q, k, v (and out, g) in,
    out (dq, dk, dv) out, lse f32."""
    if name == "flash_attention":
        return 4 * BN * T * S * H, (2 * T + 2 * S) * BN * H * x_bytes + 4 * BN * T
    return 10 * BN * T * S * H, (4 * T + 4 * S) * BN * H * x_bytes + 4 * BN * T


def flash_args(g, BN: int, T: int, S: int, H: int, dtype, biased: bool):
    """q (BN, T, H), k and v (BN, S, H) in ``dtype``, an f32 (BN, T, S) bias
    or None, and a cotangent like q, all on the card."""
    r = lambda *s: torch.randn(s, generator=g)
    q, k, v = (r(BN, n, H).to("cuda", dtype) for n in (T, S, S))
    bias = r(BN, T, S).cuda() if biased else None
    return q, k, v, bias, r(BN, T, H).to("cuda", dtype)


def flash_one_plane(q, k, v, g) -> tuple[torch.Tensor, ...]:
    """The control for K6's f32 bound: the plain forward and backward with
    p and ds rounded to bf16 once before their products, as a kernel that
    kept them in one bf16 plane would compute; every other value f32.
    (out, dq, dk, dv) on f32 (B·N, T, H) operands."""
    one = lambda x: x.bfloat16().float()
    qs = q * q.shape[-1] ** -0.5
    logits = qs @ k.transpose(-1, -2)
    m = logits.amax(-1, keepdim=True)
    p = torch.exp(logits - m)
    l = p.sum(-1, keepdim=True)
    out = (one(p) @ v) / l
    p = p / l  # exp(logits − lse)
    ds = p * (g @ v.transpose(-1, -2) - (g * out).sum(-1, keepdim=True))
    return out, one(ds) @ k * q.shape[-1] ** -0.5, one(ds).transpose(-1, -2) @ qs, \
        one(p).transpose(-1, -2) @ g


def compare_flash(report: dict) -> dict[str, float]:
    """Phase 17, part 1: K6 forward (out and lse; with a bias where the case
    has one) and backward (dq, dk, dv) vs their plain versions at
    FLASH_CASES, on the flat (B·N, T, H) layout. Tensors by max abs error
    against FLASH_BOUND·max|plain|, the gradients also by rel L2 ≤
    BWD_REL_L2, and a second backward bit-equal to the first (no atomics).
    At the timed case (siglip, batch FLASH_TIME_BATCH, bf16) the kernels on
    the packed (B, T, N, H) layout, read and written in place, give the same
    bits as on the flat one. At the f32 case the one-plane control
    (``flash_one_plane``) must fail FLASH_BOUND on out, dq, dk and dv: the
    bound tells a kernel that keeps p and ds in f32 from one that rounds
    them to bf16 once. Returns the forward's and the backward's (worst of
    dq, dk, dv) max abs error at the timed case."""
    from vision_toolbox_tpu_torch.ops import flash_attention as fa

    g = torch.Generator().manual_seed(17)
    checks, main_err, control = Checks(), {}, {}
    check = lambda case, name, got, want: checks.elementwise(case, name, got, want, FLASH_BOUND)
    for B, N, T, S, H, dtype, biased in FLASH_CASES:
        q, k, v, bias, dout = flash_args(g, B * N, T, S, H, dtype, biased)
        case = dict(kernel="flash_attention", B=B, N=N, T=T, S=S, H=H,
                    dtype=str(dtype).split(".")[-1])
        out, lse = fa.flash_attention_cuda(q, k, v)
        want_out, want_lse = fa.flash_attention_plain(q, k, v)
        err = check(case, "out", out, want_out)
        check(case, "lse", lse, want_lse)
        if biased:
            got_b, want_b = fa.flash_attention_cuda(q, k, v, bias), fa.flash_attention_plain(
                q, k, v, bias)
            check(case, "out (biased)", got_b[0], want_b[0])
            check(case, "lse (biased)", got_b[1], want_b[1])
            del got_b, want_b, bias
        got = fa.flash_attention_bwd_cuda(q, k, v, out, lse, dout)
        again = fa.flash_attention_bwd_cuda(q, k, v, out, lse, dout)
        want = fa.flash_attention_bwd_plain(q, k, v, out, lse, dout)
        torch.cuda.synchronize()
        errs = [check(case, n, a, b) for n, a, b in zip(("dq", "dk", "dv"), got, want)]
        for n, a, b, c in zip(("dq", "dk", "dv"), got, want, again):
            checks.reduced(case, f"{n} (rel L2)", a, b)
            checks.exact(case, f"{n} (second backward)", c, a)
        if (B, dtype) == (FLASH_TIME_BATCH, torch.bfloat16):
            # the packed (B, T, N, H) layout, read in place: the same bits as the flat one
            packed = lambda t: t.view(B, N, -1, H).transpose(1, 2).contiguous()
            flat = lambda t: t.transpose(1, 2).reshape(B * N, -1, H)
            p_out, p_lse = fa.flash_attention_cuda(packed(q), packed(k), packed(v))
            p_got = fa.flash_attention_bwd_cuda(packed(q), packed(k), packed(v), p_out, p_lse,
                                                packed(dout))
            torch.cuda.synchronize()
            for n, a, b in zip(("out", "lse", "dq", "dk", "dv"), (p_out, p_lse, *p_got),
                               (out, lse, *got)):
                checks.exact(case, f"{n} (packed layout)", a if n == "lse" else flat(a), b)
            del p_out, p_lse, p_got
        del again
        log(f"[flash] B={B:2d} N={N:2d} T={T} S={S} H={H:3d} {case['dtype']:8s} "
            f"{'biased ' if biased else ''}{checks.summary(case)}")
        if dtype == torch.float32:
            ones = flash_one_plane(q, k, v, dout)
            for n, a, b in zip(("out", "dq", "dk", "dv"), ones, (want_out, *want)):
                control[n] = (a - b).abs().max().item() / b.abs().max().item()
            log(f"[flash] one-plane control (p and ds rounded to bf16 once), f32, error / "
                f"max|plain|: {', '.join(f'{n} {e:.2e}' for n, e in control.items())}; each "
                f"must exceed the f32 bound {FLASH_BOUND[torch.float32]:.0e}")
            del ones
        if (B, dtype) == (FLASH_TIME_BATCH, torch.bfloat16):
            main_err["flash_attention"], main_err["flash_attention_bwd"] = err, max(errs)
        del q, k, v, dout, out, lse, got, want, want_out, want_lse
        torch.cuda.empty_cache()
    report["compare_flash"] = checks.rows
    report["flash_one_plane_control"] = control
    bad = [r for r in checks.rows if not r["ok"]]
    if bad:
        raise AssertionError(f"{len(bad)} K6 comparisons out of bounds: {bad[:8]}")
    if not control or min(control.values()) <= FLASH_BOUND[torch.float32]:
        raise AssertionError(f"K6's f32 bound does not refuse the one-plane control: {control}")
    return main_err


def time_flash(report: dict, name_power: str) -> dict[str, tuple[float, float, float]]:
    """Phase 17, part 2: at siglip's shapes, batch FLASH_TIME_BATCH, bf16, on
    one set of packed (B, T, N, H) tensors, the layout the model hands K6:
    K6 reading them in place, its plain version (on flat (B·N, T, H) copies
    made outside the timing) and torch's scaled_dot_product_attention on the
    same memory seen as a strided (B, N, T, H) view (the library yardstick;
    the port never calls it), forward alone and forward + backward, in
    turns; and K6's peak memory beyond its inputs for one forward +
    backward, held below one bf16 (B, N, T, S) tensor. Returns (kernel,
    plain, library) ms of the forward and of the backward (forward +
    backward less the forward)."""
    import torch.nn.functional as F

    from vision_toolbox_tpu_torch.ops import flash_attention as fa

    g = torch.Generator().manual_seed(18)
    B, N, T, H = FLASH_TIME_BATCH, SIGLIP_HEADS, SIGLIP_T, 64
    q, k, v, dout = (torch.randn(B, T, N, H, generator=g).to("cuda", torch.bfloat16)
                     for _ in range(4))
    flat = [t.transpose(1, 2).reshape(B * N, T, H) for t in (q, k, v, dout)]
    as_bnth = lambda t: t.transpose(1, 2)  # SDPA's layout, a view of the same memory

    def kernel_fb():
        out, lse = fa.flash_attention_cuda(q, k, v)
        fa.flash_attention_bwd_cuda(q, k, v, out, lse, dout)

    def plain_fb():
        out, lse = fa.flash_attention_plain(*flat[:3])
        fa.flash_attention_bwd_plain(*flat[:3], out, lse, flat[3])

    leaves = [as_bnth(t).detach().requires_grad_() for t in (q, k, v)]

    def sdpa_fb():
        out = F.scaled_dot_product_attention(*leaves)
        torch.autograd.grad(out, leaves, as_bnth(dout))

    rows = {}
    for what, plain, kernel, library in (
        ("forward", lambda: fa.flash_attention_plain(*flat[:3]),
         lambda: fa.flash_attention_cuda(q, k, v),
         lambda: F.scaled_dot_product_attention(*map(as_bnth, (q, k, v)))),
        ("forward+backward", plain_fb, kernel_fb, sdpa_fb),
    ):
        plain_ms, ms = alternate(plain, kernel, iters=10)
        library_ms = time_ms(library, iters=10)
        rows[what] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms)
        log(f"[flash-time] {what:16s} (B, T, N, H) = ({B}, {T}, {N}, {H}) bf16 in place: kernel "
            f"{ms:.4f} ms  plain {plain_ms:.4f} ms  scaled_dot_product_attention "
            f"{library_ms:.4f} ms  [{name_power}]")

    del flat
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    kernel_fb()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    scores = B * N * T * T * 2
    log(f"[flash-time] K6 forward + backward at B={B}: peak memory beyond its inputs "
        f"{peak / 1e6:.1f} MB (one bf16 (B, N, T, S) tensor: {scores / 1e6:.1f} MB)")
    report["flash_times"] = dict(rows, peak_extra_bytes=peak, scores_bytes=scores)
    if not peak < scores:
        raise AssertionError(f"K6 forward + backward took {peak} bytes, a (B, N, T, S) tensor "
                             f"is {scores}")
    f, fb = rows["forward"], rows["forward+backward"]
    out = {"flash_attention": (f["ms"], f["plain_ms"], f["library_ms"]),
           "flash_attention_bwd": tuple(fb[key] - f[key] for key in ("ms", "plain_ms",
                                                                     "library_ms"))}
    for name in out:
        log(f"[flash-time] {name}: {against_section6(name, out[name][0])}")
    return out


def serve_siglip(report: dict, name_power: str) -> int:
    """Phase 18: a seeded bf16 vit_b_16 SigLIP at 512 px whose position
    table is a 224 px one carried over by ``resize_pe``: eager through the
    kernels (12 K6 and 12 K3 forward launches per forward) against its plain
    versions (logits rel L2 ≤ REL_L2_BOUND or twice the plain bf16 path's
    own distance from an f32 forward of the same weights), then served:
    export (12 ``vtt::flash_attention`` calls in the program, no backward
    op) → load → three requests at each of SERVE_BATCHES, each against eager
    and launching no backward kernel. Returns K6's launches in the served
    requests."""
    import io

    import vision_toolbox_tpu_torch as vtt
    from vision_toolbox_tpu_torch.models.vit import resize_pe
    from vision_toolbox_tpu_torch.ops import _cuda
    from vision_toolbox_tpu_torch.utils.export import export_model

    gen = lambda: torch.Generator().manual_seed(0)
    model = vtt.create_backbone("vit_b_16", dtype=torch.bfloat16, generator=gen(), **SIGLIP)
    table = vtt.create_backbone("vit_b_16", weights="siglip", generator=gen()).pe  # 224 px
    with torch.no_grad():
        model.pe.copy_(resize_pe(table, 512, 16))
    model.eval()
    depth, width = len(model.blocks), model.last_out_channels
    per_forward = NO_LAUNCHES | {"flash_attention": depth, "block_mlp": depth}
    images = torch.rand(32, 512, 512, 3, generator=torch.Generator().manual_seed(1)).cuda()
    ref = vtt.create_backbone("vit_b_16", **SIGLIP)  # f32 compute, the same weights
    ref.load_state_dict(model.state_dict())
    with torch.inference_mode():
        _cuda.reset_launch_counts()
        logits = model(images[:8])
        torch.cuda.synchronize()
        counts = dict(_cuda.LAUNCHES)
        plain_logits = model(images[:8], plain=True)
        f32_logits = ref(images[:8], force_unfused=True, plain=True)
    err, own = rel_l2(logits, plain_logits), rel_l2(plain_logits, f32_logits)
    bound = max(REL_L2_BOUND, 2 * own)
    log(f"[siglip-serve] vit_b_16 siglip@512 (pe from 224 px by resize_pe) bf16 bs8 forward: "
        f"launches {counts}; logits kernel vs plain path rel L2 {err:.3e} (bound {bound:.3e}: "
        f"the plain bf16 path is {own:.3e} from the f32 reference; the kernel path "
        f"{rel_l2(logits, f32_logits):.3e})")
    if counts != per_forward:
        raise AssertionError(f"expected {per_forward}, got {counts}")
    if logits.shape != (8, width) or not torch.isfinite(logits.float()).all() \
            or not err <= bound:
        raise AssertionError(f"siglip logits: shape {tuple(logits.shape)}, rel L2 {err}")
    del ref

    t0 = time.perf_counter()
    blob = export_model(model, (8, 512, 512, 3))
    program = torch.export.load(io.BytesIO(blob))
    targets = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    n_flash = targets.count("vtt.flash_attention.default")
    backward_ops = [t for t in targets if "bwd" in t or "backward" in t]
    served = program.module()
    log(f"[siglip-serve] export+load {time.perf_counter() - t0:.1f} s, artifact "
        f"{len(blob) / 2**20:.1f} MiB; the program calls vtt::flash_attention {n_flash} times, "
        f"backward ops {backward_ops}")
    if n_flash != depth or backward_ops:
        raise AssertionError(f"exported program: {n_flash} flash calls, backward {backward_ops}")
    with torch.inference_mode():
        eager = {b: model(images[:b]) for b in SERVE_BATCHES}
        _cuda.reset_launch_counts()
        answers = {b: [served(images[:b]) for _ in range(3)] for b in SERVE_BATCHES}
        torch.cuda.synchronize()
        launches = dict(_cuda.LAUNCHES)
    n_forwards = 3 * len(SERVE_BATCHES)
    log(f"[siglip-serve] {n_forwards} requests at batch {SERVE_BATCHES}: launches {launches}")
    if launches != {k: n_forwards * v for k, v in per_forward.items()}:
        raise AssertionError(f"served path launched {launches}, expected {n_forwards}× "
                             f"{per_forward}")
    rows = []
    for b in SERVE_BATCHES:
        for out in answers[b]:
            e = rel_l2(out, eager[b])
            if out.shape != (b, width) or not torch.isfinite(out.float()).all() or e > 1e-3:
                raise AssertionError(f"served batch {b} disagrees with eager: rel L2 {e}")
        with torch.inference_mode():
            ms = time_ms(lambda: served(images[:b]), iters=10)
        rows.append(dict(batch=b, ms_per_batch=ms, rel_l2_vs_eager=e))
        log(f"[siglip-serve] batch {b:2d}: {ms:.3f} ms/batch ({b / ms * 1e3:.1f} img/s), "
            f"rel L2 vs eager {e:.2e}  [{name_power}]")
    report["siglip_serve"] = dict(launches_per_forward=counts, rel_l2_vs_plain=err,
                                  plain_vs_f32=own, bound=bound, requests=rows)
    return launches["flash_attention"]


def train_siglip(report: dict, name_power: str) -> dict[str, int]:
    """Phase 19: the vit_b_16 SigLIP step at bs64@512 with ViT's recipe, 3
    warm-up + 10 timed steps, each of the 12 blocks through K6 and K3
    forward and backward; then phase 20, one step at bs8 through the kernels
    against one through the plain versions and an f32 reference."""
    watched = ("head.weight", "backbone.pe", "backbone.blocks.0.mha.q_proj.weight",
               "backbone.blocks.11.mlp.linear2.bias", "backbone.pooler.probe",
               "backbone.pooler.mha.k_proj.weight")
    per_step = NO_LAUNCHES | dict.fromkeys(
        ("flash_attention", "flash_attention_bwd", "block_mlp", "block_mlp_bwd"), 12)
    return train_transformer(report, "siglip_train", "vit_b_16", SIGLIP_TRAIN, per_step, watched,
                             name_power, **SIGLIP)


def depthwise_work(name: str, B: int, H: int, W: int, C: int, k: int,
                   x_bytes: int) -> tuple[float, float, float]:
    """(product operations, bytes, f32 operations) of one K9 call: 2·k²
    operations per output element for the forward, twice that for the
    backward (dx and dw). Bytes: x (and g) in, y (dx) out, the weights (and
    dw), in the run's type."""
    n = B * H * W * C
    if name == "depthwise_conv":
        return 0.0, 2 * n * x_bytes + k * k * C * x_bytes, 2 * k * k * n
    return 0.0, 3 * n * x_bytes + 2 * k * k * C * x_bytes, 4 * k * k * n


def depthwise_args(g, B, H, W, C, k, dtype, offset: int = 0):
    """x (B, H, W, C), w (k, k, 1, C) and a cotangent like x, on the card;
    x and the cotangent ``offset`` elements into their buffers."""
    def r(*s, scale=1.0, offset=0):
        buf = torch.empty(math.prod(s) + offset, dtype=dtype, device="cuda")
        t = buf[offset:].view(s)
        t.copy_(torch.randn(s, generator=g) * scale)
        return t
    return r(B, H, W, C, offset=offset), r(k, k, 1, C, scale=0.2), r(B, H, W, C, offset=offset)


def hold_depthwise(checks: Checks, case: dict, x, w, dout,
                   second: bool) -> tuple[list[float], float, list[int] | None]:
    """One K9 forward and backward on (x, w, dout) against the plain
    versions: bf16 out and dx bit-equal (the count of differing elements,
    bound 0: the same f32 taps summed in the same order and rounded once),
    f32 by max abs error against BOUND·max|plain|; dw by rel L2 ≤
    BWD_REL_L2 (its f32 sum runs in another order: block partials, then a
    fixed-order sum); with ``second``, a second backward bit-equal to the
    first. Returns max|out − plain| and max|dx − plain|, dw's rel L2 and,
    in bf16, the counts of differing out and dx elements."""
    from vision_toolbox_tpu_torch.ops import depthwise_conv as dc

    out = dc.depthwise_conv2d_cuda(x, w)
    dx, dw = dc.depthwise_conv2d_bwd_cuda(x, w, dout)
    want, (want_dx, want_dw) = (dc.depthwise_conv2d_plain(x, w),
                                dc.depthwise_conv2d_bwd_plain(x, w, dout))
    torch.cuda.synchronize()
    errs = [(a.float() - b.float()).abs().max().item() for a, b in ((out, want), (dx, want_dx))]
    differ = None
    if x.dtype == torch.bfloat16:
        differ = [checks.exact(case, "out", out, want), checks.exact(case, "dx", dx, want_dx)]
    else:
        checks.elementwise(case, "out", out, want)
        checks.elementwise(case, "dx", dx, want_dx)
    err_dw = checks.reduced(case, "dw", dw, want_dw)
    if second:
        dx2, dw2 = dc.depthwise_conv2d_bwd_cuda(x, w, dout)
        torch.cuda.synchronize()
        checks.exact(case, "dx second backward", dx2, dx)
        checks.exact(case, "dw second backward", dw2, dw)
    return errs, err_dw, differ


def compare_depthwise(report: dict) -> tuple[dict[str, float], float]:
    """Phase 21: K9 forward and backward vs their plain versions
    (``hold_depthwise``) at DEPTHWISE_CASES (convnext_t's four stage shapes
    at batch 8, k = 3, 5, 9 and 21, C = 20, one-wide and one-high maps, an
    offset view), f32 and bf16, each with the route its launch takes; at
    stage 1 bf16 a second backward bit-equal to the first. Returns the max
    abs error of out and of dx, and dw's rel L2, at convnext_t stage 1,
    batch 8, bf16."""
    from vision_toolbox_tpu_torch.ops import depthwise_conv as dc

    g = torch.Generator().manual_seed(21)
    checks, main_err = Checks(), {}
    for B, H, W, C, k, offset in DEPTHWISE_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            x, w, dout = depthwise_args(g, B, H, W, C, k, dtype, offset)
            case = dict(kernel="depthwise_conv", B=B, H=H, W=W, C=C, k=k, offset=offset,
                        dtype=str(dtype).split(".")[-1], route=dc.kernel_route(x, dout))
            main = (B, H, C, offset, dtype) == (8, 56, 96, 0, torch.bfloat16)
            errs, err_dw, differ = hold_depthwise(checks, case, x, w, dout, second=main)
            if main:
                main_err["depthwise_conv"], main_err["depthwise_conv_bwd"] = errs
                main_dw = err_dw
            counts = (f"; bf16 elements differing from plain: out {differ[0]}, dx {differ[1]}"
                      if differ else "")
            log(f"[depthwise] B={B} {H}x{W}x{C} k={k} offset={offset} {case['dtype']:8s} "
                f"route {case['route']}: {checks.summary(case)}{counts}")
    report["compare_depthwise"] = checks.rows
    bad = [r for r in checks.rows if not r["ok"]]
    if bad:
        raise AssertionError(f"{len(bad)} K9 comparisons out of bounds: {bad[:8]}")
    return main_err, main_dw


def time_depthwise_case(g, B: int, H: int, C: int, k: int, name_power: str,
                        earlier: bool = False, tag: str = "depthwise-time"):
    """K9 forward and backward on a (B, H, H, C) bf16 map with a k × k
    filter: the kernels, their plain versions (in turns) and cuDNN's grouped
    conv (``F.conv2d(groups=C)`` on the same memory as a channels_last
    tensor; its backward is forward + backward less the forward), each with
    its bound, the route and launch geometry; with ``earlier``, beside the
    first design's times (K9_EARLIER_MS, convnext_t stage 1). Returns the
    row and the timed operands (x, w, dout)."""
    import torch.nn.functional as F

    from vision_toolbox_tpu_torch.ops import depthwise_conv as dc

    x, w, dout = depthwise_args(g, B, H, H, C, k, torch.bfloat16)
    wc = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)  # (C, 1, k, k)
    conv = lambda t, wt: F.conv2d(t.permute(0, 3, 1, 2), wt, padding=k // 2, groups=C)
    xl, wl = x.detach().clone().requires_grad_(), wc.detach().clone().requires_grad_()

    def library_fb():
        with torch.enable_grad():
            out = conv(xl, wl)
            torch.autograd.grad(out, (xl, wl), dout.permute(0, 3, 1, 2))

    row = dict(B=B, H=H, C=C, k=k, route=dc.kernel_route(x, dout),
               geometry=dict(forward=dc.kernel_geometry(x, w),
                             weight_gradient=dc.kernel_geometry(x, w, bwd=True)))
    log(f"[{tag}] B={B} {H}x{H}x{C} k={k}: route {row['route']}, geometry {row['geometry']}")
    for what, plain, kernel, library in (
        ("forward", lambda: dc.depthwise_conv2d_plain(x, w),
         lambda: dc.depthwise_conv2d_cuda(x, w), lambda: conv(x, wc)),
        ("backward", lambda: dc.depthwise_conv2d_bwd_plain(x, w, dout),
         lambda: dc.depthwise_conv2d_bwd_cuda(x, w, dout), library_fb),
    ):
        plain_ms, ms = alternate(plain, kernel, iters=5)
        library_ms = time_ms(library, iters=10)
        row[what] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms)
    row["backward"]["library_ms"] -= row["forward"]["library_ms"]
    for what in ("forward", "backward"):
        r = row[what]
        name = "depthwise_conv" + ("_bwd" if what == "backward" else "")
        r["bound_ms"], r["bound_by"] = bound(*depthwise_work(name, B, H, H, C, k, 2))
        first = (f"; first design (PERF.md §6) {K9_EARLIER_MS[name]:.4f} ms, this / "
                 f"first = {r['ms'] / K9_EARLIER_MS[name]:.3f}" if earlier else "")
        log(f"[{tag}] {what:8s} B={B} {H}x{H}x{C} k={k} bf16: kernel {r['ms']:.4f} ms"
            f"  plain {r['plain_ms']:.4f} ms  cuDNN grouped conv {r['library_ms']:.4f} ms "
            f"(kernel / cuDNN = {r['ms'] / r['library_ms']:.3f})  bound {r['bound_ms']:.4f} "
            f"ms ({r['bound_by']}){first}  [{name_power}]")
    return row, (x, w, dout)


def time_depthwise(report: dict, name_power: str) -> dict[str, tuple[float, float, float]]:
    """Phase 22: K9 forward and backward at convnext_t's four stage shapes,
    batch DEPTHWISE_TIME_BATCH, bf16: the kernels, their plain versions (in
    turns) and cuDNN's grouped conv (``F.conv2d(groups=C)`` on the same
    memory as a channels_last tensor; its backward is forward + backward
    less the forward), the library yardstick that no path of the port
    calls; each stage with its route and launch geometry, stage 1 beside
    the first design's times (K9_EARLIER_MS). Then each stage's timed
    operands, and stage 1's in f32, held against the plain versions
    (``hold_depthwise``, a second backward bit-equal): at this batch a
    block walks several regions through the ring (stage 1's geometry must
    show it: two ring stages and several regions a forward block, several
    a weight-gradient block), which phase 21's batch 8 leaves to one region
    a bf16 block. Returns (kernel, plain, library) ms of stage 1, the shape
    of the JSON line's bound; the stages and the 18-call sums go to the
    report."""
    from vision_toolbox_tpu_torch.ops import depthwise_conv as dc

    g = torch.Generator().manual_seed(22)
    B, rows, per_step, checks = DEPTHWISE_TIME_BATCH, [], {}, Checks()
    for H, C, blocks in CONVNEXT_STAGES:
        row, (x, w, dout) = time_depthwise_case(g, B, H, C, 7, name_power,
                                                earlier=H == CONVNEXT_STAGES[0][0])
        row["blocks"] = blocks
        for what in ("forward", "backward"):
            for key in ("ms", "plain_ms", "library_ms", "bound_ms"):
                per_step[(what, key)] = per_step.get((what, key), 0.0) + blocks * row[what][key]
        rows.append(row)
        operands = [(x, w, dout)]
        if H == CONVNEXT_STAGES[0][0]:
            fwd, wgrad = row["geometry"]["forward"], row["geometry"]["weight_gradient"]
            if not (fwd["stages"] == 2 and fwd["regions_per_block"] > 1
                    and wgrad["regions_per_block"] > 1):
                raise AssertionError(f"K9 at B={B} {H}x{H}x{C}: geometry {row['geometry']} "
                                     "walks no ring of several regions to check")
            operands.append(depthwise_args(g, B, H, H, C, 7, torch.float32))
        for x, w, dout in operands:
            case = dict(kernel="depthwise_conv", B=B, H=H, W=H, C=C, k=7,
                        dtype=str(x.dtype).split(".")[-1], route=dc.kernel_route(x, dout))
            _, _, differ = hold_depthwise(checks, case, x, w, dout, second=True)
            counts = (f"; bf16 elements differing from plain: out {differ[0]}, dx {differ[1]}"
                      if differ else "")
            log(f"[depthwise-time] held B={B} {H}x{H}x{C} k=7 {case['dtype']}: "
                f"{checks.summary(case)}{counts}")
        del x, w, dout, operands
    for what in ("forward", "backward"):
        log(f"[depthwise-time] {what} summed over convnext_t's 18 calls at bs{B}: kernel "
            f"{per_step[(what, 'ms')]:.3f} ms, plain {per_step[(what, 'plain_ms')]:.3f}, cuDNN "
            f"{per_step[(what, 'library_ms')]:.3f}, bound {per_step[(what, 'bound_ms')]:.3f}")
    report["depthwise_times"] = dict(stages=rows, per_step={f"{a}/{b}": v
                                                            for (a, b), v in per_step.items()},
                                     held=checks.rows)
    bad = [r for r in checks.rows if not r["ok"]]
    if bad:
        raise AssertionError(f"{len(bad)} K9 comparisons at bs{B} out of bounds: {bad[:8]}")
    f, b = rows[0]["forward"], rows[0]["backward"]
    return {"depthwise_conv": (f["ms"], f["plain_ms"], f["library_ms"]),
            "depthwise_conv_bwd": (b["ms"], b["plain_ms"], b["library_ms"])}


def time_narrow_mlp(report: dict, name_power: str) -> None:
    """Phase 23: K3's inference forward and backward through its 96-column
    tiles, timed in turns with their plain versions at convnext_t stage 1
    (T = 56², D = 96), bs128, bf16, in ConvNeXt's form (γ_ls, drop path,
    residual), and a second backward bit-equal to the first. Phases 3 and
    9 check them at these widths."""
    from vision_toolbox_tpu_torch.ops import block_mlp as bm

    g = torch.Generator().manual_seed(23)
    B, T, D, Dh = DEPTHWISE_TIME_BATCH, 56 * 56, 96, 384
    m = mlp_args(g, B, T, D, Dh, torch.bfloat16, True, True)
    ops = [m[k] for k in ("ln_scale", "ln_bias", "w1", "b1", "w2", "b2")]
    fwd = (m["x"], *ops, m["ls_gamma"], m["dp_scale"], m["residual"])
    _, saves = bm.fused_mlp_save_cuda(*fwd)
    dout = torch.randn(m["x"].shape, generator=g).to("cuda", torch.bfloat16)
    bwd = (dout, saves, m["w1"], m["w2"], m["ln_scale"], m["ls_gamma"], m["dp_scale"], True)
    second_backward_bit_equal(report, f"block_mlp_bwd convnext_t stage 1 b{B}",
                              lambda: bm.fused_mlp_bwd_cuda(*bwd))
    rows = {}
    for name, plain, kernel in (
        ("block_mlp", lambda: bm.fused_mlp_block_plain(**m), lambda: bm.fused_mlp_block(**m)),
        ("block_mlp_bwd", lambda: bm.fused_mlp_bwd_plain(*bwd), lambda: bm.fused_mlp_bwd_cuda(*bwd)),
    ):
        plain_ms, ms = alternate(plain, kernel, iters=5)
        flops = 4 * B * T * D * Dh
        nbytes = (2 * B * T * D * 2 + 4 * D * Dh) if name == "block_mlp" else \
            (2 * B * T * D * 2 + 2 * B * T * D + 4 * B * T + 4 * B * T * Dh + 4 * D * Dh)
        bound_ms, bound_by = bound(flops, nbytes)
        rows[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)
        log(f"[mlp-32-time] {name:13s} convnext_t stage 1 bs{B} (M={B * T}, D={D}) bf16 γ+dp+res: "
            f"kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  bound {bound_ms:.4f} ms ({bound_by})  "
            f"[{name_power}]")
    report["narrow_mlp_times"] = rows


def serve_backbone(report: dict, key: str, name: str, per_forward: dict[str, int],
                   program_ops: dict[str, int], batches: tuple[int, ...], name_power: str,
                   layer_scale: float | None = None, model_kw: dict | None = None,
                   per_batch: dict[int, dict[str, int]] | None = None) -> dict[str, int]:
    """A seeded bf16 ``name`` (224 px, built with ``model_kw``; LayerScale
    γs spread around ``layer_scale`` where given; its output (B, width) or,
    for a convnet's feature map, (B, h, w, width)), eager at batch 8 through
    the kernels (``per_forward`` launches a forward, nothing else) and, where
    it runs one, against its plain versions (logits rel L2 ≤ REL_L2_BOUND or
    twice the plain bf16 path's own distance from an f32 forward of the same
    weights), then
    served: export (the program calls each custom op of ``program_ops`` that
    many times, no backward op) → load → three requests at each of
    ``batches``, each against eager, a request at batch b launching
    ``per_batch[b]`` where given (K2's pair test), else ``per_forward``.
    Returns the served requests' launches."""
    import vision_toolbox_tpu_torch as vtt
    from vision_toolbox_tpu_torch.ops import _cuda

    tag, model_kw = key.replace("_", "-"), model_kw or {}
    model = vtt.create_backbone(name, dtype=torch.bfloat16,
                                generator=torch.Generator().manual_seed(0), **model_kw)
    if layer_scale is not None:
        spread_layer_scale(model, layer_scale)
    model.eval()
    width, per_forward = model.last_out_channels, NO_LAUNCHES | per_forward
    per_batch = {b: NO_LAUNCHES | (per_batch or {}).get(b, per_forward) for b in batches}
    images = torch.rand(max(batches), 224, 224, 3,
                        generator=torch.Generator().manual_seed(1)).cuda()
    ref = vtt.create_backbone(name, **model_kw)  # f32 compute, the same weights
    ref.load_state_dict(model.state_dict())
    runs_kernels = any(per_forward.values())
    with torch.inference_mode():
        _cuda.reset_launch_counts()
        logits = model(images[:8])
        torch.cuda.synchronize()
        counts = dict(_cuda.LAUNCHES)
        plain_logits = model(images[:8], plain=True) if runs_kernels else None
        f32_logits = ref(images[:8], **reference_kw(ref))
    if runs_kernels:
        err, own = rel_l2(logits, plain_logits), rel_l2(plain_logits, f32_logits)
        bound_l2 = max(REL_L2_BOUND, 2 * own)
        log(f"[{tag}] {name} bf16 bs8 forward: launches {counts}; logits kernel vs plain path "
            f"rel L2 {err:.3e} (bound {bound_l2:.3e}: the plain bf16 path is {own:.3e} from the "
            f"f32 reference; the kernel path {rel_l2(logits, f32_logits):.3e})")
    else:  # no kernel in the model: nothing to hold against a plain path
        err = own = bound_l2 = None
        log(f"[{tag}] {name} bf16 bs8 forward: launches {counts}; no kernel in the model; "
            f"the bf16 forward is {rel_l2(logits, f32_logits):.3e} from the f32 reference")
    if counts != per_forward:
        raise AssertionError(f"expected {per_forward}, got {counts}")
    if (logits.shape[0], logits.shape[-1]) != (8, width) \
            or not torch.isfinite(logits.float()).all() or (runs_kernels and not err <= bound_l2):
        raise AssertionError(f"{name} logits: shape {tuple(logits.shape)}, rel L2 {err}")
    del ref

    launches, rows, nodes, _ = serve_program(tag, model, program_ops, batches, images,
                                             per_batch, width, name_power)
    report[key] = dict(launches_per_forward=counts, rel_l2_vs_plain=err, plain_vs_f32=own,
                       bound=bound_l2, requests=rows, program_nodes=nodes)
    return launches


def serve_program(tag: str, model: torch.nn.Module, program_ops: dict[str, int],
                  batches: tuple[int, ...], images: torch.Tensor,
                  per_batch: dict[int, dict[str, int]], width: int, name_power: str):
    """The serving half of ``serve_backbone``: export ``model`` (the program
    calls each custom op of ``program_ops`` that many times, no backward
    op) → load → three requests at each of ``batches``, each within 1e-3
    rel L2 of eager, a request at batch b launching exactly
    ``per_batch[b]``; then each batch timed (10 requests). Returns (the
    served requests' launches, the timed rows, the program's operator node
    count, the loaded program)."""
    import io

    from vision_toolbox_tpu_torch.ops import _cuda
    from vision_toolbox_tpu_torch.utils.export import export_model

    t0 = time.perf_counter()
    blob = export_model(model, (8, 224, 224, 3))
    program = torch.export.load(io.BytesIO(blob))
    targets = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    calls = {op: targets.count(f"vtt.{op}.default") for op in program_ops}
    backward_ops = [t for t in targets if "bwd" in t or "backward" in t]
    served = program.module()
    log(f"[{tag}] export+load {time.perf_counter() - t0:.1f} s, artifact "
        f"{len(blob) / 2**20:.1f} MiB; {len(targets)} operator nodes; the program's custom-op "
        f"calls {calls}, backward ops {backward_ops}")
    if calls != program_ops or backward_ops:
        raise AssertionError(f"exported program: {calls}, backward {backward_ops}")
    with torch.inference_mode():
        eager = {b: model(images[:b]) for b in batches}
        _cuda.reset_launch_counts()
        answers = {b: [served(images[:b]) for _ in range(3)] for b in batches}
        torch.cuda.synchronize()
        launches = dict(_cuda.LAUNCHES)
    n_forwards = 3 * len(batches)
    log(f"[{tag}] {n_forwards} requests at batch {batches}: launches {launches}")
    expected = {k: sum(3 * per_batch[b][k] for b in batches) for k in NO_LAUNCHES}
    if launches != expected:
        raise AssertionError(f"served path launched {launches}, expected {expected}")
    rows = []
    for b in batches:
        for out in answers[b]:
            e = rel_l2(out, eager[b])
            if out.shape != eager[b].shape or (out.shape[0], out.shape[-1]) != (b, width) \
                    or not torch.isfinite(out.float()).all() or e > 1e-3:
                raise AssertionError(f"served batch {b} disagrees with eager: rel L2 {e}")
        with torch.inference_mode():
            ms = time_ms(lambda: served(images[:b]), iters=10)
        rows.append(dict(batch=b, ms_per_batch=ms, rel_l2_vs_eager=e))
        log(f"[{tag}] batch {b:3d}: {ms:.3f} ms/batch ({b / ms * 1e3:.1f} img/s), "
            f"rel L2 vs eager {e:.2e}  [{name_power}]")
    return launches, rows, len(targets), served


def serve_convnext(report: dict, name_power: str) -> int:
    """Phase 24: convnext_t served (``serve_backbone``; LayerScale γs around
    CONVNEXT_TRAIN's 0.1): 18 K9 and 18 K3 forward launches per forward, 18
    ``vtt::depthwise_conv2d`` and 18 ``vtt::fused_mlp_block`` calls in the
    program, batches SERVE_BATCHES. Returns K9's launches in the served
    requests."""
    blocks = {"depthwise_conv": 18, "block_mlp": 18}
    return serve_backbone(report, "convnext_serve", "convnext_t", blocks,
                          {"depthwise_conv2d": 18, "fused_mlp_block": 18}, SERVE_BATCHES,
                          name_power, CONVNEXT_TRAIN["layer_scale"])["depthwise_conv"]


def train_convnext(report: dict, name_power: str) -> dict[str, int]:
    """Phase 25: the convnext_t step at bs128@224 with ViT's recipe and
    stochastic depth 0.1, 3 warm-up + 10 timed steps, each of the 18 blocks
    through K9 and K3 forward and backward; then phase 26, one step at bs8
    through the kernels against one through the plain versions and an f32
    reference, one drop-path draw for all three."""
    watched = ("head.weight", "backbone.stem_conv.weight", "backbone.stages.0.0.dwconv.weight",
               "backbone.stages.2.8.layer_scale.gamma", "backbone.stages.3.2.pwconv2.bias",
               "backbone.downsample_conv_1.bias", "backbone.norm.weight")
    per_step = NO_LAUNCHES | dict.fromkeys(
        ("depthwise_conv", "depthwise_conv_bwd", "block_mlp", "block_mlp_bwd"), 18)
    return train_transformer(report, "convnext_train", "convnext_t", CONVNEXT_TRAIN, per_step,
                             watched, name_power, **CONVNEXT_KW)


def repairs_on_card(report: dict, name_power: str) -> None:
    """Phase 27: the repaired port faults on the card. cait_s_24 at 384 px
    (T = 576, beyond K5's rule: the XLA branch) builds, runs K3 and no K5,
    and is served (export → load → a request equal to eager); K6 at head 72,
    T = 1024 (zero-padded to 80), forward and backward against the plain
    versions on the unpadded head, FLASH_BOUND."""
    import vision_toolbox_tpu_torch as vtt
    from vision_toolbox_tpu_torch.ops import _cuda
    from vision_toolbox_tpu_torch.ops import attention
    from vision_toolbox_tpu_torch.utils.export import export_model, load_exported

    model = vtt.create_backbone("cait_s_24", img_size=384, dtype=torch.bfloat16,
                                generator=torch.Generator().manual_seed(0))
    spread_layer_scale(model, CAIT_LAYER_SCALE)
    model.eval()
    images = torch.rand(2, 384, 384, 3, generator=torch.Generator().manual_seed(1)).cuda()
    served = load_exported(export_model(model, (2, 384, 384, 3)))
    with torch.inference_mode():
        eager = model(images)
        _cuda.reset_launch_counts()
        out = served(images)
        torch.cuda.synchronize()
        counts = dict(_cuda.LAUNCHES)
    e = rel_l2(out, eager)
    log(f"[repairs] cait_s_24 at 384 px (T = 576) served: launches {counts}, rel L2 vs eager "
        f"{e:.2e}")
    if counts != NO_LAUNCHES | {"block_mlp": 24} or not torch.isfinite(out.float()).all() \
            or e > 1e-3:
        raise AssertionError(f"cait_s_24 at 384 px: launches {counts}, rel L2 {e}")

    g = torch.Generator().manual_seed(27)
    q, k, v = (torch.randn(2, 1024, 4, 72, generator=g).to("cuda", torch.bfloat16).requires_grad_()
               for _ in range(3))
    dout = torch.randn(2, 1024, 4, 72, generator=g).to("cuda", torch.bfloat16)
    _cuda.reset_launch_counts()
    got = attention.dot_product_attention(q, k, v)
    got_grads = torch.autograd.grad(got, (q, k, v), dout)
    torch.cuda.synchronize()
    k6 = (_cuda.LAUNCHES["flash_attention"], _cuda.LAUNCHES["flash_attention_bwd"])
    want = attention.dot_product_attention(q, k, v, plain=True)
    want_grads = torch.autograd.grad(want, (q, k, v), dout)
    checks, case = Checks(), dict(kernel="flash_attention", head=72, T=1024)
    for name, a, b in zip(("out", "dq", "dk", "dv"), (got, *got_grads), (want, *want_grads)):
        checks.elementwise(case, name, a, b, FLASH_BOUND)
    log(f"[repairs] K6 at head 72 (padded to 80), T = 1024, bf16: launches {k6}, "
        f"{checks.summary(case)}")
    report["repairs"] = dict(cait_384_launches=counts, cait_384_rel_l2=e, k6_head72=checks.rows)
    if k6 != (1, 1) or not all(r["ok"] for r in checks.rows):
        raise AssertionError(f"K6 at head 72: launches {k6}, {checks.rows}")


def swin_attention_work(name: str, B: int, nW: int, T: int, N: int, hd: int,
                        x_bytes: int, masked: bool = True) -> tuple[float, float]:
    """(product operations, bytes) of one K7 call: the forward's q·kᵀ and
    p·v per window and head; the backward's five products (the recomputed
    logits, g·vᵀ, dv, dq, dk). Bytes: q, k, v (and g) in, out (dq, dk, dv)
    out, pe and the mask (where there is one) in (and dPE out, f32)."""
    x, tables = B * nW * T * N * hd * x_bytes, (N + nW * masked) * T * T * x_bytes
    if name == "swin_attention":
        return 4 * B * nW * N * T * T * hd, 4 * x + tables
    return 10 * B * nW * N * T * T * hd, 7 * x + tables + N * T * T * 4


def swin_attention_args(g, B, nW, T, N, hd, masked, dtype):
    """q, k, v (B, nW, T, N·hd), pe (1, N, T, T), a −100 mask (nW, T, T) on
    about 30% of the token pairs or None, and a cotangent like q, on the card."""
    r = lambda *s, scale=1.0: torch.randn(s, generator=g) * scale
    q, k, v, dout = (r(B, nW, T, N * hd).to("cuda", dtype) for _ in range(4))
    pe = r(1, N, T, T, scale=0.5).to("cuda", dtype)
    mask = None
    if masked:
        mask = ((torch.rand(nW, T, T, generator=g) < 0.3).float() * -100.0).to("cuda", dtype)
    return q, k, v, pe, mask, dout


def compare_swin(report: dict) -> tuple[dict[str, float], float]:
    """Phase 28: K7 forward and backward vs their plain versions at
    SWIN_ATTENTION_CASES, f32 and bf16: out, dq, dk, dv by max abs error
    against BOUND·max|plain|, dPE (an f32 sum over batch and windows in
    another order) by rel L2 ≤ BWD_REL_L2, and a second backward bit-equal
    to the first; at SWIN_CONTROL_CASES in bf16 the second-plane control, as
    phase 34's for K2: the kernels' rel L2 from the plain versions at most
    SECOND_PLANE of ``swin_attention_one_plane``'s (out: p rounded to bf16
    once) and ``swin_attention_bwd_one_plane``'s (dq, dk, dv: p and ds rounded
    once); K8 partition and unpartition at SWIN_RELAYOUT_CASES, bit-exact
    against their plain versions. Returns the max abs errors at swin_t stage
    1, batch 8, bf16 (K7: out and the worst of dq, dk, dv) and dPE's rel L2
    there."""
    from vision_toolbox_tpu_torch.ops import swin_attention as sa
    from vision_toolbox_tpu_torch.ops import swin_relayout as sr

    g = torch.Generator().manual_seed(28)
    checks, main_err, main_dpe, control = Checks(), {}, None, []
    for B, nW, T, N, hd, masked in SWIN_ATTENTION_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, pe, mask, dout = swin_attention_args(g, B, nW, T, N, hd, masked, dtype)
            case = dict(kernel="swin_attention", B=B, nW=nW, T=T, N=N, hd=hd, masked=masked,
                        dtype=str(dtype).split(".")[-1])
            err = checks.elementwise(case, "out", sa.swin_attention_cuda(q, k, v, pe, mask, N),
                                     sa.swin_attention_plain(q, k, v, pe, mask, N))
            got = sa.swin_attention_bwd_cuda(q, k, v, pe, mask, N, dout)
            again = sa.swin_attention_bwd_cuda(q, k, v, pe, mask, N, dout)
            want = sa.swin_attention_bwd_plain(q, k, v, pe, mask, N, dout)
            torch.cuda.synchronize()
            errs = [checks.elementwise(case, n, a, b) for n, a, b in zip(("dq", "dk", "dv"), got,
                                                                         want)]
            dpe = checks.reduced(case, "dpe", got[3], want[3])
            for n, a, b in zip(("dq", "dk", "dv", "dpe"), got, again):
                checks.exact(case, f"{n} twice", a, b)
            log(f"[swin-attention] B={B} nW={nW:2d} T={T} N={N:2d} hd={hd} "
                f"{'mask ' if masked else ''}{case['dtype']:8s} {checks.summary(case)}")
            if (B, nW, dtype) == (8, 64, torch.bfloat16):
                main_err["swin_attention"], main_err["swin_attention_bwd"] = err, max(errs)
                main_dpe = dpe
            del q, k, v, pe, mask, dout, got, again, want
    for B, nW, T, N, hd, masked in SWIN_CONTROL_CASES:
        args = swin_attention_args(g, B, nW, T, N, hd, masked, torch.bfloat16)
        q, k, v, pe, mask, dout = args
        got = (sa.swin_attention_cuda(q, k, v, pe, mask, N),
               *sa.swin_attention_bwd_cuda(*args[:5], N, dout)[:3])
        want = (sa.swin_attention_plain(q, k, v, pe, mask, N),
                *sa.swin_attention_bwd_plain(*args[:5], N, dout)[:3])
        ctrl = (sa.swin_attention_one_plane(q, k, v, pe, mask, N),
                *sa.swin_attention_bwd_one_plane(*args[:5], N, dout)[:3])
        row = dict(B=B, nW=nW, T=T, N=N, hd=hd, masked=masked, **{
            n: dict(kernel=rel_l2(a, b), control=rel_l2(c, b))
            for n, a, b, c in zip(("out", "dq", "dk", "dv"), got, want, ctrl)})
        row["ok"] = all(row[n]["kernel"] <= SECOND_PLANE * row[n]["control"]
                        for n in ("out", "dq", "dk", "dv"))
        control.append(row)
        log(f"[swin-attention] second-plane control B={B} nW={nW} T={T} N={N} bf16, rel L2 from "
            f"the plain versions, kernel / control: " + ", ".join(
                f"{n} {row[n]['kernel']:.2e} / {row[n]['control']:.2e}"
                for n in ("out", "dq", "dk", "dv"))
            + f" (kernel ≤ {SECOND_PLANE} × control) {'ok' if row['ok'] else 'FAIL'}")
        del args, q, k, v, pe, mask, dout, got, want, ctrl
    for B, H, W, C, w, s in SWIN_RELAYOUT_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn(B, H, W, C, generator=g).to("cuda", dtype)
            y = sr.shifted_window_partition_cuda(x, w, s)
            back = sr.shifted_window_unpartition_cuda(y, w, s, H, W)
            y2 = y.flip(0)
            pairs = ((y, sr.shifted_window_partition_plain(x, w, s)), (back, x),
                     (sr.shifted_window_unpartition_cuda(y2, w, s, H, W),
                      sr.shifted_window_unpartition_plain(y2, w, s, H, W)))
            torch.cuda.synchronize()
            case = dict(kernel="swin_relayout", B=B, H=H, W=W, C=C, w=w, shift=s,
                        dtype=str(dtype).split(".")[-1])
            for name, (a, b) in zip(("partition", "round trip", "unpartition"), pairs):
                checks.exact(case, name, a, b)
                if (B, H, dtype) == (8, 56, torch.bfloat16) and name != "round trip":
                    main_err["swin_" + name] = (a.float() - b.float()).abs().max().item()
            log(f"[swin-relayout] B={B} {H}x{W}x{C} w={w} s={s} {case['dtype']:8s} "
                f"{checks.summary(case)}")
    report["compare_swin"] = checks.rows
    report["swin_second_plane_control"] = control
    bad = [r for r in checks.rows if not r["ok"]]
    if bad:
        raise AssertionError(f"{len(bad)} K7/K8 comparisons out of bounds: {bad[:8]}")
    if len(control) != len(SWIN_CONTROL_CASES) or not all(r["ok"] for r in control):
        raise AssertionError(f"K7 fails its second-plane control: {control}")
    return main_err, main_dpe


def k7_ptxas(build_log: str) -> list[dict]:
    """ptxas's registers and spill bytes of each register-tile K7 kernel in
    the build log (head-width class, and whether the window takes one key
    tile: ≤ 64 tokens)."""
    rows, entry = [], None
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = re.search(r"(swin_(?:fwd|bwd)_rt_kernel)ILi(\d+)ELb([01])E", m.group(1))
            entry = None if k is None else dict(kernel=k.group(1), head_class=int(k.group(2)),
                                                small_window=k.group(3) == "1")
            if entry:
                rows.append(entry)
        elif entry and "registers" in line:
            entry["registers"] = int(re.search(r"Used (\d+) registers", line).group(1))
        elif entry and "spill" in line:
            entry["spill_bytes"] = sum(map(int, re.findall(r"(\d+) bytes spill", line)))
    return rows


def time_k7_case(g, case: tuple, name_power: str) -> dict[str, dict]:
    """K7 forward and forward + backward at ``case`` (B, nW, T, N, hd,
    masked), bf16, in turns with their plain versions, and torch's
    scaled_dot_product_attention on (B, nW·N, T, hd) with pe + mask summed
    once, outside the timing, into one bf16 attn_mask broadcast over the
    batch (the library yardstick; the port never calls it). First the
    kernels are held against their plain versions on these inputs as phase
    28 holds them (out, dq, dk, dv by BOUND, dPE by BWD_REL_L2): at batch 128
    a block takes several images in turn."""
    import torch.nn.functional as F

    from vision_toolbox_tpu_torch.ops import swin_attention as sa

    B, nW, T, N, hd, masked = case
    q, k, v, pe, mask, dout = swin_attention_args(g, B, nW, T, N, hd, masked, torch.bfloat16)
    checks, check = Checks(), dict(kernel="swin_attention", B=B, nW=nW, T=T, N=N, hd=hd,
                                   masked=masked, dtype="bfloat16")
    got = (sa.swin_attention_cuda(q, k, v, pe, mask, N),
           *sa.swin_attention_bwd_cuda(q, k, v, pe, mask, N, dout))
    want = (sa.swin_attention_plain(q, k, v, pe, mask, N),
            *sa.swin_attention_bwd_plain(q, k, v, pe, mask, N, dout))
    torch.cuda.synchronize()
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        checks.elementwise(check, name, a, b)
    checks.reduced(check, "dpe", got[4], want[4])
    log(f"[swin-time] B={B} nW={nW} T={T} N={N} hd={hd} bf16 against the plain versions: "
        f"{checks.summary(check)}")
    if not all(r["ok"] for r in checks.rows):
        raise AssertionError(f"K7 disagrees with its plain version at the timed shape "
                             f"{case}: {checks.rows}")
    del got, want
    heads = lambda t: t.view(B, nW, T, N, hd).transpose(2, 3).reshape(B, nW * N, T, hd)
    sq, sk, sv, sg = map(heads, (q, k, v, dout))
    bias = pe.float()[None] + (0.0 if mask is None else mask.float()[None, :, None])
    bias = bias.expand(1, nW, N, T, T).to(torch.bfloat16).reshape(1, nW * N, T, T)
    leaves = [t.detach().requires_grad_() for t in (sq, sk, sv)]

    def sdpa_fb():
        out = F.scaled_dot_product_attention(*leaves, attn_mask=bias)
        torch.autograd.grad(out, leaves, sg)

    def kernel_fb():
        sa.swin_attention_cuda(q, k, v, pe, mask, N)
        sa.swin_attention_bwd_cuda(q, k, v, pe, mask, N, dout)

    def plain_fb():
        sa.swin_attention_plain(q, k, v, pe, mask, N)
        sa.swin_attention_bwd_plain(q, k, v, pe, mask, N, dout)

    rows = {"check": checks.rows}
    for what, plain, kernel, library in (
        ("forward", lambda: sa.swin_attention_plain(q, k, v, pe, mask, N),
         lambda: sa.swin_attention_cuda(q, k, v, pe, mask, N),
         lambda: F.scaled_dot_product_attention(sq, sk, sv, attn_mask=bias)),
        ("forward+backward", plain_fb, kernel_fb, sdpa_fb),
    ):
        plain_ms, ms = alternate(plain, kernel, iters=10)
        rows[what] = dict(ms=ms, plain_ms=plain_ms, library_ms=time_ms(library, iters=10))
        log(f"[swin-time] {what:16s} B={B} nW={nW} T={T} N={N} hd={hd} bf16"
            f"{' masked' if masked else ''}: kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  "
            f"scaled_dot_product_attention {rows[what]['library_ms']:.4f} ms  [{name_power}]")
    return rows


def time_swin(report: dict, name_power: str) -> dict[str, tuple[float, float, float | None]]:
    """Phase 29: at swin_t stage 1, batch SWIN_TIME_BATCH, bf16 (64 windows
    of 49 tokens, 3 heads of 32, the shift mask): K7 forward and backward
    (``time_k7_case``; the backward: forward + backward less the forward),
    beside the earlier wmma design's times (K7_EARLIER_MS); the same at window
    14 (SWIN_WINDOW14) with its bounds; the register-tile kernels' registers
    and spills (ptxas); K8 partition and unpartition of the 56×56×96 map in
    turns with their plain versions (no PyTorch call computes them). Returns
    (kernel, plain, library) ms at stage 1."""
    from vision_toolbox_tpu_torch.ops import swin_relayout as sr

    g = torch.Generator().manual_seed(29)
    B, (H, nW, N, _, _), T, hd = SWIN_TIME_BATCH, SWIN_STAGES[0], 49, 32
    rows, out = {}, {}
    for label, case in (("stage1", (B, nW, T, N, hd, True)), ("window14", SWIN_WINDOW14)):
        r = time_k7_case(g, case, name_power)
        f, fb = r["forward"], r["forward+backward"]
        times = {"swin_attention": (f["ms"], f["plain_ms"], f["library_ms"]),
                 "swin_attention_bwd": tuple(fb[key] - f[key] for key in ("ms", "plain_ms",
                                                                          "library_ms"))}
        for name, (ms, _, lib_ms) in times.items():
            bound_ms, bound_by = bound(*swin_attention_work(name, *case[:5], 2, case[5]))
            r[name] = dict(ms=ms, library_ms=lib_ms, bound_ms=bound_ms, bound_by=bound_by)
            earlier = (f"; earlier wmma design (PERF.md §6) {K7_EARLIER_MS[name]:.4f} ms, this / "
                       f"earlier = {ms / K7_EARLIER_MS[name]:.3f}" if label == "stage1" else "")
            log(f"[swin-time] {label} {name:18s}: kernel {ms:.4f} ms  "
                f"scaled_dot_product_attention {lib_ms:.4f} ms  bound {bound_ms:.4f} ms "
                f"({bound_by})  [{name_power}]{earlier}")
        rows[label] = r
        if label == "stage1":
            out = times
        torch.cuda.empty_cache()
    regs = k7_ptxas(report["build_log"])
    for r in regs:
        log(f"[swin-time] ptxas {r['kernel']}<head ≤ {r['head_class']}, "
            f"{'≤ 64 tokens' if r['small_window'] else '> 64 tokens'}>: {r.get('registers')} "
            f"registers, {r.get('spill_bytes')} bytes of spills")
    rows["ptxas"] = regs
    x = torch.randn(B, H, H, 96, generator=g).to("cuda", torch.bfloat16)
    y = sr.shifted_window_partition_cuda(x, 7, 3)
    for name, plain, kernel in (
        ("swin_partition", lambda: sr.shifted_window_partition_plain(x, 7, 3),
         lambda: sr.shifted_window_partition_cuda(x, 7, 3)),
        ("swin_unpartition", lambda: sr.shifted_window_unpartition_plain(y, 7, 3, H, H),
         lambda: sr.shifted_window_unpartition_cuda(y, 7, 3, H, H)),
    ):
        plain_ms, ms = alternate(plain, kernel, iters=10)
        rows[name] = dict(ms=ms, plain_ms=plain_ms)
        out[name] = (ms, plain_ms, None)
        log(f"[swin-time] {name:16s} B={B} {H}x{H}x96 w=7 s=3 bf16: kernel {ms:.4f} ms  plain "
            f"{plain_ms:.4f} ms  [{name_power}]")
    report["swin_times"] = rows
    return out


def serve_swin(report: dict, name_power: str) -> dict[str, int]:
    """Phase 30: swin_t served (``serve_backbone``): 12 K7, 5 + 5 K8 (its five
    shifted blocks) and 12 K3 forward launches per forward; 12
    ``vtt::swin_window_attention``, 5 + 5 ``vtt::swin_window_{partition,
    unpartition}`` and 12 ``vtt::fused_mlp_block`` calls in the program;
    batches SWIN_SERVE_BATCHES. Returns the served requests' launches."""
    per_forward = {"swin_attention": 12, "swin_partition": 5, "swin_unpartition": 5,
                   "block_mlp": 12}
    program_ops = {"swin_window_attention": 12, "swin_window_partition": 5,
                   "swin_window_unpartition": 5, "fused_mlp_block": 12}
    return serve_backbone(report, "swin_serve", "swin_t", per_forward, program_ops,
                          SWIN_SERVE_BATCHES, name_power)


def train_swin(report: dict, name_power: str) -> dict[str, int]:
    """Phase 31: the swin_t step at bs128@224 with ViT's recipe and
    stochastic depth 0.2, 3 warm-up + 10 timed steps: per step 12 K7 and 12
    K3 forward and backward, 10 K8 partitions (5 forward, 5 as the
    unpartitions' backward) and 10 unpartitions; then phase 32, one step at
    bs8 through the kernels against one through the plain versions and an
    f32 reference, one drop-path draw for all three."""
    watched = ("head.weight", "backbone.patch_embed.weight",
               "backbone.stages.0.1.mha.relative_pe_table", "backbone.stages.2.5.mha.q_proj.weight",
               "backbone.downsample_1.reduction.weight", "backbone.stages.3.1.mlp.linear2.bias",
               "backbone.norm.weight")
    per_step = NO_LAUNCHES | dict.fromkeys(
        ("swin_attention", "swin_attention_bwd", "block_mlp", "block_mlp_bwd"), 12) | dict.fromkeys(
        ("swin_partition", "swin_unpartition"), 10)
    return train_transformer(report, "swin_train", "swin_t", SWIN_TRAIN, per_step, watched,
                             name_power, **SWIN_KW)


def repaired_head_widths(report: dict, name_power: str) -> None:
    """Phase 33: the repaired faults F3, F5 and F6 on the card. K5 forward and
    backward at REPAIRED_TALKING_HEAD_CASES (head widths 32, 96 and 160, and
    (T, S, N) = (64, 512, 16), inside the JAX rule, whose backward blocks
    hold two query rows), f32 and bf16, against their plain versions as in
    phase 13; K6 at head 256 (two 128-wide column chunks), forward and
    backward against the plain versions at FLASH_BOUND, f32 and bf16, then
    timed at WIDE_FLASH beside scaled_dot_product_attention."""
    import torch.nn.functional as F

    from vision_toolbox_tpu_torch.ops import cait_attention as ca
    from vision_toolbox_tpu_torch.ops import flash_attention as fa

    g = torch.Generator().manual_seed(33)
    checks = Checks()
    for B, T, S, H, hd in REPAIRED_TALKING_HEAD_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            a, dout = talking_head_args(g, B, T, S, H, hd, dtype)
            args = tuple(a.values())
            case = dict(kernel="talking_head", B=B, T=T, S=S, H=H, hd=hd,
                        dtype=str(dtype).split(".")[-1])
            checks.elementwise(case, "out", ca.talking_head_cuda(*args),
                               ca.talking_head_plain(*args))
            got, want = ca.talking_head_bwd_cuda(*args, dout), ca.talking_head_bwd_plain(*args, dout)
            torch.cuda.synchronize()
            for i, n in enumerate("qkv"):
                checks.elementwise(case, "d" + n, got[i], want[i])
            for n in ("ml", "mw", "mwb"):
                checks.reduced(case, f"d{n}", getattr(got[3], n), getattr(want[3], n))
            checks.reduced(case, "dmlb (vs ‖dml‖)", got[3].mlb, want[3].mlb, ref=want[3].ml)
            log(f"[repairs-f5-f6] K5 B={B} T={T} S={S} H={H:2d} hd={hd:3d} {case['dtype']:8s} "
                f"{checks.summary(case)}")
    for BN, T, H, dtype in ((4, 1024, 256, torch.bfloat16), (2, 1024, 256, torch.float32)):
        q, k, v, _, dout = flash_args(g, BN, T, T, H, dtype, False)
        case = dict(kernel="flash_attention", BN=BN, T=T, H=H, dtype=str(dtype).split(".")[-1])
        out, lse = fa.flash_attention_cuda(q, k, v)
        want_out, want_lse = fa.flash_attention_plain(q, k, v)
        got = fa.flash_attention_bwd_cuda(q, k, v, out, lse, dout)
        want = fa.flash_attention_bwd_plain(q, k, v, out, lse, dout)
        torch.cuda.synchronize()
        for n, a, b in zip(("out", "lse", "dq", "dk", "dv"), (out, lse, *got),
                           (want_out, want_lse, *want)):
            checks.elementwise(case, n, a, b, FLASH_BOUND)
        log(f"[repairs-f3] K6 BN={BN} T={T} H={H} {case['dtype']:8s} {checks.summary(case)}")
        del q, k, v, dout, out, lse, got, want, want_out, want_lse
    B, N, T, H = WIDE_FLASH
    q, k, v, _, dout = flash_args(g, B * N, T, T, H, torch.bfloat16, False)
    as_bnth = lambda t: t.view(B, N, T, H)
    leaves = [as_bnth(t).detach().requires_grad_() for t in (q, k, v)]

    def kernel_fb():
        out, lse = fa.flash_attention_cuda(q, k, v)
        fa.flash_attention_bwd_cuda(q, k, v, out, lse, dout)

    def sdpa_fb():
        torch.autograd.grad(F.scaled_dot_product_attention(*leaves), leaves, as_bnth(dout))

    times = {}
    for what, kernel, library in (
        ("forward", lambda: fa.flash_attention_cuda(q, k, v),
         lambda: F.scaled_dot_product_attention(*map(as_bnth, (q, k, v)))),
        ("forward+backward", kernel_fb, sdpa_fb),
    ):
        times[what] = dict(ms=time_ms(kernel, iters=5), library_ms=time_ms(library, iters=5))
        log(f"[repairs-f3] K6 {what:16s} B={B} N={N} T=S={T} head {H} bf16: kernel "
            f"{times[what]['ms']:.4f} ms  scaled_dot_product_attention "
            f"{times[what]['library_ms']:.4f} ms  [{name_power}]")
    fb = times["forward+backward"]["ms"] - times["forward"]["ms"]
    for name, ms in (("flash_attention_head256", times["forward"]["ms"]),
                     ("flash_attention_bwd_head256", fb)):
        log(f"[repairs-f3] {name}: {against_section6(name, ms)}")
    report["repaired_head_widths"] = dict(checks=checks.rows, k6_head256_times=times)
    bad = [r for r in checks.rows if not r["ok"]]
    if bad:
        raise AssertionError(f"{len(bad)} repaired-width comparisons out of bounds: {bad[:8]}")


def short_args(g, B: int, T: int, S: int, N: int, H: int, dtype):
    """q (B, T, N, H), k and v (B, S, N, H) in ``dtype`` and a cotangent
    like q, on the card."""
    r = lambda *s: torch.randn(s, generator=g)
    q, dout = (r(B, T, N, H).to("cuda", dtype) for _ in range(2))
    k, v = (r(B, S, N, H).to("cuda", dtype) for _ in range(2))
    return q, k, v, dout


def short_work(name: str, B: int, T: int, S: int, N: int, H: int,
               x_bytes: int) -> tuple[float, float]:
    """(product operations, bytes) of one K2 call on (B, T, N, H) operands:
    the forward's q·kᵀ and p·v per pair; the backward's five products (the
    recomputed logits, g·vᵀ, dv, dq, dk). Bytes: q, k, v (and g) in, out
    (dq, dk, dv) out."""
    pairs = B * N
    if name == "short_attention":
        return 4 * pairs * T * S * H, (2 * T + 2 * S) * pairs * H * x_bytes
    return 10 * pairs * T * S * H, (3 * T + 4 * S) * pairs * H * x_bytes


def compare_short(report: dict) -> dict[str, float]:
    """Phase 34: K2 forward and backward vs their plain versions at
    SHORT_CASES, f32 and bf16: out, dq, dk, dv by max abs error against
    BOUND·max|plain| and the gradients also by rel L2 ≤ BWD_REL_L2, and a
    second backward bit-equal to the first (no atomics). The flat case runs
    through the ``short_attention`` entry and autograd, which must launch
    each kernel once a call. At SHORT_CONTROL_CASES in bf16, the second-plane
    control: the kernels' rel L2 from the plain versions at most
    SECOND_PLANE of ``dense_attention``'s (out: p rounded to bf16 once) and
    ``short_attention_bwd_one_plane``'s (dq, dk, dv: p and ds rounded once),
    which a kernel that drops p's or ds's second plane fails though the bf16
    bound admits it. Returns the forward's and the backward's (worst of dq,
    dk, dv) max abs error at vit_b_16 bs128, bf16."""
    from vision_toolbox_tpu_torch.ops import _cuda
    from vision_toolbox_tpu_torch.ops import short_attention as sa

    g = torch.Generator().manual_seed(34)
    checks, main_err, control = Checks(), {}, []
    for B, T, S, N, H, entry in SHORT_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, dout = short_args(g, B, T, S, N, H, dtype)
            case = dict(kernel="short_attention", B=B, T=T, S=S, N=N, H=H, entry=entry,
                        dtype=str(dtype).split(".")[-1])
            if entry == "flat":
                leaves = [t.detach().requires_grad_() for t in (q, k, v)]
                before = dict(_cuda.LAUNCHES)
                out = sa.short_attention(*leaves)
                got = torch.autograd.grad(out, leaves, dout)
                again = torch.autograd.grad(sa.short_attention(*leaves), leaves, dout)
                torch.cuda.synchronize()
                runs = tuple(_cuda.LAUNCHES[n] - before[n]
                             for n in ("short_attention", "short_attention_bwd"))
                if runs != (2, 2):
                    raise AssertionError(f"the short_attention entry launched {runs} at {case}")
            else:
                out = sa.short_attention_cuda(q, k, v)
                got = sa.short_attention_bwd_cuda(q, k, v, dout)
                again = sa.short_attention_bwd_cuda(q, k, v, dout)
            want_out = sa.short_attention_plain(q, k, v)
            want = sa.short_attention_bwd_plain(q, k, v, dout)
            torch.cuda.synchronize()
            err = checks.elementwise(case, "out", out, want_out)
            errs = [checks.elementwise(case, n, a, b) for n, a, b in zip(("dq", "dk", "dv"), got,
                                                                         want)]
            for n, a, b in zip(("dq", "dk", "dv"), got, want):
                checks.reduced(case, f"{n} (rel L2)", a, b)
            for n, a, b in zip(("dq", "dk", "dv"), got, again):
                checks.exact(case, f"{n} twice", a, b)
            log(f"[short] B={B:3d} T={T} S={S} N={N:2d} H={H:3d} {entry:6s} {case['dtype']:8s} "
                f"{checks.summary(case)}")
            if (B, T, N, dtype) == (SHORT_TIME_BATCH, 197, 12, torch.bfloat16):
                main_err["short_attention"], main_err["short_attention_bwd"] = err, max(errs)
            if (B, T, S, N, H) in SHORT_CONTROL_CASES and dtype == torch.bfloat16:
                ctrl = (sa.dense_attention(q, k, v), *sa.short_attention_bwd_one_plane(q, k, v,
                                                                                     dout))
                row = dict(B=B, T=T, S=S, N=N, H=H, **{
                    n: dict(kernel=rel_l2(a, b), control=rel_l2(c, b))
                    for n, a, b, c in zip(("out", "dq", "dk", "dv"), (out, *got),
                                          (want_out, *want), ctrl)})
                row["ok"] = all(row[n]["kernel"] <= SECOND_PLANE * row[n]["control"]
                                for n in ("out", "dq", "dk", "dv"))
                control.append(row)
                log(f"[short] second-plane control B={B} N={N} H={H} bf16, rel L2 from the "
                    f"plain versions, kernel / control: " + ", ".join(
                        f"{n} {row[n]['kernel']:.2e} / {row[n]['control']:.2e}"
                        for n in ("out", "dq", "dk", "dv"))
                    + f" (kernel ≤ {SECOND_PLANE} × control) {'ok' if row['ok'] else 'FAIL'}")
                del ctrl
            del q, k, v, dout, out, got, again, want, want_out
        torch.cuda.empty_cache()
    report["compare_short"] = checks.rows
    report["short_second_plane_control"] = control
    bad = [r for r in checks.rows if not r["ok"]]
    if bad:
        raise AssertionError(f"{len(bad)} K2 comparisons out of bounds: {bad[:8]}")
    if len(control) != len(SHORT_CONTROL_CASES) or not all(r["ok"] for r in control):
        raise AssertionError(f"K2 fails its second-plane control: {control}")
    return main_err


def k2_ptxas(build_log: str) -> list[dict]:
    """ptxas's registers and spill bytes of each K2 kernel in the build log."""
    rows, entry = [], None
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = re.search(r"(short_(?:fwd|bwd_rows|bwd_keys)_kernel)I(13__nv_bfloat16|f)Li(\d+)E",
                          m.group(1))
            entry = None if k is None else dict(
                kernel=k.group(1), dtype="float32" if k.group(2) == "f" else "bfloat16",
                head_class=int(k.group(3)))
            if entry:
                rows.append(entry)
        elif entry and "registers" in line:
            entry["registers"] = int(re.search(r"Used (\d+) registers", line).group(1))
        elif entry and "spill" in line:
            entry["spill_bytes"] = sum(map(int, re.findall(r"(\d+) bytes spill", line)))
    return rows


def time_short(report: dict, name_power: str) -> dict[str, tuple[float, float, float]]:
    """Phase 35: at vit_b_16's shapes, batch SHORT_TIME_BATCH, bf16 (1536
    pairs, T = S = 197, head 64): K2 forward and backward against their plain
    versions, in turns, and torch's scaled_dot_product_attention on the same
    memory seen as (B, N, T, H) (the library yardstick; the port never calls
    it; its backward is forward + backward less the forward), beside the
    earlier wmma design's times (K2_EARLIER_MS). K2's backward recomputes p
    from q, k, v, so it is timed alone. Also the K2 kernels' registers and
    spills (ptxas), 0 bytes at bf16 head 64 or the phase fails. Returns
    (kernel, plain, library) ms."""
    import torch.nn.functional as F

    from vision_toolbox_tpu_torch.ops import short_attention as sa

    g = torch.Generator().manual_seed(35)
    B, N, T, H = SHORT_TIME_BATCH, VIT_B["H"], 197, VIT_B["D"] // VIT_B["H"]
    q, k, v, dout = short_args(g, B, T, T, N, H, torch.bfloat16)
    heads = lambda t: t.transpose(1, 2)  # (B, N, T, H), a view of the same memory
    leaves = [heads(t).detach().requires_grad_() for t in (q, k, v)]

    def sdpa_fb():
        torch.autograd.grad(F.scaled_dot_product_attention(*leaves), leaves, heads(dout))

    rows = {}
    for name, plain, kernel, library in (
        ("short_attention", lambda: sa.short_attention_plain(q, k, v),
         lambda: sa.short_attention_cuda(q, k, v),
         lambda: F.scaled_dot_product_attention(*map(heads, (q, k, v)))),
        ("short_attention_bwd", lambda: sa.short_attention_bwd_plain(q, k, v, dout),
         lambda: sa.short_attention_bwd_cuda(q, k, v, dout), sdpa_fb),
    ):
        plain_ms, ms = alternate(plain, kernel, iters=10)
        rows[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=time_ms(library, iters=10))
    rows["short_attention_bwd"]["library_ms"] -= rows["short_attention"]["library_ms"]
    for name, r in rows.items():
        r["bound_ms"], r["bound_by"] = bound(*short_work(name, B, T, T, N, H, 2))
        log(f"[short-time] {name:19s} B={B} N={N} T=S={T} H={H} bf16: kernel {r['ms']:.4f} ms  "
            f"plain {r['plain_ms']:.4f} ms  scaled_dot_product_attention "
            f"{r['library_ms']:.4f} ms  bound {r['bound_ms']:.4f} ms ({r['bound_by']})  "
            f"[{name_power}]; earlier wmma design (PERF.md §6) {K2_EARLIER_MS[name]:.4f} ms, "
            f"this / earlier = {r['ms'] / K2_EARLIER_MS[name]:.3f}")
    regs = k2_ptxas(report["build_log"])
    for r in regs:
        log(f"[short-time] ptxas {r['kernel']}<{r['dtype']}, head ≤ {r['head_class']}>: "
            f"{r.get('registers')} registers, {r.get('spill_bytes')} bytes of spills")
    report["short_times"] = dict(rows, ptxas=regs)
    main = [r for r in regs if (r["dtype"], r["head_class"]) == ("bfloat16", 64)]
    if len(main) != 3 or any(r.get("spill_bytes") != 0 for r in main):
        raise AssertionError(f"K2 kernels at bf16 head 64 spill or were not found: {main}")
    return {n: (r["ms"], r["plain_ms"], r["library_ms"]) for n, r in rows.items()}


def serve_vit_dropout(report: dict, name_power: str) -> int:
    """Phase 36: vit_b_16 built with dropout 0.1 served (``serve_backbone``):
    the fused kernels refuse dropout, so both halves of every block take the
    module chain and its attention K2: 12 K2 forward launches per forward at
    batch 8 and 32 (96 and 384 pairs) and none at batch 1 (12 pairs: the
    JAX package's XLA attention), 12 ``vtt::short_attention`` calls in the
    program. Returns K2's launches in the served requests."""
    return serve_backbone(report, "vit_dropout_serve", "vit_b_16", {"short_attention": 12},
                          {"short_attention": 12}, SERVE_BATCHES, name_power,
                          model_kw=VIT_DROPOUT, per_batch={1: {}})["short_attention"]


def train_vit_unfused(report: dict, name_power: str) -> dict[str, int]:
    """Phase 37: the vit_b_16 step at bs128@224 on the unfused block chain
    (``force_unfused``, the chain the JAX package runs under token sharding;
    the projections and MLPs stay ``torch.matmul``), ViT's recipe, 3
    warm-up + 10 timed steps, each of the 12 blocks through K2 forward and
    backward; then one step at bs8 through the kernels against one through
    the plain versions and an f32 reference, all on the unfused chain."""
    watched = ("head.weight", "backbone.pe", "backbone.blocks.0.mha.q_proj.weight",
               "backbone.blocks.5.mlp_norm.weight", "backbone.blocks.11.mlp.linear2.bias")
    per_step = NO_LAUNCHES | dict.fromkeys(("short_attention", "short_attention_bwd"), 12)
    launches = train_transformer(report, "vit_unfused_train", "vit_b_16", VIT_UNFUSED_TRAIN,
                                 per_step, watched, name_power, forward_kw=UNFUSED)
    n = VIT_UNFUSED_TRAIN["warmup"] + VIT_UNFUSED_TRAIN["steps"]
    log(f"[vit-unfused-train] K2 launches per step: {launches['short_attention'] / n:g} forward "
        f"+ {launches['short_attention_bwd'] / n:g} backward (12 + 12 expected)")
    return launches


def time_chains(report: dict, name_power: str) -> None:
    """Phase 38: the K3/K4 half-blocks through the port's module chain, the
    path a block takes where the fused gates refuse it (cuBLAS products on
    bf16 operands, the LayerNorm module, exact GELU; attention through MHA,
    whose K2 runs at 64 pairs or more), at PERF.md §6's K3/K4 shapes
    (CHAIN_CASES), bf16: the forward, and the backward to x (forward +
    backward less the forward; the weight gradients, which the fused kernels
    leave to torch.matmul, are not asked for). It is the yardstick of a K3/K4
    redesign: "chain ms", several calls, not one library call. Beside each,
    the fused kernels on the same shapes (the save forward at batch-128
    transformer shapes, else the inference one; the backward from its
    saves), their bound and their first design's times (K3K4_EARLIER_MS)."""
    from vision_toolbox_tpu_torch.models.convnext import ConvNeXtBlock
    from vision_toolbox_tpu_torch.nn.attention import ViTBlock
    from vision_toolbox_tpu_torch.nn.layers import _gelu_exact

    g = torch.Generator().manual_seed(38)
    vit = ViTBlock(VIT_B["D"], VIT_B["H"], dtype=torch.bfloat16, generator=g).cuda()
    cnx = ConvNeXtBlock(96, dtype=torch.bfloat16, generator=g).cuda()
    halves = {
        "block_mlp": lambda x, res: res + vit.mlp(vit.mlp_norm(x)),
        "block_attention": lambda x, res: res + vit.mha(vit.mha_norm(x)),
        "block_mlp_convnext": lambda x, res: res + cnx.layer_scale(
            cnx.pwconv2(_gelu_exact(cnx.pwconv1(cnx.norm(x))))),
    }
    rows = []
    for name, B, T, D in CHAIN_CASES:
        x, res, dout = (torch.randn(B, T, D, generator=g).to("cuda", torch.bfloat16)
                        for _ in range(3))
        if name != "block_mlp_convnext":
            res = x  # the transformer block's residual is its input
        leaf = x.detach().requires_grad_()

        def forward():
            with torch.no_grad():
                halves[name](x, res)

        def forward_backward():
            torch.autograd.grad(halves[name](leaf, leaf if res is x else res), leaf, dout)

        f_ms = time_ms(forward, iters=10)
        fb_ms = time_ms(forward_backward, iters=10)
        kernel_fwd, kernel_bwd, (flops, nbytes) = fused_half_calls(name, B, T, D, dout)
        k_ms, kb_ms = time_ms(kernel_fwd, iters=10), time_ms(kernel_bwd, iters=10)
        bound_ms, bound_by = bound(flops, nbytes)
        first_f, first_b = K3K4_EARLIER_MS[(name, B)]
        rows.append(dict(half=name, B=B, T=T, D=D, chain_ms=f_ms, chain_bwd_ms=fb_ms - f_ms,
                         kernel_ms=k_ms, kernel_bwd_ms=kb_ms, bound_ms=bound_ms,
                         bound_by=bound_by, first_design_ms=first_f, first_design_bwd_ms=first_b))
        first_b_text = "" if first_b is None else f", first design {first_b:.4f}"
        log(f"[chain-time] {name:18s} B={B:3d} T={T} D={D} bf16: forward chain {f_ms:.4f} ms, "
            f"kernels {k_ms:.4f} (first design {first_f:.4f}, bound {bound_ms:.4f} {bound_by}); "
            f"backward to x chain {fb_ms - f_ms:.4f} ms, kernels {kb_ms:.4f}{first_b_text}  "
            f"[{name_power}]")
        del x, res, dout, leaf
    report["chain_times"] = rows


def fused_half_calls(name: str, B: int, T: int, D: int, dout: torch.Tensor):
    """(forward, backward, (operations, bytes) of the forward) of the fused
    kernels on seeded operands of one CHAIN_CASES shape: the save forward at
    batch-128 transformer shapes, else the inference one; the backward from
    the save forward's saves."""
    from vision_toolbox_tpu_torch.ops import block_attention as ba
    from vision_toolbox_tpu_torch.ops import block_mlp as bm

    g = torch.Generator().manual_seed(B * T)
    convnext = name == "block_mlp_convnext"
    if name == "block_attention":
        a = attn_args(g, B, T, D, VIT_B["H"], torch.bfloat16, False)
        wb = [a[k] for n in "qkvo" for k in (f"w{n}", f"b{n}")]
        fwd = (a["x"], a["ln_scale"], a["ln_bias"], *wb, a["n_heads"])
        _, saves = ba.fused_attention_save_cuda(*fwd)
        ws = (a["wq"], a["wk"], a["wv"], a["wo"])
        serve = lambda: ba.fused_attention_block(*fwd)
        save = lambda: ba.fused_attention_save_cuda(*fwd)
        bwd = lambda: ba.fused_attention_bwd_cuda(dout, saves, *ws, a["ln_scale"], None, None,
                                                  a["n_heads"])
        work = block_work("block_attention", B, T, 2)
    else:
        Dh = 4 * D
        a = mlp_args(g, B, T, D, Dh, torch.bfloat16, convnext, convnext)
        ops = [a[k] for k in ("ln_scale", "ln_bias", "w1", "b1", "w2", "b2")]
        fwd = (a["x"], *ops, a["ls_gamma"], a["dp_scale"], a["residual"])
        _, saves = bm.fused_mlp_save_cuda(*fwd)
        serve = lambda: bm.fused_mlp_block(*fwd[:9], residual=fwd[9])
        save = lambda: bm.fused_mlp_save_cuda(*fwd)
        bwd = lambda: bm.fused_mlp_bwd_cuda(dout, saves, a["w1"], a["w2"], a["ln_scale"],
                                            a["ls_gamma"], a["dp_scale"], convnext)
        M = B * T
        work = ((4 * M * D * Dh, 3 * M * D * 2 + 4 * D * Dh) if convnext
                else block_work("block_mlp", B, T, 2))
    return (save if B == 128 and not convnext else serve), bwd, work


def core_ptxas(build_log: str) -> list[dict]:
    """ptxas's registers and spill bytes of each K4 attention-core kernel."""
    rows, entry = [], None
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = re.search(r"(attn_kernel|attn_bwd_rows_kernel|attn_bwd_keys_kernel)I(.*?)E(?:E|v)",
                          m.group(1))
            entry = None if k is None else dict(kernel=k.group(1), template=k.group(2))
            if entry:
                rows.append(entry)
        elif entry and "registers" in line:
            entry["registers"] = int(re.search(r"Used (\d+) registers", line).group(1))
        elif entry and "spill" in line:
            entry["spill_bytes"] = sum(map(int, re.findall(r"(\d+) bytes spill", line)))
    return rows


def core_parts(fn, calls: int = 5) -> dict[str, float]:
    """Device ms a call of K4's attention-core launches among those ``fn``
    makes (torch.profiler): "forward", "rows", "keys"."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    parts = dict.fromkeys(("forward", "rows", "keys"), 0.0)
    names = {"attn_kernel": "forward", "attn_bwd_rows_kernel": "rows",
             "attn_bwd_keys_kernel": "keys"}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        m = re.search(r"(attn_kernel|attn_bwd_rows_kernel|attn_bwd_keys_kernel)\b", e.name)
        if m:
            parts[names[m.group(1)]] += e.time_range.elapsed_us() / 1e3 / calls
    return parts


def hold_attention_core(report: dict, name_power: str, build_log: str) -> dict[str, float]:
    """Phase 39: K4's attention core (register tiles since slice 15). At
    K4_CORE_CASES (γ_ls and drop path) and vit_b_16 b128, bf16: the saved p
    against the plain version's, out and the backward's dx, dq, dk, dv
    against the plain versions, and a second backward bit-equal to the
    first. At vit_b_16 b128, on the operands K4_FIRST_CORE_REL_L2 was
    measured on: the bf16 rel L2 to the plain versions of out, p, dx, dq,
    dk and dv within twice the first design's; each core launch timed apart by
    torch.profiler (the served and the save forward's core, the backward's
    rows and keys passes) beside the first design's (K4_FIRST_CORE_MS),
    phase 38's chain and the core's bound (bytes: q, k, v in and o out, the
    save forward also p; the backward do, q, k, v, p in and dq, dk, dv
    out); the core kernels' registers and spills (ptxas). Returns the core's
    device ms at vit_b_16 b128 by part."""
    from vision_toolbox_tpu_torch.ops import block_attention as ba

    g = torch.Generator().manual_seed(39)
    checks = Checks()
    regs = core_ptxas(build_log)
    report["core_ptxas"] = regs
    for r in regs:
        log(f"[core] {r['kernel']}<{r['template']}>: {r.get('registers')} registers, "
            f"{r.get('spill_bytes', 0)} bytes of spills")
    if not regs:
        raise AssertionError("no K4 attention-core kernel in the build log")
    main = (VIT_TRAIN["batch"], 197, VIT_B["D"], VIT_B["H"])
    if not ba.use_fused_attention(K4_HEAD128[2], K4_HEAD128[3], K4_HEAD128[1], 0.0, True):
        raise AssertionError(f"the gate refuses head 128 at {K4_HEAD128}")
    for B, T, D, H in K4_CORE_CASES + (main, K4_HEAD128):
        case = dict(kernel="block_attention core", B=B, T=T, D=D, H=H)
        if (B, T, D, H) == main:  # K4_FIRST_CORE_REL_L2's operands (ab_block_kernels.py --core)
            g_main = torch.Generator().manual_seed(13)
            a = attn_args(g_main, B, T, D, H, torch.bfloat16, False)
            dout = torch.randn(a["x"].shape, generator=g_main).to("cuda", torch.bfloat16)
        else:
            a = attn_args(g, B, T, D, H, torch.bfloat16, True)
            dout = torch.randn(a["x"].shape, generator=g).to("cuda", torch.bfloat16)
        wb = [a[k] for n in "qkvo" for k in (f"w{n}", f"b{n}")]
        fwd = (a["x"], a["ln_scale"], a["ln_bias"], *wb, H, a["ls_gamma"], a["dp_scale"])
        want_out, want_saves = ba.fused_attention_save_plain(*fwd)
        out, saves = ba.fused_attention_save_cuda(*fwd)
        bwd = (dout, saves, a["wq"], a["wk"], a["wv"], a["wo"], a["ln_scale"], a["ls_gamma"],
               a["dp_scale"], H)
        got, want = ba.fused_attention_bwd_cuda(*bwd), ba.fused_attention_bwd_plain(*bwd)
        torch.cuda.synchronize()
        checks.elementwise(case, "out", out, want_out)
        checks.elementwise(case, "p", saves.p, want_saves.p)
        for n in ("dx", "dq", "dk", "dv"):
            checks.elementwise(case, n, getattr(got, n).contiguous(), getattr(want, n))
        again = ba.fused_attention_bwd_cuda(*bwd)
        torch.cuda.synchronize()
        for n in ("dx", "dq", "dk", "dv", "dbq", "dbk", "dbv"):
            checks.exact(case, f"{n} again", getattr(again, n), getattr(got, n))
        if (B, T, D, H) in (main, K4_HEAD128):
            pairs = dict(out=(out, want_out), p=(saves.p, want_saves.p))
            pairs |= {n: (getattr(got, n), getattr(want, n)) for n in ("dx", "dq", "dk", "dv")}
            for n, (x, y) in pairs.items():
                l2, bound_ = rel_l2(x, y), 2 * K4_FIRST_CORE_REL_L2[n]
                checks.rows.append(dict(**case, tensor=f"{n} rel L2", rel_l2=l2, bound=bound_,
                                        ok=l2 <= bound_))
            log(f"[core] B={B} bf16 rel L2 to plain: " + ", ".join(
                f"{r['tensor']} {r['rel_l2']:.3e} (≤ {r['bound']:.3e}; first design "
                f"{K4_FIRST_CORE_REL_L2[r['tensor'].split()[0]]:.3e})" for r in checks.rows[-6:]))
        log(f"[core] B={B} T={T} D={D} H={H} bf16: {checks.summary(case)}")
        del a, want_out, want_saves, out, saves, dout, got, want, again

    B, T, D, H = VIT_TRAIN["batch"], 197, VIT_B["D"], VIT_B["H"]
    a = attn_args(g, B, T, D, H, torch.bfloat16, False)
    wb = [a[k] for n in "qkvo" for k in (f"w{n}", f"b{n}")]
    fwd = (a["x"], a["ln_scale"], a["ln_bias"], *wb, H)
    _, saves = ba.fused_attention_save_cuda(*fwd)
    dout = torch.randn(a["x"].shape, generator=g).to("cuda", torch.bfloat16)
    parts = {"forward": core_parts(lambda: ba.fused_attention_block_cuda(*fwd, None, None,
                                                                         1e-6))["forward"],
             "save_forward": core_parts(lambda: ba.fused_attention_save_cuda(*fwd))["forward"]}
    parts |= {k: v for k, v in core_parts(lambda: ba.fused_attention_bwd_cuda(
        dout, saves, a["wq"], a["wk"], a["wv"], a["wo"], a["ln_scale"], None, None, H)).items()
        if k != "forward"}
    qkv, p_bytes = B * T * D * 2, B * H * T * T * 2
    bounds = {"forward": 4 * qkv, "save_forward": 4 * qkv + p_bytes,
              "backward": 7 * qkv + p_bytes}
    bounds = {k: v / PEAK_BYTES_PER_S * 1e3 for k, v in bounds.items()}
    chain = {r["half"]: r for r in report.get("chain_times", []) if r["B"] == B}
    chain_row = chain.get("block_attention", {})
    for k in ("forward", "save_forward", "rows", "keys"):
        log(f"[core-time] {k:12s} vit_b_16 b{B} bf16: {parts[k]:.4f} ms (first design "
            f"{K4_FIRST_CORE_MS[k]:.4f}, this / first = {parts[k] / K4_FIRST_CORE_MS[k]:.3f})  "
            f"[{name_power}]")
    bwd_ms = parts["rows"] + parts["keys"]
    log(f"[core-time] bounds (bytes) forward {bounds['forward']:.4f} / save "
        f"{bounds['save_forward']:.4f} / backward {bounds['backward']:.4f} ms; backward core "
        f"{bwd_ms:.4f} ms (first design {K4_FIRST_CORE_MS['rows'] + K4_FIRST_CORE_MS['keys']:.4f});"
        f" phase 38's chain: forward {chain_row.get('chain_ms', float('nan')):.4f} / backward "
        f"{chain_row.get('chain_bwd_ms', float('nan')):.4f} ms, K4 "
        f"{chain_row.get('kernel_ms', float('nan')):.4f} / "
        f"{chain_row.get('kernel_bwd_ms', float('nan')):.4f}  [{name_power}]")
    B, T, D, H = K4_HEAD128
    a = attn_args(g, B, T, D, H, torch.bfloat16, False)
    wb = [a[k] for n in "qkvo" for k in (f"w{n}", f"b{n}")]
    fwd = (a["x"], a["ln_scale"], a["ln_bias"], *wb, H)
    _, saves = ba.fused_attention_save_cuda(*fwd)
    dout = torch.randn(a["x"].shape, generator=g).to("cuda", torch.bfloat16)
    wide = {"forward": core_parts(lambda: ba.fused_attention_block_cuda(*fwd, None, None,
                                                                        1e-6))["forward"],
            "save_forward": core_parts(lambda: ba.fused_attention_save_cuda(*fwd))["forward"]}
    wide |= {k: v for k, v in core_parts(lambda: ba.fused_attention_bwd_cuda(
        dout, saves, a["wq"], a["wk"], a["wv"], a["wo"], a["ln_scale"], None, None, H)).items()
        if k != "forward"}
    qkv, p_bytes = B * T * D * 2, B * H * T * T * 2
    wide_bounds = {k: v / PEAK_BYTES_PER_S * 1e3 for k, v in
                   {"forward": 4 * qkv, "save_forward": 4 * qkv + p_bytes,
                    "backward": 7 * qkv + p_bytes}.items()}
    log(f"[core-time] head 128 T={T} b{B} bf16: forward {wide['forward']:.4f} / save "
        f"{wide['save_forward']:.4f} / rows {wide['rows']:.4f} / keys {wide['keys']:.4f} ms; "
        f"bounds (bytes) {wide_bounds['forward']:.4f} / {wide_bounds['save_forward']:.4f} / "
        f"backward {wide_bounds['backward']:.4f} ms  [{name_power}]")
    report["attention_core"] = dict(ms=parts, first_design_ms=K4_FIRST_CORE_MS,
                                    bound_ms=bounds, head128_ms=wide, head128_bound_ms=wide_bounds,
                                    checks=checks.rows)
    bad = [r for r in checks.rows if not r["ok"]]
    if bad:
        raise AssertionError(f"{len(bad)} K4 core comparisons out of bounds: {bad[:8]}")
    return parts


def hold_mixer_s8(report: dict) -> None:
    """Phase 40, second part: one seeded bf16 mixer_s_8 forward at batch 8
    (N = 784 tokens, the gate's largest Mixer T): 8 K3 launches and nothing
    else, logits against the plain path (rel L2 ≤ REL_L2_BOUND or twice the
    plain bf16 path's own distance from an f32 forward)."""
    import vision_toolbox_tpu_torch as vtt
    from vision_toolbox_tpu_torch.ops import _cuda

    cfg = MIXER_S8
    model = vtt.create_backbone(cfg["name"], dtype=torch.bfloat16,
                                generator=torch.Generator().manual_seed(0))
    ref = vtt.create_backbone(cfg["name"])  # f32 compute, the same weights
    ref.load_state_dict(model.state_dict())
    images = torch.rand(cfg["batch"], 224, 224, 3,
                        generator=torch.Generator().manual_seed(1)).cuda()
    with torch.inference_mode():
        _cuda.reset_launch_counts()
        logits = model(images)
        torch.cuda.synchronize()
        counts = dict(_cuda.LAUNCHES)
        plain = model(images, plain=True)
        f32 = ref(images, force_unfused=True, plain=True)
    err, own = rel_l2(logits, plain), rel_l2(plain, f32)
    bound_l2 = max(REL_L2_BOUND, 2 * own)
    report["mixer_s8"] = dict(launches=counts, rel_l2_vs_plain=err, plain_vs_f32=own)
    log(f"[mixer-s8] {cfg['name']} bf16 bs{cfg['batch']} forward (T = 784): launches {counts}; "
        f"logits kernel vs plain path rel L2 {err:.3e} (bound {bound_l2:.3e}; plain vs f32 "
        f"{own:.3e})")
    if counts != NO_LAUNCHES | {"block_mlp": cfg["blocks"]}:
        raise AssertionError(f"mixer_s_8: expected {cfg['blocks']} K3 launches, got {counts}")
    if not torch.isfinite(logits.float()).all() or not err <= bound_l2:
        raise AssertionError(f"mixer_s_8 logits disagree with the plain path: {err}")


def time_mixer_mlp(report: dict, name_power: str) -> None:
    """Phase 40, last part: K3's inference forward, save forward and
    backward at mixer_s_8's channel half (MIXER_S8_MLP: T = 784, 512 /
    2048, batch 128, bf16, no γ, drop-path or separate residual), in turns
    with their plain versions, each beside its bound; the timed operands
    held against the plain versions (Checks' bounds) and a second backward
    bit-equal to the first."""
    from vision_toolbox_tpu_torch.ops import block_mlp as bm

    g = torch.Generator().manual_seed(40)
    B, T, D, Dh = MIXER_S8_MLP
    widths = dict(D=D, Dh=Dh)
    m = mlp_args(g, B, T, D, Dh, torch.bfloat16, False, False)
    ops = [m[k] for k in ("ln_scale", "ln_bias", "w1", "b1", "w2", "b2")]
    fwd = (m["x"], *ops, None, None, None)
    out, saves = bm.fused_mlp_save_cuda(*fwd)
    dout = torch.randn(m["x"].shape, generator=g).to("cuda", torch.bfloat16)
    bwd = (dout, saves, m["w1"], m["w2"], m["ln_scale"], None, None, False)
    checks, case = Checks(), dict(kernel="block_mlp", B=B, T=T, D=D, Dh=Dh)
    checks.elementwise(case, "out", bm.fused_mlp_block(**m), bm.fused_mlp_block_plain(**m))
    got, want = bm.fused_mlp_bwd_cuda(*bwd), bm.fused_mlp_bwd_plain(*bwd)
    checks.elementwise(case, "dx", got.dx, want.dx)
    for name in ("db1", "db2", "dln_scale", "dln_bias"):
        checks.reduced(case, name, getattr(got, name), getattr(want, name))
    log(f"[mixer-mlp] held mixer_s_8's channel half bs{B} bf16: {checks.summary(case)}")
    second_backward_bit_equal(report, f"block_mlp_bwd mixer_s_8 b{B}",
                              lambda: bm.fused_mlp_bwd_cuda(*bwd))
    rows = {}
    for name, work, plain, kernel in (
        ("block_mlp", "block_mlp", lambda: bm.fused_mlp_block_plain(**m),
         lambda: bm.fused_mlp_block(**m)),
        ("block_mlp save", "block_mlp", lambda: bm.fused_mlp_save_plain(*fwd),
         lambda: bm.fused_mlp_save_cuda(*fwd)),
        ("block_mlp_bwd", "block_mlp_bwd", lambda: bm.fused_mlp_bwd_plain(*bwd),
         lambda: bm.fused_mlp_bwd_cuda(*bwd)),
    ):
        plain_ms, ms = alternate(plain, kernel, iters=5)
        bound_ms, bound_by = bound(*block_work(work, B, T, 2, widths=widths))
        rows[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)
        log(f"[mixer-mlp] {name:14s} mixer_s_8 bs{B} (M={B * T}, D={D}, Dh={Dh}) bf16: kernel "
            f"{ms:.4f} ms  plain {plain_ms:.4f} ms  bound {bound_ms:.4f} ms ({bound_by}), "
            f"{4 * B * T * D * Dh / ms / 1e9:.0f} TFLOP/s  [{name_power}]")
    report["mixer_mlp_times"] = dict(rows=rows, held=checks.rows)
    if not all(r["ok"] for r in checks.rows):
        raise AssertionError(f"K3 at mixer_s_8's shape out of bounds: {checks.rows}")


def mixer(report: dict, name_power: str) -> dict[str, int]:
    """Phase 40 (cell (o)): mixer_b_16 served (``serve_backbone``: 12 K3
    forward launches a forward, 12 ``vtt::fused_mlp_block`` calls in the
    program, batches SERVE_BATCHES), its bs128@224 step with ViT's recipe
    (3 warm-up + 10 timed steps, 12 + 12 K3 a step) and one step at bs8
    through the kernels against the plain versions and an f32 reference;
    then mixer_s_8 at T = 784 held (``hold_mixer_s8``) and K3 timed at its
    channel half (``time_mixer_mlp``). Returns the step's launches."""
    serve_backbone(report, "mixer_serve", "mixer_b_16", {"block_mlp": 12},
                   {"fused_mlp_block": 12}, SERVE_BATCHES, name_power)
    watched = ("head.weight", "backbone.patch_embed.weight",
               "backbone.blocks.0.token_mixing.linear1.weight", "backbone.blocks.5.norm2.weight",
               "backbone.blocks.11.channel_mixing.linear2.bias", "backbone.norm.bias")
    per_step = NO_LAUNCHES | dict.fromkeys(("block_mlp", "block_mlp_bwd"), 12)
    launches = train_transformer(report, "mixer_train", "mixer_b_16", MIXER_TRAIN, per_step,
                                 watched, name_power)
    hold_mixer_s8(report)
    with torch.no_grad():
        time_mixer_mlp(report, name_power)
    return launches


def patchconvnet(report: dict, name_power: str) -> dict[str, int]:
    """Phase 41 (cell (p)): K9 at k = 3 on patchconvnet_s's trunk at batch
    128 (PATCHCONV_DEPTHWISE) timed beside its plain versions, cuDNN's
    grouped conv and its bound (``time_depthwise_case``), the timed operands
    held (bf16 out and dx bit-equal, a second backward bit-equal); then
    patchconvnet_s (depth 60, LayerScale γs around 0.1) served: 60 K9
    forward launches a forward, 60 ``vtt::depthwise_conv2d`` calls in the
    program; its bs128@224 step with drop-path 0.3 (60 + 60 K9 a step) and
    one step at bs8 through the kernels against the plain versions and an
    f32 reference, one set of drop-path draws for all three. Returns the
    step's launches."""
    from vision_toolbox_tpu_torch.ops import depthwise_conv as dc

    B, H, C, k = PATCHCONV_DEPTHWISE
    with torch.no_grad():
        g = torch.Generator().manual_seed(41)
        row, (x, w, dout) = time_depthwise_case(g, B, H, C, k, name_power, tag="pcn-depthwise")
        checks = Checks()
        case = dict(kernel="depthwise_conv", B=B, H=H, W=H, C=C, k=k, dtype="bfloat16",
                    route=dc.kernel_route(x, dout))
        _, _, differ = hold_depthwise(checks, case, x, w, dout, second=True)
        log(f"[pcn-depthwise] held B={B} {H}x{H}x{C} k={k} bf16: {checks.summary(case)}; bf16 "
            f"elements differing from plain: out {differ[0]}, dx {differ[1]}")
        report["patchconvnet_depthwise"] = dict(row=row, held=checks.rows)
        if not all(r["ok"] for r in checks.rows):
            raise AssertionError(f"K9 at patchconvnet_s's trunk out of bounds: {checks.rows}")
        del x, w, dout
    blocks = {"depthwise_conv": 60}
    serve_backbone(report, "patchconvnet_serve", "patchconvnet_s", blocks,
                   {"depthwise_conv2d": 60}, SERVE_BATCHES, name_power,
                   PATCHCONV_TRAIN["layer_scale"])
    watched = ("head.weight", "backbone.stem_0.weight", "backbone.blocks.0.dwconv.weight",
               "backbone.blocks.30.layer_scale", "backbone.blocks.59.se.fc2.bias",
               "backbone.pool.cls_token", "backbone.pool.mlp.linear2.weight")
    per_step = NO_LAUNCHES | dict.fromkeys(("depthwise_conv", "depthwise_conv_bwd"), 60)
    return train_transformer(report, "patchconvnet_train", "patchconvnet_s", PATCHCONV_TRAIN,
                             per_step, watched, name_power)


def vovnet(report: dict, name_power: str) -> int:
    """Phase 42 (cell (q)): vovnet57 on configs/base.yaml's recipe at
    bs512@176 (``train_recipe``: TrivialAugment through K1 once a step,
    RandomErasing 0.1, CutMix⊕MixUp, label smoothing 0.1, SGD in three
    groups; peak memory printed), one step through K1 against its plain
    version; then vovnet57 served at 224 px (``serve_backbone``: its last
    feature map, no kernel in the model). Returns K1's launches."""
    watched = ("head.weight", "backbone.stem_0.conv.weight", "backbone.stem_2.norm.running_var",
               "backbone.stages.2.3.out_conv.norm.running_mean",
               "backbone.stages.3.2.conv_4.conv.weight")
    launches = train_recipe(report, "vovnet_train", VOVNET_TRAIN, watched, name_power)
    serve_backbone(report, "vovnet_serve", "vovnet57", {}, {}, SERVE_BATCHES, name_power)
    return launches


def efficientnet(report: dict, name_power: str) -> dict[str, int]:
    """Phase 43 (cell (r)): efficientnet_b0 served (``serve_backbone``: 12 K9
    forward launches a forward, 12 ``vtt::depthwise_conv2d`` calls in the
    program, batches SERVE_BATCHES), its bs128@224 step with the convnet
    recipe and drop-path 0.2 (3 warm-up + 10 timed steps, 12 + 12 K9 a step,
    peak memory) and one step at bs8 through the kernels against the plain
    versions and an f32 reference; then K9 at each distinct stride-1 MBConv
    shape of efficientnet_b0 at batch 128 (``time_depthwise_case``: kernel,
    plain, cuDNN's grouped conv, bound), the timed operands held (bf16 out
    and dx bit-equal, a second backward bit-equal), and the sums over the
    model's 12 calls. Returns the served requests' and the step's K9
    launches."""
    from vision_toolbox_tpu_torch.ops import depthwise_conv as dc

    served = serve_backbone(report, "efficientnet_serve", "efficientnet_b0",
                            {"depthwise_conv": 12}, {"depthwise_conv2d": 12}, SERVE_BATCHES,
                            name_power, model_kw=EFFICIENTNET_KW)
    watched = ("head.weight", "backbone.stem.conv.weight", "backbone.stages.0.0.dwconv.conv.weight",
               "backbone.stages.5.3.se.fc1.bias", "backbone.stages.6.0.project.conv.weight",
               "backbone.last_conv.norm.weight")
    per_step = NO_LAUNCHES | dict.fromkeys(("depthwise_conv", "depthwise_conv_bwd"), 12)
    launches = train_transformer(report, "efficientnet_train", "efficientnet_b0",
                                 EFFICIENTNET_TRAIN, per_step, watched, name_power,
                                 **EFFICIENTNET_KW)
    g, B, rows, sums, checks = torch.Generator().manual_seed(43), DEPTHWISE_TIME_BATCH, [], {}, \
        Checks()
    with torch.no_grad():
        for H, C, k, blocks in EFFICIENTNET_DEPTHWISE:
            row, (x, w, dout) = time_depthwise_case(g, B, H, C, k, name_power,
                                                    tag="effnet-depthwise")
            row["blocks"] = blocks
            rows.append(row)
            for what in ("forward", "backward"):
                for m in ("ms", "plain_ms", "library_ms", "bound_ms"):
                    sums[f"{what}/{m}"] = sums.get(f"{what}/{m}", 0.0) + blocks * row[what][m]
            case = dict(kernel="depthwise_conv", B=B, H=H, W=H, C=C, k=k, dtype="bfloat16",
                        route=dc.kernel_route(x, dout))
            _, _, differ = hold_depthwise(checks, case, x, w, dout, second=True)
            log(f"[effnet-depthwise] held B={B} {H}x{H}x{C} k={k} bf16: {checks.summary(case)}; "
                f"bf16 elements differing from plain: out {differ[0]}, dx {differ[1]}")
            del x, w, dout
    for what in ("forward", "backward"):
        log(f"[effnet-depthwise] {what} summed over efficientnet_b0's 12 calls at bs{B}: kernel "
            f"{sums[what + '/ms']:.3f} ms, plain {sums[what + '/plain_ms']:.3f}, cuDNN "
            f"{sums[what + '/library_ms']:.3f}, bound {sums[what + '/bound_ms']:.3f}  "
            f"[{name_power}]")
    report["efficientnet_depthwise"] = dict(shapes=rows, per_step=sums, held=checks.rows)
    if not all(r["ok"] for r in checks.rows):
        raise AssertionError(f"K9 at efficientnet_b0's shapes out of bounds: {checks.rows}")
    return {"served": served["depthwise_conv"], "step": launches["depthwise_conv_bwd"]}


def other_families(report: dict, name_power: str) -> None:
    """Phase 44 (cell (s)): mobilenet_v3_large served (11 K9 a forward, 11
    ``vtt::depthwise_conv2d`` calls); resnet50 served and its bs256@224 step
    on the convnet recipe (no kernel in the model: launches none, and one
    bf16 step against an f32 one, printed); regnet_y_1_6gf and
    resnext50_32x4d served (no kernel)."""
    serve_backbone(report, "mobilenet_serve", "mobilenet_v3_large", {"depthwise_conv": 11},
                   {"depthwise_conv2d": 11}, SERVE_BATCHES, name_power)
    serve_backbone(report, "resnet50_serve", "resnet50", {}, {}, SERVE_BATCHES, name_power)
    watched = ("head.weight", "backbone.stem.conv.weight",
               "backbone.layer1_block0.conv2.conv.weight",
               "backbone.layer4_block2.conv3.norm.bias")
    train_transformer(report, "resnet50_train", "resnet50", RESNET_TRAIN, NO_LAUNCHES, watched,
                      name_power)
    for name in ("regnet_y_1_6gf", "resnext50_32x4d"):
        serve_backbone(report, f"{name}_serve", name, {}, {}, SERVE_BATCHES, name_power)


def necks_on_card(report: dict, name_power: str) -> dict[str, int]:
    """Phase 45: BiFPN(64, 3 layers) on efficientnet_b0's five taps at
    bs8@224, bf16, train mode: 12 + 24 K9 forward launches a forward and as
    many backward, through the kernels against the plain versions and an f32
    reference (outputs and every parameter gradient rel L2 ≤ max(GRAD_REL_L2,
    2× the plain bf16 path's own distance from f32)); PAN(256) on
    darknet_yolov5s's last four maps (the README's composition), f32, eval,
    on the card against the same modules on the CPU; DeformableConv2d (v2,
    3 × 3) at stride 1 and 2, f32, forward and backward on the card against
    the CPU. Returns BiFPN's launches."""
    import vision_toolbox_tpu_torch as vtt
    from vision_toolbox_tpu_torch.models.necks import PAN, BiFPN
    from vision_toolbox_tpu_torch.nn.layers import DeformableConv2d
    from vision_toolbox_tpu_torch.ops import _cuda

    B = BIFPN["batch"]
    x = torch.rand(B, 224, 224, 3, generator=torch.Generator().manual_seed(45)).cuda()

    def build(dtype):
        gen = torch.Generator().manual_seed(0)
        backbone = vtt.create_backbone("efficientnet_b0", dtype=dtype, generator=gen)
        neck = BiFPN(backbone.out_channels_list, BIFPN["out_channels"], BIFPN["num_layers"],
                     dtype=dtype, generator=gen)
        return backbone, neck

    paths = {"kernel": build(torch.bfloat16), "plain": build(torch.bfloat16),
             "f32": build(None)}
    cts = None
    results, launches = {}, None
    for path, (backbone, neck) in paths.items():
        plain = path != "kernel"
        drop = torch.Generator(device="cuda").manual_seed(5)  # one set of drop-path draws
        _cuda.reset_launch_counts()
        outs = neck(backbone.get_feature_maps(x, train=True, plain=plain, generator=drop),
                    train=True, plain=plain)
        if cts is None:
            g = torch.Generator().manual_seed(46)
            cts = [torch.randn(o.shape, generator=g).cuda() for o in outs]
        sum((o.float() * c).sum() for o, c in zip(outs, cts)).backward()
        torch.cuda.synchronize()
        if path == "kernel":
            launches = dict(_cuda.LAUNCHES)
        grads = {f"backbone.{n}": p.grad for n, p in backbone.named_parameters()}
        grads |= {f"neck.{n}": p.grad for n, p in neck.named_parameters()}
        results[path] = ([o.detach().float() for o in outs], grads)
    expected = NO_LAUNCHES | {"depthwise_conv": 36, "depthwise_conv_bwd": 36}
    log(f"[bifpn] efficientnet_b0 + BiFPN({BIFPN['out_channels']}, {BIFPN['num_layers']} layers) "
        f"bf16 bs{B}@224, train mode, forward and backward: launches {launches}")
    if launches != expected:
        raise AssertionError(f"BiFPN on efficientnet_b0: expected {expected}, got {launches}")
    bad, rows = {}, {}
    (k_out, k_grads), (p_out, p_grads), (f_out, f_grads) = (results[p] for p in paths)
    for i, (ko, po, fo) in enumerate(zip(k_out, p_out, f_out)):
        own = rel_l2(po, fo)
        rows[f"out{i}"] = dict(kernel_vs_plain=rel_l2(ko, po), plain_vs_f32=own,
                               bound=max(REL_L2_BOUND, 2 * own))
    for n in k_grads:
        own = rel_l2(p_grads[n], f_grads[n])
        rows[n] = dict(kernel_vs_plain=rel_l2(k_grads[n], p_grads[n]), plain_vs_f32=own,
                       bound=max(GRAD_REL_L2, 2 * own))
    bad = {n: r for n, r in rows.items() if not r["kernel_vs_plain"] <= r["bound"]}
    worst = sorted(rows.items(), key=lambda kv: -kv[1]["kernel_vs_plain"] / kv[1]["bound"])[:4]
    log(f"[bifpn] kernel vs plain path: the five outputs rel L2 "
        f"{['%.2e' % rows[f'out{i}']['kernel_vs_plain'] for i in range(len(k_out))]}; "
        f"{len(rows) - len(k_out)} parameter gradients, worst against their bound "
        f"{[(n, '%.2e' % r['kernel_vs_plain'], 'bound %.2e' % r['bound']) for n, r in worst]}")
    report["bifpn"] = dict(launches=launches, rows=rows)
    if bad:
        raise AssertionError(f"BiFPN: the kernel path and the plain path disagree: {bad}")
    del paths, results

    # PAN on darknet_yolov5s's last four maps: the card against the CPU, f32
    gen = torch.Generator().manual_seed(0)
    backbone = vtt.create_backbone(PAN_NECK["backbone"], device="cpu", generator=gen).eval()
    xs = torch.rand(PAN_NECK["batch"], 224, 224, 3, generator=torch.Generator().manual_seed(47))
    with torch.no_grad():
        channels = tuple(f.shape[-1] for f in backbone.get_feature_maps(xs[:1])[-4:])
        neck = PAN(channels, PAN_NECK["out_channels"], device="cpu", generator=gen).eval()
        want = neck(backbone.get_feature_maps(xs)[-4:])
        backbone.cuda(), neck.cuda()
        got = neck(backbone.get_feature_maps(xs.cuda())[-4:])
    errs = [rel_l2(a.float().cpu(), b) for a, b in zip(got, want)]
    log(f"[pan] {PAN_NECK['backbone']} → PAN({PAN_NECK['out_channels']}) f32 bs{PAN_NECK['batch']}"
        f"@224 on the card vs the CPU: outputs {[tuple(t.shape) for t in got]}, rel L2 "
        f"{['%.2e' % e for e in errs]} (bound {CARD_VS_CPU_REL_L2})")
    report["pan"] = dict(channels=channels, rel_l2=errs)
    if len(got) != 4 or not all(e <= CARD_VS_CPU_REL_L2 for e in errs):
        raise AssertionError(f"PAN on the card disagrees with the CPU: {errs}")

    # DeformableConv2d, v2: the card against the CPU, f32, forward and backward
    rows = []
    for Bd, H, C, Co, stride in DEFORM_CASES:
        m = DeformableConv2d(C, Co, 3, stride, padding=1, generator=torch.Generator().manual_seed(1))
        with torch.no_grad():
            m.conv_offset.weight.mul_(8)  # offsets of a few pixels, some off the map
        xd = torch.randn(Bd, H, H, C, generator=torch.Generator().manual_seed(2))
        sides = []
        for device in ("cpu", "cuda"):
            md = copy.deepcopy(m).to(device)
            xi = xd.to(device).detach().requires_grad_()
            out = md(xi)
            ct = torch.randn(out.shape, generator=torch.Generator().manual_seed(3)).to(device)
            out.backward(ct)
            sides.append([out.detach().cpu(), xi.grad.cpu()] +
                         [p.grad.cpu() for p in md.parameters()])
        names = ["out", "dx"] + [n for n, _ in m.named_parameters()]
        errs = {n: rel_l2(a, b) for n, a, b in zip(names, sides[1], sides[0])}
        rows.append(dict(B=Bd, H=H, C=C, Co=Co, stride=stride, rel_l2=errs))
        log(f"[deform] v2 3x3 stride {stride} ({Bd}, {H}, {H}, {C}) → {Co}, f32, card vs CPU rel "
            f"L2: {', '.join(f'{n} {e:.2e}' for n, e in errs.items())} (bound "
            f"{CARD_VS_CPU_REL_L2})")
        if not all(e <= CARD_VS_CPU_REL_L2 for e in errs.values()):
            raise AssertionError(f"DeformableConv2d on the card disagrees with the CPU: {errs}")
    report["deform"] = rows
    return launches


# --- phases 46-48: the trainer and the data plane ---------------------------

CLI_BASE = dict(config="configs/base.yaml", steps=6, batch=512)
# the phase 47-48 corpus: raw shards written with the port's own write_shard
CORPUS = dict(train=4096, train_px=200, shards=2, val=512, val_px=224, classes=100, seed=0)
RESIDENT = dict(config="configs/synth_hard_dev.yaml", epochs=2, batch=256, crop=176)
FEED_STEPS, FEED_CHECKED, TRACED_STEPS = 16, 4, 3
RRC_BOUND = 1e-5  # max abs, [0, 1] images, f32 products with TF32 off on both sides


def union_length(spans: list[tuple[float, float]]) -> float:
    """Time (in the spans' unit) that at least one span covers."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(spans):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def trace_device(path: Path) -> dict:
    """From a chrome trace of torch.profiler: the device's busy time (the
    union of kernels, copies and sets), the window (first to last event) and
    the host-to-device bytes, µs and bytes."""
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X" and "dur" in e]
    device = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    h2d = [e for e in device if e.get("cat") == "gpu_memcpy" and "HtoD" in e.get("name", "")]
    return dict(busy_us=union_length([(e["ts"], e["ts"] + e["dur"]) for e in device]),
                window_us=max(e["ts"] + e["dur"] for e in events) - min(e["ts"] for e in events),
                kernels=sum(e.get("cat") == "kernel" for e in device),
                h2d_copies=len(h2d), h2d_bytes=sum(e.get("args", {}).get("bytes", 0) for e in h2d),
                h2d_bytes_known=all("bytes" in e.get("args", {}) for e in h2d))


def cli(*args: str, timeout: int = 900) -> subprocess.CompletedProcess:
    """The port's training CLI in a process of its own, from the checkout."""
    proc = subprocess.run([sys.executable, "-m", "vision_toolbox_tpu_torch.train", *args],
                          cwd=ROOT, capture_output=True, text=True, timeout=timeout)
    if proc.returncode != 0:
        raise AssertionError(f"CLI {args[0]} exited {proc.returncode}:\n{proc.stderr[-4000:]}")
    return proc


def cli_base_recipe(report: dict, name_power: str) -> int:
    """Phase 46 (cell (t)): ``python -m vision_toolbox_tpu_torch.train fit
    --config configs/base.yaml`` on synthetic data for 6 steps (vovnet57,
    bs512@176, bf16, the full recipe with K1), its metrics.jsonl read back:
    a finite loss and the schedule's lr at every step, the epoch's train_ips,
    peak memory and K1 launches (one a step), val/* from the synthetic val
    set at 224, a torch.profiler trace of steps 2-4 for the idle share; then
    ``validate`` on its checkpoint through the CLI, equal to the fit's val
    metrics within 1e-6. Returns K1's launches."""
    import tempfile

    from vision_toolbox_tpu_torch.train.optim import warmup_cosine_schedule

    steps, B = CLI_BASE["steps"], CLI_BASE["batch"]
    torch.cuda.empty_cache()  # the CLI's process needs its own ~28 GiB
    with tempfile.TemporaryDirectory(prefix="vtt_cli_") as tmp:
        out = Path(tmp) / "base"
        sets = ["data.synthetic=true", f"data.train_size={steps * B}", "train.epochs=1",
                "runtime.log_every=1", "runtime.profile_steps=3", f"runtime.out_dir={out}"]
        common = ["--config", CLI_BASE["config"], *[a for s in sets for a in ("--set", s)]]
        t0 = time.perf_counter()
        cli("fit", *common)
        fit_s = time.perf_counter() - t0
        records = [json.loads(line) for line in (out / "metrics.jsonl").read_text().splitlines()]
        per_step = [r for r in records if "train/loss" in r]
        epoch = records[-1]
        schedule = warmup_cosine_schedule(0.25, 1, steps, 5, 0.01, 0.0)  # base.yaml's
        lr_err = max(abs(r["lr"] - schedule(r["step"] - 1)) for r in per_step)
        losses = [r["train/loss"] for r in per_step]
        log(f"[cli_base] fit: {fit_s:.1f} s (process start, build load, {steps} steps, val, "
            f"checkpoint); losses {['%.4f' % v for v in losses]}, lr max|err| {lr_err:.1e}")
        trace = trace_device(out / "profile" / "trace.json")
        traced_ms = trace["window_us"] / 1e3 / 3
        idle = 1 - trace["busy_us"] / trace["window_us"]
        log(f"[cli_base] epoch: {epoch['epoch_time_s']:.2f} s for {steps} steps (the first "
            f"included), train_ips {epoch['train_ips']:.1f}, peak {epoch['peak_memory_gib']:.1f} "
            f"GiB, K1 launches {epoch.get('launches/warp_shear3')}; traced steps 2-4: "
            f"{traced_ms:.2f} ms a step (profiler on), idle share {idle:.3f}; val/loss "
            f"{epoch['val/loss']:.6f} val/acc {epoch['val/acc']:.4f}  [{name_power}]")
        if ([r["step"] for r in per_step] != list(range(1, steps + 1))
                or not all(map(math.isfinite, losses)) or lr_err > 1e-9):
            raise AssertionError(f"bad step records: {per_step}")
        want_keys = {"train_ips", "peak_memory_gib", "val/loss", "val/acc", "val/acc5"}
        if not want_keys <= epoch.keys() or epoch.get("launches/warp_shear3") != steps:
            raise AssertionError(f"bad epoch record (K1 once a step expected): {epoch}")
        ckpt = out / "checkpoints" / f"step_{steps}"
        if not (ckpt / "state.pt").is_file() or not (out / "best" / "state.pt").is_file():
            raise AssertionError(f"no checkpoint or best/ under {out}")
        t0 = time.perf_counter()
        proc = cli("validate", *common, "--set", f"runtime.resume={ckpt}")
        validate_s = time.perf_counter() - t0
        val = json.loads(proc.stdout.strip().splitlines()[-1])
        val_err = max(abs(val[k] - epoch[k]) for k in ("val/loss", "val/acc", "val/acc5"))
        log(f"[cli_base] validate: {validate_s:.1f} s, {val}; max|err| vs the fit's {val_err:.1e}")
        if not val_err <= 1e-6:
            raise AssertionError(f"validate disagrees with the fit: {val} vs {epoch}")
    report["cli_base"] = dict(fit_s=fit_s, validate_s=validate_s, losses=losses, epoch=epoch,
                              traced_ms_per_step=traced_ms, idle_share=idle, trace=trace,
                              lr_max_abs_err=lr_err, validate_max_abs_err=val_err)
    return epoch["launches/warp_shear3"]


def write_corpus(root: Path) -> tuple[Path, Path]:
    """CORPUS as raw shards (uint8, seeded) with the port's write_shard."""
    import numpy as np

    from vision_toolbox_tpu_torch.data.raw_shards import write_shard

    rng = np.random.default_rng(CORPUS["seed"])
    dirs = root / "train", root / "val"
    for d in dirs:
        d.mkdir(parents=True)
    per, px = CORPUS["train"] // CORPUS["shards"], CORPUS["train_px"]
    for s in range(CORPUS["shards"]):
        write_shard(str(dirs[0] / f"{s:03d}.vtraw"),
                    rng.integers(0, 256, (per, px, px, 3), dtype=np.uint8),
                    rng.integers(0, CORPUS["classes"], per))
    n, px = CORPUS["val"], CORPUS["val_px"]
    write_shard(str(dirs[1] / "000.vtraw"), rng.integers(0, 256, (n, px, px, 3), dtype=np.uint8),
                rng.integers(0, CORPUS["classes"], n))
    return dirs


def corpus_trainer(dirs: tuple[Path, Path], out: Path, *extra: str):
    """A Trainer on configs/synth_hard_dev.yaml over the corpus."""
    from vision_toolbox_tpu_torch.train.config import load_config
    from vision_toolbox_tpu_torch.train.trainer import Trainer

    sets = [f"data.train_dir={dirs[0]}", f"data.val_dir={dirs[1]}", f"runtime.out_dir={out}",
            f"train.epochs={RESIDENT['epochs']}", "runtime.log_every=4", *extra]
    return Trainer(load_config([str(ROOT / RESIDENT["config"])], sets))


def state_arrays(trainer) -> dict[str, torch.Tensor]:
    """Copies of the model's state (parameters, BN buffers) and of every
    tensor of the optimizer's state."""
    out = {f"model.{k}": v.detach().clone() for k, v in trainer.state.model.state_dict().items()}
    for name, lists in trainer.state.optimizer.state_dict().items():
        if isinstance(lists, list):
            for gi, group in enumerate(lists):
                for pi, t in enumerate(group):
                    out[f"{name}.{gi}.{pi}"] = t.detach().clone()
    return out


def timed_steps(trainer, batches, n: int) -> dict:
    """``n`` steps of ``trainer.train_batch`` on fed batches: CUDA-event ms
    a step and the host's wall ms a step, and where the host waited: for the
    next fed batch, and in ``host_rng``'s device-to-host read (the step's
    one sync)."""
    from vision_toolbox_tpu_torch.train import step as step_module

    real, waited = step_module.host_rng, [0.0]

    def timed_rng(generator):
        t = time.perf_counter()
        rng = real(generator)
        waited[0] += time.perf_counter() - t
        return rng

    feed_wait = 0.0
    step_module.host_rng = timed_rng
    try:
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        for _ in range(n):
            t = time.perf_counter()
            batch = next(batches)
            feed_wait += time.perf_counter() - t
            trainer.train_batch(batch)
        end.record()
        end.synchronize()
        wall = time.perf_counter() - t0
    finally:
        step_module.host_rng = real
    ms = start.elapsed_time(end) / n
    B = trainer.cfg.data.batch_size
    return dict(ms=ms, img_per_s=B / ms * 1e3, wall_ms=wall * 1e3 / n,
                feed_wait_ms=feed_wait * 1e3 / n, rng_wait_ms=waited[0] * 1e3 / n)


def traced_idle(trainer, batches, n: int, path: Path) -> dict:
    """torch.profiler over ``n`` steps: the device's idle share of the host
    window, and the host-to-device bytes a step."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    trainer.train_batch(next(batches))  # the feed primed outside the window
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            trainer.train_batch(next(batches))
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    prof.export_chrome_trace(str(path))
    trace = trace_device(path)
    return dict(idle_share=1 - trace["busy_us"] / 1e3 / window_ms, window_ms_per_step=window_ms / n,
                busy_ms_per_step=trace["busy_us"] / 1e3 / n,
                h2d_bytes_per_step=trace["h2d_bytes"] / n, h2d_copies_per_step=trace["h2d_copies"] / n,
                h2d_bytes_known=trace["h2d_bytes_known"])


def resident_trainer(report: dict, name_power: str, dirs: tuple[Path, Path], tmp: Path) -> int:
    """Phase 47 (cell (u), device-resident): ``Trainer`` on
    configs/synth_hard_dev.yaml (cspdarknet53, bs256@176, bf16, K1) over the
    corpus for 2 epochs with the uint8 train store on the card: K1 launched
    exactly once a step and no other kernel, the feed carrying the (B,)
    int32 index vector alone (and a trace's host-to-device bytes a step
    under one image's), ``random_resized_crop_flip`` on the card against
    the CPU from the same boxes and flips (max abs ≤ RRC_BOUND); then a
    fresh Trainer resumed from the epoch-1 checkpoint: parameters, BN
    buffers and momentum bit-equal to the saved ones, start_epoch 1, and the
    resumed epoch runs. Then the steps timed (CUDA events) and traced.
    Returns K1's launches in the two epochs."""
    from vision_toolbox_tpu_torch.data import prefetch_to_device
    from vision_toolbox_tpu_torch.ops import _cuda, device_rrc

    B, S = RESIDENT["batch"], RESIDENT["crop"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer = corpus_trainer(dirs, tmp / "resident")
    build_s = time.perf_counter() - t0
    store = trainer._device_store[0]
    saved = {}
    save = trainer.save

    def snapshot_save(epoch, val_acc=None):
        path = save(epoch, val_acc)
        saved.setdefault(epoch, (path, state_arrays(trainer)))
        return path

    trainer.save = snapshot_save
    _cuda.reset_launch_counts()  # the main path: counts from 0 just before, read just after
    t0 = time.perf_counter()
    trainer.fit()
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = dict(_cuda.LAUNCHES)
    n_steps = trainer.state.step
    records = [json.loads(line) for line in
               (tmp / "resident" / "metrics.jsonl").read_text().splitlines()]
    epochs = [r for r in records if "epoch_time_s" in r]
    feed_bytes = trainer.feed.bytes_copied / trainer.feed.batches
    log(f"[resident] store {tuple(store.shape)} uint8 {store.numel() / 1e9:.3f} GB on the card, "
        f"Trainer built in {build_s:.1f} s; fit {RESIDENT['epochs']} epochs, {n_steps} steps in "
        f"{fit_s:.1f} s; launches {launches}; feed {feed_bytes:.0f} bytes a step")
    for r in epochs:
        log(f"[resident] epoch {r['epoch']}: {r['epoch_time_s']:.2f} s, train_ips "
            f"{r['train_ips']:.1f}, peak {r.get('peak_memory_gib', math.nan):.1f} GiB, val/loss "
            f"{r['val/loss']:.4f} val/acc {r['val/acc']:.4f}  [{name_power}]")
    if n_steps != RESIDENT["epochs"] * CORPUS["train"] // B:
        raise AssertionError(f"{n_steps} steps")
    if launches != NO_LAUNCHES | {"warp_shear3": n_steps}:
        raise AssertionError(f"expected exactly one K1 launch a step and no other kernel: {launches}")
    if feed_bytes != B * 4:
        raise AssertionError(f"the feed carried {feed_bytes} bytes a step, not the index vector")

    # the device-side crop against the CPU's, same boxes and flips
    g = torch.Generator().manual_seed(5)
    idx = torch.randperm(store.shape[0], generator=g)[:B].to(store.device)
    images = store.index_select(0, idx).float() / 255.0
    draws = device_rrc.sample_rrc(g, B, store.shape[1], store.shape[2])
    got = device_rrc.crop_resize_flip(images, *draws, S)
    want = device_rrc.crop_resize_flip(images.cpu(), *draws, S)
    rrc_err = (got.cpu() - want).abs().max().item()
    d_card = device_rrc.RRCDraws(*(t.to(store.device) for t in draws))
    rrc_ms = time_ms(lambda: device_rrc.crop_resize_flip(images, *d_card, S), iters=10)
    log(f"[resident] random_resized_crop_flip bs{B} {store.shape[1]}→{S}: card vs CPU max|err| "
        f"{rrc_err:.2e} (bound {RRC_BOUND}), {rrc_ms:.3f} ms on the card")
    if not rrc_err <= RRC_BOUND:
        raise AssertionError("device_rrc on the card disagrees with the CPU")

    # resume from the epoch-1 checkpoint in a fresh Trainer
    path, snapshot = saved[0]
    resumed = corpus_trainer(dirs, tmp / "resident", f"runtime.resume={path}")
    restored = state_arrays(resumed)
    differ = sorted(k for k in snapshot if k not in restored or not torch.equal(snapshot[k], restored[k]))
    start_epoch = resumed.state.step // resumed.steps_per_epoch
    _cuda.reset_launch_counts()
    resumed.fit()
    torch.cuda.synchronize()
    resumed_launches = _cuda.LAUNCHES["warp_shear3"]
    tail = [json.loads(line) for line in
            (tmp / "resident" / "metrics.jsonl").read_text().splitlines()][-1]
    log(f"[resident] resumed from {Path(path).name}: {len(snapshot)} tensors, {len(differ)} "
        f"differ; start_epoch {start_epoch}; the resumed epoch: {resumed.state.step} steps, "
        f"{resumed_launches} K1, val/acc {tail.get('val/acc')}")
    if differ or snapshot.keys() != restored.keys() or start_epoch != 1:
        raise AssertionError(f"resume: differing {differ[:5]}, start_epoch {start_epoch}")
    if resumed.state.step != n_steps or tail.get("epoch") != 1 or resumed_launches != n_steps // 2:
        raise AssertionError(f"the resumed epoch did not run: {tail}")

    index_batches = lambda: iter(prefetch_to_device(
        ((i,) for i, _ in trainer.train_loader), "cuda"))
    timed = timed_steps(trainer, index_batches(), FEED_STEPS)
    traced = traced_idle(trainer, index_batches(), TRACED_STEPS, tmp / "resident_trace.json")
    log(f"[resident] {FEED_STEPS} steps: {timed['ms']:.2f} ms a step ({timed['img_per_s']:.1f} "
        f"img/s, CUDA events), host {timed['wall_ms']:.2f} ms a step, of it waiting for the "
        f"feed {timed['feed_wait_ms']:.3f} and in host_rng's read {timed['rng_wait_ms']:.2f}; "
        f"traced {TRACED_STEPS}: idle share {traced['idle_share']:.3f}, host-to-device "
        f"{traced['h2d_bytes_per_step']:.0f} bytes in {traced['h2d_copies_per_step']:.1f} "
        f"copies a step (bytes known: {traced['h2d_bytes_known']})  [{name_power}]")
    if traced["h2d_bytes_known"] and not traced["h2d_bytes_per_step"] < S * S * 3:
        raise AssertionError("an image crossed to the card in a device-resident step")
    report["resident"] = dict(build_s=build_s, fit_s=fit_s, launches=launches, epochs=epochs,
                              feed_bytes_per_step=feed_bytes, rrc_max_abs_err=rrc_err,
                              rrc_ms=rrc_ms, resume_differing=len(differ),
                              start_epoch=start_epoch, timed=timed, traced=traced)
    return launches["warp_shear3"]


def host_fed(report: dict, name_power: str, dirs: tuple[Path, Path], tmp: Path) -> int:
    """Phase 48 (cell (u), host-fed): the same corpus and step through the
    host's ``RawShardLoader`` and ``prefetch_to_device`` (page-locked
    buffers, copies on a side stream): one epoch through ``fit``, then
    FEED_STEPS steps timed (CUDA events) with the first FEED_CHECKED fed
    batches copied back and held bit-equal to the host's arrays, and
    TRACED_STEPS traced for the idle share; beside the device-resident run
    and the bare steps of phases 7 and 42. Returns K1's launches."""
    from vision_toolbox_tpu_torch.data import prefetch_to_device
    from vision_toolbox_tpu_torch.ops import _cuda

    trainer = corpus_trainer(dirs, tmp / "host", "train.epochs=1", "data.device_resident=false")
    _cuda.reset_launch_counts()
    trainer.fit()
    torch.cuda.synchronize()
    launches = _cuda.LAUNCHES["warp_shear3"]
    epoch = [json.loads(line) for line in
             (tmp / "host" / "metrics.jsonl").read_text().splitlines()][-1]

    host, fed = [], []

    def kept_host(batches):
        for images, labels in batches:
            if len(host) < FEED_CHECKED:
                host.append((images.copy(), labels.copy()))
            yield images, labels

    def kept_fed(batches):
        for batch in batches:
            if len(fed) < FEED_CHECKED:
                fed.append(tuple(t.clone() for t in batch))
            yield batch

    batches = kept_fed(iter(prefetch_to_device(kept_host(iter(trainer.train_loader)), "cuda")))
    timed = timed_steps(trainer, batches, FEED_STEPS)
    differ = [sum(int((got.cpu() != torch.from_numpy(want)).sum()) for got, want in zip(f, h))
              for f, h in zip(fed, host)]
    traced = traced_idle(trainer, iter(prefetch_to_device(iter(trainer.train_loader), "cuda")),
                         TRACED_STEPS, tmp / "host_trace.json")
    resident = report["resident"]["timed"]
    log(f"[host_fed] fit 1 epoch: train_ips {epoch['train_ips']:.1f}, peak "
        f"{epoch.get('peak_memory_gib', math.nan):.1f} GiB, {launches} K1 launches; {FEED_CHECKED} fed batches "
        f"copied back: differing elements {differ}")
    log(f"[host_fed] {FEED_STEPS} steps: {timed['ms']:.2f} ms a step ({timed['img_per_s']:.1f} "
        f"img/s), host {timed['wall_ms']:.2f} ms a step, waiting for the feed "
        f"{timed['feed_wait_ms']:.2f} and in host_rng's read {timed['rng_wait_ms']:.2f}; traced: "
        f"idle share {traced['idle_share']:.3f}, host-to-device {traced['h2d_bytes_per_step']:.0f} "
        f"bytes a step  [{name_power}]")
    bare, bare_vov = report["train"], report["vovnet_train"]
    log(f"[trainer vs bare step] cspdarknet53 bs256@176: bare (phase 7) {bare['ms_per_step']:.2f} "
        f"ms, device-resident trainer {resident['ms']:.2f} ms, host-fed {timed['ms']:.2f} ms; "
        f"vovnet57 bs512@176: bare (phase 42) {bare_vov['ms_per_step']:.2f} ms "
        f"({bare_vov['img_per_s']:.1f} img/s), CLI epoch train_ips "
        f"{report['cli_base']['epoch']['train_ips']:.1f} (first step included)")
    if len(differ) != FEED_CHECKED or any(differ):
        raise AssertionError(f"fed batches differ from the host's: {differ}")
    if launches != len(trainer.train_loader):
        raise AssertionError(f"{launches} K1 launches in {len(trainer.train_loader)} steps")
    report["host_fed"] = dict(epoch=epoch, launches=launches, differing=differ, timed=timed,
                              traced=traced)
    return launches


def trainer_phases(report: dict, name_power: str, phase_s: dict) -> dict[str, int]:
    """Phases 46-48, each timed; the corpus in a temporary directory."""
    import tempfile

    launches = {}
    t0 = time.perf_counter()
    launches["cli_base"] = cli_base_recipe(report, name_power)
    phase_s["cli_base"] = time.perf_counter() - t0
    log(f"[cli_base] phase wall {phase_s['cli_base']:.1f} s")
    with tempfile.TemporaryDirectory(prefix="vtt_corpus_") as tmp:
        t0 = time.perf_counter()
        dirs = write_corpus(Path(tmp))
        log(f"[corpus] {CORPUS} written in {time.perf_counter() - t0:.1f} s")
        for key, phase in (("resident", resident_trainer), ("host_fed", host_fed)):
            launches[key] = phase(report, name_power, dirs, Path(tmp))
            torch.cuda.synchronize()
            phase_s[key] = time.perf_counter() - t0
            log(f"[{key}] phase wall {phase_s[key]:.1f} s")
            t0 = time.perf_counter()
    return launches


# --- phases 49-51: checkpoints in the official layouts, int8 serving, the profiler

# Phase 49's loaded models: name → (the release's layout, launches a request,
# the program's custom-op calls); deit_b_16's (T = 198) are what the K3/K4
# gates admit there (``deit_kernels``).
LOADED = {
    "vit_b_16": ("AugReg .npz", {"block_mlp": 12, "block_attention": 12},
                 {"fused_mlp_block": 12, "fused_attention_block": 12}),
    "deit_b_16": ("FB .pth", None, None),
    "cait_s_24": ("FB .pth", {"talking_head": 24, "block_mlp": 24},
                  {"talking_head_attention": 24, "fused_mlp_block": 24}),
    "swin_t": ("MS .pth", {"swin_attention": 12, "swin_partition": 5, "swin_unpartition": 5,
                           "block_mlp": 12},
               {"swin_window_attention": 12, "swin_window_partition": 5,
                "swin_window_unpartition": 5, "fused_mlp_block": 12}),
    "convnext_t": ("FB .pth", {"depthwise_conv": 18, "block_mlp": 18},
                   {"depthwise_conv2d": 18, "fused_mlp_block": 18}),
}
LOADED_BATCH = 8
INT8_BOUND = 0.05  # mean |int8 − f32| / mean |f32|: the JAX package's test bound
# Int8Linear's shape classes (rows, in, out): vit_b_16's q/k/v/out, fc1 and
# fc2 at batch 8; CaiT's class token at batch 8 (rows ≤ 16); the Mixer's
# token halves (in or out 196); all three pads at once
INT8_CASES = ((1576, 768, 768), (1576, 768, 3072), (1576, 3072, 768), (8, 384, 384),
              (6144, 196, 384), (6144, 384, 196), (5, 196, 196))
PROFILE = dict(names=("vit_b_16", "convnext_t"), shape=(32, 224, 224, 3), n=10)


def deit_kernels() -> tuple[dict[str, int], dict[str, int]]:
    """deit_b_16's launches a request and program calls at T = 198 (cls,
    dist and 196 patches): 12 K4 and 12 K3 where their gates admit the
    shape; an attention half the K4 gate refused would run K2 on the module
    chain (96 pairs at batch 8)."""
    from vision_toolbox_tpu_torch.ops import block_attention, block_mlp

    k4 = 12 * block_attention.use_fused_attention(768, 12, 198, 0.0, True)
    k3 = 12 * block_mlp.use_fused_mlp(768, 3072, 198, 0.0)
    log(f"[loaded-deit_b_16] T = 198: the K4 gate admits {bool(k4)}, the K3 gate {bool(k3)}")
    return ({"block_mlp": k3, "block_attention": k4, "short_attention": 12 - k4},
            {"fused_mlp_block": k3, "fused_attention_block": k4, "short_attention": 12 - k4})


def loaded_and_served(report: dict, name_power: str, cache: Path) -> dict[str, dict]:
    """Phase 49: each model of LOADED written in its release's layout at full
    size (``tests/official_ckpts.py``, seeded) into the download cache
    ``cache``, loaded with ``load_pretrained`` in bf16 on the card and in f32
    on the CPU (state dicts equal), eager at batch 8 through the kernels
    (exact launches; logits rel L2 to the plain path and to the CPU's f32
    plain path ≤ max(REL_L2_BOUND, 2 × the plain bf16 path's own distance
    from it)), then served (``serve_program``: 3 requests at batch 8,
    vit_b_16 at 1, 8 and 32, each batch timed). Returns vit_b_16's and
    convnext_t's model, served program and f32 logits for phases 50-51."""
    import official_ckpts

    import vision_toolbox_tpu_torch as vtt
    from vision_toolbox_tpu_torch.ops import _cuda

    images = torch.rand(max(SERVE_BATCHES), 224, 224, 3,
                        generator=torch.Generator().manual_seed(1)).cuda()
    kept = {}
    for name, (layout, per_forward, program_ops) in LOADED.items():
        tag = f"loaded-{name}"
        if per_forward is None:
            per_forward, program_ops = deit_kernels()
        t0 = time.perf_counter()
        path = official_ckpts.write(name, cache)
        model = vtt.load_pretrained(name, dtype=torch.bfloat16).eval()
        ref = vtt.load_pretrained(name, device="cpu").eval()
        path.unlink()
        load_s = time.perf_counter() - t0
        sd, ref_sd = model.state_dict(), ref.state_dict()
        unequal = [k for k in ref_sd if k not in sd or not torch.equal(sd[k].cpu(), ref_sd[k])]
        if unequal or sd.keys() != ref_sd.keys():
            raise AssertionError(f"{name}: card and CPU state dicts differ at {unequal[:5]}")
        per_forward = NO_LAUNCHES | per_forward
        with torch.inference_mode():
            _cuda.reset_launch_counts()
            logits = model(images[:LOADED_BATCH])
            torch.cuda.synchronize()
            counts = dict(_cuda.LAUNCHES)
            plain = model(images[:LOADED_BATCH], plain=True)
            t1 = time.perf_counter()
            f32 = ref(images[:LOADED_BATCH].cpu(), **reference_kw(ref)).cuda()
            ref_s = time.perf_counter() - t1
        err, err_f32, own = rel_l2(logits, plain), rel_l2(logits, f32), rel_l2(plain, f32)
        bound_l2 = max(REL_L2_BOUND, 2 * own)
        log(f"[{tag}] {layout} {os.path.basename(path)} ({len(sd)} tensors, card = CPU) loaded "
            f"in {load_s:.1f} s, the CPU reference in {ref_s:.1f} s; bf16 bs{LOADED_BATCH} "
            f"launches {counts}; logits rel L2 to the plain path {err:.3e}, to the CPU's f32 "
            f"plain path {err_f32:.3e} (bound {bound_l2:.3e}: the plain bf16 path is "
            f"{own:.3e} from it)")
        if counts != per_forward:
            raise AssertionError(f"{name}: expected {per_forward}, got {counts}")
        if logits.shape != f32.shape or not torch.isfinite(logits.float()).all() \
                or not max(err, err_f32) <= bound_l2:
            raise AssertionError(f"{name} logits: shape {tuple(logits.shape)}, rel L2 {err}, "
                                 f"{err_f32} (bound {bound_l2})")
        batches = SERVE_BATCHES if name == "vit_b_16" else (LOADED_BATCH,)
        launches, rows, nodes, served = serve_program(
            tag, model, program_ops, batches, images, dict.fromkeys(batches, per_forward),
            model.last_out_channels, name_power)
        report[f"loaded_{name}"] = dict(
            layout=layout, load_s=load_s, launches_per_forward=counts, rel_l2_vs_plain=err,
            rel_l2_vs_cpu_f32=err_f32, plain_vs_cpu_f32=own, bound=bound_l2, requests=rows,
            program_nodes=nodes, served_launches=launches)
        if name in ("vit_b_16", "convnext_t"):
            kept[name] = dict(model=model, served=served, f32=f32, images=images)
        del ref
    return kept


class Products(TorchDispatchMode):
    """Counts the int8 and the float products a program runs (the ops it
    calls, not what runs inside a custom op)."""

    FLOAT = {"aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm", "aten::matmul",
             "aten::linear", "aten::einsum"}

    def __init__(self):
        super().__init__()
        self.int8 = self.float = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func._schema.name
        self.int8 += name == "aten::_int_mm"
        self.float += name in self.FLOAT
        return func(*args, **(kwargs or {}))


def int8_served(report: dict, name_power: str, loaded: dict[str, dict]) -> None:
    """Phase 50: ``quantize_model`` of phase 49's vit_b_16 (every q/k/v, out
    and MLP Linear an ``Int8Linear``, the original untouched), eager at
    batch 8 (its blocks on the module chain: 12 K2 launches, no K3/K4;
    mean |int8 − f32| / mean |f32| < INT8_BOUND against the CPU's f32
    logits), served at SERVE_BATCHES (``serve_program``: 12 K2 a request at
    8 and 32, none at 1), each request running one int8 product a
    quantized module and no float product; the int8 and bf16 programs timed
    in turns; then one ``Int8Linear`` per shape class of INT8_CASES on the
    card against the CPU's: the quantized weights, the int32 products and
    the outputs bit-equal."""
    from vision_toolbox_tpu_torch.nn.layers import Linear
    from vision_toolbox_tpu_torch.ops import _cuda
    from vision_toolbox_tpu_torch.utils.int8_serving import (
        Int8Linear, _absmax_scale, _quantize, int8_matmul, quantize_model,
    )

    vit, tag = loaded["vit_b_16"], "int8-vit_b_16"
    images, f32 = vit["images"], vit["f32"]
    model = quantize_model(vit["model"])
    n_q = sum(isinstance(m, Int8Linear) for m in model.modules())
    if n_q != 12 * 6 or any(isinstance(m, Int8Linear) for m in vit["model"].modules()):
        raise AssertionError(f"quantize_model: {n_q} Int8Linear, the original touched?")
    per_forward = NO_LAUNCHES | {"short_attention": 12}
    with torch.inference_mode():
        _cuda.reset_launch_counts()
        eager = model(images[:LOADED_BATCH])
        torch.cuda.synchronize()
        counts = dict(_cuda.LAUNCHES)
    rel = ((eager.float() - f32).abs().mean() / f32.abs().mean()).item()
    log(f"[{tag}] {n_q} Int8Linear; eager bs{LOADED_BATCH} launches {counts}; mean |int8 − f32| "
        f"/ mean |f32| {rel:.4e} (bound {INT8_BOUND})")
    if counts != per_forward or not rel < INT8_BOUND:
        raise AssertionError(f"int8 vit_b_16: launches {counts}, error {rel}")
    per_batch = {b: per_forward if b >= 8 else NO_LAUNCHES for b in SERVE_BATCHES}
    launches, rows, nodes, served = serve_program(tag, model, {"short_attention": 12},
                                                  SERVE_BATCHES, images, per_batch, 768,
                                                  name_power)
    products, timed = {}, []
    with torch.inference_mode():
        for b in SERVE_BATCHES:
            with Products() as p:
                served(images[:b])
            products[b] = (p.int8, p.float)
            if (p.int8, p.float) != (n_q, 0):
                raise AssertionError(f"batch {b}: {p.int8} int8 and {p.float} float products, "
                                     f"expected {n_q} and 0")
            bf16_ms, int8_ms = alternate(lambda: vit["served"](images[:b]),
                                         lambda: served(images[:b]), iters=10)
            timed.append(dict(batch=b, bf16_ms=bf16_ms, int8_ms=int8_ms))
            log(f"[{tag}] batch {b:2d}: int8 {int8_ms:.3f} ms, bf16 {bf16_ms:.3f} ms (in turns; "
                f"int8 / bf16 {int8_ms / bf16_ms:.3f}); {p.int8} int8 products, {p.float} float "
                f"[{name_power}]")

    cases = []
    for M, K, N in INT8_CASES:
        g = torch.Generator().manual_seed(M * K + N)
        linear = Linear(K, N, generator=g)
        cpu, card = Int8Linear(linear), Int8Linear(copy.deepcopy(linear).cuda())
        x = torch.randn(M, K, generator=g)
        x8 = _quantize(x, _absmax_scale(x, -1))
        x8_card = _quantize(x.cuda(), _absmax_scale(x.cuda(), -1))
        with torch.inference_mode():
            same = dict(
                w8=torch.equal(card.w8.cpu(), cpu.w8), scale=torch.equal(card.scale.cpu(), cpu.scale),
                x8=torch.equal(x8_card.cpu(), x8),
                int32=torch.equal(int8_matmul(x8_card, card.w8).cpu(), int8_matmul(x8, cpu.w8)),
                out=torch.equal(card(x.cuda()).cpu(), cpu(x)))
        pads = dict(rows=M <= 16, k=K % 8 != 0, n=N % 8 != 0)
        cases.append(dict(rows=M, k=K, n=N, padded=pads, bit_equal=same))
        log(f"[{tag}] Int8Linear ({M}, {K}) → {N}: padded {pads}; card vs CPU bit-equal {same}")
        if not all(same.values()):
            raise AssertionError(f"Int8Linear ({M}, {K}, {N}): card differs from the CPU: {same}")
    report["int8"] = dict(modules=n_q, eager_launches=counts, rel_err_vs_f32=rel, requests=rows,
                          program_nodes=nodes, served_launches=launches, products=products,
                          int8_vs_bf16=timed, linear_cases=cases)


def profile_phase(report: dict, name_power: str, loaded: dict[str, dict]) -> None:
    """Phase 51: ``profile_model`` of phase 49's vit_b_16 and convnext_t at
    PROFILE's shape in bf16 (params, GFLOPs, fwd ms, fwd+bwd ms, peak
    memory); the GFLOPs equal to the plain path's count, to which the
    depthwise convs' taps (elementwise products, which the counter does not
    see) are added as the grouped convolution that computes them."""
    import torch.nn.functional as F
    from torch.utils.flop_counter import FlopCounterMode

    from vision_toolbox_tpu_torch.nn.layers import DepthwiseConv
    from vision_toolbox_tpu_torch.utils.profile import flops, frozen, profile_model

    report["profile"] = {}
    for name in PROFILE["names"]:
        model = loaded[name]["model"]
        prof = profile_model(model, PROFILE["shape"], PROFILE["n"], torch.bfloat16)
        x = torch.zeros(PROFILE["shape"], dtype=torch.bfloat16, device="cuda")
        shapes = []
        hooks = [m.register_forward_hook(lambda mod, inp, out: shapes.append(
            (inp[0].shape, mod.weight.shape[-1]))) for m in model.modules()
            if isinstance(m, DepthwiseConv)]
        with frozen(model), torch.no_grad():
            plain = flops(lambda: model(x, plain=True))
        for h in hooks:
            h.remove()
        with FlopCounterMode(display=False) as taps:
            for (B, H, W, C), k in shapes:
                F.conv2d(torch.empty(B, C, H, W, device="meta"),
                         torch.empty(C, 1, k, k, device="meta"), padding=k // 2, groups=C)
        want = plain + taps.get_total_flops() / 1e9
        log(f"[profile] {name} bf16 {PROFILE['shape']}: {prof['params_m']:.3f} M params, "
            f"{prof['gflops']:.4f} GFLOPs (plain path {plain:.4f} + depthwise taps "
            f"{taps.get_total_flops() / 1e9:.4f}), fwd {prof['fwd_ms']:.3f} ms, fwd+bwd "
            f"{prof['fwd_bwd_ms']:.3f} ms, peak {prof.get('mem_peak_mb', float('nan')):.1f} MB "
            f"of {prof.get('mem_limit_mb', float('nan')):.0f}  [{name_power}]")
        if not math.isclose(prof["gflops"], want, rel_tol=1e-12):
            raise AssertionError(f"{name}: {prof['gflops']} GFLOPs on the kernel path, {want} "
                                 "on the plain path")
        report["profile"][name] = prof | dict(plain_gflops=plain,
                                              taps_gflops=taps.get_total_flops() / 1e9)


def interop_phases(report: dict, name_power: str, phase_s: dict) -> None:
    """Phases 49-51 in a temporary download cache (``VTT_CACHE_DIR``)."""
    import tempfile

    sys.path.insert(0, str(ROOT / "tests"))
    old = os.environ.get("VTT_CACHE_DIR")
    try:
        with tempfile.TemporaryDirectory() as cache:
            os.environ["VTT_CACHE_DIR"] = cache
            t0 = time.perf_counter()
            loaded = loaded_and_served(report, name_power, Path(cache))
            phase_s["loaded"] = time.perf_counter() - t0
            for key, phase in (("int8", int8_served), ("profile", profile_phase)):
                t0 = time.perf_counter()
                phase(report, name_power, loaded)
                torch.cuda.synchronize()
                phase_s[key] = time.perf_counter() - t0
    finally:
        if old is None:
            os.environ.pop("VTT_CACHE_DIR", None)
        else:
            os.environ["VTT_CACHE_DIR"] = old
    for key in ("loaded", "int8", "profile"):
        log(f"[{key}] phase wall {phase_s[key]:.1f} s")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import vision_toolbox_tpu_torch as vtt
    from vision_toolbox_tpu_torch.ops import _cuda
    from vision_toolbox_tpu_torch.ops.block_attention import _bwd_partial_floats
    from vision_toolbox_tpu_torch.utils.export import export_model, load_exported

    report: dict = {}
    script_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name_power = card()
    report["card"] = name_power
    log(f"[card] {name_power}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} device(s)")

    # phase 2: build
    t0 = time.perf_counter()
    lib_path = _cuda.library_path()
    _cuda.lib()
    report["build_s"] = time.perf_counter() - t0
    log(f"[build] {lib_path.relative_to(ROOT)} in {report['build_s']:.1f} s")
    build_log = (lib_path.parent / "build.log").read_text()
    report["build_log"] = build_log
    for line in build_log.splitlines():
        if "registers" in line or "spill" in line or line.startswith("[") and ".cu: " in line:
            log(f"[build] {line.strip()}")
    for b, t, d in ((8, 197, 768), (3, 50, 128), (2, 512, 1024), (1, 2, 256)):
        # the wrapper's mirror of K4's partial-row layout
        if _cuda.lib().vtt_block_attention_bwd_partial_floats(b, t, d) != _bwd_partial_floats(
                b, t, d):
            raise AssertionError(f"K4's partial-row count differs at B={b}, T={t}, D={d}")

    # phase 3: kernels vs plain versions
    with torch.inference_mode():
        errors = compare_kernels(report)

    # phase 4: the model, eager, kernels vs plain versions
    model = vtt.create_backbone("vit_b_16", dtype=torch.bfloat16, device="cuda",
                                generator=torch.Generator().manual_seed(0))
    model.eval()
    images = torch.rand(32, 224, 224, 3, generator=torch.Generator().manual_seed(1)).cuda()
    with torch.inference_mode():
        _cuda.reset_launch_counts()
        logits = model(images[:8])
        torch.cuda.synchronize()
        counts = dict(_cuda.LAUNCHES)
        plain_logits = model(images[:8], plain=True)
        torch.cuda.synchronize()
    log(f"[model] vit_b_16 bf16 bs8 forward: launches {counts}")
    if counts != NO_LAUNCHES | dict.fromkeys(SERVE_KERNELS, 12):
        raise AssertionError(f"expected 12 launches of each forward kernel, got {counts}")
    width = model.last_out_channels
    if logits.shape != (8, width) or not torch.isfinite(logits.float()).all():
        raise AssertionError(f"bad logits: shape {tuple(logits.shape)}")
    err = rel_l2(logits, plain_logits)
    report["model"] = dict(launches=counts, rel_l2_vs_plain=err)
    log(f"[model] logits kernel vs plain path: rel L2 {err:.3e} (bound {REL_L2_BOUND})")
    if not err <= REL_L2_BOUND:
        raise AssertionError(f"logits disagree with the plain path: rel L2 {err}")

    # phase 5: serve — the main path. Counts cover only the served requests.
    t0 = time.perf_counter()
    blob = export_model(model, (8, 224, 224, 3))
    served = load_exported(blob)
    log(f"[serve] export+load {time.perf_counter() - t0:.1f} s, artifact {len(blob) / 2**20:.1f} MiB")
    with torch.inference_mode():
        eager = {b: model(images[:b]) for b in SERVE_BATCHES}
        _cuda.reset_launch_counts()
        answers = {b: [served(images[:b]) for _ in range(3)] for b in SERVE_BATCHES}
        torch.cuda.synchronize()
        launches = dict(_cuda.LAUNCHES)
    n_forwards = 3 * len(SERVE_BATCHES)
    log(f"[serve] {n_forwards} requests at batch {SERVE_BATCHES}: launches {launches}")
    if launches != NO_LAUNCHES | dict.fromkeys(SERVE_KERNELS, 12 * n_forwards):
        raise AssertionError(f"served path launched {launches}, expected {12 * n_forwards} of "
                             "each forward kernel and no backward kernel")
    serve_rows = []
    for b in SERVE_BATCHES:
        for out in answers[b]:
            e = rel_l2(out, eager[b])
            if out.shape != (b, width) or not torch.isfinite(out.float()).all() or e > 1e-3:
                raise AssertionError(f"served batch {b} disagrees with eager: rel L2 {e}")
        with torch.inference_mode():
            ms = time_ms(lambda: served(images[:b]), iters=10)
        serve_rows.append(dict(batch=b, ms_per_batch=ms, rel_l2_vs_eager=e))
        log(f"[serve] batch {b:2d}: {ms:.3f} ms/batch ({b / ms * 1e3:.1f} img/s), "
            f"rel L2 vs eager {e:.2e}  [{name_power}]")
    report["serve"] = serve_rows

    with torch.inference_mode():
        times = time_kernels(report)

    # phases 6-8: the training path
    with torch.no_grad():
        errors["warp_shear3"], ms, plain_ms = compare_warp(report)
    times["warp_shear3"] = (ms, plain_ms)
    torch.backends.cudnn.benchmark = True
    launches["warp_shear3"] = train(report, name_power)

    # phases 9-12: the transformer training path
    errors |= compare_backward(report)
    times |= time_backward(report)
    vit_launches = train_vit(report, name_power)
    for k in ("block_mlp_bwd", "block_attention_bwd"):
        launches[k] = vit_launches[k]
    train_deit3(report)

    # phases 13-16: CaiT serving and training
    with torch.no_grad():
        errors |= compare_talking_head(report)
        times |= time_talking_head(report)
    launches["talking_head"] = serve_cait(report, name_power)
    launches["talking_head_bwd"] = train_cait(report, name_power)["talking_head_bwd"]

    # phases 17-20: SigLIP at 512 px, serving and training
    with torch.no_grad():
        errors |= compare_flash(report)
    flash_times = time_flash(report, name_power)
    times |= {k: t[:2] for k, t in flash_times.items()}
    launches["flash_attention"] = serve_siglip(report, name_power)
    launches["flash_attention_bwd"] = train_siglip(report, name_power)["flash_attention_bwd"]

    # phases 21-27: ConvNeXt with K9, K3's 32-column tiles, the repaired faults
    with torch.no_grad():
        depthwise_errors, main_dw_rel_l2 = compare_depthwise(report)
        errors |= depthwise_errors
        depthwise_times = time_depthwise(report, name_power)
        time_narrow_mlp(report, name_power)
    times |= {k: t[:2] for k, t in depthwise_times.items()}
    launches["depthwise_conv"] = serve_convnext(report, name_power)
    launches["depthwise_conv_bwd"] = train_convnext(report, name_power)["depthwise_conv_bwd"]
    repairs_on_card(report, name_power)

    # phases 28-33: Swin with K7 and K8, the repaired head widths of K5 and K6
    with torch.no_grad():
        swin_errors, main_dpe_rel_l2 = compare_swin(report)
        errors |= swin_errors
    swin_times = time_swin(report, name_power)
    times |= {k: t[:2] for k, t in swin_times.items()}
    served = serve_swin(report, name_power)
    for k in ("swin_attention", "swin_partition", "swin_unpartition"):
        launches[k] = served[k]
    launches["swin_attention_bwd"] = train_swin(report, name_power)["swin_attention_bwd"]
    repaired_head_widths(report, name_power)

    # phases 34-37: short attention (K2), vit_b_16 with dropout served, the unfused step
    errors |= compare_short(report)
    short_times = time_short(report, name_power)
    times |= {k: t[:2] for k, t in short_times.items()}
    launches["short_attention"] = serve_vit_dropout(report, name_power)
    launches["short_attention_bwd"] = train_vit_unfused(report, name_power)["short_attention_bwd"]

    # phase 38: the K3/K4 half-blocks through the module chain, their yardstick
    time_chains(report, name_power)

    # phase 39: K4's attention core, held and timed apart
    with torch.no_grad():
        core = hold_attention_core(report, name_power, build_log)

    # phases 40-42: MLP-Mixer (K3 on its channel half), PatchConvNet (K9 at
    # 3 × 3), VoVNet (the default recipe's backbone, K1 in its step)
    phase_s = {}
    for key, phase in (("mixer", mixer), ("patchconvnet", patchconvnet), ("vovnet", vovnet)):
        t0 = time.perf_counter()
        phase(report, name_power)
        torch.cuda.synchronize()
        phase_s[key] = time.perf_counter() - t0
        log(f"[{key}] phase wall {phase_s[key]:.1f} s")
    log(f"[phases 40-42] {sum(phase_s.values()):.1f} s together; the script so far "
        f"{time.perf_counter() - script_start:.1f} s")

    # phases 43-45: EfficientNet (K9 at 3 × 3 and 5 × 5 in its MBConvs), the
    # other families at full width, the necks (BiFPN's separable convs on K9)
    slice18 = {}
    for key, phase in (("efficientnet", efficientnet), ("other_families", other_families),
                       ("necks", necks_on_card)):
        t0 = time.perf_counter()
        slice18[key] = phase(report, name_power)
        torch.cuda.synchronize()
        phase_s[key] = time.perf_counter() - t0
        log(f"[{key}] phase wall {phase_s[key]:.1f} s")
    log(f"[phases 43-45] {sum(phase_s[k] for k in slice18):.1f} s together; the script so far "
        f"{time.perf_counter() - script_start:.1f} s")

    # phases 46-48: the trainer through the CLI on base.yaml, the
    # device-resident trainer and its resume, the host feed
    trainer_launches = trainer_phases(report, name_power, phase_s)
    log(f"[phases 46-48] {sum(phase_s[k] for k in trainer_launches):.1f} s together; the script "
        f"so far {time.perf_counter() - script_start:.1f} s")

    # phases 49-51: checkpoints in the official layouts loaded and served, int8
    # serving, the profiler
    interop_phases(report, name_power, phase_s)
    report["phase_s"] = phase_s
    log(f"[phases 49-51] {sum(phase_s[k] for k in ('loaded', 'int8', 'profile')):.1f} s "
        f"together; the script so far {time.perf_counter() - script_start:.1f} s")

    B8, B128, T = 8, VIT_TRAIN["batch"], 197
    cait = dict(T=CAIT_S["T"], S=CAIT_S["T"], H=CAIT_S["H"], D=CAIT_S["D"], x_bytes=2)
    work = {
        "block_mlp": block_work("block_mlp", B8, T, 2),
        "block_attention": block_work("block_attention", B8, T, 2),
        "block_mlp_bwd": block_work("block_mlp_bwd", B128, T, 2),
        "block_attention_bwd": block_work("block_attention_bwd", B128, T, 2),
        "warp_shear3": (0.0, 2 * TRAIN["batch"] * TRAIN["img"] ** 2 * 3 * 4),
        "talking_head": talking_head_work("talking_head", B128, **cait),
        "talking_head_bwd": talking_head_work("talking_head_bwd", B128, **cait),
        **{k: flash_work(k, FLASH_TIME_BATCH * SIGLIP_HEADS, SIGLIP_T, SIGLIP_T, 64, 2)
           for k in ("flash_attention", "flash_attention_bwd")},
        **{k: depthwise_work(k, DEPTHWISE_TIME_BATCH, 56, 56, 96, 7, 2)
           for k in ("depthwise_conv", "depthwise_conv_bwd")},
        **{k: swin_attention_work(k, SWIN_TIME_BATCH, 64, 49, 3, 32, 2)
           for k in ("swin_attention", "swin_attention_bwd")},
        **dict.fromkeys(("swin_partition", "swin_unpartition"),
                        (0.0, 2 * SWIN_TIME_BATCH * 56 * 56 * 96 * 2)),
        **{k: short_work(k, SHORT_TIME_BATCH, 197, 197, VIT_B["H"], 64, 2)
           for k in ("short_attention", "short_attention_bwd")},
    }
    library = {k: t[2] for k, t in
               (flash_times | depthwise_times | swin_times | short_times).items()}
    # K9's dw and K7's dPE sum in their own order: their rel L2 beside the
    # elementwise tensors' max abs error
    extra = {"depthwise_conv_bwd": dict(dw_rel_l2=main_dw_rel_l2),
             "swin_attention_bwd": dict(dpe_rel_l2=main_dpe_rel_l2),
             "block_attention": dict(core_save_ms=core["save_forward"],
                                     core_served_ms=core["forward"]),
             "block_attention_bwd": dict(core_rows_ms=core["rows"],
                                         core_keys_ms=core["keys"]),
             "warp_shear3": dict(wrapper_ms=report["warp"]["wrapper_ms"],
                                 trainer_launches=trainer_launches)}
    # K9 on the MBConv and BiFPN paths (slice 18): their launches, and the
    # kernel's time summed over efficientnet_b0's 12 calls at batch 128
    effnet = report["efficientnet_depthwise"]["per_step"]
    for k, what in (("depthwise_conv", "forward"), ("depthwise_conv_bwd", "backward")):
        extra[k] = extra.get(k, {}) | dict(
            efficientnet_b0_served_launches=slice18["efficientnet"]["served"] if k ==
            "depthwise_conv" else None,
            efficientnet_b0_step_launches=slice18["efficientnet"]["step"],
            bifpn_launches=slice18["necks"][k],
            efficientnet_b0_b128_ms=effnet[f"{what}/ms"],
            efficientnet_b0_b128_bound_ms=effnet[f"{what}/bound_ms"],
            efficientnet_b0_b128_library_ms=effnet[f"{what}/library_ms"])
    kernels = []
    for k in KERNELS:
        bound_ms, bound_by = bound(*work[k])
        kernels.append(dict(name=k, **KERNELS[k], launches=launches[k], max_abs_err=errors[k],
                            ms=times[k][0], plain_ms=times[k][1], bound_ms=bound_ms,
                            bound_by=bound_by, library_ms=library.get(k), **extra.get(k, {})))
    report["kernels"] = kernels
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    report["total_s"] = time.perf_counter() - script_start
    log(f"[total] {report['total_s']:.1f} s, the build included")
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))

    print(json.dumps({"kernels": kernels}))
    print(name_power)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
