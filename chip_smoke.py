#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port, monai_tpu_torch, on one NVIDIA GPU.

Drives the port's paths, each at full width with random weights from a seed:

- UNet: the Spleen-CT 3-D UNet (channels 16-32-64-128-256, strides 2, two residual
  units, instance norm, PReLU) under ``SlidingWindowInferer``, one window batch of 18,
  bfloat16, over 224x224x112 volumes (roi 96³, overlap 0.25, gaussian, 18 windows);
- SwinUNETR: ``SwinUNETR(1, 14, feature_size=24)`` (BTCV; depths 2-2-2-2, heads
  3-6-12-24, window 7) under ``SlidingWindowInfererAdapt``, window batches of 6, bfloat16,
  over the same volumes;
- Spleen inference: the Spleen bundle's inference entry point in float32, from a
  512x512x90 int16 CT at (0.79, 0.79, 5.0) mm written as .nii.gz under ``build/``:
  LoadImaged, EnsureChannelFirstd, Orientationd RAS, Spacingd (1.5, 1.5, 2.0) bilinear
  (the separable resample kernel), ScaleIntensityRanged; the bundle's batch-norm UNet
  under SlidingWindowInferer(96, sw_batch_size=4, overlap=0.25), 48 windows; Activationsd
  softmax, AsDiscreted argmax, and Invertd at nearest interpolation (the resample kernel
  again), back to a (1, 512, 512, 90) label map on the input's affine.
- Filtering: the bilateral entry points on the spleen path's own data, float32: the
  brute-force ``BilateralFilter`` on the preprocessed (1, 1, 270, 270, 224) image (the
  3-D bilateral kernel) and on the CT's 90 axial 512x512 slices after the bundle's
  ScaleIntensityRange (the 2-D kernel); the bilateral grid (``BilateralFilter``'s
  default) on the image; and ``CRF()`` over the spleen UNet's (1, 2, 270, 270, 224)
  logits with the image as reference.
- Training: the JAX bench's ``unet_train``, the same UNet (instance norm, PReLU) trained by
  ``SupervisedTrainer(amp=True)`` with ``DiceCELoss(to_onehot_y=True, softmax=True)`` and
  AdamW (lr 1e-4, weight decay 1e-4) on batches of 4 96³ patches (x uniform, label
  uniform > 0.5, from a seed), bfloat16 compute on float32 master weights.
- BTCV training: the BTCV bundle's ``SwinUNETR(1, 14, feature_size=48)`` trained in
  float32 by ``SupervisedTrainer`` (no amp) with ``DiceCELoss(to_onehot_y=True,
  softmax=True)`` and AdamW (lr 1e-4, weight decay 1e-5) on batches of 4 96³ patches, under
  torch's default TF32 setting; and the BTCV bundle's ``train.json`` through the port's
  runner on synthetic data (CacheDataset, the random crops, flips, rotations and shift,
  the validation, the statistics and the checkpoint).
- MedNIST training: the MedNIST bundle's ``train.json`` (the 2-D ``DenseNet121(2, 1, 6)``,
  ``CrossEntropyLoss``, Adam, 64x64 images with ``RandRotated``, ``RandFlipd`` and
  ``RandZoomd``, a ``ROCAUC`` validation) through the port's runner, with the general
  resample's ops against the CPU and kernel 3 at its 2-D zoom sites.
- BraTS and Spleen training: the BraTS bundle's ``train.json`` (``SegResNet`` at init_filters
  16, group norm, float32, one 96³ crop a step from 240x240x155 phantoms, ``DiceLoss`` on
  sigmoids, AdamW) and the Spleen bundle's ``train.json`` (the float32 batch-norm UNet, 8
  96³ crops a step, ``DiceCELoss``, Adam) through the port's runner, each with kernel 1's
  forward, dx and dw at its float32 sites.
- The Spleen bundle end to end: ``bundles/spleen_ct_segmentation/configs/inference.json``
  as it stands, through the port's bundle runner (``monai_tpu_torch.bundle.run``, then
  ``python -m monai_tpu_torch.bundle run``), over 4 copies of the spleen path's CT with its
  weights as the bundle's checkpoint: Dataset, DataLoader, SupervisedEvaluator with
  decollation, CheckpointLoader, the path above, and SaveImaged writing one label map a
  volume.

  1. the card's name and power limit; the CUDA kernels built from the checkout's sources
  2. each kernel against its plain PyTorch version at every shape each path gives it, the
     conv, norm and attention in bfloat16, float32 and float16 (read off one forward by
     hooks; the attention also at head dim 16 and at a 9^3 window of head dim 12; the
     resample at its two sites and over an order x bound grid at odd extents, each on the
     route and tile its plan gives, the fused route in one CUDA launch, a shape on its
     axes route, and at the two sites other tiles timed beside the plan's): max error
     under a stated tolerance, and the kernel's,
     the plain version's and the one PyTorch library call's times (for the norm
     ``F.instance_norm``, without the slope), with the least time
     the card could take (bytes over 3.35 TB/s or operations over the type's peak; for
     the attention also its exps, one a score); each attention site names the kernel's
     instance and the windows a block walks over
  3. per sliding-window path, the inferer over 224x224x112 volumes: output shape and
     finiteness, single-volume latency, vols/s and peak memory, with the launch counts of
     that run (every count set to 0 just before it and read just after)
  4. per sliding-window path, one forward on a 96³ window, on the card in float32,
     bfloat16 and float16, against the port's own CPU float32 forward of the same weights
     and input, with each forward's launch counts; and the same for
     ``SwinUNETR(1, 14, feature_size=12)`` (head dim 4) in float32 and bfloat16
  5. the Spleen inference path, volume after volume: the time of each stage (NIfTI load,
     preprocessing on the card, the Spacing resample within it, sliding window,
     postprocessing with the inverse), the per-volume latency and peak memory, the launch
     counts, and the output's shape and affine; then its preprocessed image against the
     port's CPU preprocessing of the same file, its inverse against the CPU's inverse of
     the card's own label map, and one 96³ float32 forward of its UNet against the CPU
  6. the filtering path, stage by stage: the median of 5 synchronised calls after a
     warm-up, the launch counts of those calls and the peak memory; at the full sizes the
     bilateral kernel against its plain version, with its instance (``bilateral_plan``),
     the exps a voxel that its checked build counts on the card (required to equal the
     plan's) beside the least, both times and the bound (bytes, float32 operations or the
     special-function unit's exp, one a symmetric pair of voxels), and its time at other
     segment lengths of the walked axis beside the plan's; then each stage on the card
     against the port's CPU run of the same call on a crop
  7. the training path, outside inference mode: each backward kernel (the conv's weight
     gradient, dx on the conv kernel, the norm's backward) against its plain version at
     every site of the training step (read off by hooks), in bfloat16, float32 and float16,
     with the kernel's, the plain version's and the library call's times and the bound
     (each norm site's line with the backward's plan: its path, channel group, units a
     group, stash, and one launch, which it requires);
     one batch-1 step on a 96³ patch against the port's CPU float32 step (the loss and
     every grad, in float32 and in the bfloat16 amp step) and two card steps from one state
     bit for bit; then ``SupervisedTrainer(amp=True)`` at batch 4, 3 warm-up iterations and
     20 timed: steps/s, patches/s, the median step, the peak memory, the launches a step
     of each kernel against the sites, and the loss at each step
  8. the Spleen bundle's inference.json through the port's runner, overriding only its
     bundle root and the ``imports`` and ``initialize`` that name the package, after a
     warm-up over one volume: at 0 and at 2 loader threads, vols/s over 4 volumes, each
     volume's time from the start of its iteration to its file written with the loader's
     wait, the forward, the postprocessing and the write, the write's share, the peak
     memory and the launches (counted across the threads); each saved file's type, shape,
     affine and values, and its identity with phase 5's label map; the evaluator's network
     against the checkpoint; the same through the command line; then a spleen forward and
     a volume under torch's default TF32 setting against the CPU and the float32 labels
  9. (run after 7, before 8) the BTCV SwinUNETR's float32 training step: the window
     attention's backward kernel against its plain version at the step's eight sites (head
     dim 16) and the bench SwinUNETR's (head dim 8), masked and unmasked, in float32,
     bfloat16 and float16, two calls bit for bit, each site's plan (route, tile, cluster
     size, runs, partials), float32 timed against the plain version, autograd of SDPA
     (which it must beat at every site) and the bound (its products as 3xTF32 on the
     tensor cores), with the kernel's share of it;
     the forward kernel's float32 tensor-core instance ("tf32x3", which the plan must
     name) at the step's eight sites and their head-dim-8 twins against its plain version,
     two calls bit for bit, timed beside ``F.scaled_dot_product_attention`` and its bound
     (the products as 3xTF32), the old FMA-pipe bound beside it; the conv's and the norm's backward kernels at the Swin
     sites in float32 and bfloat16, each site's line with dw's or the norm backward's plan, float32 timed against
     the plain versions, cuDNN's convolution backward and autograd of ``F.instance_norm``
     in full float32, and the bound at the float32 peak (their sums a step go into the
     kernels line under ``swin_train_float32``); one batch-1 32³ step on the card against
     the port's CPU step; then ``SupervisedTrainer`` in float32 at batch 4, 2 warm-up iterations and 10
     timed with cuDNN's TF32 allowed as by default: steps/s, the median step, the peak
     memory, the grads copied to channels-last a step, the launches a step of each kernel
     against the sites, each loss
  10. the BTCV bundle's ``train.json`` through the port's runner, overriding its
     bundle root, imports and initialize (the port's), its optimizer (``torch.optim.AdamW``,
     the file's rates) and its datalists (the file's expressions at 160x160x200, which its
     96³ crops fit): the synthetic data's and the cache fill's time, two epochs' steps,
     steps/s and times, each validation's time and ``val_mean_dice``, the peak memory and
     the launches; each crop batch (4, 1, 96, 96, 96) on the card, the checkpoint against
     the trained network; then the command line as a process of its own for one epoch
  11. the BraTS bundle's ``train.json`` the same way (its datalists at 240x240x155, 8
     images, two epochs of 6 steps of one 96³ crop), after kernel 1's forward, dx and dw
     against their plain versions at each of its ``SegResNet``'s float32 sites (1->16 and
     16->16 at 96³, 32 at 48³, 64 at 24³, 128 at 12³, batch 1), timed against cuDNN in full
     float32 and the bound; the launches of each training iteration (3x3x3 conv forward,
     dx and dw: 25, 24 and 25), the trained network's forward and a batch-1 32³ step on the
     card against the CPU, one step's profile (device time, layout copies, kernels by time);
     then its command line for one epoch
  12. the Spleen bundle's ``train.json`` likewise (datalists at 160x160x200, 8 images, two
     epochs of 3 steps of 2 images x 4 crops), after kernel 1 at the batch-8 float32 sites
     of its batch-norm UNet (launches an iteration 10, 10 and 10)
  13. the MedNIST bundle's ``train.json`` through the port's runner, overriding its bundle
     root, imports, initialize and optimizer (``torch.optim.Adam`` at the file's 1e-5), on
     the file's own 48 synthetic 64x64 images: two epochs of 5 steps of the float32 2-D
     ``DenseNet121``, a ``ROCAUC`` validation each; first ``grid_pull`` (orders 0-7 x the
     eight bounds), ``grid_push``, ``grid_count``, ``grid_grad`` and the GMM on the card
     against the port's CPU; kernel 3's launches against the ``RandZoomd`` draws that
     resized, and kernel 3 at each 2-D zoom shape against its plain version, timed beside
     ``F.interpolate``; ``RandRotated``, the trained net's forward and a batch-8 step against
     the CPU; one step's profile (device time, idle share, the convs', norms' and cats'
     launches)

It prints the ``{"kernels": [...]}`` line and, last, ``{"ok": true, "device": ...}``.
Any failed check raises, so the exit code is not 0; so it is without a CUDA device.

Run from the repository root: ``python3 chip_smoke.py``
"""
from __future__ import annotations

import contextlib
import copy
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROI = (96, 96, 96)
VOLUME = (224, 224, 112)
N_WINDOWS = 18  # per volume
UNET_BATCH, SWIN_BATCH = N_WINDOWS, 6
UNET_TIMING, SWIN_TIMING = (10, 30), (5, 10)  # (latency runs, throughput volumes)
# launches per forward: (3x3x3 conv, instance norm, window attention, separable resample,
# bilateral stencil)
UNET_PER_FORWARD, SWIN_PER_FORWARD = (10, 17, 0, 0, 0), (20, 26, 8, 0, 0)
# the Spleen inference path: a Task09-shaped CT, the bundle's Spacing, its inferer
CT_SHAPE, CT_SPACING, PIXDIM = (512, 512, 90), (0.79, 0.79, 5.0), (1.5, 1.5, 2.0)
SPLEEN_PRE = (1, 270, 270, 224)  # the preprocessed image
SPLEEN_BATCH, SPLEEN_WINDOWS = 4, 48
SPLEEN_PER_VOLUME = (120, 0, 0, 2, 0)  # 12 forwards of 10 convs; Spacing and its inverse
SPLEEN_TIMED = 5  # volumes timed end to end, after one warm-up
CT_PATH = Path(__file__).resolve().parent / "build" / "spleen_ct" / "ct_512x512x90.nii.gz"
# The Spleen bundle's own inference.json through the port's runner: 4 copies of the CT, at 0
# and 2 loader threads, the bundle root overridden and its imports and initialize naming the
# port (as README gives them)
BUNDLE_CONFIG = Path(__file__).resolve().parent / "bundles" / "spleen_ct_segmentation" / "configs" / "inference.json"
BUNDLE_ROOT = Path(__file__).resolve().parent / "build" / "spleen_bundle"
BUNDLE_VOLUMES, BUNDLE_WORKERS = 4, (0, 2)
BUNDLE_OVERRIDES = {"imports": ["$import os", "$import glob", "$from monai_tpu_torch.handlers import from_engine"],
                    "initialize": ["$import monai_tpu_torch", "$monai_tpu_torch.utils.set_determinism(seed=123)"]}
# a voxel where a label map differs from another run's must be a near tie: its top-two
# logit margin below this share of the logits' std
TOL_TIE = 1e-4

# Tolerances, relative to max|plain output|. bfloat16: both versions round an f32 sum to
# bf16 (8-bit significand), so they may differ by one bf16 step, <= 2^-7 of the value;
# float16 likewise by one step of its 11-bit significand, <= 2^-10. float32: the sums
# differ only in order.
TOL_BF16, TOL_F16, TOL_F32 = 1e-2, 2e-3, 1e-4
CHECKED = ((torch.bfloat16, TOL_BF16), (torch.float32, TOL_F32), (torch.float16, TOL_F16))
# The resample: orders 1 and 3 sum 2 or 4 taps per axis in float32 in another order than
# the dense product (1e-5 of max|ref|); order 0 has one tap of weight 1 and is bit-identical.
TOL_RESAMPLE = 1e-5
# Tiles timed beside the plan's at the resample's two sites: shorter and longer rows of y,
# more rows of z, shorter runs along x, and past the plan's 48 KB of shared memory.
RESAMPLE_SWEEP = {"Spacing": ((2, 8, 224), (1, 8, 224), (2, 16, 224), (1, 32, 224), (1, 16, 128), (4, 16, 32)),
                  "inverse": ((4, 16, 90), (16, 4, 90), (8, 16, 90), (1, 32, 90), (4, 8, 90), (16, 16, 32))}
# A forward against the CPU float32 forward, relative to the std of the CPU logits:
# float32 on the card (tight: sums in another order), bfloat16 (loose: ~30-40 layers
# each rounding to bf16), and the share of voxels whose argmax class agrees. For the
# SwinUNETR's 14 classes with random weights, 5% of the voxels have a top-two margin
# below 0.026 std (the port's CPU float32 forward), so bf16 noise of ~0.01 std flips
# about 1% of them (0.9887 agreement between the CPU's bf16 and f32 forwards). float16
# rounds 8x finer than bfloat16: its forwards measured ~0.0011 std on the H100, so its
# limit, 5e-3 std, fails a float16 net that ran in bfloat16 (0.0087-0.0093 std).
TOL_FWD_F32_MAX, MIN_ARGMAX_AGREE = 1e-3, 0.95
TOL_FWD_MEAN = {torch.bfloat16: 5e-2, torch.float16: 5e-3}
# The Spleen preprocessing on the card against the CPU's (values in [0, 1]; float32 sums
# in another order), absolute.
TOL_PRE = 1e-5
# The filtering path: the bilateral kernel against its plain version and the card's
# stencil against the CPU's, relative to max|ref| (float32 sums of 121-125 taps in another
# order, exp2 on the card's special-function unit); the bilateral grid and the CRF against
# the CPU, absolute (the splat's scatter-add sums in another order on the card).
TOL_BILATERAL, TOL_GRID = 1e-5, 1e-4
FILTER_TIMED = 5  # calls timed per stage, after one warm-up
CROP_3D, CROP_SLICES, CROP_CRF = (64, 64, 48), (8, 128, 128), (48, 48, 40)  # centre crops for the CPU

# The training path (bench.py unet_train): batch, patch, warm-up and timed iterations; the
# launches a step of each kernel (conv forward + dx, dw, norm forward, norm backward)
TRAIN_BATCH, TRAIN_WARMUP, TRAIN_TIMED = 4, 3, 20
TRAIN_PER_STEP = {"conv3d_3x3_same": 20, "conv3d_3x3_wgrad": 10, "instance_norm_prelu": 17,
                  "instance_norm_prelu_backward": 17}
# A batch-1 step against the CPU step (train_step_check says how each is held): float32 on
# the card (TF32 off), each grad's max error relative to its max|ref| (sums in another
# order through ~40 layers forward and back), or STEP_FLOOR_RATIO times the CPU's own change
# under a 1e-7 change of the input where the PReLU's kink is in the net; the bfloat16 amp
# step, the loss relative and each grad's cosine similarity. With random weights and
# random labels the grads are sums with much cancellation, and the port's own CPU bfloat16
# step reaches a cosine of only 0.981-0.996 to the float32 one at the deep convs' weights
# (96^3, batch 1, seed 11). So a grad passes at MIN_STEP_COSINE, or where its distance
# from 1 is at most STEP_COSINE_RATIO times the CPU bfloat16 step's own.
TOL_STEP_F32, TOL_STEP_LOSS_BF16, MIN_STEP_COSINE = 1e-3, 1e-2, 0.99
STEP_FLOOR_RATIO, STEP_COSINE_RATIO = 10.0, 2.0

# The card's peaks (NVIDIA H100 SXM data sheet): memory 3.35 TB/s; dense bf16 989 TFLOP/s
# on the tensor cores, float32 67 TFLOP/s outside them.
HBM_BYTES_S, PEAK_FLOPS = 3.35e12, {torch.bfloat16: 989e12, torch.float32: 67e12}
TF32_FLOPS = 495e12  # the tensor cores' dense TF32 rate


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def cuda_ms(fn, iters: int = 30, warmup: int = 3) -> float:
    """Mean device time of fn() in ms, by CUDA events around `iters` back-to-back calls."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def paired_ms(kernel, plain, iters: int = 30) -> tuple[float, float]:
    """(kernel ms, plain ms), timed in turns plain, kernel, kernel, plain."""
    p1, k1, k2, p2 = (cuda_ms(f, iters) for f in (plain, kernel, kernel, plain))
    return (k1 + k2) / 2, (p1 + p2) / 2


def rel_err(got: torch.Tensor, ref: torch.Tensor) -> tuple[float, float]:
    err = (got.float() - ref.float()).abs().max().item()
    return err, err / max(ref.float().abs().max().item(), 1e-30)


def bound(nbytes: float, flops: float, dtype: torch.dtype) -> tuple[float, float]:
    """(ms for the bytes at the memory rate, ms for the operations at the type's peak)."""
    return nbytes / HBM_BYTES_S * 1e3, flops / PEAK_FLOPS[dtype] * 1e3


def bound_tf32x3(nbytes: float, flops: float) -> tuple[float, float]:
    """(ms for the bytes at the memory rate, ms for float32 products run as 3xTF32, three
    TF32 products each, at the tensor cores' TF32 peak): the bound of a float32 kernel whose
    products run on the tensor cores."""
    return nbytes / HBM_BYTES_S * 1e3, 3 * flops / TF32_FLOPS * 1e3


def _wrappers():
    from monai_tpu_torch.networks.layers.fast_norm import instance_norm_prelu
    from monai_tpu_torch.ops.bilateral import bilateral_stencil
    from monai_tpu_torch.ops.conv3d import conv3d_3x3_same
    from monai_tpu_torch.ops.separable_resample import separable_resample_3d
    from monai_tpu_torch.ops.window_attention import fused_window_attention

    return conv3d_3x3_same, instance_norm_prelu, fused_window_attention, separable_resample_3d, bilateral_stencil


def _backward_wrappers():
    from monai_tpu_torch.networks.layers.fast_norm import instance_norm_prelu_backward
    from monai_tpu_torch.ops.conv3d import conv3d_3x3_wgrad

    return conv3d_3x3_wgrad, instance_norm_prelu_backward


def _attention_backward():
    from monai_tpu_torch.ops.window_attention import fused_window_attention_backward

    return fused_window_attention_backward


def launch_counts() -> tuple[int, ...]:
    return tuple(w.launches for w in _wrappers())


def all_launch_counts() -> dict:
    """Every kernel wrapper's launches, by its name."""
    return {w.__name__: w.launches for w in (*_wrappers(), *_backward_wrappers(), _attention_backward())}


def reset_launch_counts() -> None:
    for w in (*_wrappers(), *_backward_wrappers(), _attention_backward()):
        w.launches = 0
    _wrappers()[3].cuda_launches = 0  # the resample's CUDA launches, which its C function counts


def record_sites(net, window):
    """The shapes a path gives each kernel, read off one forward by hooks: Counters of
    (CI, CO, spatial) per 3x3x3 conv, (C, spatial, affine, slope) per norm and
    (windows, heads, tokens, head dim, mask rows) per window attention; and the
    attention masks by their row count."""
    from monai_tpu_torch.networks.blocks.convolutions import Convolution
    from monai_tpu_torch.networks.layers.factories import Conv3d
    from monai_tpu_torch.networks.layers.fast_norm import InstanceNorm
    from monai_tpu_torch.networks.nets.swin_unetr import WindowAttention

    convs, norms, attns, masks, hooks = [], [], [], {}, []

    def on_conv(mod, inp, out):
        convs.append((mod.in_channels, mod.out_channels, tuple(inp[0].shape[2:])))

    def on_fused(mod, inp, out):  # UNet: Convolution runs N -> D(0) -> PReLU as one launch
        norms.append((out.shape[1], tuple(out.shape[2:]), mod.adn.N.affine, float(mod.adn.A.weight)))

    def on_norm(mod, inp, out):  # SwinUNETR: InstanceNorm, a LeakyReLU slope fused in or none
        norms.append((out.shape[1], tuple(out.shape[2:]), mod.affine, float(inp[1]) if len(inp) > 1 else None))

    def on_attn(mod, inp, out):
        x, mask = inp
        b, n, c = x.shape
        nw = None if mask is None else mask.shape[0]
        attns.append((b, mod.num_heads, n, c // mod.num_heads, nw))
        if mask is not None:
            masks[nw] = mask

    for m in net.modules():
        if isinstance(m, Conv3d) and m.same_3x3x3:
            hooks.append(m.register_forward_hook(on_conv))
        elif isinstance(m, Convolution) and m.fused_norm_prelu:
            hooks.append(m.register_forward_hook(on_fused))
        elif isinstance(m, InstanceNorm):
            hooks.append(m.register_forward_hook(on_norm))
        elif isinstance(m, WindowAttention):
            hooks.append(m.register_forward_hook(on_attn))
    net(window)
    for h in hooks:
        h.remove()
    return Counter(convs), Counter(norms), Counter(attns), masks


def _summary(rows: list[tuple]) -> dict:
    """rows of (count, max abs err, kernel ms, plain ms, library ms or None, bytes ms,
    operations ms) -> the kernels-line numbers for one forward (or volume): worst error,
    summed times, the summed per-site bound and which side bounds the sum."""
    lib = [None if r[4] is None else r[0] * r[4] for r in rows]
    out = {"max_abs_err": max((r[1] for r in rows), default=0.0), "ms": sum(r[0] * r[2] for r in rows),
           "plain_ms": sum(r[0] * r[3] for r in rows), "bound_ms": sum(r[0] * max(r[5], r[6]) for r in rows),
           "library_ms": None if any(v is None for v in lib) else sum(lib),
           "bytes_ms": sum(r[0] * r[5] for r in rows), "ops_ms": sum(r[0] * r[6] for r in rows)}
    return _bound_by(out)


def _bound_by(summary: dict) -> dict:
    summary["bound_by"] = "bytes" if summary["bytes_ms"] >= summary["ops_ms"] else "operations"
    return summary


def check_conv(sites: Counter, batch: int, dev, timed: torch.dtype = torch.bfloat16, checked=None) -> dict:
    """Every site in bfloat16, float32 and float16 (or the ``checked`` types); the ``timed``
    type also timed against the plain version and cuDNN's ``F.conv3d`` on channel-first
    tensors (the library call; float32 in full float32, ``full_float32``)."""
    from monai_tpu_torch.ops.conv3d import conv3d_3x3_same, conv3d_3x3_same_plain
    from monai_tpu_torch.utils.backend import full_float32

    g = torch.Generator(device=dev).manual_seed(2)
    rows = []
    for (ci, co, sp), count in sorted(sites.items()):
        for dtype, tol in checked or CHECKED:
            x = torch.randn((batch, *sp, ci), generator=g, device=dev).to(dtype)
            w = (torch.randn((3, 3, 3, ci, co), generator=g, device=dev) / (27 * ci) ** 0.5).to(dtype)
            b = torch.randn((co,), generator=g, device=dev).to(dtype)
            got, ref = conv3d_3x3_same(x, w, b), conv3d_3x3_same_plain(x, w, b)
            torch.cuda.synchronize()
            err, rel = rel_err(got, ref)
            require(rel <= tol, f"conv {ci}->{co} @{sp} {dtype}: max err {err:.3g} = {rel:.3g} x max|ref| > {tol}")
            msg = f"conv {ci:3d}->{co:3d} @{sp} x{count} {str(dtype)[6:]:8s} max_abs_err {err:.4g} ({rel:.3g} of max|ref|, tol {tol})"
            if dtype == timed:
                k_ms, p_ms = paired_ms(lambda: conv3d_3x3_same(x, w, b), lambda: conv3d_3x3_same_plain(x, w, b))
                xc, wc = x.permute(0, 4, 1, 2, 3).contiguous(), w.permute(4, 3, 0, 1, 2).contiguous()
                with full_float32(x):
                    lib_ms = cuda_ms(lambda: F.conv3d(xc, wc, b, padding=1))
                size = x.element_size()
                b_ms, o_ms = bound((x.numel() + w.numel() + b.numel() + got.numel()) * size,
                                   2.0 * batch * np.prod(sp) * 27 * ci * co, dtype)
                rows.append((count, err, k_ms, p_ms, lib_ms, b_ms, o_ms))
                msg += (f"  kernel {k_ms:.4f} ms  plain {p_ms:.4f} ms  cuDNN {lib_ms:.4f} ms  "
                        f"bound {max(b_ms, o_ms):.4f} ms")
            print(msg, flush=True)
    return _summary(rows)


def check_norm(sites: Counter, batch: int, dev) -> dict:
    """Every site in bfloat16, float32 and float16; bfloat16 also timed against the plain
    version and the library call ``F.instance_norm(x, w, b, eps=1e-5)`` on the same
    channels-last tensor, which computes the norm and its affine but not the slope. Each
    line names the kernel's plan (path, blocks, bytes a load, groups of units) and the
    share of the bound the kernel reaches."""
    from monai_tpu_torch.networks.layers.fast_norm import (_card, instance_norm_plan, instance_norm_prelu,
                                                           instance_norm_prelu_plain)

    g = torch.Generator(device=dev).manual_seed(3)
    rows = []
    for (c, sp, affine, slope), count in sorted(sites.items(), key=str):
        for dtype, tol in CHECKED:
            x = (torch.randn((batch, c, *sp), generator=g, device=dev) * 3 + 1).to(dtype)
            x = x.contiguous(memory_format=torch.channels_last_3d)
            w = (torch.rand((c,), generator=g, device=dev) + 0.5).to(dtype) if affine else None
            b = torch.randn((c,), generator=g, device=dev).to(dtype) if affine else None
            a = None if slope is None else torch.full((1,), slope, device=dev, dtype=dtype)
            t0 = time.perf_counter()
            got = instance_norm_prelu(x, w, b, a)
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t0
            ref = instance_norm_prelu_plain(x, w, b, a)
            err, rel = rel_err(got, ref)
            require(rel <= tol, f"norm C={c} @{sp} {dtype}: max err {err:.3g} = {rel:.3g} x max|ref| > {tol}")
            card, occupancy = _card(dev.index or 0)
            plan = instance_norm_plan(batch, c, int(np.prod(sp)), dtype, x.data_ptr() % 16 == 0, card, occupancy)
            msg = (f"norm C={c:3d} @{sp} affine {affine} slope {slope} x{count} {str(dtype)[6:]:8s} max_abs_err "
                   f"{err:.4g} ({rel:.3g} of max|ref|, tol {tol})  first call {first_s:.2f} s  plan {plan['path']}, "
                   f"{plan['blocks']} blocks, {plan['vec_bytes']} B a load, {plan['units_per_group']} units a "
                   f"group x {plan['unit_groups']}")
            if dtype == torch.bfloat16:
                k_ms, p_ms = paired_ms(lambda: instance_norm_prelu(x, w, b, a),
                                       lambda: instance_norm_prelu_plain(x, w, b, a))
                lib_ms = cuda_ms(lambda: F.instance_norm(x, weight=w, bias=b, eps=1e-5))
                # reads x once, writes y once; ~10 operations an element are far below the peak
                b_ms, o_ms = bound(2 * x.numel() * x.element_size(), 10.0 * x.numel(), torch.float32)
                rows.append((count, err, k_ms, p_ms, lib_ms, b_ms, o_ms))
                msg += (f"  kernel {k_ms:.4f} ms  plain {p_ms:.4f} ms  F.instance_norm (no slope) {lib_ms:.4f} ms  "
                        f"bound {max(b_ms, o_ms):.4f} ms ({max(b_ms, o_ms) / k_ms * 100:.1f}% of it)")
            print(msg, flush=True)
    return _summary(rows)


def check_attention(sites: Counter, masks: dict, dev) -> dict:
    """Every site, plus two that are not counted in the per-forward sums: the first
    stage's masked site at head dim 16 (feature size 48), and a 9^3 window (N = 729) at
    head dim 12 (feature size 36) under a random mask of 8 rows, which the kernel's
    generic instance runs. Each line names the kernel's instance (mma on the tensor
    cores, fma, generic) and the windows a block walks over. The library call is
    ``F.scaled_dot_product_attention`` with bias + mask as one additive mask in the input's
    type (built before the timing). The bound is the largest of the bytes (q, k, v, out,
    bias and mask once), the products' operations and the exps, one a score at the card's
    exp rate; the kernels line files the exps under "operations"."""
    from monai_tpu_torch.ops.window_attention import (fused_window_attention, fused_window_attention_plain,
                                                      window_attention_plan)

    rate = exp_per_s()
    exp_total = 0.0
    g = torch.Generator(device=dev).manual_seed(5)
    first = max(s for s in sites if s[4] is not None)
    extra = {(first[0], first[1], first[2], 16, first[4]): 0, (96, 3, 729, 12, 8): 0}
    masks = {(nw, m.shape[1]): m for nw, m in masks.items()}  # by (rows, tokens)
    masks[8, 729] = (torch.rand((8, 729, 729), generator=g, device=dev) > 0.5).float() * -100.0
    rows = []
    for (b, h, n, d, nw), count in sorted(sites.items(), key=str) + list(extra.items()):
        for dtype, tol in CHECKED:
            q, k, v = (torch.randn((b, h, n, d), generator=g, device=dev).to(dtype) for _ in range(3))
            bias = torch.randn((h, n, n), generator=g, device=dev) * 0.5
            mask = None if nw is None else masks[nw, n]
            plan = window_attention_plan(q, k, v, bias, mask)
            got = fused_window_attention(q, k, v, bias, mask)
            torch.cuda.synchronize()
            ref = fused_window_attention_plain(q, k, v, bias, mask)
            err, rel = rel_err(got, ref)
            require(rel <= tol, f"attention {(b, h, n, d, nw)} {dtype}: max err {err:.3g} = {rel:.3g} x max|ref| > {tol}")
            msg = (f"attention windows {b} heads {h} N {n} D {d} mask rows {nw} x{count} {str(dtype)[6:]:8s} "
                   f"max_abs_err {err:.4g} ({rel:.3g} of max|ref|, tol {tol})  instance {plan['instance']}, "
                   f"{plan['windows_per_block']} windows a block, {plan['blocks']} blocks")
            if dtype == torch.bfloat16:
                k_ms, p_ms = paired_ms(lambda: fused_window_attention(q, k, v, bias, mask),
                                       lambda: fused_window_attention_plain(q, k, v, bias, mask), iters=10)
                groups = 1 if nw is None else nw
                add = (bias if nw is None else bias[None] + mask[:, None]).to(dtype)  # (nW, H, N, N) or (H, N, N)
                qs, ks, vs = (t.view(b // groups, groups, h, n, d) if nw else t for t in (q, k, v))
                lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=add, scale=1.0),
                                 iters=10)
                nbytes = 4 * q.numel() * q.element_size() + bias.numel() * 4 + (0 if mask is None else mask.numel() * 4)
                b_ms, o_ms = bound(nbytes, 4.0 * b * h * n * n * d, dtype)
                e_ms = b * h * n * n / rate * 1e3
                rows.append((count, err, k_ms, p_ms, lib_ms, b_ms, max(o_ms, e_ms)))
                exp_total += count * e_ms
                sides = {"bytes": b_ms, "FLOP": o_ms, "exp": e_ms}
                side = max(sides, key=sides.get)
                msg += (f"  kernel {k_ms:.4f} ms  plain {p_ms:.4f} ms  SDPA {lib_ms:.4f} ms  bound {sides[side]:.4f} "
                        f"ms ({side}; bytes {b_ms:.4f}, FLOP {o_ms:.4f}, exp {e_ms:.4f} at {rate:.4g}/s)")
                del add, qs, ks, vs
            print(msg, flush=True)
            del q, k, v, got, ref
    out = _summary(rows)
    out["bound_side"] = "exp" if exp_total >= out["bytes_ms"] else out["bound_by"]
    return out


def _diag(scales, offsets) -> np.ndarray:
    m = np.diag([*scales, 1.0])
    m[:3, 3] = offsets
    return m


def spacing_matrix() -> np.ndarray:
    """The Spacing op of the path's CT: output voxel (1.5, 1.5, 2.0) mm to input voxel."""
    return _diag([p / s for p, s in zip(PIXDIM, CT_SPACING)], [0.0, 0.0, 0.0])


def _grid_sample_fn(x: torch.Tensor, m: np.ndarray, out_shape, mode: str):
    """``F.grid_sample`` (5-D, border, align_corners=True) on a precomputed grid of the
    diagonal affine ``m``: the library call that computes the resample at order 1 (and,
    but for ties at half a voxel, order 0)."""
    axes = []
    for d in range(3):
        n_in = x.shape[1 + d]
        c = m[d, d] * torch.arange(out_shape[d], device=x.device, dtype=torch.float64) + m[d, 3]
        axes.append((2 * c / max(n_in - 1, 1) - 1).float())
    gz, gy, gx = torch.meshgrid(*axes, indexing="ij")
    grid = torch.stack((gx, gy, gz), dim=-1)[None]  # grid_sample takes (x, y, z) = (last axis first)
    x5 = x[None]
    return lambda: F.grid_sample(x5, grid, mode=mode, padding_mode="border", align_corners=True)[0]


def check_resample(dev) -> dict:
    """The separable resample at the path's two sites (a CT-like volume through Spacing at
    order 1; a label map back at order 0), timed against the plain version and
    ``F.grid_sample``, each on the route, tile and contraction order ``resample_plan``
    gives, in one CUDA launch; and every order x bound, upsampling and downsampling, at odd
    extents, and a shape whose bricks do not fit (800x along x) on the axes route.
    Returns the kernels-line numbers of the Spacing site, with the inverse site's time,
    plain time, bound and share of it, and the worst error of all."""
    from monai_tpu_torch.ops.separable_resample import (_launch, resample_plan, separable_resample_3d,
                                                        separable_resample_3d_plain)

    def run(x, m, out, order, bnd, ac=False):
        """One call, checked against the plan's route and CUDA launches; (output, plan)."""
        plan = resample_plan(x.shape, out, m, order, bnd, ac)
        before = separable_resample_3d.cuda_launches
        got = separable_resample_3d(x, m, out, order, bnd, ac)
        torch.cuda.synchronize()
        require(separable_resample_3d.cuda_launches - before == plan.launches,
                f"resample {tuple(x.shape)} -> {out}: {separable_resample_3d.cuda_launches - before} CUDA launches "
                f"on the {plan.route} route, not {plan.launches}")
        return got, plan

    g = torch.Generator(device=dev).manual_seed(6)
    worst = 0.0
    for name, m, shape, out, route in (
            ("up", _diag([0.45, 0.7, 0.38], [0.3, -0.6, 0.1]), (1, 61, 47, 53), (133, 66, 138), "fused"),
            ("down", _diag([1.7, 2.3, 1.9], [-0.4, 0.5, 0.2]), (2, 61, 47, 53), (35, 21, 27), "fused"),
            ("axes", _diag([2.0, 2.0, 800.0], [0.1, 0.2, 3.0]), (2, 5, 5, 16000), (2, 2, 20), "axes")):
        x = torch.randn(shape, generator=g, device=dev)
        plans = Counter()
        for order in (0, 1, 3):
            for bnd in ("zeros", "border", "reflection"):
                for ac in (False, True):
                    got, plan = run(x, m, out, order, bnd, ac)
                    require(plan.route == route, f"resample {name}: the {plan.route} route, not {route}")
                    plans[plan.route, plan.tile] += 1
                    ref = separable_resample_3d_plain(x, m, out, order, bnd, ac)
                    err, rel = rel_err(got, ref)
                    worst = max(worst, err)
                    require(torch.equal(got, ref) if order == 0 else rel <= TOL_RESAMPLE,
                            f"resample {name} order {order} {bnd} align {ac}: max err {err:.3g} ({rel:.3g})")
        print(f"resample grid {name} {tuple(shape)} -> {out}: orders 0/1/3 x zeros/border/reflection x "
              f"align_corners, order 0 bit-identical, worst max_abs_err {worst:.4g}; route and tile (cases): "
              + ", ".join(f"{r} {t} ({n})" for (r, t), n in sorted(plans.items())), flush=True)

    m = spacing_matrix()
    inv = np.linalg.inv(m)
    ct = (torch.randn((1, *CT_SHAPE), generator=g, device=dev) * 200 - 300).round()
    labels = (torch.rand(SPLEEN_PRE, generator=g, device=dev) > 0.7).float()
    rows = []
    for name, x, mat, out, order, mode in (("Spacing", ct, m, SPLEEN_PRE[1:], 1, "bilinear"),
                                           ("inverse", labels, inv, CT_SHAPE, 0, "nearest")):
        got, plan = run(x, mat, out, order, "border")
        require(plan.route == "fused", f"resample {name} site: the {plan.route} route, not the fused one")
        ref = separable_resample_3d_plain(x, mat, out, order, "border")
        err, rel = rel_err(got, ref)
        worst = max(worst, err)
        require(torch.equal(got, ref) if order == 0 else rel <= TOL_RESAMPLE,
                f"resample {name} site: max err {err:.3g} ({rel:.3g})")
        lib = _grid_sample_fn(x, mat, out, mode)
        lib_err = (lib() - ref).abs().max().item()
        k_ms, p_ms = paired_ms(lambda: separable_resample_3d(x, mat, out, order, "border"),
                               lambda: separable_resample_3d_plain(x, mat, out, order, "border"), iters=20)
        lib_ms = cuda_ms(lib, iters=20)
        flops = 2.0 * plan.taps * x.shape[0] * sum(  # each contraction's outputs, taps each
            np.prod([out[d] if d in plan.order[:k + 1] else x.shape[1 + d] for d in range(3)])
            for k in range(len(plan.order)))
        b_ms, o_ms = bound(plan.bytes_bound, flops, torch.float32)
        rows.append((1, err, k_ms, p_ms, lib_ms, b_ms, o_ms))
        sweep = []  # the plan's tile against others, each checked and timed the same way
        for tile in (plan.tile, *RESAMPLE_SWEEP[name]):
            alt = resample_plan(x.shape, out, mat, order, "border", tile=tile)
            alt_out = _launch(x, alt)
            torch.cuda.synchronize()
            require(torch.equal(alt_out, got) if order == 0 else rel_err(alt_out, ref)[1] <= TOL_RESAMPLE,
                    f"resample {name} site at tile {tile}: disagrees with the plain version")
            sweep.append(f"{tile} {cuda_ms(lambda: _launch(x, alt), iters=20):.4f} ms ({alt.smem} B, "
                         f"{alt.bytes_fused / 1e6:.1f} MB)")
        print(f"resample {name} site, tiles (the plan's first; launch only, without the wrapper's checks): "
              + "; ".join(sweep), flush=True)
        print(f"resample {name} site {tuple(x.shape)} -> {tuple(out)} order {order} border: {plan.route} route, "
              f"tile {plan.tile}, band {plan.band}, contraction order {plan.order}, {plan.smem} B shared memory, "
              f"{np.prod(plan.tiles)} blocks, bricks and output {plan.bytes_fused / 1e6:.1f} MB against the bound's "
              f"{plan.bytes_bound / 1e6:.1f} MB (a pass an axis: {plan.bytes_axes / 1e6:.1f} MB); max_abs_err "
              f"{err:.4g} ({'bit-identical' if order == 0 else f'{rel:.3g} of max|ref|, tol {TOL_RESAMPLE}'})  "
              f"kernel {k_ms:.4f} ms ({plan.bytes_bound / k_ms / 1e6:.0f} GB/s over the bound's bytes, "
              f"{max(b_ms, o_ms) / k_ms * 100:.1f}% of the bound)  plain {p_ms:.4f} ms  grid_sample {lib_ms:.4f} ms "
              f"(max |diff| to plain {lib_err:.4g})  bound {max(b_ms, o_ms):.4f} ms", flush=True)
    # the kernels line holds the Spacing site, which F.grid_sample computes; at the inverse
    # site grid_sample's nearest mode rounds half-voxel ties to even, the resample up, so
    # its time there is printed but is no library time of the same function
    whole = _summary(rows)
    print(f"resample per volume (both sites): kernel {whole['ms']:.4f} ms  plain {whole['plain_ms']:.4f} ms  "
          f"bound {whole['bound_ms']:.4f} ms", flush=True)
    summary = _summary(rows[:1])
    summary["max_abs_err"] = worst
    inv_row = rows[1]
    summary.update(inverse_ms=inv_row[2], inverse_plain_ms=inv_row[3], inverse_bound_ms=max(inv_row[5], inv_row[6]),
                   inverse_bound_share=max(inv_row[5], inv_row[6]) / inv_row[2])
    return summary


def sliding_window(name: str, inferer, net, per_forward: tuple[int, ...], timing: tuple[int, int], dev,
                   out_channels: int) -> tuple[tuple[int, ...], int]:
    """The path's inferer over 224x224x112 bf16 volumes; returns the launch counts of the
    run and its number of forwards."""
    n_latency, n_throughput = timing
    gv = torch.Generator(device=dev).manual_seed(4)
    vols = [torch.rand((1, 1, *VOLUME), generator=gv, device=dev).to(torch.bfloat16) for _ in range(3)]
    calls = 0

    def predictor(w):
        nonlocal calls
        calls += 1
        return net(w)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launch_counts()
    out = inferer(vols[0], predictor)  # warm-up
    lat = []
    for i in range(n_latency):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = inferer(vols[i % 3], predictor)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    for i in range(n_throughput):
        out = inferer(vols[i % 3], predictor)
    torch.cuda.synchronize()
    vols_per_s = n_throughput / (time.perf_counter() - t0)
    counts = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    print(f"{name} sliding window {VOLUME}: out {tuple(out.shape)} {out.dtype}; {vols_per_s:.3f} vols/s "
          f"({n_throughput} volumes back to back); latency median {statistics.median(lat) * 1e3:.2f} ms "
          f"(min {min(lat) * 1e3:.2f}, {n_latency} runs); peak memory {peak_gb:.2f} GB; {calls} forwards, "
          f"launches conv {counts[0]}, norm {counts[1]}, attention {counts[2]}, resample {counts[3]}, bilateral "
          f"{counts[4]}", flush=True)
    require(tuple(out.shape) == (1, out_channels, *VOLUME) and bool(torch.isfinite(out).all()),
            f"{name} sliding-window output is not finite (1, {out_channels}, 224, 224, 112)")
    n_volumes = 1 + n_latency + n_throughput
    require(calls == n_volumes * N_WINDOWS // inferer.sw_batch_size, f"{name}: {calls} forwards for {n_volumes} volumes")
    require(counts == tuple(n * calls for n in per_forward), f"{name}: {calls} forwards launched {counts} kernels")
    require(all(c > 0 for c, n in zip(counts, per_forward) if n), f"{name}: a kernel of the path never launched")
    return counts, calls


def forward_check(name: str, net_cpu, net_f32, low: dict, per_forward: tuple[int, ...], dev) -> None:
    """One forward on a 96³ window on the card, float32 and each of ``low``'s types
    ({dtype: net}, bfloat16 and float16), against the CPU; the launch counts of each
    forward (every kernel of the path launches its instance of the type)."""
    window = torch.rand((1, 1, *ROI), generator=torch.Generator().manual_seed(1))
    ref = net_cpu(window)
    std = ref.std().item()
    reset_launch_counts()
    out_f32 = net_f32(window.to(dev)).cpu()
    counts = launch_counts()
    d32 = (out_f32 - ref).abs()
    msg = (f"{name} forward 96^3: logit std {std:.4g}; f32 card max err {d32.max().item():.4g} "
           f"({d32.max().item() / std:.3g} std, tol {TOL_FWD_F32_MAX})")
    require(tuple(out_f32.shape) == tuple(ref.shape) and bool(torch.isfinite(out_f32).all()),
            f"{name} f32 forward output is not finite {tuple(ref.shape)}")
    require(d32.max().item() / std <= TOL_FWD_F32_MAX, f"{name} f32 card forward disagrees with the CPU")
    require(counts == per_forward, f"{name}: one f32 forward launched {counts}, not {per_forward} kernels")
    for dtype, net in low.items():
        reset_launch_counts()
        out = net(window.to(dev, dtype)).float().cpu()
        counts = launch_counts()
        d16 = (out - ref).abs()
        agree = (out.argmax(1) == ref.argmax(1)).float().mean().item()
        tag = str(dtype)[6:]
        msg += (f"; {tag} card mean err {d16.mean().item():.4g} ({d16.mean().item() / std:.3g} std, tol "
                f"{TOL_FWD_MEAN[dtype]}), max {d16.max().item():.4g}; argmax agreement {agree:.5f} "
                f"(min {MIN_ARGMAX_AGREE})")
        require(tuple(out.shape) == tuple(ref.shape) and bool(torch.isfinite(out).all()),
                f"{name} {tag} forward output is not finite {tuple(ref.shape)}")
        require(d16.mean().item() / std <= TOL_FWD_MEAN[dtype], f"{name} {tag} card forward disagrees with the CPU")
        require(agree >= MIN_ARGMAX_AGREE, f"{name} {tag} argmax disagrees with the CPU")
        require(counts == per_forward, f"{name}: one {tag} forward launched {counts}, not {per_forward} kernels")
    print(msg + f"; launches per forward (each type): conv {counts[0]}, norm {counts[1]}, attention {counts[2]}",
          flush=True)


def write_ct(path: Path) -> None:
    """A 512x512x90 int16 abdominal CT phantom at (0.79, 0.79, 5.0) mm, stored as the
    usual Task09 header does (x and y flipped: affine diag(-0.79, -0.79, 5.0)): air at
    -1000 HU, an elliptic body at 40 HU, a spleen-like ellipsoid 60 HU brighter, and
    noise of 25 HU, from seed 0."""
    from monai_tpu_torch.data import write_nifti

    rng = np.random.default_rng(0)
    x, y, z = (np.linspace(-1, 1, n, dtype=np.float32) for n in CT_SHAPE)
    x, y, z = x[:, None, None], y[None, :, None], z[None, None, :]
    hu = np.where(x ** 2 / 0.8 + y ** 2 / 0.55 < 1, 40.0, -1000.0).astype(np.float32)
    hu = hu + np.where(((x - 0.45) ** 2 + (y + 0.25) ** 2) / 0.02 + z ** 2 / 0.25 < 1, 60.0, 0.0).astype(np.float32)
    hu = hu + rng.normal(0.0, 25.0, CT_SHAPE).astype(np.float32)
    path.parent.mkdir(parents=True, exist_ok=True)
    write_nifti(hu.astype(np.int16), path, affine=np.diag([-CT_SPACING[0], -CT_SPACING[1], CT_SPACING[2], 1.0]))


def spleen_pipelines(device):
    """The bundle's preprocessing and postprocessing (configs/inference.json), up to the
    inverted label map; SaveImaged is not ported."""
    from monai_tpu_torch.transforms import (Activationsd, AsDiscreted, Compose, EnsureChannelFirstd, Invertd,
                                            LoadImaged, Orientationd, ScaleIntensityRanged, Spacingd)

    pre = Compose([LoadImaged("image", device=device), EnsureChannelFirstd("image"),
                   Orientationd("image", axcodes="RAS"), Spacingd("image", pixdim=list(PIXDIM), mode="bilinear"),
                   ScaleIntensityRanged("image", a_min=-57, a_max=164, b_min=0.0, b_max=1.0, clip=True)])
    post = Compose([Activationsd("pred", softmax=True), AsDiscreted("pred", argmax=True),
                    Invertd("pred", transform=pre, orig_keys="image", nearest_interp=True)])
    return pre, post


def spleen_net(generator: torch.Generator):
    """The bundle's UNet (configs/inference.json: norm "batch") on the CPU, random weights
    and running statistics from the generator's seed; the output conv's bias is zero, so
    the argmax follows the data and not the bias."""
    from monai_tpu_torch.networks.nets import UNet

    net = UNet(3, 1, 2, channels=(16, 32, 64, 128, 256), strides=(2, 2, 2, 2), num_res_units=2, norm="batch",
               device="cpu", generator=generator)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, torch.nn.BatchNorm3d):
                c = m.num_features
                m.running_mean.copy_((torch.rand(c, generator=generator) - 0.5) * 0.2)
                m.running_var.copy_(torch.rand(c, generator=generator) * 0.1 + 0.05)
                m.weight.copy_(torch.rand(c, generator=generator) * 0.4 + 0.8)
                m.bias.copy_((torch.rand(c, generator=generator) - 0.5) * 0.2)
        net.model[2][1].conv.unit0.conv.bias.zero_()
    return net.eval()


def spleen_volume(pre, post, inferer, net) -> tuple[dict, dict, torch.Tensor, float]:
    """One volume through the path's entry points, from the file to the inverted label
    map: (the stages' seconds, the final dict, the argmax label map before the inverse,
    the whole wall seconds). Each stage ends in a synchronise."""
    stages, devices = {}, []

    def stage(name, fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        stages[name] = time.perf_counter() - t0
        return out

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    d = stage("load", lambda: pre({"image": str(CT_PATH)}, end=1))
    devices.append(d["image"].device)
    d = stage("channel_first_orientation", lambda: pre(d, start=1, end=3))
    devices.append(d["image"].device)
    d = stage("spacing", lambda: pre(d, start=3, end=4))
    devices.append(d["image"].device)
    d = stage("scale_intensity", lambda: pre(d, start=4))
    devices.append(d["image"].device)
    logits = stage("sliding_window", lambda: inferer(d["image"].data[None], net))
    devices.append(logits.device)
    d = stage("activations_argmax", lambda: post({**d, "pred": logits[0]}, end=2))
    labels = d["pred"]
    devices.append(labels.device)
    d = stage("invert", lambda: post(d, start=2))
    devices.append(d["pred"].device)
    wall = time.perf_counter() - t0
    require(all(dv.type == "cuda" for dv in devices), f"a stage of the spleen path left the card: {devices}")
    return stages, d, labels, wall


def spleen_path(dev) -> tuple[tuple[int, ...], dict, torch.Tensor, torch.Tensor, dict]:
    """Phase 5: the Spleen inference path on the card, then its checks against the CPU.
    Returns the launch counts, the kernels' summaries, the last volume's preprocessed
    image (1, 1, 270, 270, 224) and logits (1, 2, 270, 270, 224) for phase 6, and for
    phase 8 the path's pieces with the net on the CPU and its label map."""
    from monai_tpu_torch.data import read_nifti
    from monai_tpu_torch.data.utils import dense_patch_slices
    from monai_tpu_torch.inferers import SlidingWindowInferer, compute_scan_interval
    from monai_tpu_torch.transforms import Invertd

    t0 = time.perf_counter()
    write_ct(CT_PATH)
    print(f"spleen CT {CT_SHAPE} int16 at {CT_SPACING} mm written to {CT_PATH.relative_to(CT_PATH.parents[2])} "
          f"({CT_PATH.stat().st_size / 1e6:.1f} MB) in {time.perf_counter() - t0:.1f} s", flush=True)
    require(len(dense_patch_slices(SPLEEN_PRE[1:], ROI, compute_scan_interval(SPLEEN_PRE[1:], ROI, 3, (0.25,) * 3)))
            == SPLEEN_WINDOWS, f"the spleen volume should have {SPLEEN_WINDOWS} windows")
    net_cpu = spleen_net(torch.Generator().manual_seed(0))
    net = copy.deepcopy(net_cpu).to(dev)
    pre, post = spleen_pipelines(None)  # the card, by default
    inferer = SlidingWindowInferer(ROI, sw_batch_size=SPLEEN_BATCH, overlap=0.25)

    window = torch.rand((SPLEEN_BATCH, 1, *ROI), generator=torch.Generator(device=dev).manual_seed(1), device=dev)
    conv_sites, norm_sites, attn_sites, _ = record_sites(net, window)
    n_sites = (sum(conv_sites.values()), sum(norm_sites.values()), sum(attn_sites.values()))
    print(f"spleen sites per {SPLEEN_BATCH}-window forward: {n_sites[0]} 3x3x3 stride-1 convs (float32), "
          f"{n_sites[1]} instance norms, {n_sites[2]} window attentions", flush=True)
    require(n_sites == (10, 0, 0), f"the spleen UNet should have 10 conv sites and no norm kernel, not {n_sites}")
    conv = check_conv(conv_sites, SPLEEN_BATCH, dev, timed=torch.float32)
    resample = check_resample(dev)

    torch.cuda.synchronize()
    reset_launch_counts()
    spleen_volume(pre, post, inferer, net)  # warm-up
    torch.cuda.reset_peak_memory_stats(dev)
    runs = [spleen_volume(pre, post, inferer, net) for _ in range(SPLEEN_TIMED)]
    counts = launch_counts()
    resample_cuda = _wrappers()[3].cuda_launches
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    stages, d, labels, _ = runs[-1]
    med = {k: statistics.median(r[0][k] for r in runs) * 1e3 for k in stages}
    walls = [r[3] * 1e3 for r in runs]
    pre_ms = med["channel_first_orientation"] + med["spacing"] + med["scale_intensity"]
    decode = []
    for _ in range(3):  # the host's share of the load: gzip decode and header parse alone
        t0 = time.perf_counter()
        read_nifti(CT_PATH)
        decode.append(time.perf_counter() - t0)
    out, image = d["pred"], d["image"]
    print(f"spleen inference {CT_SHAPE} -> {tuple(image.shape)} -> {tuple(out.shape)} float32, medians of "
          f"{SPLEEN_TIMED} volumes (ms): load {med['load']:.2f} (read_nifti alone, host: median "
          f"{statistics.median(decode) * 1e3:.2f} of 3); preprocessing on the card {pre_ms:.2f} "
          f"(channel first + orientation {med['channel_first_orientation']:.2f}, Spacing {med['spacing']:.2f}, "
          f"scale intensity {med['scale_intensity']:.2f}); sliding window {med['sliding_window']:.2f}; "
          f"postprocessing {med['activations_argmax'] + med['invert']:.2f} (softmax + argmax "
          f"{med['activations_argmax']:.2f}, invert {med['invert']:.2f}); per volume {statistics.median(walls):.2f} "
          f"(min {min(walls):.2f}, max {max(walls):.2f}); peak memory {peak_gb:.2f} GB; label 1 on "
          f"{out.data.mean().item() * 100:.2f}% of the voxels; launches over {1 + SPLEEN_TIMED} volumes: conv "
          f"{counts[0]}, norm {counts[1]}, attention {counts[2]}, resample {counts[3]} ({resample_cuda} CUDA "
          f"launches), bilateral {counts[4]}", flush=True)
    n_volumes = 1 + SPLEEN_TIMED
    require(counts == tuple(n * n_volumes for n in SPLEEN_PER_VOLUME),
            f"spleen: {n_volumes} volumes launched {counts} kernels, not {SPLEEN_PER_VOLUME} each")
    require(resample_cuda == SPLEEN_PER_VOLUME[3] * n_volumes,
            f"spleen: the resample made {resample_cuda} CUDA launches, not one a site")
    file_affine = image.meta["original_affine"]
    require(tuple(image.shape) == SPLEEN_PRE, f"spleen preprocessed image {tuple(image.shape)}, not {SPLEEN_PRE}")
    require(tuple(out.shape) == (1, *CT_SHAPE) and np.abs(out.affine - file_affine).max() <= 1e-9,
            f"spleen labels {tuple(out.shape)} on affine {out.affine.tolist()}, not (1, 512, 512, 90) on the input's")
    require(bool(((out.data == 0) | (out.data == 1)).all()), "spleen labels are not 0 or 1")

    # against the CPU: the preprocessing of the same file, the inverse of the card's own labels
    pre_cpu, _ = spleen_pipelines("cpu")
    d_cpu = pre_cpu({"image": str(CT_PATH)})
    pre_err = (image.data.cpu() - d_cpu["image"].data).abs().max().item()
    aff_err = np.abs(image.affine - d_cpu["image"].affine).max()
    inv_cpu = Invertd("pred", transform=pre, orig_keys="image")({"image": image, "pred": labels.cpu()})["pred"]
    same = torch.equal(inv_cpu.data, out.data.cpu())
    print(f"spleen against the CPU: preprocessed image max abs err {pre_err:.4g} (tol {TOL_PRE}), affine "
          f"{aff_err:.3g}; inverse of the card's label map identical to the CPU's: {same}", flush=True)
    require(pre_err <= TOL_PRE and aff_err <= 1e-9, "the spleen preprocessing on the card disagrees with the CPU")
    require(same, "the spleen inverse on the card disagrees with the CPU's")
    forward_check("spleen", net_cpu, net, {}, (10, 0, 0, 0, 0), dev)
    logits = inferer(image.data[None], net)  # the last volume's, for phase 6
    resample["cuda_launches"] = resample_cuda
    path = {"pre": pre, "post": post, "inferer": inferer, "net": net, "net_cpu": net_cpu, "labels": out.data.cpu()}
    return counts, {"conv": conv, "resample": resample}, image.data[None], logits, path


def exp_per_s() -> float:
    """The card's exp rate: its SMs x 16 special-function results a clock (Hopper's
    throughput for ex2) x the SM clock's maximum that nvidia-smi reads (clocks.max.sm)."""
    mhz = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True).stdout.split()[0]
    return torch.cuda.get_device_properties(0).multi_processor_count * 16 * float(mhz) * 1e6


def centre_crop(x: torch.Tensor, size) -> torch.Tensor:
    """The centre ``size`` of the trailing axes of ``x``."""
    starts = [(n - s) // 2 for n, s in zip(x.shape[-len(size):], size)]
    return x[(...,) + tuple(slice(a, a + s) for a, s in zip(starts, size))]


def filter_stage(name: str, fn, per_call: int, dev) -> int:
    """One stage of the filtering path: a warm-up, then ``FILTER_TIMED`` synchronised calls;
    the median, the launch counts of all those calls (the bilateral kernel ``per_call``
    times a call, nothing else) and the peak memory. Returns the bilateral launches."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launch_counts()
    out = fn()
    times = []
    for _ in range(FILTER_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    counts = launch_counts()
    calls = 1 + FILTER_TIMED
    print(f"filtering {name}: out {tuple(out.shape)} {out.dtype}; median {statistics.median(times):.3f} ms of "
          f"{FILTER_TIMED} (min {min(times):.3f}); launches over {calls} calls: bilateral {counts[4]}, others "
          f"{counts[:4]}; peak memory {torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB", flush=True)
    require(counts == (0, 0, 0, 0, per_call * calls), f"filtering {name}: {calls} calls launched {counts}")
    require(bool(torch.isfinite(out).all()), f"filtering {name}: the output is not finite")
    return counts[4]


def check_bilateral(name: str, x: torch.Tensor, ss: float, cs: float, rate: float) -> dict:
    """The bilateral kernel against its plain version at a stage's full size: max error,
    both times and the bound, the larger of the bytes (the input read once, the output
    written once), the float32 operations and the exps, counted as the least the function
    needs. A tap's weight ws(o) wc(o, v) is symmetric in the pair (v, v + o), so a voxel's
    T taps need one weight per pair, (T - 1) / 2 of them, and none for the centre (weight
    1): an exp and 4 operations each (difference, square, scale, spatial factor); every
    tap off the centre adds w x and w to the sums, 3 operations (edge voxels are counted
    as interior ones). The exps a voxel are those the kernel's checked build counts on
    the card, which must equal the plan's, as must the blocks an SM holds. The segment sweep times the kernel at the plan's
    segments times 1/2 to 2 (information: the plan's wave threshold is fitted to it)."""
    from monai_tpu_torch.ops.bilateral import (bilateral_exps, bilateral_plan, bilateral_stencil,
                                               bilateral_stencil_plain, card_resident, filter_radius)

    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    plan = bilateral_plan(tuple(x.shape), filter_radius(ss), sms)
    got, ref = bilateral_stencil(x, ss, cs), bilateral_stencil_plain(x, ss, cs)
    counted, exps = bilateral_exps(x, ss, cs)
    torch.cuda.synchronize()
    err, rel = rel_err(got, ref)
    require(rel <= TOL_BILATERAL, f"bilateral {name}: max err {err:.3g} = {rel:.3g} x max|ref| > {TOL_BILATERAL}")
    require(rel_err(counted, ref)[1] <= TOL_BILATERAL, f"bilateral {name}: the checked build disagrees")
    require(exps == plan["exps"], f"bilateral {name}: the kernel computed {exps} exps, the plan says {plan['exps']}")
    resident = card_resident(x.device, x.ndim - 2, filter_radius(ss), plan["warps_x"])
    require(resident == plan["resident"], f"bilateral {name}: an SM holds {resident} blocks, the plan says "
                                          f"{plan['resident']}")
    k_ms, p_ms = paired_ms(lambda: bilateral_stencil(x, ss, cs), lambda: bilateral_stencil_plain(x, ss, cs), iters=5)
    stream, nseg = x.shape[2], plan["tiles"][2]
    sweep = {}
    for seg in sorted({-(-stream // max(1, nseg * k // 4)) for k in (2, 3, 4, 6, 8)}, reverse=True):
        waves = bilateral_plan(tuple(x.shape), filter_radius(ss), sms, seg)["waves"]
        sweep[seg] = (waves, cuda_ms(lambda: bilateral_stencil(x, ss, cs, seg=seg), 10))
    print(f"bilateral {name} segments (steps: waves of resident blocks, ms; the plan's {plan['seg']}): " + ", ".join(
        f"{seg}: {w:.3f}, {t:.4f}" for seg, (w, t) in sweep.items()), flush=True)
    taps = (2 * filter_radius(ss) + 1) ** (x.ndim - 2)
    pairs = (taps - 1) // 2 * x.numel()
    b_ms, f_ms = bound(2 * x.numel() * 4, 4.0 * pairs + 3.0 * (taps - 1) * x.numel(), torch.float32)
    e_ms = pairs / rate * 1e3
    sides = {"bytes": b_ms, "FLOP": f_ms, "exp": e_ms}
    side = max(sides, key=sides.get)
    print(f"bilateral {name} {tuple(x.shape)} radius {filter_radius(ss)}: instance {plan['label']} ({plan['blocks']} "
          f"blocks of {plan['threads']}, {resident} an SM, {plan['seg']} steps a segment), exps a voxel {exps / x.numel():.2f} "
          f"counted on the card (the plan's {plan['exps_per_voxel']:.2f}, least {plan['least_exps']:.0f}); max_abs_err {err:.4g} ({rel:.3g} of max|ref|, tol {TOL_BILATERAL})  "
          f"kernel {k_ms:.4f} ms  plain {p_ms:.4f} ms  library none  bound {sides[side]:.4f} ms ({side}; bytes "
          f"{b_ms:.4f}, FLOP {f_ms:.4f}, exp {e_ms:.4f} at {rate:.4g}/s; {sides[side] / k_ms * 100:.1f}% of it)",
          flush=True)
    return {"max_abs_err": err, "ms": k_ms, "plain_ms": p_ms, "bound_ms": sides[side],
            "bound_by": "bytes" if side == "bytes" else "operations", "library_ms": None,
            "instance": plan["label"], "exps_per_voxel": exps / x.numel(), "bytes_ms": b_ms,
            "ops_ms": max(f_ms, e_ms)}


def filtering_path(dev, image: torch.Tensor, logits: torch.Tensor) -> dict:
    """Phase 6: the filtering entry points on the spleen path's data, then the kernel at
    the full sizes and each stage against the CPU on a crop. Returns the kernels-line
    entries of the 3-D (stage A) and 2-D (stage B) bilateral kernel."""
    from monai_tpu_torch.data import read_nifti
    from monai_tpu_torch.networks.blocks import CRF
    from monai_tpu_torch.networks.layers import BilateralFilter
    from monai_tpu_torch.transforms import ScaleIntensityRange

    raw, _ = read_nifti(CT_PATH)  # (512, 512, 90) int16, x fastest
    hu = torch.from_numpy(np.ascontiguousarray(raw.transpose(2, 1, 0))).to(dev)  # (90, 512, 512), axial slices
    slices = ScaleIntensityRange(a_min=-57, a_max=164, b_min=0.0, b_max=1.0, clip=True)(hu)[:, None].contiguous()
    del hu
    rate = exp_per_s()
    stages = {  # name: (call, its input, launches a call)
        "A": (lambda x: BilateralFilter.apply(x, 1.0, 0.1, fast_approx=False), image, 1),
        "B": (lambda x: BilateralFilter.apply(x, 2.5, 0.1, fast_approx=False), slices, 1),
        "C": (lambda x: BilateralFilter.apply(x), image, 0),
    }
    crf = CRF()
    launches = {name: filter_stage(f"{name} {'bilateral grid' if name == 'C' else 'stencil'}", lambda: call(x),
                                   per_call, dev)
                for name, (call, x, per_call) in stages.items()}
    filter_stage("D CRF", lambda: crf(logits, image), 0, dev)
    out = {"A": check_bilateral("3-D (stage A)", image, 1.0, 0.1, rate),
           "B": check_bilateral("2-D (stage B)", slices, 2.5, 0.1, rate)}

    # each stage on the card against the port's CPU run of the same call on a centre crop
    crops = {"A": centre_crop(image, CROP_3D), "B": centre_crop(slices[:, 0], CROP_SLICES)[:, None],
             "C": centre_crop(image, CROP_3D)}
    for name, (call, _, _) in stages.items():
        x = crops[name].contiguous()
        card, cpu = call(x).cpu(), call(x.cpu())
        err, rel = rel_err(card, cpu)
        tol, ok = (TOL_GRID, err <= TOL_GRID) if name == "C" else (TOL_BILATERAL, rel <= TOL_BILATERAL)
        print(f"filtering {name} on {tuple(x.shape)}, card against CPU: max abs err {err:.4g} ({rel:.3g} of "
              f"max|ref|; tol {tol} {'absolute' if name == 'C' else 'of max|ref|'})", flush=True)
        require(ok, f"filtering {name}: the card disagrees with the CPU on a crop")
    lc, ic = centre_crop(logits, CROP_CRF).contiguous(), centre_crop(image, CROP_CRF).contiguous()
    card, cpu = crf(lc, ic).cpu(), crf(lc.cpu(), ic.cpu())
    err, _ = rel_err(card, cpu)
    print(f"filtering D CRF on {tuple(lc.shape)}, card against CPU: max abs err {err:.4g} (tol {TOL_GRID} absolute); "
          f"probabilities sum to 1 within {(card.sum(1) - 1).abs().max().item():.3g}", flush=True)
    require(err <= TOL_GRID, "filtering D: the CRF on the card disagrees with the CPU on a crop")
    return {name: {"launches": launches[name], **out[name]} for name in out}


def _conv_backward_library(x: torch.Tensor, g: torch.Tensor, w: torch.Tensor, mask: list[bool]):
    """One ``aten.convolution_backward`` call (cuDNN) on the channel-first views of the
    channels-last x and g: dx with mask (True, False, False), dw with (False, True, False)."""
    xc, gc, wc = x.permute(0, 4, 1, 2, 3), g.permute(0, 4, 1, 2, 3), w.permute(4, 3, 0, 1, 2).contiguous()
    return lambda: torch.ops.aten.convolution_backward(gc, xc, wc, None, [1, 1, 1], [1, 1, 1], [1, 1, 1], False,
                                                       [0, 0, 0], 1, mask)


def check_conv_backward(sites: Counter, batch: int, dev, checked=None,
                        timed: torch.dtype | None = torch.bfloat16) -> tuple[dict, dict]:
    """At every conv site of the training step, in bfloat16, float32 and float16 (or the
    ``checked`` types): the weight gradient kernel (dw of x and g) and dx on the conv
    kernel (g and the flipped, transposed weights) against their plain versions; in the
    ``timed`` type (the step's own) also timed against the plain versions and cuDNN's
    ``aten.convolution_backward`` with dw's or dx's output mask (float32 in full float32,
    ``full_float32``), with the bound at that type's peak. Returns the kernels-line numbers
    of dw and of dx, summed over a step's sites."""
    from monai_tpu_torch.ops.conv3d import (conv3d_3x3_same, conv3d_3x3_same_plain, conv3d_3x3_wgrad,
                                            conv3d_3x3_wgrad_plain, conv3d_3x3_wgrad_plan)
    from monai_tpu_torch.utils.backend import full_float32

    g = torch.Generator(device=dev).manual_seed(7)
    dw_rows, dx_rows = [], []
    for (ci, co, sp), count in sorted(sites.items()):
        for dtype, tol in checked or CHECKED:
            x = torch.randn((batch, *sp, ci), generator=g, device=dev).to(dtype)
            gy = torch.randn((batch, *sp, co), generator=g, device=dev).to(dtype)
            w = (torch.randn((3, 3, 3, ci, co), generator=g, device=dev) / (27 * ci) ** 0.5).to(dtype)
            wf = w.flip((0, 1, 2)).transpose(3, 4).contiguous()
            dw, dx = conv3d_3x3_wgrad(x, gy), conv3d_3x3_same(gy, wf)
            torch.cuda.synchronize()
            err_w, rel_w = rel_err(dw, conv3d_3x3_wgrad_plain(x, gy))
            err_x, rel_x = rel_err(dx, conv3d_3x3_same_plain(gy, wf))
            require(rel_w <= tol, f"conv dw {ci}->{co} @{sp} {dtype}: max err {err_w:.3g} = {rel_w:.3g} x max|ref|")
            require(rel_x <= tol, f"conv dx {ci}->{co} @{sp} {dtype}: max err {err_x:.3g} = {rel_x:.3g} x max|ref|")
            p = conv3d_3x3_wgrad_plan(x, gy)
            msg = (f"conv backward {ci:3d}->{co:3d} @{sp} x{count} {str(dtype)[6:]:8s} dw max_abs_err {err_w:.4g} "
                   f"({rel_w:.3g} of max|ref|), dx {err_x:.4g} ({rel_x:.3g}), tol {tol}; dw plan {p['route']} "
                   f"{p['rc']}x{p['ro']} a thread, tiles {p['tiles_ci']}x{p['tiles_co']} of "
                   f"{p['rc'] * p['pci']}x{p['ro'] * p['pco']}, brick {p['bd']}x{p['bh']}x{p['bw']}, {p['chunks']} "
                   f"chunks of {p['per_chunk']}, {p['blocks']} blocks of {p['threads']} ({p['per_sm']} an SM, "
                   f"{p['smem']} B), {p['launches']} launches")
            if dtype == timed:
                flops = 2.0 * batch * np.prod(sp) * 27 * ci * co
                size = x.element_size()
                k_ms, p_ms = paired_ms(lambda: conv3d_3x3_wgrad(x, gy), lambda: conv3d_3x3_wgrad_plain(x, gy), iters=10)
                with full_float32(x):
                    lib_ms = cuda_ms(_conv_backward_library(x, gy, w, [False, True, False]), iters=10)
                b_ms, o_ms = bound((x.numel() + gy.numel() + dw.numel()) * size, flops, dtype)
                dw_rows.append((count, err_w, k_ms, p_ms, lib_ms, b_ms, o_ms))
                kx_ms, px_ms = paired_ms(lambda: conv3d_3x3_same(gy, wf), lambda: conv3d_3x3_same_plain(gy, wf),
                                         iters=10)
                with full_float32(x):
                    lx_ms = cuda_ms(_conv_backward_library(x, gy, w, [True, False, False]), iters=10)
                bx_ms, ox_ms = bound((gy.numel() + wf.numel() + dx.numel()) * size, flops, dtype)
                dx_rows.append((count, err_x, kx_ms, px_ms, lx_ms, bx_ms, ox_ms))
                msg += (f"  dw kernel {k_ms:.4f} ms  plain {p_ms:.4f} ms  cuDNN {lib_ms:.4f} ms  bound "
                        f"{max(b_ms, o_ms):.4f} ms ({max(b_ms, o_ms) / k_ms * 100:.1f}% of it);  dx kernel "
                        f"{kx_ms:.4f} ms  plain {px_ms:.4f} ms  cuDNN {lx_ms:.4f} ms  bound {max(bx_ms, ox_ms):.4f} ms")
            print(msg, flush=True)
    return _summary(dw_rows), _summary(dx_rows)


def check_norm_backward(sites: Counter, batch: int, dev, checked=None,
                        timed: torch.dtype | None = torch.bfloat16) -> dict:
    """At every norm site of the training step, in bfloat16, float32 and float16 (or the
    ``checked`` types): the backward kernel against its plain version, from the forward
    kernel's statistics (dx, and the three float32 sums the parameter grads come from,
    1e-4 of max|ref|: sums in another order); in the ``timed`` type (the step's own) also
    timed against the plain version and autograd's backward of ``F.instance_norm`` without
    the slope (the library call). The bound: x and g read once, dx written once."""
    from monai_tpu_torch.networks.layers.fast_norm import (_card, _forward, instance_norm_backward_plan,
                                                           instance_norm_prelu_backward,
                                                           instance_norm_prelu_backward_plain)

    g = torch.Generator(device=dev).manual_seed(8)
    rows = []
    for (c, sp, affine, slope), count in sorted(sites.items(), key=str):
        for dtype, tol in checked or CHECKED:
            x = (torch.randn((batch, c, *sp), generator=g, device=dev) * 3 + 1).to(dtype)
            x = x.contiguous(memory_format=torch.channels_last_3d)
            gy = torch.randn((batch, c, *sp), generator=g, device=dev).to(dtype)
            gy = gy.contiguous(memory_format=torch.channels_last_3d)
            w = (torch.rand((c,), generator=g, device=dev) + 0.5).to(dtype) if affine else None
            b = torch.randn((c,), generator=g, device=dev).to(dtype) if affine else None
            a = None if slope is None else torch.full((1,), slope, device=dev, dtype=dtype)
            _, stats = _forward(x, w, b, a, 1e-5, True)
            dx, sums = instance_norm_prelu_backward(gy, x, stats, w, b, a)
            torch.cuda.synchronize()
            ref_dx, ref_sums = instance_norm_prelu_backward_plain(gy, x, stats, w, b, a)
            err, rel = rel_err(dx, ref_dx)
            sum_rel = max(rel_err(s_, r_)[1] for s_, r_ in zip(sums, ref_sums) if r_.abs().max().item() > 0)
            require(rel <= tol and sum_rel <= TOL_F32, f"norm backward C={c} @{sp} {dtype}: dx max err {err:.3g} = "
                                                       f"{rel:.3g} x max|ref|, sums {sum_rel:.3g}")
            card, occupancy = _card(dev.index or 0)
            plan = instance_norm_backward_plan(batch, c, int(np.prod(sp)), dtype, True, card, occupancy)
            require(plan["launches"] == 1, f"norm backward C={c} @{sp} {dtype}: {plan['launches']} launches a call")
            msg = (f"norm backward C={c:3d} @{sp} x{count} {str(dtype)[6:]:8s} dx max_abs_err {err:.4g} ({rel:.3g} of "
                   f"max|ref|, tol {tol}), sums {sum_rel:.3g} (tol {TOL_F32}); plan {plan['path']}, G {plan['group']}, "
                   f"{plan['units_per_group']} units a group x {plan['unit_groups']}, {plan['blocks']} blocks of "
                   f"{plan['threads']}, stash {plan['stash_bytes']} B a block, {plan['launches']} launch")
            if dtype == timed:
                k_ms, p_ms = paired_ms(lambda: instance_norm_prelu_backward(gy, x, stats, w, b, a),
                                       lambda: instance_norm_prelu_backward_plain(gy, x, stats, w, b, a), iters=10)
                xl = x.detach().requires_grad_()
                with torch.enable_grad():
                    y = F.instance_norm(xl, weight=w, bias=b, eps=1e-5)
                lib_ms = cuda_ms(lambda: torch.autograd.grad(y, xl, gy, retain_graph=True), iters=10)
                del y, xl
                b_ms, o_ms = bound(3 * x.numel() * x.element_size(), 20.0 * x.numel(), torch.float32)
                rows.append((count, err, k_ms, p_ms, lib_ms, b_ms, o_ms))
                msg += (f"  kernel {k_ms:.4f} ms  plain {p_ms:.4f} ms  F.instance_norm backward (no slope) "
                        f"{lib_ms:.4f} ms  bound {max(b_ms, o_ms):.4f} ms ({max(b_ms, o_ms) / k_ms * 100:.1f}% of it)")
            print(msg, flush=True)
    out = _summary(rows)
    out["bound_share"] = out["bound_ms"] / out["ms"] if out["ms"] else None  # the kernel's share of its bound
    return out


def _normed_biases(net) -> set[str]:
    """The biases of the convs whose output an instance or batch norm takes (in train mode):
    the norm removes each channel's mean, so their exact grad is 0 and what the step
    computes is rounding."""
    from monai_tpu_torch.networks.blocks.convolutions import Convolution
    from monai_tpu_torch.networks.layers.fast_norm import InstanceNorm

    norms = (InstanceNorm, torch.nn.modules.batchnorm._BatchNorm)
    return {f"{name}.conv.bias" for name, m in net.named_modules()
            if isinstance(m, Convolution) and "adn" in m._modules and isinstance(m.adn._modules.get("N"), norms)}


def _step(net, x: torch.Tensor, y: torch.Tensor, loss_fn, amp: bool = False) -> tuple[float, dict]:
    """(loss, {name: grad}) of one step of ``net`` on (x, y): float32, or the amp step (the
    bfloat16 view of the parameters, the input in bfloat16, the logits cast to float32)."""
    from monai_tpu_torch.networks.utils import amp_model_view

    net.zero_grad(set_to_none=True)
    model = amp_model_view(net) if amp else net
    loss = loss_fn(model(x.to(torch.bfloat16) if amp else x).float(), y)
    loss.backward()
    return loss.item(), {k: p.grad.detach().clone() for k, p in net.named_parameters()}


def _worst(got: dict, ref: dict, skip: set) -> tuple[str, float]:
    """The grad with the largest max|got - ref| over its max|ref|, and that ratio."""
    return max(((k, (got[k].cpu() - r).abs().max().item() / max(r.abs().max().item(), 1e-30))
                for k, r in ref.items() if k not in skip), key=lambda t: t[1])


def train_step_check(net_cpu, dev) -> None:
    """One batch-1 step on a 96³ patch, on the card against the port's CPU step of the same
    weights and data. The PReLU's kink makes the float32 grads of this net jump where an
    activation crosses 0 within rounding: a 1e-7 relative change of the input moves the
    CPU's own grads by ~1e-2 of their max (PERF.md §6). So float32 is held twice: the
    same net with every PReLU slope at 1 (no kink; every kernel's backward still runs),
    each grad within TOL_STEP_F32 of its max|ref|; and the net as it is, each grad within
    STEP_FLOOR_RATIO times the CPU's own change under that perturbation (the worst grad).
    The bfloat16 amp step: the loss within TOL_STEP_LOSS_BF16 and each grad's cosine
    similarity at least MIN_STEP_COSINE, or within STEP_COSINE_RATIO of the CPU's own
    bfloat16 step's distance from 1. The biases whose exact grad is 0 (``_normed_biases``)
    are held instead, in float32, to TOL_STEP_F32 of their conv weight's max|grad| on both
    sides; in bfloat16 they are rounding alone. Then two amp steps from one state, with
    cuDNN's deterministic algorithms, bit for bit, and the float32 step's launches."""
    from monai_tpu_torch.losses import DiceCELoss

    gen = torch.Generator().manual_seed(11)
    x = torch.rand((1, 1, *ROI), generator=gen)
    y = (torch.rand((1, 1, *ROI), generator=gen) > 0.5).float()
    x_moved = x * (1 + 1e-7 * torch.randn(x.shape, generator=gen))
    loss_fn = DiceCELoss(to_onehot_y=True, softmax=True)
    zero = _normed_biases(net_cpu)
    net_cpu.train()
    net_one = copy.deepcopy(net_cpu)
    with torch.no_grad():
        for m in net_one.modules():
            if isinstance(m, torch.nn.PReLU):
                m.weight.fill_(1.0)
    t0 = time.perf_counter()
    ref_loss, ref = _step(net_cpu, x, y, loss_fn)
    cpu_s = time.perf_counter() - t0
    _, moved = _step(net_cpu, x_moved, y, loss_fn)
    _, ref_bf = _step(net_cpu, x, y, loss_fn, amp=True)
    ref1_loss, ref1 = _step(net_one, x, y, loss_fn)
    net_cpu.zero_grad(set_to_none=True)
    net_one.zero_grad(set_to_none=True)
    floor = _worst(moved, ref, zero)
    cos_cpu = {k: F.cosine_similarity(ref_bf[k].double().flatten(), ref[k].double().flatten(), dim=0).item()
               for k in ref}

    def zero_ok(grads, k) -> float:
        """A bias of ``zero``: its max|grad| over its conv weight's max|grad|."""
        return grads[k].abs().max().item() / max(grads[k[:-4] + "weight"].abs().max().item(), 1e-30)

    xd, yd = x.to(dev), y.to(dev)
    net, card_one = copy.deepcopy(net_cpu).to(dev), copy.deepcopy(net_one).to(dev)
    reset_launch_counts()
    loss32, g32 = _step(net, xd, yd, loss_fn)
    counts = launch_counts()[:2] + tuple(w.launches for w in _backward_wrappers())
    loss1, g1 = _step(card_one, xd, yd, loss_fn)
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    lossbf, gbf = _step(net, xd, yd, loss_fn, amp=True)
    lossbf2, gbf2 = _step(net, xd, yd, loss_fn, amp=True)
    torch.backends.cudnn.deterministic = prev
    same = lossbf == lossbf2 and all(torch.equal(gbf[k], gbf2[k]) for k in gbf)
    worst, worst1 = _worst(g32, ref, zero), _worst(g1, ref1, zero)
    worst_zero = max(max(zero_ok(g, k), zero_ok(r, k)) for g, r in ((g32, ref), (g1, ref1)) for k in zero)
    loss_rel32, loss_rel1 = (abs(a - b) / abs(b) for a, b in ((loss32, ref_loss), (loss1, ref1_loss)))
    cos_min, cos_fail = ("", 1.0), []
    for k, r in ref.items():
        if k in zero:
            continue
        cos = F.cosine_similarity(gbf[k].cpu().double().flatten(), r.double().flatten(), dim=0).item()
        cos_min = min(cos_min, (k, cos), key=lambda t: t[1])
        if cos < MIN_STEP_COSINE and 1 - cos > STEP_COSINE_RATIO * (1 - cos_cpu[k]):
            cos_fail.append(f"{k} {cos:.6f} (CPU bfloat16 {cos_cpu[k]:.6f})")
    loss_relbf = abs(lossbf - ref_loss) / abs(ref_loss)
    f32_limit = max(TOL_STEP_F32, STEP_FLOOR_RATIO * floor[1])
    print(f"train step batch 1 @{ROI} against the CPU step ({cpu_s:.1f} s a float32 step on the CPU): loss "
          f"{ref_loss:.6f}; float32, PReLU slopes 1: loss rel err {loss_rel1:.3g}, worst grad max err {worst1[1]:.3g} "
          f"of max|ref| ({worst1[0]}; tol {TOL_STEP_F32}); float32 as it is: loss rel err {loss_rel32:.3g}, worst "
          f"grad {worst[1]:.3g} ({worst[0]}; tol {f32_limit:.3g}: {STEP_FLOOR_RATIO}x the CPU's own change under a "
          f"1e-7 input change, {floor[1]:.3g} at {floor[0]}); bfloat16 amp loss {lossbf:.6f} rel err {loss_relbf:.3g} "
          f"(tol {TOL_STEP_LOSS_BF16}), least grad cosine {cos_min[1]:.6f} ({cos_min[0]}; the CPU's bfloat16 step "
          f"{cos_cpu[cos_min[0]]:.6f}; min {MIN_STEP_COSINE} or within {STEP_COSINE_RATIO}x the CPU's distance from 1; "
          f"least on the CPU {min(cos_cpu[k] for k in cos_cpu if k not in zero):.6f}); {len(zero)} biases with an "
          f"exact grad of 0: max|grad| over their weight's, float32 {worst_zero:.3g} (tol {TOL_STEP_F32}); two amp "
          f"steps bit-identical: {same}; float32 step launches conv {counts[0]}, norm {counts[1]}, dw {counts[2]}, "
          f"norm backward {counts[3]}", flush=True)
    require(np.isfinite(loss1) and loss_rel1 <= TOL_STEP_F32 and worst1[1] <= TOL_STEP_F32,
            "the float32 train step (PReLU slopes 1) on the card disagrees with the CPU")
    require(np.isfinite(loss32) and loss_rel32 <= TOL_STEP_F32 and worst[1] <= f32_limit,
            "the float32 train step on the card disagrees with the CPU")
    require(worst_zero <= TOL_STEP_F32, "a bias whose exact grad is 0 has a float32 grad that is not ~0")
    require(np.isfinite(lossbf) and loss_relbf <= TOL_STEP_LOSS_BF16 and not cos_fail,
            f"the bfloat16 amp train step on the card disagrees with the CPU: {cos_fail}")
    require(same, "two amp steps from one state gave different grads")
    per_step = tuple(TRAIN_PER_STEP[k] for k in ("conv3d_3x3_same", "instance_norm_prelu", "conv3d_3x3_wgrad",
                                                  "instance_norm_prelu_backward"))
    require(counts == per_step, f"the float32 step launched {counts}, not {per_step}")


def train_path(net_cpu, sites: tuple[Counter, Counter], dev) -> dict:
    """``SupervisedTrainer(amp=True)`` at batch 4 on one fixed batch: TRAIN_WARMUP
    iterations, then TRAIN_TIMED timed, the launch counts and peak memory of those (set to
    0 just before them), the step times between CUDA events recorded at each iteration's
    end, and the loss at each step. Returns the launch counts of the timed run."""
    from monai_tpu_torch.engines import Events, SupervisedTrainer
    from monai_tpu_torch.losses import DiceCELoss
    from monai_tpu_torch.networks.layers.fast_norm import _InstanceNormPReLU
    from monai_tpu_torch.ops.conv3d import _Conv3x3Same

    net = copy.deepcopy(net_cpu).to(dev)
    gen = torch.Generator(device=dev).manual_seed(12)
    batch = {"image": torch.rand((TRAIN_BATCH, 1, *ROI), generator=gen, device=dev),
             "label": (torch.rand((TRAIN_BATCH, 1, *ROI), generator=gen, device=dev) > 0.5).float()}
    optimizer = torch.optim.AdamW(net.parameters(), lr=1e-4, weight_decay=1e-4)  # optax.adamw(1e-4)'s decay
    trainer = SupervisedTrainer(device=dev, max_epochs=1, train_data_loader=[batch] * (TRAIN_WARMUP + TRAIN_TIMED),
                                network=net, optimizer=optimizer,
                                loss_function=DiceCELoss(to_onehot_y=True, softmax=True), amp=True)
    losses, ends, start = [], [], {}

    @trainer.on(Events.ITERATION_COMPLETED)
    def _record(engine):
        losses.append(engine.state.output["loss"])
        ends.append(torch.cuda.Event(enable_timing=True))
        ends[-1].record()
        if engine.state.iteration == TRAIN_WARMUP:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            reset_launch_counts()
            _Conv3x3Same.copied_bytes = _InstanceNormPReLU.copied_bytes = 0
            start["t"] = time.perf_counter()

    trainer.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - start["t"]
    names = ("conv3d_3x3_same", "instance_norm_prelu", "conv3d_3x3_wgrad", "instance_norm_prelu_backward")
    counts = dict(zip(names, launch_counts()[:2] + tuple(w.launches for w in _backward_wrappers())))
    losses = [v.item() for v in losses]
    step_ms = [ends[i].elapsed_time(ends[i + 1]) for i in range(TRAIN_WARMUP - 1, len(ends) - 1)]
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    copied = (_Conv3x3Same.copied_bytes / TRAIN_TIMED, _InstanceNormPReLU.copied_bytes / TRAIN_TIMED)
    n_conv, n_norm = sum(sites[0].values()), sum(sites[1].values())
    expected = {"conv3d_3x3_same": 2 * n_conv, "conv3d_3x3_wgrad": n_conv, "instance_norm_prelu": n_norm,
                "instance_norm_prelu_backward": n_norm}
    per_step = {k: v / TRAIN_TIMED for k, v in counts.items()}
    print(f"unet_train SupervisedTrainer(amp=True) batch {TRAIN_BATCH} @96^3: {TRAIN_TIMED / wall:.4f} steps/s, "
          f"{TRAIN_BATCH * TRAIN_TIMED / wall:.3f} patches/s ({TRAIN_TIMED} steps after {TRAIN_WARMUP} warm-up, one "
          f"synchronise at the end); step median {statistics.median(step_ms):.3f} ms (min {min(step_ms):.3f}, max "
          f"{max(step_ms):.3f}, CUDA events at each iteration's end); peak memory {peak_gb:.2f} GB; "
          f"grads that came back "
          f"channel-first and were copied a step: conv {copied[0] / 1e6:.2f} MB, norm {copied[1] / 1e6:.2f} MB "
          f"(read and written once: {2 * sum(copied) / HBM_BYTES_S * 1e3:.4f} ms at the memory rate); launches a step: "
          f"conv forward + dx {per_step['conv3d_3x3_same']:g}, dw {per_step['conv3d_3x3_wgrad']:g}, norm forward "
          f"{per_step['instance_norm_prelu']:g}, norm backward {per_step['instance_norm_prelu_backward']:g} (the sites "
          f"give {expected}); loss by step: " + ", ".join(f"{v:.6f}" for v in losses), flush=True)
    require(all(np.isfinite(v) for v in losses), "unet_train: a loss is not finite")
    require(losses[10] < losses[0], f"unet_train: the loss after 10 steps {losses[10]:.6f} is not below the first "
                                    f"{losses[0]:.6f}")
    require(per_step == expected and expected == TRAIN_PER_STEP,
            f"unet_train: launches a step {per_step}, the sites give {expected}, expected {TRAIN_PER_STEP}")
    return counts


class StageClock:
    """Per-iteration stamps of a bundle run, taken by wrapping the engine's pieces for the
    run's length: the loader's wait for each batch, the forward (``_iteration``, then a
    synchronise), the postprocessing (decollate, the transforms and the write, then a
    synchronise) and the write alone (``NiftiWriter.write``: the label map's one copy to the
    host, the gzip and the file); the devices of each stage's tensors, and the evaluator."""

    def __init__(self):
        from monai_tpu_torch.data import DataLoader, NiftiWriter
        from monai_tpu_torch.engines import SupervisedEvaluator, Workflow

        self.targets = [(DataLoader, "__iter__"), (SupervisedEvaluator, "_iteration"),
                        (Workflow, "_apply_post_and_metrics"), (NiftiWriter, "write")]
        self.iters, self.devices, self.evaluator, self.start, self.end = [], [], None, None, None

    def __enter__(self):
        self.saved = [getattr(cls, name) for cls, name in self.targets]
        (it, iteration, post, write), clock = self.saved, self

        def timed_iter(loader):
            clock.start = time.perf_counter()
            inner = it(loader)
            while True:
                t0 = time.perf_counter()
                try:
                    batch = next(inner)
                except StopIteration:
                    return
                clock.iters.append({"t0": t0, "wait": time.perf_counter() - t0})
                clock.devices.append(("batch", batch["image"].data.device))
                yield batch

        def timed_iteration(engine, *args):
            clock.evaluator = engine
            t0 = time.perf_counter()
            out = iteration(engine, *args)
            torch.cuda.synchronize()
            clock.iters[-1]["forward"] = time.perf_counter() - t0
            clock.devices.append(("pred", out["pred"].device))
            return out

        def timed_post(engine):
            t0 = time.perf_counter()
            post(engine)
            torch.cuda.synchronize()
            clock.end = time.perf_counter()
            clock.iters[-1].update(post=clock.end - t0, total=clock.end - clock.iters[-1]["t0"])

        def timed_write(writer, *args, **kwargs):
            clock.devices.append(("written", writer.data_obj.device))
            t0 = time.perf_counter()
            write(writer, *args, **kwargs)
            clock.iters[-1]["write"] = clock.iters[-1].get("write", 0.0) + time.perf_counter() - t0

        for (cls, name), fn in zip(self.targets, (timed_iter, timed_iteration, timed_post, timed_write)):
            setattr(cls, name, fn)
        return self

    def __exit__(self, *exc):
        for (cls, name), fn in zip(self.targets, self.saved):
            setattr(cls, name, fn)


def check_bundle_outputs(eval_dir: Path, volumes: int, labels: np.ndarray, same: np.ndarray, affine: np.ndarray,
                         margins) -> list[int]:
    """Each volume's saved label map: its path, type, shape, affine and values; identical
    to ``same`` (phase 5's path re-run under the bundle's cuDNN settings), and where it
    differs from ``labels`` (phase 5's own run), a near tie: a top-two logit margin
    (``margins()``, relative to the logits' std) below TOL_TIE. Returns the voxels that
    differ from phase 5's run, file by file."""
    from monai_tpu_torch.data import read_nifti

    differ = []
    for i in range(volumes):
        path = eval_dir / f"spleen_{i}" / f"spleen_{i}_seg.nii.gz"
        require(path.is_file(), f"bundle: {path} was not written")
        got, meta = read_nifti(path)
        require(got.dtype == np.float32 and got.shape == CT_SHAPE, f"bundle: {path.name} is {got.dtype} {got.shape}")
        require(np.abs(meta["affine"] - affine).max() <= 1e-9, f"bundle: {path.name} is not on the input's affine")
        require(bool(np.isin(got, (0.0, 1.0)).all()), f"bundle: {path.name} holds values other than 0 and 1")
        require(np.array_equal(got, same), f"bundle: {path.name} is not the label map of phase 5's path under the "
                                           f"bundle's settings ({int((got != same).sum())} voxels differ)")
        bad = got != labels
        differ.append(int(bad.sum()))
        if differ[-1]:
            worst = float(margins()[bad].max())
            require(worst < TOL_TIE, f"bundle: {path.name} differs from phase 5's label map beyond a near tie "
                                     f"({differ[-1]} voxels, margins up to {worst:.3g} std)")
    return differ


def make_bundle_root(root: Path, volumes: int, state: dict) -> Path:
    """A bundle root for inference.json: ``volumes`` copies of the CT (each decoded from its
    own file) under data/Task09_Spleen/imagesTs and ``state`` as models/model_final.ckpt.
    Returns the checkpoint's path."""
    data = root / "data" / "Task09_Spleen" / "imagesTs"
    shutil.rmtree(root, ignore_errors=True)
    data.mkdir(parents=True)
    (root / "models").mkdir()
    for i in range(volumes):
        shutil.copyfile(CT_PATH, data / f"spleen_{i}.nii.gz")
    torch.save({"model": state}, root / "models" / "model_final.ckpt")
    return root / "models" / "model_final.ckpt"


def bundle_phase(dev, spleen5: dict) -> tuple[int, ...]:
    """Phase 8: the Spleen bundle's inference.json, run as it stands through the port's
    ``bundle.run`` (overriding only ``bundle_root``, ``imports`` and ``initialize``) over 4
    copies of phase 5's CT, with phase 5's weights in ``models/model_final.ckpt``: once as
    the bundle sets its loader (no worker thread) and once with 2 threads, after a warm-up
    over one volume; then through the command line, in a process of its own, over one.
    Each file is checked against phase 5's label map; then a spleen forward and a volume
    under torch's default TF32 setting. Returns the launch counts of the two timed runs."""
    from monai_tpu_torch.bundle import run
    from monai_tpu_torch.data import read_nifti
    from monai_tpu_torch.transforms import Invertd, SaveImage

    ckpt = make_bundle_root(BUNDLE_ROOT, BUNDLE_VOLUMES, spleen5["net_cpu"].state_dict())
    overrides = {"bundle_root": str(BUNDLE_ROOT), **BUNDLE_OVERRIDES}
    labels, affine = spleen5["labels"][0].numpy(), read_nifti(CT_PATH)[1]["affine"]
    pre, post, inferer, net = spleen5["pre"], spleen5["post"], spleen5["inferer"], spleen5["net"]
    cache = {}

    def margins() -> np.ndarray:
        """The top-two logit margin of phase 5's net on the CT, relative to the logits' std,
        on the file's grid (inverted at nearest interpolation, as the labels are)."""
        if "margins" not in cache:
            with torch.inference_mode():
                d = pre({"image": str(CT_PATH)})
                logits = inferer(d["image"].data[None], net)[0]
                m = ((logits[1] - logits[0]).abs() / logits.std())[None]
                cache["margins"] = Invertd("pred", transform=pre, orig_keys="image")(
                    {**d, "pred": m})["pred"].data[0].cpu().numpy()
        return cache["margins"]

    t0 = time.perf_counter()
    run(config_file=str(BUNDLE_CONFIG), **overrides,
        datalist=[{"image": str(BUNDLE_ROOT / "data" / "Task09_Spleen" / "imagesTs" / "spleen_0.nii.gz")}])
    torch.cuda.synchronize()
    print(f"bundle warm-up (one volume, with the parse, the net and the checkpoint): {time.perf_counter() - t0:.2f} s; "
          f"cuDNN deterministic {torch.backends.cudnn.deterministic}, benchmark {torch.backends.cudnn.benchmark} "
          f"(set_determinism), TF32 {torch.backends.cudnn.allow_tf32}", flush=True)
    with torch.inference_mode():  # phase 5's path under the cuDNN settings the bundle set, twice
        for _ in range(2):
            stages, d, argmax, wall = spleen_volume(pre, post, inferer, net)
            same = d["pred"].data[0].cpu().numpy()
            del d, argmax  # their tensors would count in the bundle runs' peak memory
    n_same = int((same != labels).sum())
    print(f"phase 5's path under the bundle's settings: sliding window {stages['sliding_window'] * 1e3:.2f} ms, "
          f"per volume {wall * 1e3:.2f} ms (the second of two volumes); {n_same} voxels differ from phase 5's "
          f"label map" + (f", top-two logit margins up to {float(margins()[same != labels].max()):.3g} std"
                          if n_same else ""), flush=True)
    (BUNDLE_ROOT / "eval").rename(BUNDLE_ROOT / "eval_warmup")

    totals = [0] * 5
    for workers in BUNDLE_WORKERS:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_launch_counts()
        extra = {"dataloader::num_workers": workers} if workers else {}
        with StageClock() as clock:
            t0 = time.perf_counter()
            run(config_file=str(BUNDLE_CONFIG), **overrides, **extra)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        counts, resample_cuda = launch_counts(), _wrappers()[3].cuda_launches
        peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
        its = clock.iters
        require(len(its) == BUNDLE_VOLUMES and all("write" in it for it in its),
                f"bundle ({workers} threads): {len(its)} iterations, not {BUNDLE_VOLUMES} each with a write")
        med = {k: statistics.median(it[k] for it in its) * 1e3 for k in ("total", "wait", "forward", "post", "write")}
        epoch = clock.end - clock.start
        print(f"bundle run, {workers} loader threads: {BUNDLE_VOLUMES / epoch:.4f} vols/s over {BUNDLE_VOLUMES} volumes "
              f"({epoch:.3f} s from the loader's start to the last file; the whole run {wall:.3f} s with its parse, "
              f"net and checkpoint); per volume, medians (ms): iteration start to file written {med['total']:.2f}, "
              f"loader wait {med['wait']:.2f}, forward {med['forward']:.2f}, postprocessing without the write "
              f"{med['post'] - med['write']:.2f}, write {med['write']:.2f} (the write's share of the volumes' time "
              f"{sum(it['write'] for it in its) / sum(it['total'] for it in its):.4f}); per volume (ms): "
              f"{[round(it['total'] * 1e3, 2) for it in its]}, loader waits {[round(it['wait'] * 1e3, 2) for it in its]}; "
              f"peak memory {peak_gb:.2f} GB; launches conv {counts[0]}, norm {counts[1]}, attention {counts[2]}, "
              f"resample {counts[3]} ({resample_cuda} CUDA launches), bilateral {counts[4]}", flush=True)
        require(counts == tuple(n * BUNDLE_VOLUMES for n in SPLEEN_PER_VOLUME),
                f"bundle ({workers} threads): {BUNDLE_VOLUMES} volumes launched {counts}, not {SPLEEN_PER_VOLUME} each")
        require(resample_cuda == SPLEEN_PER_VOLUME[3] * BUNDLE_VOLUMES, f"bundle: {resample_cuda} resample launches")
        require(all(dv.type == "cuda" for _, dv in clock.devices), f"bundle: a stage left the card: {clock.devices}")
        file_state = torch.load(ckpt, map_location="cpu", weights_only=True)["model"]
        loaded = clock.evaluator.network.state_dict()
        require(set(loaded) == set(file_state) and all(torch.equal(loaded[k].cpu(), v) for k, v in file_state.items()),
                "bundle: the evaluator's network is not the checkpoint's (CheckpointLoader did not run)")
        differ = check_bundle_outputs(BUNDLE_ROOT / "eval", BUNDLE_VOLUMES, labels, same, affine, margins)
        print(f"bundle run, {workers} loader threads: {BUNDLE_VOLUMES} files at eval/spleen_i/spleen_i_seg.nii.gz, "
              f"float32 {CT_SHAPE} on the input's affine, labels 0 and 1, each identical to phase 5's path under the "
              f"bundle's settings; voxels that differ from phase 5's own label map: {differ}; every stage's tensors "
              f"on the card; the evaluator's network equals the checkpoint", flush=True)
        (BUNDLE_ROOT / "eval").rename(BUNDLE_ROOT / f"eval_{workers}_threads")
        totals = [a + b for a, b in zip(totals, counts)]

    # the write alone of a smooth label map of the same shape and type (the phantom's
    # spleen): gzip's time depends on what it compresses
    smooth = np.zeros(CT_SHAPE, np.float32)
    x, y, z = (np.linspace(-1, 1, n, dtype=np.float32) for n in CT_SHAPE)
    smooth[((x[:, None, None] - 0.45) ** 2 + (y[None, :, None] + 0.25) ** 2) / 0.02 + z[None, None] ** 2 / 0.25 < 1] = 1
    saver = SaveImage(output_dir=str(BUNDLE_ROOT / "eval_write"), output_postfix="seg", print_log=False)
    t0 = time.perf_counter()
    saver(torch.from_numpy(smooth)[None].to(dev), meta_data={"affine": affine, "filename_or_obj": "smooth.nii.gz"})
    print(f"write alone, a smooth label map ({100 * smooth.mean():.2f}% label 1, "
          f"{(BUNDLE_ROOT / 'eval_write' / 'smooth' / 'smooth_seg.nii.gz').stat().st_size / 1e6:.3f} MB gzipped): "
          f"{(time.perf_counter() - t0) * 1e3:.1f} ms; the bundle's label map ({100 * labels.mean():.2f}% label 1, "
          f"{(BUNDLE_ROOT / 'eval_0_threads' / 'spleen_0' / 'spleen_0_seg.nii.gz').stat().st_size / 1e6:.3f} MB "
          f"gzipped) took the write times above", flush=True)

    # the command line, as README gives it, in a process of its own, on a root of one volume
    cli_root = BUNDLE_ROOT.parent / "spleen_bundle_cli"
    make_bundle_root(cli_root, 1, spleen5["net_cpu"].state_dict())
    cmd = [sys.executable, "-m", "monai_tpu_torch.bundle", "run", "--config_file", str(BUNDLE_CONFIG),
           "--bundle_root", str(cli_root), "--imports", json.dumps(BUNDLE_OVERRIDES["imports"]),
           "--initialize", json.dumps(BUNDLE_OVERRIDES["initialize"])]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=Path(__file__).resolve().parent, capture_output=True, text=True, timeout=300)
    require(proc.returncode == 0, f"bundle command line failed:\n{proc.stderr[-3000:]}")
    differ = check_bundle_outputs(cli_root / "eval", 1, labels, same, affine, margins)
    print(f"bundle command line (python -m monai_tpu_torch.bundle run, torch's default TF32 setting): one volume in "
          f"{time.perf_counter() - t0:.1f} s with the process's start; identical to phase 5's path under the bundle's "
          f"settings; voxels that differ from phase 5's own label map: {differ}", flush=True)

    # torch's default settings, as a user's process has them (cuDNN may use TF32 for float32)
    torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic = True, False
    try:
        with torch.inference_mode():
            d = pre({"image": str(CT_PATH)})
            tf32 = post({**d, "pred": inferer(d["image"].data[None], net)[0]})["pred"].data[0].cpu().numpy()
            bad = tf32 != labels
            worst = float(margins()[bad].max()) if bad.any() else 0.0
            print(f"spleen volume under torch's defaults (TF32 allowed): label agreement with phase 5's float32 label "
                  f"map {1 - bad.mean():.8f} ({int(bad.sum())} voxels differ, top-two logit margins up to {worst:.3g} "
                  f"std; tie tolerance {TOL_TIE})", flush=True)
            require(worst < TOL_TIE, "spleen: the label map under torch's TF32 default differs beyond a near tie")
            forward_check("spleen under torch's TF32 default", spleen5["net_cpu"], net, {}, (10, 0, 0, 0, 0), dev)
            # what the TF32 default does where the port does not turn it off (no gate: the fault
            # that full_float32 repairs)
            import monai_tpu_torch.networks.layers.factories as factories

            kept, factories.full_float32 = factories.full_float32, lambda x: contextlib.nullcontext()
            try:
                window = torch.rand((1, 1, *ROI), generator=torch.Generator().manual_seed(1))
                ref = spleen5["net_cpu"](window)
                err = (net(window.to(dev)).cpu() - ref).abs().max().item() / ref.std().item()
                raw = post({**d, "pred": inferer(d["image"].data[None], net)[0]})["pred"].data[0].cpu().numpy()
            finally:
                factories.full_float32 = kept
            bad = raw != labels
            print(f"spleen with cuDNN's float32 convs on TF32 (the port's full_float32 taken out): forward 96^3 max err "
                  f"{err:.4g} std (the float32 gate {TOL_FWD_F32_MAX}); volume label agreement with the float32 map "
                  f"{1 - bad.mean():.8f} ({int(bad.sum())} voxels differ, margins up to "
                  f"{float(margins()[bad].max()) if bad.any() else 0.0:.3g} std)", flush=True)
    finally:
        torch.backends.cudnn.allow_tf32 = False
    return tuple(totals)


def training_phase(dev) -> tuple[dict, dict]:
    """Phase 7: the training path's kernels at its sites, the batch-1 step against the CPU,
    and the trainer. Returns the launch counts of the trainer's timed run and the
    kernels-line numbers of dw, dx and the norm's backward."""
    from monai_tpu_torch.networks.nets import UNet

    net_cpu = UNet(3, 1, 2, channels=(16, 32, 64, 128, 256), strides=(2, 2, 2, 2), num_res_units=2,
                   generator=torch.Generator().manual_seed(0), device="cpu")
    window = torch.rand((TRAIN_BATCH, 1, *ROI), generator=torch.Generator(device=dev).manual_seed(1), device=dev)
    with torch.no_grad():
        conv_sites, norm_sites, _, _ = record_sites(copy.deepcopy(net_cpu).to(dev, torch.bfloat16).train(),
                                                    window.to(torch.bfloat16))
    print(f"unet_train sites a step (batch {TRAIN_BATCH}): {sum(conv_sites.values())} 3x3x3 stride-1 convs (each a "
          f"forward, a dx and a dw), {sum(norm_sites.values())} instance norms (each a forward and a backward)",
          flush=True)
    dw, dx = check_conv_backward(conv_sites, TRAIN_BATCH, dev)
    norm_bwd = check_norm_backward(norm_sites, TRAIN_BATCH, dev)
    torch.cuda.empty_cache()
    train_step_check(net_cpu, dev)
    torch.cuda.empty_cache()
    counts = train_path(net_cpu, (conv_sites, norm_sites), dev)
    return counts, {"dw": dw, "dx": dx, "norm_backward": norm_bwd}


# Phase 9, the BTCV bundle's SwinUNETR trained in float32 (no amp), as its train.json has
# it: SwinUNETR(1, 14, feature_size=48), DiceCELoss(to_onehot_y, softmax), AdamW(lr 1e-4,
# weight decay 1e-5) built by the trainer from the parameters, one fixed batch of 4 96^3
# patches; warm-up and timed iterations, under torch's default TF32 setting
SWIN_TRAIN_WARMUP, SWIN_TRAIN_TIMED = 2, 10
# the window attention's sites a step at batch 4 of 96^3 (windows, heads, N, D, mask rows);
# the bench SwinUNETR's (feature size 24) are the same at D = 8
SWIN_ATTN_SITES = {(1372, 3, 343, 16, 343): 1, (1372, 3, 343, 16, None): 1, (256, 6, 343, 16, 64): 1,
                   (256, 6, 343, 16, None): 1, (32, 12, 343, 16, 8): 1, (32, 12, 343, 16, None): 1,
                   (4, 24, 216, 16, None): 2}
# The batch-1 step on the card against the port's CPU step, at 32^3 (full widths). As in
# phase 7, float32 is held twice: the same net with every LeakyReLU slope at 1 (no kink;
# every kernel's backward still runs), each grad within TOL_STEP_F32 of its max|ref|; and
# the net as it is, each grad's cosine with the CPU's at least SWIN_MIN_COSINE (branch
# flips of the LeakyReLU move its grads by up to ~1e-2 of their max, PERF.md §6 PR 13).
# At 32^3 the bottleneck is one voxel, and an instance norm over one voxel gives its bias
# whatever its input: what lies before the bottleneck's two norms has an exact grad of 0,
# held under TOL_STEP_F32 of the largest grad on both sides. The 1x1 residual conv from the
# single input channel reaches the loss only through its norm's eps (the norm undoes its
# scale), so its grad is 1/sqrt(eps)-amplified rounding: held by the cosine alone.
SWIN_STEP_ROI = (32, 32, 32)
SWIN_MIN_COSINE = 0.999
SWIN_EXACT_ZERO = {"encoder10.layer.conv1.conv.weight", "encoder10.layer.conv2.conv.weight",
                   "encoder10.layer.norm1.weight", "encoder10.layer.norm1.bias", "encoder10.layer.norm2.weight"}
SWIN_EPS_ONLY = {"encoder1.layer.conv3.conv.weight"}


def _attention_bwd_inputs(g, site, dtype, masks, dev):
    b, h, n, d, nw = site
    q, k, v = (torch.randn((b, h, n, d), generator=g, device=dev).to(dtype) for _ in range(3))
    q = (q.float() * d ** -0.5).to(dtype)
    bias = torch.randn((h, n, n), generator=g, device=dev) * 0.5
    mask = None if nw is None else masks[nw]
    dout = torch.randn((b, h, n, d), generator=g, device=dev).to(dtype)
    return q, k, v, bias, mask, dout


def check_attention_backward(masks: dict, dev) -> dict:
    """The backward kernel at each site of the BTCV step (head dim 16) and of the bench
    SwinUNETR (head dim 8), masked and unmasked, in float32, bfloat16 and float16: dq, dk,
    dv and dbias against the plain backward on the kernel forward's output, each at the
    type's gate of its max|ref|, and two calls bit for bit; each line gives the plan's
    route, tile (keys x query rows a step), cluster size, runs and partials. In float32 (the
    step's type) also timed against the plain version and, as the library call, autograd's
    backward of ``F.scaled_dot_product_attention`` with bias + mask as one additive mask
    that requires a grad (its forward run once before), which the kernel must beat at every
    site. The bound: q, k, v, dO, O, bias, mask and the log-sum-exp read once and dq, dk,
    dv, dbias written once; the five N^2 D products as 3xTF32 on the tensor cores (the
    kernel's arithmetic; the line gives its share of the bound, and the old bound at the
    float32 FMA pipe's 67 TFLOP/s); one exp a score at the card's exp rate. Returns the
    kernels-line numbers of the step's (head dim 16) sites, summed over a step."""
    from monai_tpu_torch.ops.window_attention import (_forward, fused_window_attention_backward,
                                                      fused_window_attention_backward_plain,
                                                      window_attention_backward_plan)

    rate = exp_per_s()
    g = torch.Generator(device=dev).manual_seed(9)
    rows = []
    sites = list(SWIN_ATTN_SITES.items()) + [((b, h, n, 8, nw), 0) for (b, h, n, _, nw) in SWIN_ATTN_SITES]
    for site, count in sites:
        for dtype, tol in CHECKED:
            q, k, v, bias, mask, dout = _attention_bwd_inputs(g, site, dtype, masks, dev)
            out, lse = _forward(q, k, v, bias, mask, with_lse=True)
            got = fused_window_attention_backward(q, k, v, bias, mask, out, dout, lse)
            again = fused_window_attention_backward(q, k, v, bias, mask, out, dout, lse)
            torch.cuda.synchronize()
            same = all(torch.equal(a, c) for a, c in zip(got, again))
            del again
            errs = [rel_err(a, r) for a, r in zip(got, fused_window_attention_backward_plain(q, k, v, bias, mask, out,
                                                                                            dout))]
            err = max(e[0] for e in errs)
            require(all(e[1] <= tol for e in errs) and same,
                    f"attention backward {site} {dtype}: dq, dk, dv, dbias max err over max|ref| "
                    f"{[round(e[1], 8) for e in errs]} (tol {tol}), the same bits twice: {same}")
            plan = window_attention_backward_plan(q, k, v, bias, mask)
            msg = (f"attention backward windows {site[0]} heads {site[1]} N {site[2]} D {site[3]} mask rows {site[4]} "
                   f"x{count} {str(dtype)[6:]:8s} max err over max|ref| dq {errs[0][1]:.3g} dk {errs[1][1]:.3g} dv "
                   f"{errs[2][1]:.3g} dbias {errs[3][1]:.3g} (tol {tol}); same bits twice; plan: route "
                   f"{plan['route']}, instance D {plan['head_dim']}, tile {plan['key_tile']} keys x "
                   f"{plan['query_rows']} rows, cluster {plan['cluster']}, {plan['splits']} runs of "
                   f"{plan['windows_per_block']} windows, {plan['blocks']} blocks ({plan['blocks_per_sm']} an SM), "
                   f"{plan['dq_partials']} dq and {plan['dbias_partials']} dbias partials, {plan['launches']} launches")
            if dtype == torch.float32:
                b, h, n, d, nw = site
                k_ms, p_ms = paired_ms(lambda: fused_window_attention_backward(q, k, v, bias, mask, out, dout, lse),
                                       lambda: fused_window_attention_backward_plain(q, k, v, bias, mask, out, dout),
                                       iters=5)
                groups = 1 if nw is None else nw
                add = (bias if nw is None else bias[None] + mask[:, None]).detach().requires_grad_()
                qs, ks, vs = (t.view(b // groups, groups, h, n, d).detach().requires_grad_() if nw else
                              t.detach().requires_grad_() for t in (q, k, v))
                with torch.enable_grad():
                    y = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=add, scale=1.0)
                gs = dout.view(y.shape)
                lib_ms = cuda_ms(lambda: torch.autograd.grad(y, (qs, ks, vs, add), gs, retain_graph=True), iters=5)
                del y, add, qs, ks, vs
                # q, k, v, dO, O read and dq, dk, dv written; bias read, dbias written; lse; mask
                nbytes = (8 * q.numel() * q.element_size() + 2 * bias.numel() * 4 + b * h * n * 4
                          + (0 if mask is None else mask.numel() * 4))
                b_ms, o_ms = bound_tf32x3(nbytes, 5 * 2.0 * b * h * n * n * d)
                fma_ms = bound(0, 5 * 2.0 * b * h * n * n * d, dtype)[1]
                e_ms = b * h * n * n / rate * 1e3
                if count:
                    rows.append((count, err, k_ms, p_ms, lib_ms, b_ms, max(o_ms, e_ms)))
                sides = {"bytes": b_ms, "FLOP": o_ms, "exp": e_ms}
                side = max(sides, key=sides.get)
                msg += (f"  kernel {k_ms:.4f} ms  plain {p_ms:.4f} ms  SDPA autograd {lib_ms:.4f} ms  bound "
                        f"{sides[side]:.4f} ms ({side}; bytes {b_ms:.4f}, 3xTF32 FLOP {o_ms:.4f}, exp {e_ms:.4f}); "
                        f"{sides[side] / k_ms:.1%} of the bound; old FMA-pipe FLOP bound {fma_ms:.4f} ms")
                print(msg, flush=True)
                require(k_ms < lib_ms, f"attention backward {site} float32: the kernel's {k_ms:.4f} ms is not below "
                                       f"SDPA autograd's {lib_ms:.4f} ms")
            else:
                print(msg, flush=True)
            del q, k, v, bias, dout, out, lse, got
    torch.cuda.empty_cache()
    return _summary(rows)


def check_attention_forward_f32(masks: dict, dev) -> dict:
    """The forward kernel's float32 tensor-core instance ("tf32x3", as the float32 step runs
    it) at each site of the BTCV step and at its head-dim-8 twins: the instance the plan
    names, the result against the plain version at the float32 gate, two calls bit for bit,
    timed beside the plain version and ``F.scaled_dot_product_attention`` with bias + mask
    as one additive float32 mask (built before the timing). The bound: q, k, v, out, bias
    and mask once, the two N^2 D products as 3xTF32 on the tensor cores (the instance's
    arithmetic), one exp a score; beside it the old bound's products at the float32 FMA
    pipe's 67 TFLOP/s, which the instance no longer runs on. Returns the kernels-line
    numbers of the step's (head dim 16) sites, summed over a step."""
    from monai_tpu_torch.ops.window_attention import (fused_window_attention, fused_window_attention_plain,
                                                      window_attention_plan)

    rate = exp_per_s()
    exp_total = flop_total = fma_total = 0.0
    g = torch.Generator(device=dev).manual_seed(10)
    rows = []
    sites = list(SWIN_ATTN_SITES.items()) + [((b, h, n, 8, nw), 0) for (b, h, n, _, nw) in SWIN_ATTN_SITES]
    for (b, h, n, d, nw), count in sites:
        q, k, v = (torch.randn((b, h, n, d), generator=g, device=dev) for _ in range(3))
        q *= d ** -0.5
        bias = torch.randn((h, n, n), generator=g, device=dev) * 0.5
        mask = None if nw is None else masks[nw]
        plan = window_attention_plan(q, k, v, bias, mask)
        require(plan["instance"] == "tf32x3", f"attention forward {(b, h, n, d, nw)} float32 runs the "
                                              f"{plan['instance']} instance, not tf32x3")
        with torch.no_grad():
            got = fused_window_attention(q, k, v, bias, mask)
            err, rel = rel_err(got, fused_window_attention_plain(q, k, v, bias, mask))
            require(rel <= TOL_F32, f"attention forward {(b, h, n, d, nw)} float32: {rel:.3g} of max|ref| > {TOL_F32}")
            require(torch.equal(got, fused_window_attention(q, k, v, bias, mask)),
                    f"attention forward {(b, h, n, d, nw)} float32: two calls differ")
            del got
            k_ms, p_ms = paired_ms(lambda: fused_window_attention(q, k, v, bias, mask),
                                   lambda: fused_window_attention_plain(q, k, v, bias, mask), iters=10)
            groups = 1 if nw is None else nw
            add = bias if nw is None else bias[None] + mask[:, None]
            qs, ks, vs = (t.view(b // groups, groups, h, n, d) if nw else t for t in (q, k, v))
            lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=add, scale=1.0), iters=10)
        nbytes = 4 * q.numel() * 4 + bias.numel() * 4 + (0 if mask is None else mask.numel() * 4)
        b_ms, o_ms = bound_tf32x3(nbytes, 4.0 * b * h * n * n * d)
        fma_ms = bound(0, 4.0 * b * h * n * n * d, torch.float32)[1]
        e_ms = b * h * n * n / rate * 1e3
        if count:
            rows.append((count, err, k_ms, p_ms, lib_ms, b_ms, max(o_ms, e_ms)))
            exp_total += count * e_ms
            flop_total += count * o_ms
            fma_total += count * max(b_ms, fma_ms, e_ms)
        print(f"attention forward windows {b} heads {h} N {n} D {d} mask rows {nw} x{count} float32 instance "
              f"{plan['instance']} ({plan['rows_per_block']} rows and {plan['windows_per_block']} windows a block, "
              f"{plan['blocks']} blocks): max err {rel:.3g} of max|ref| (tol {TOL_F32}), two calls bit for bit  "
              f"kernel {k_ms:.4f} ms  plain {p_ms:.4f} ms  SDPA {lib_ms:.4f} ms  bound "
              f"{max(b_ms, o_ms, e_ms):.4f} ms (bytes {b_ms:.4f}, 3xTF32 FLOP {o_ms:.4f}, exp {e_ms:.4f}); "
              f"{max(b_ms, o_ms, e_ms) / k_ms:.1%} of the bound; old FMA-pipe bound {max(b_ms, fma_ms, e_ms):.4f} ms",
              flush=True)
        del q, k, v, bias, add, qs, ks, vs
    torch.cuda.empty_cache()
    out = _summary(rows)
    out["bound_side"] = "exp" if exp_total >= max(out["bytes_ms"], flop_total) else out["bound_by"]
    print(f"attention forward float32 a step: kernel {out['ms']:.4f} ms, bound {out['bound_ms']:.4f} ms "
          f"({out['bound_ms'] / out['ms']:.1%}; 3xTF32 products), old FMA-pipe bound {fma_total:.4f} ms", flush=True)
    return out


def _swin_grads(net, x, y, loss_fn) -> tuple[float, dict]:
    net.zero_grad(set_to_none=True)
    loss = loss_fn(net(x), y)
    loss.backward()
    return loss.item(), {k: p.grad.detach().clone() for k, p in net.named_parameters()}


def swin_step_check(net_cpu, dev) -> None:
    """One float32 step of the BTCV SwinUNETR at batch 1 of 32^3 (full widths) on the card
    against the port's CPU step of the same weights and data (see SWIN_STEP_ROI)."""
    from monai_tpu_torch.losses import DiceCELoss

    gen = torch.Generator().manual_seed(21)
    x = torch.rand((1, 1, *SWIN_STEP_ROI), generator=gen)
    y = torch.randint(0, 14, (1, 1, *SWIN_STEP_ROI), generator=gen).float()
    loss_fn = DiceCELoss(to_onehot_y=True, softmax=True)
    net_one = copy.deepcopy(net_cpu).train()
    for name, buf in net_one.named_buffers():  # the slopes fused into the norm kernel
        if name.endswith("lrelu_slope"):
            buf.fill_(1.0)
    for m in net_one.modules():  # and the LeakyReLUs after the residual adds
        if isinstance(m, torch.nn.LeakyReLU):
            m.negative_slope = 1.0
    results = {}
    for label, net_c in (("slopes 1", net_one), ("as it is", net_cpu.train())):
        t0 = time.perf_counter()
        ref_loss, ref = _swin_grads(net_c, x, y, loss_fn)
        cpu_s = time.perf_counter() - t0
        net_c.zero_grad(set_to_none=True)
        loss, got = _swin_grads(copy.deepcopy(net_c).to(dev), x.to(dev), y.to(dev), loss_fn)
        skip = SWIN_EXACT_ZERO | SWIN_EPS_ONLY
        largest = max(r.abs().max().item() for r in ref.values())
        zero = max(max(got[k].abs().max().item(), ref[k].abs().max().item()) for k in SWIN_EXACT_ZERO) / largest
        errs = sorted(((got[k].cpu() - r).abs().max().item() / max(r.abs().max().item(), 1e-30), k)
                      for k, r in ref.items() if k not in skip)
        cos = sorted((F.cosine_similarity(got[k].cpu().double().flatten(), r.double().flatten(), dim=0).item(), k)
                     for k, r in ref.items() if k not in SWIN_EXACT_ZERO)
        results[label] = (abs(loss - ref_loss) / abs(ref_loss), errs, cos, zero)
        print(f"swin train step batch 1 @{SWIN_STEP_ROI} float32, LeakyReLU {label}, against the CPU step ({cpu_s:.1f} "
              f"s on the CPU): loss {ref_loss:.6f}, rel err {results[label][0]:.3g}; worst grads (max err over "
              f"max|ref|) " + ", ".join(f"{k} {e:.3g}" for e, k in errs[-3:]) + "; least cosines "
              + ", ".join(f"{k} {c:.6f}" for c, k in cos[:3]) + f"; the {len(SWIN_EXACT_ZERO)} grads that are "
              f"exactly 0: max|grad| {zero:.3g} of the largest grad", flush=True)
    loss_one, errs_one, _, zero_one = results["slopes 1"]
    loss_as, _, cos_as, zero_as = results["as it is"]
    require(loss_one <= TOL_STEP_F32 and errs_one[-1][0] <= TOL_STEP_F32,
            "the float32 SwinUNETR step (slopes 1) on the card disagrees with the CPU")
    require(loss_as <= TOL_STEP_F32 and cos_as[0][0] >= SWIN_MIN_COSINE,
            "the float32 SwinUNETR step on the card disagrees with the CPU")
    require(max(zero_one, zero_as) <= TOL_STEP_F32, "a SwinUNETR grad that is exactly 0 is not ~0 on the card or CPU")


def swin_train_path(net_cpu, per_step: dict, dev) -> dict:
    """``SupervisedTrainer`` in float32 (no amp) with the optimizer given as a factory (the
    bundle's ``"_mode_": "partial"``), on one fixed batch of 4 96^3 patches, under torch's
    default ``cudnn.allow_tf32`` (True; restored after): SWIN_TRAIN_WARMUP iterations, then
    SWIN_TRAIN_TIMED timed, their launch counts and peak memory (set to 0 just before
    them), the step times between CUDA events at each iteration's end and each loss.
    Returns the launch counts of the timed run."""
    import functools

    from monai_tpu_torch.engines import Events, SupervisedTrainer
    from monai_tpu_torch.losses import DiceCELoss
    from monai_tpu_torch.networks.layers.fast_norm import _InstanceNormPReLU
    from monai_tpu_torch.ops.conv3d import _Conv3x3Same

    net = copy.deepcopy(net_cpu).to(dev)
    gen = torch.Generator(device=dev).manual_seed(22)
    batch = {"image": torch.rand((TRAIN_BATCH, 1, *ROI), generator=gen, device=dev),
             "label": torch.randint(0, 14, (TRAIN_BATCH, 1, *ROI), generator=gen, device=dev).float()}
    trainer = SupervisedTrainer(device=dev, max_epochs=1,
                                train_data_loader=[batch] * (SWIN_TRAIN_WARMUP + SWIN_TRAIN_TIMED), network=net,
                                optimizer=functools.partial(torch.optim.AdamW, lr=1e-4, weight_decay=1e-5),
                                loss_function=DiceCELoss(to_onehot_y=True, softmax=True))
    losses, ends, start = [], [], {}

    @trainer.on(Events.ITERATION_COMPLETED)
    def _record(engine):
        losses.append(engine.state.output["loss"])
        ends.append(torch.cuda.Event(enable_timing=True))
        ends[-1].record()
        if engine.state.iteration == SWIN_TRAIN_WARMUP:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            reset_launch_counts()
            _Conv3x3Same.copied_bytes = _InstanceNormPReLU.copied_bytes = 0
            start["t"] = time.perf_counter()

    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True  # torch's default, as a user's process runs
    try:
        trainer.run()
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    wall = time.perf_counter() - start["t"]
    counts = all_launch_counts()
    losses = [v.item() for v in losses]
    step_ms = [ends[i].elapsed_time(ends[i + 1]) for i in range(SWIN_TRAIN_WARMUP - 1, len(ends) - 1)]
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    got = {k: v / SWIN_TRAIN_TIMED for k, v in counts.items() if k in per_step}
    copied = (_Conv3x3Same.copied_bytes / SWIN_TRAIN_TIMED, _InstanceNormPReLU.copied_bytes / SWIN_TRAIN_TIMED)
    print(f"swin_train SupervisedTrainer float32 SwinUNETR(1, 14, feature_size=48) batch {TRAIN_BATCH} @96^3 "
          f"(cudnn.allow_tf32 True, matmul TF32 {torch.backends.cuda.matmul.allow_tf32}): "
          f"{SWIN_TRAIN_TIMED / wall:.4f} steps/s, {TRAIN_BATCH * SWIN_TRAIN_TIMED / wall:.3f} patches/s "
          f"({SWIN_TRAIN_TIMED} steps after {SWIN_TRAIN_WARMUP} warm-up, one synchronise at the end); step median "
          f"{statistics.median(step_ms):.3f} ms (min {min(step_ms):.3f}, max {max(step_ms):.3f}, CUDA events at each "
          f"iteration's end); peak memory {peak_gb:.2f} GB; grads that came back channel-first and were copied a "
          f"step: conv {copied[0] / 1e6:.2f} MB, norm {copied[1] / 1e6:.2f} MB; launches a step {got} (the sites give "
          f"{per_step}); loss by step: " + ", ".join(f"{v:.6f}" for v in losses), flush=True)
    require(all(np.isfinite(v) for v in losses), "swin_train: a loss is not finite")
    require(losses[SWIN_TRAIN_TIMED] < losses[0], f"swin_train: the loss after {SWIN_TRAIN_TIMED} steps "
                                                  f"{losses[SWIN_TRAIN_TIMED]:.6f} is not below the first {losses[0]:.6f}")
    require(got == per_step, f"swin_train: launches a step {got}, the sites give {per_step}")
    return counts


def swin_training_phase(dev) -> tuple[dict, dict]:
    """Phase 9: the BTCV SwinUNETR's training step: the backward kernel of the window
    attention at the step's sites, the conv and norm kernels' backward at the Swin sites
    (timed in float32), the batch-1 step against the CPU, and the float32 trainer. Returns
    the trainer's launch counts and the kernels-line numbers of the attention backward and
    forward, dw, dx and the norm's backward, each summed over a float32 step's sites."""
    from monai_tpu_torch.networks.nets import SwinUNETR

    net_cpu = SwinUNETR(1, 14, feature_size=48, generator=torch.Generator().manual_seed(0), device="cpu")
    window = torch.rand((TRAIN_BATCH, 1, *ROI), generator=torch.Generator(device=dev).manual_seed(1), device=dev)
    with torch.no_grad():
        conv_sites, norm_sites, attn_sites, masks = record_sites(copy.deepcopy(net_cpu).to(dev).train(), window)
    require(attn_sites == Counter(SWIN_ATTN_SITES), f"the BTCV step's attention sites {dict(attn_sites)} are not "
                                                    f"{SWIN_ATTN_SITES}")
    n_conv, n_norm, n_attn = sum(conv_sites.values()), sum(norm_sites.values()), sum(attn_sites.values())
    # each conv a forward and a dx, but encoder1's first: its input is the image, which takes no grad
    per_step = {"conv3d_3x3_same": 2 * n_conv - 1, "conv3d_3x3_wgrad": n_conv, "instance_norm_prelu": n_norm,
                "instance_norm_prelu_backward": n_norm, "fused_window_attention": n_attn,
                "fused_window_attention_backward": n_attn}
    print(f"swin_train sites a step (batch {TRAIN_BATCH}): {n_conv} 3x3x3 stride-1 convs (each a forward, a dx but "
          f"the first and a dw), {n_norm} instance norms (each a forward and a backward; affine, LeakyReLU 0.01 or none), {n_attn} "
          f"window attentions (each a forward and a backward)", flush=True)
    attn_bwd = check_attention_backward(masks, dev)
    attn_fwd = check_attention_forward_f32(masks, dev)
    del masks
    # the conv and norm backward kernels at the Swin sites, in the step's float32 (timed) and
    # in bfloat16
    checked = ((torch.float32, TOL_F32), (torch.bfloat16, TOL_BF16))
    dw, dx = check_conv_backward(conv_sites, TRAIN_BATCH, dev, checked, timed=torch.float32)
    norm_bwd = check_norm_backward(norm_sites, TRAIN_BATCH, dev, checked, timed=torch.float32)
    torch.cuda.empty_cache()
    swin_step_check(net_cpu, dev)
    torch.cuda.empty_cache()
    counts = swin_train_path(net_cpu, per_step, dev)
    torch.cuda.empty_cache()
    return counts, {"attention_backward": attn_bwd, "attention_forward": attn_fwd, "dw": dw, "dx": dx,
                    "norm_backward": norm_bwd}


# Phases 10-12: a bundle's train.json through the port's runner, overriding its bundle root,
# its imports and initialize (naming the port), its optimizer (optax's rates under torch's
# name) and its datalists (the file's own expressions at a synthetic size its 96^3 crops
# fit: BTCV's and Spleen's 96^3 phantoms at 1 mm come out of Spacingd 64x64x48, which
# RandCropByPosNegLabeld refuses; BraTS's 64^3 phantoms would give 64^3 crops, so they are
# written at 240x240x155, a Task01 volume's shape)
BUNDLES = Path(__file__).resolve().parent / "bundles"
BUILD = Path(__file__).resolve().parent / "build"
BTCV_CONFIG = BUNDLES / "btcv_swinunetr" / "configs" / "train.json"
BTCV_SYNTH_SIZE = (160, 160, 200)
BRATS_CONFIG = BUNDLES / "brats_segresnet" / "configs" / "train.json"
BRATS_SYNTH_SIZE = (240, 240, 155)
SPLEEN_TRAIN_CONFIG = BUNDLES / "spleen_ct_segmentation" / "configs" / "train.json"
SPLEEN_SYNTH_SIZE = (160, 160, 200)


def bundle_overrides(config: Path, root: Path, size: tuple[int, ...], seed: int, optimizer: dict) -> dict:
    """The runner's overrides of a training bundle (README gives them as a command line)."""
    cfg = json.loads(config.read_text())
    lists = {k: re.sub(r"spatial_size=\([0-9, ]*\)", f"spatial_size={size}", cfg[k])
             for k in ("datalist", "val_datalist")}
    require(all(f"spatial_size={size}" in v for v in lists.values()), f"{config}: the datalist expressions changed")
    imports = [i.replace("monai_tpu.", "monai_tpu_torch.") for i in cfg["imports"]]
    return {"bundle_root": str(root), "imports": imports,
            "initialize": ["$import monai_tpu_torch", f"$monai_tpu_torch.utils.set_determinism(seed={seed})"],
            "optimizer": {"_mode_": "partial", **optimizer}, **lists}


def train_bundle_phase(name: str, config: Path, overrides, synth: dict, steps: int, crop: tuple[int, ...],
                       per_step: dict, fresh_net, dev, cli: bool = True) -> tuple[dict, dict, torch.nn.Module]:
    """A bundle's train.json through ``monai_tpu_torch.bundle.run`` in a fresh bundle root
    under ``build/<name>_bundle``: the synthetic data made first (``synth``, the arguments of
    ``make_synthetic_datalist``, timed; the config's expression then finds the files), the
    cache fill, the two epochs' iterations and times, each validation's time and
    ``val_mean_dice``, the peak memory and every kernel's launches, and the launches of
    each training iteration, 3x3x3 conv forwards counted at the modules (the conv kernel's
    launches less those are dx). Checked: both epochs and ``steps`` iterations, every loss
    finite, every batch of crops ``crop`` on the card, each iteration's launches
    ``per_step`` (by wrapper name, ``conv3d_forward`` and ``conv3d_dx``), the dice finite in
    [0, 1], the checkpoint loading into ``fresh_net()`` equal to the trained network. Then,
    where ``cli``, the same command line as a process of its own with ``--epochs 1``, and
    its checkpoint. Returns the run's launch counts, the launches an iteration and the
    trained network."""
    from monai_tpu_torch.apps.datasets import make_synthetic_datalist
    from monai_tpu_torch.bundle import run
    from monai_tpu_torch.data import CacheDataset
    from monai_tpu_torch.engines import Events, SupervisedTrainer, Workflow
    from monai_tpu_torch.networks.layers.factories import Conv3d

    top = BUILD / f"{name}_bundle"
    shutil.rmtree(top, ignore_errors=True)
    root = top / "run"
    t0 = time.perf_counter()
    make_synthetic_datalist(str(root / "data" / synth["dir"]), num_images=synth["num_images"],
                            spatial_size=synth["spatial_size"], num_seg_classes=synth["num_seg_classes"])
    data_s = time.perf_counter() - t0
    stamps, engines, crops, losses, iterations = [], {}, [], [], []
    fire, fill, conv_forward = Workflow.fire_event, CacheDataset.set_data, Conv3d.forward
    forwards = [0]  # 3x3x3 conv forwards under autograd: the training iterations'

    def counted_forward(conv, x):
        if conv.same_3x3x3 and torch.is_grad_enabled():
            forwards[0] += 1
        return conv_forward(conv, x)

    def launches() -> dict:
        return {**all_launch_counts(), "conv3d_forward": forwards[0]}

    def recorded_fire(engine, event):
        kind = "trainer" if isinstance(engine, SupervisedTrainer) else "evaluator"
        engines[kind] = engine
        if kind == "trainer" and str(event) == str(Events.ITERATION_STARTED):
            image = engine.state.batch["image"]
            crops.append((tuple(image.data.shape), image.data.device.type))
            iterations.append(launches())
        if kind == "trainer" and str(event) == str(Events.ITERATION_COMPLETED):
            losses.append(engine.state.output["loss"].item())
            after = launches()
            iterations[-1] = {k: after[k] - iterations[-1][k] for k in after}
            iterations[-1]["conv3d_dx"] = iterations[-1]["conv3d_3x3_same"] - iterations[-1]["conv3d_forward"]
        if str(event) in (str(Events.STARTED), str(Events.EPOCH_STARTED), str(Events.EPOCH_COMPLETED),
                          str(Events.COMPLETED)):
            torch.cuda.synchronize()
            stamps.append((kind, str(event), engine.state.epoch, time.perf_counter()))
        return fire(engine, event)

    def timed_fill(dataset, data):
        t1 = time.perf_counter()
        fill(dataset, data)
        torch.cuda.synchronize()
        stamps.append(("cache", "filled", len(dataset._cache), time.perf_counter() - t1))

    Workflow.fire_event, CacheDataset.set_data, Conv3d.forward = recorded_fire, timed_fill, counted_forward
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launch_counts()
    t0 = time.perf_counter()
    try:
        run(config_file=str(config), **overrides(root))
        torch.cuda.synchronize()
    finally:
        Workflow.fire_event, CacheDataset.set_data, Conv3d.forward = fire, fill, conv_forward
    total_s = time.perf_counter() - t0
    counts = all_launch_counts()
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    trainer, evaluator = engines["trainer"], engines["evaluator"]
    n_steps = trainer.state.iteration

    def at(kind, event, epoch):
        return next(t for n, e, ep, t in stamps if n == kind and e == event and ep == epoch)

    # each stamp is taken before the event's handlers run: an epoch's time is its iterations
    # (the loader's reads included), without the validation its EPOCH_COMPLETED handler runs
    epochs = [at("trainer", str(Events.EPOCH_COMPLETED), e) - at("trainer", str(Events.EPOCH_STARTED), e)
              for e in (1, 2)]
    starts, ends = ([t for n, e, _, t in stamps if n == "evaluator" and e == str(ev)]
                    for ev in (Events.STARTED, Events.COMPLETED))
    vals = [b - a for a, b in zip(starts, ends)]
    train_s = sum(epochs)
    fill_s = [t for n, e, _, t in stamps if n == "cache"]
    dice = evaluator.state.metrics.get("val_mean_dice", float("nan"))
    step = {k: v for k, v in iterations[-1].items() if v} if iterations else {}
    print(f"{name} bundle train.json (python -m monai_tpu_torch.bundle run's function; datalists at "
          f"{synth['spatial_size']}): synthetic data ({synth['num_images']} images) {data_s:.1f} s; cache fill "
          f"{fill_s[0] if fill_s else float('nan'):.2f} s ({trainer.data_loader.dataset.cache_num} items); "
          f"{trainer.state.epoch} epochs, {n_steps} steps of {crop}, {n_steps / train_s:.4f} steps/s over the training "
          f"iterations ({train_s:.2f} s, the loader's reads included); epochs {', '.join(f'{t:.2f}' for t in epochs)} "
          f"s; validations {', '.join(f'{t:.2f}' for t in vals)} s; val_mean_dice {dice:.6f}; the whole run "
          f"{total_s:.1f} s with the parse, the net and the data; peak memory {peak_gb:.2f} GB; launches {counts}; "
          f"launches an iteration {step} (3x3x3 conv forward {step.get('conv3d_forward', 0)}, dx "
          f"{step.get('conv3d_dx', 0)}, dw {step.get('conv3d_3x3_wgrad', 0)}); losses "
          + ", ".join(f"{v:.4f}" for v in losses), flush=True)
    require(trainer.state.epoch == 2 and n_steps == steps, f"{name} bundle: {trainer.state.epoch} epochs, "
                                                           f"{n_steps} steps, not 2 and {steps}")
    require(all(np.isfinite(v) for v in losses) and len(losses) == n_steps,
            f"{name} bundle: a training loss is not finite")
    require(all(c == (crop, "cuda") for c in crops) and len(crops) == n_steps,
            f"{name} bundle: crop batches {sorted(set(crops))}, not {crop} on the card")
    for i, it in enumerate(iterations):
        require(all(it[k] == v > 0 for k, v in per_step.items()),
                f"{name} bundle: iteration {i + 1} launched {it}, not {per_step}")
    require(np.isfinite(dice) and 0.0 <= dice <= 1.0, f"{name} bundle: val_mean_dice {dice}")
    ckpt = root / "models" / "model_final.ckpt"
    fresh = fresh_net()
    fresh.load_state_dict(torch.load(ckpt, map_location="cpu", weights_only=True)["model"])
    network = trainer.network
    trained = network.state_dict()
    require(all(torch.equal(v, trained[k].cpu()) for k, v in fresh.state_dict().items()),
            f"{name} bundle: the checkpoint is not the trained network")
    del trainer, evaluator, engines, fresh, trained
    torch.cuda.empty_cache()

    if cli:  # the command line, as README gives it, one epoch, on the same synthetic data
        args = [sys.executable, "-m", "monai_tpu_torch.bundle", "run", "--config_file", str(config), "--epochs", "1"]
        for k, v in overrides(top / "cli").items():
            args += [f"--{k}", v if isinstance(v, str) else json.dumps(v)]
        env = {**os.environ, "MONAI_DATA_DIRECTORY": str(root / "data")}
        t0 = time.perf_counter()
        proc = subprocess.run(args, capture_output=True, text=True, env=env, cwd=Path(__file__).resolve().parent)
        require(proc.returncode == 0, f"{name} bundle command line failed: {proc.stderr[-2000:]}")
        cli_ckpt = top / "cli" / "models" / "model_final.ckpt"
        fresh_net().load_state_dict(torch.load(cli_ckpt, map_location="cpu", weights_only=True)["model"])
        print(f"{name} bundle command line (--epochs 1, a process of its own): {time.perf_counter() - t0:.1f} s with "
              f"the process's start; {cli_ckpt.relative_to(top)} loads into a fresh network; its last log lines: "
              + " | ".join(proc.stdout.strip().splitlines()[-2:]), flush=True)
    return counts, step, network


def btcv_bundle_phase(dev) -> dict:
    """Phase 10: the BTCV bundle's train.json (``train_bundle_phase``): 8 images at
    160x160x200, 12 steps of 4 crops, 8 attention backward launches a step. Returns the
    run's launch counts."""
    from monai_tpu_torch.networks.nets import SwinUNETR

    optimizer = {"_target_": "torch.optim.AdamW", "lr": 1e-4, "weight_decay": 1e-5}
    counts, _, _ = train_bundle_phase(
        "btcv", BTCV_CONFIG, lambda root: bundle_overrides(BTCV_CONFIG, root, BTCV_SYNTH_SIZE, 0, optimizer),
        {"dir": "BTCV_synth", "num_images": 8, "spatial_size": BTCV_SYNTH_SIZE, "num_seg_classes": 3}, 12,
        (4, 1, *ROI), {"fused_window_attention_backward": 8}, lambda: SwinUNETR(1, 4, feature_size=48, device="cpu"),
        dev)
    return counts


# Phases 11 and 12, kernel 1 at their float32 sites: the forward, dx and dw kernels against
# their plain versions in float32 (TOL_F32), timed against cuDNN in full float32 and the
# bound at the float32 peak; the trained network's forward on the card against the CPU; a
# batch-1 32^3 step on the card against the CPU's (the loss relative, each grad's cosine:
# ReLU's kink turns float32 order differences into grad differences, as the LeakyReLU's
# does in phase 9)
TRAIN_CHECKED_F32 = ((torch.float32, TOL_F32),)
TRAIN_MIN_COSINE = 0.999


def check_conv_f32_sites(name: str, net, batch: int, dev) -> tuple[dict, dict, dict, Counter]:
    """Kernel 1's forward, dx and dw at each 3x3x3 site of ``net`` (a CPU network) at
    ``batch`` 96^3 inputs, in float32 (``check_conv`` and ``check_conv_backward``). Returns
    the three kernels-line summaries, each summed over a step's sites, and the sites."""
    window = torch.rand((batch, net.in_channels, *ROI), generator=torch.Generator(device=dev).manual_seed(1),
                        device=dev)
    with torch.no_grad():
        sites = record_sites(copy.deepcopy(net).to(dev).eval(), window)[0]
    print(f"{name} 3x3x3 stride-1 conv sites at batch {batch} of 96^3: "
          + ", ".join(f"{ci}->{co} @{sp} x{n}" for (ci, co, sp), n in sorted(sites.items())), flush=True)
    forward = check_conv(sites, batch, dev, timed=torch.float32, checked=TRAIN_CHECKED_F32)
    dw, dx = check_conv_backward(sites, batch, dev, TRAIN_CHECKED_F32, timed=torch.float32)
    return forward, dx, dw, sites


def net_against_cpu(name: str, network, fresh_net, loss_fn, label, dev) -> None:
    """The trained network (on the card) in eval mode on a 96^3 input against its CPU copy,
    relative to the CPU logits' std; then, on a fresh float32 copy without dropout, one
    batch-1 32^3 training step's loss and grads on the card against the CPU's."""
    gen = torch.Generator().manual_seed(31)
    cpu = fresh_net()
    cpu.load_state_dict({k: v.cpu() for k, v in network.state_dict().items()})
    card = copy.deepcopy(cpu).to(dev)
    x = torch.rand((1, cpu.in_channels, *ROI), generator=gen)
    with torch.no_grad():
        ref = cpu.eval()(x)
        got = card.eval()(x.to(dev)).cpu()
    err = (got - ref).abs().max().item() / ref.std().item()
    print(f"{name} trained network, eval forward at 96^3 on the card against the CPU: max err {err:.3g} std of the "
          f"CPU logits (tol {TOL_FWD_F32_MAX})", flush=True)
    require(err <= TOL_FWD_F32_MAX, f"{name}: the trained network's forward on the card disagrees with the CPU")
    x, y = torch.rand((1, cpu.in_channels, 32, 32, 32), generator=gen), label(gen)
    results = []
    for net, device in ((cpu, "cpu"), (card, dev)):
        net.train()
        net.zero_grad(set_to_none=True)
        loss = loss_fn(net(x.to(device)), y.to(device))
        loss.backward()
        results.append((loss.item(), {k: p.grad.double().cpu().reshape(-1) for k, p in net.named_parameters()}))
    (loss_cpu, g_cpu), (loss_card, g_card) = results
    zero = _normed_biases(cpu)  # exactly 0: held under TOL_STEP_F32 of the largest grad on both sides
    largest = max(g.abs().max().item() for g in g_cpu.values())
    zero_max = max((g[k].abs().max().item() for g in (g_cpu, g_card) for k in zero), default=0.0) / largest
    cosines = sorted((F.cosine_similarity(g_card[k][None], g_cpu[k][None]).item(), k) for k in g_cpu if k not in zero)
    loss_rel = abs(loss_card - loss_cpu) / abs(loss_cpu)
    print(f"{name} batch-1 32^3 float32 step on the card against the CPU: loss {loss_card:.6f} against {loss_cpu:.6f} "
          f"({loss_rel:.3g} relative, tol {TOL_STEP_F32}); least grad cosine {cosines[0][0]:.6f} ({cosines[0][1]}; "
          f"tol {TRAIN_MIN_COSINE}); {len(zero)} conv biases before a norm (exact grad 0) at most {zero_max:.3g} of "
          f"the largest grad (tol {TOL_STEP_F32})", flush=True)
    require(loss_rel <= TOL_STEP_F32 and cosines[0][0] >= TRAIN_MIN_COSINE and zero_max <= TOL_STEP_F32,
            f"{name}: the float32 step on the card disagrees with the CPU")


def step_profile(name: str, network, batch: dict, loss_fn, dev) -> None:
    """One float32 training step of ``network`` (forward, loss, backward) under
    ``torch.profiler`` after a warm-up step: the device time, the layout copies (``aten::copy_``
    and their device time) and the conv's channel-first grads copied, and the kernels by
    device time."""
    from torch.profiler import ProfilerActivity, profile

    from monai_tpu_torch.ops.conv3d import _Conv3x3Same

    def step():
        network.zero_grad(set_to_none=True)
        loss_fn(network(batch["image"]), batch["label"]).backward()

    network.train()
    step()
    torch.cuda.synchronize()
    _Conv3x3Same.copied_bytes = 0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    events = prof.key_averages()

    def device_ms(e) -> float:
        return getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0.0)) / 1e3

    copies = [e for e in events if e.key == "aten::copy_"]
    kernels = sorted((e for e in events if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA),
                     key=device_ms, reverse=True)
    total = sum(device_ms(e) for e in kernels)
    print(f"{name} one float32 training step at {tuple(batch['image'].shape)} under torch.profiler: device kernel "
          f"time {total:.3f} ms; aten::copy_ {sum(e.count for e in copies)} calls, "
          f"{sum(device_ms(e) for e in copies):.3f} ms of device time; conv grads copied from channel-first "
          f"{_Conv3x3Same.copied_bytes / 1e6:.2f} MB; kernels by device time: "
          + "; ".join(f"{e.key[:60]} x{e.count} {device_ms(e):.3f} ms" for e in kernels[:12]), flush=True)


def brats_bundle_phase(dev) -> tuple[dict, dict]:
    """Phase 11: the BraTS bundle's train.json (``train_bundle_phase``) at the file's own
    width (``SegResNet`` init_filters 16, blocks (1, 2, 2, 4) and (1, 1, 1), dropout 0.2,
    1 input channel as the synthetic branch gives), 8 phantoms at 240x240x155, 12 steps of
    one 96^3 crop, ``DiceLoss(sigmoid, squared_pred)`` and AdamW at the file's rates; kernel
    1's forward, dx and dw at the net's float32 sites first; then the trained network
    against the CPU and one step's profile. Returns the run's launch counts and the three
    kernels' summaries."""
    from monai_tpu_torch.losses import DiceLoss
    from monai_tpu_torch.networks.nets import SegResNet

    def fresh_net(dropout: float | None = 0.2):
        return SegResNet(3, init_filters=16, in_channels=1, out_channels=3, dropout_prob=dropout,
                         blocks_down=(1, 2, 2, 4), blocks_up=(1, 1, 1), device="cpu")

    forward, dx, dw, sites = check_conv_f32_sites("brats", fresh_net(), 1, dev)
    n = sum(sites.values())
    torch.cuda.empty_cache()
    optimizer = {"_target_": "torch.optim.AdamW", "lr": 1e-4, "weight_decay": 1e-5}
    # each 3x3x3 conv a forward, a dx but convInit's (its input is the image) and a dw
    counts, step, network = train_bundle_phase(
        "brats", BRATS_CONFIG, lambda root: bundle_overrides(BRATS_CONFIG, root, BRATS_SYNTH_SIZE, 0, optimizer),
        {"dir": "Task01_BrainTumour_synth", "num_images": 8, "spatial_size": BRATS_SYNTH_SIZE, "num_seg_classes": 3},
        12, (1, 1, *ROI), {"conv3d_forward": n, "conv3d_dx": n - 1, "conv3d_3x3_wgrad": n}, fresh_net, dev)
    loss = DiceLoss(smooth_nr=0, smooth_dr=1e-5, squared_pred=True, sigmoid=True)
    net_against_cpu("brats", network, lambda: fresh_net(None), loss,
                    lambda gen: (torch.rand((1, 3, 32, 32, 32), generator=gen) > 0.7).float(), dev)
    gen = torch.Generator(device=dev).manual_seed(32)
    step_profile("brats", network, {"image": torch.rand((1, 1, *ROI), generator=gen, device=dev),
                                    "label": (torch.rand((1, 3, *ROI), generator=gen, device=dev) > 0.7).float()},
                 loss, dev)
    del network
    torch.cuda.empty_cache()
    return counts, {"forward": forward, "dx": dx, "dw": dw}


def spleen_train_bundle_phase(dev) -> tuple[dict, dict]:
    """Phase 12: the Spleen bundle's train.json (``train_bundle_phase``): the float32
    batch-norm ``UNet(1, 2, (16, 32, 64, 128, 256), (2, 2, 2, 2), num_res_units=2)``, 8
    phantoms at 160x160x200 (107x107x100 after Spacingd), 6 steps of 2 images x 4 crops of
    96^3, ``DiceCELoss`` and Adam (lr 1e-4), validation by ``SlidingWindowInferer(96, 4,
    0.25)``; kernel 1's forward, dx and dw at the step's batch-8 float32 sites first; then
    the trained network against the CPU and one step's profile. Returns the run's launch
    counts and the three kernels' summaries."""
    from monai_tpu_torch.losses import DiceCELoss
    from monai_tpu_torch.networks.nets import UNet

    def fresh_net():
        return UNet(3, 1, 2, channels=(16, 32, 64, 128, 256), strides=(2, 2, 2, 2), num_res_units=2, norm="batch",
                    device="cpu")

    forward, dx, dw, sites = check_conv_f32_sites("spleen_train", fresh_net(), 8, dev)
    n = sum(sites.values())
    torch.cuda.empty_cache()
    # each 3x3x3 conv a forward, a dx (the image goes into a stride-2 conv) and a dw
    counts, step, network = train_bundle_phase(
        "spleen_train", SPLEEN_TRAIN_CONFIG,
        lambda root: bundle_overrides(SPLEEN_TRAIN_CONFIG, root, SPLEEN_SYNTH_SIZE, 123,
                                      {"_target_": "torch.optim.Adam", "lr": 1e-4}),
        {"dir": "Task09_Spleen_synth", "num_images": 8, "spatial_size": SPLEEN_SYNTH_SIZE, "num_seg_classes": 1},
        6, (8, 1, *ROI), {"conv3d_forward": n, "conv3d_dx": n, "conv3d_3x3_wgrad": n}, fresh_net, dev, cli=False)
    loss = DiceCELoss(to_onehot_y=True, softmax=True)
    net_against_cpu("spleen_train", network, fresh_net, loss,
                    lambda gen: (torch.rand((1, 1, 32, 32, 32), generator=gen) > 0.5).float(), dev)
    gen = torch.Generator(device=dev).manual_seed(33)
    batch = {"image": torch.rand((8, 1, *ROI), generator=gen, device=dev),
             "label": (torch.rand((8, 1, *ROI), generator=gen, device=dev) > 0.5).float()}
    step_profile("spleen_train", network, batch, loss, dev)
    del network
    torch.cuda.empty_cache()
    return counts, {"forward": forward, "dx": dx, "dw": dw}


# Phase 13, the MedNIST bundle: its train.json at the file's own sizes (48 synthetic 64x64
# images of 6 classes, 36 to train at batch 8, two epochs), and the native ops its
# RandRotated needs, each against the port on the CPU
MEDNIST_CONFIG = BUNDLES / "mednist_classification" / "configs" / "train.json"
MEDNIST_IMAGE = (1, 64, 64)
MEDNIST_STEPS = (8, 8, 8, 8, 4)  # an epoch's batches of 36 images
# grid_pull, grid_push and grid_count on the card against the CPU: order 0 gathers one
# voxel and is bit-identical; orders 1-7 sum up to 8^3 taps a point in float32 against the
# CPU's float64 (the inputs the same float32 values), 1e-5 of max|ref|; the push and count
# add on the card in no fixed order, up to ~60 float32 terms a voxel, 1e-5 of max|ref|
TOL_NATIVE = 1e-5
# the GMM's EM in float32 on the card and the CPU: a solve and a slogdet a component and
# step, 10 steps, sums in another order carried through them (the CPU tests hold the port to
# the JAX package at 1e-4)
TOL_GMM = 1e-4
NATIVE_VOLUME, NATIVE_GRID = (3, 48, 48, 48), (32, 32, 32)
NATIVE_BOUNDS = ("zeros", "border", "reflection", "dct1", "dst1", "dst2", "dft", "sliding")


def native_ops_check(dev) -> None:
    """The general resample's ops on the card against the port on the CPU, on a (3, 48, 48,
    48) float32 volume and a rotated, sheared 32^3 grid reaching past its ends:
    ``grid_pull`` at orders 0-7 under every bound, ``grid_push`` and ``grid_count`` at
    orders 1 and 3, ``grid_grad`` at orders 1 and 3; then ``GaussianMixtureModel.learn``
    and ``apply`` on (1, 3, 64^2) features."""
    from monai_tpu_torch.networks.layers import GaussianMixtureModel
    from monai_tpu_torch.ops import resample as R

    g = torch.Generator().manual_seed(41)
    x = torch.randn(NATIVE_VOLUME, generator=g)
    a = np.eye(4)
    a[:3, :3] = [[0.9, -0.3, 0.1], [0.35, 0.85, -0.2], [0.05, 0.25, 1.1]]  # rotated and sheared
    a[:3, 3] = [-4.0, 6.0, -3.0]
    grid = R.affine_grid(a, NATIVE_GRID).float()
    xd, gd = x.to(dev), grid.to(dev)
    t0 = time.perf_counter()
    worst, card_s = {}, 0.0
    for order in range(8):
        for bound in NATIVE_BOUNDS:
            t1 = time.perf_counter()
            got = R.grid_pull(xd, gd, order, bound).cpu()
            card_s += time.perf_counter() - t1
            if order == 0:
                require(torch.equal(got, R.grid_pull(x, grid, order, bound)),
                        f"grid_pull order 0 {bound}: the card is not bit-identical to the CPU")
                continue
            ref = R.grid_pull(x.double(), grid.double(), order, bound)
            rel = ((got.double() - ref).abs().max() / ref.abs().max()).item()
            worst[order] = max(worst.get(order, 0.0), rel)
            require(rel <= TOL_NATIVE, f"grid_pull order {order} {bound}: {rel:.3g} of max|ref| (tol {TOL_NATIVE})")
    y = torch.randn((3, *NATIVE_GRID), generator=g)
    push = {}
    for order in (1, 3):
        for name, got, ref in (
                ("push", R.grid_push(y.to(dev), gd, NATIVE_VOLUME[1:], order).cpu(),
                 R.grid_push(y.double(), grid.double(), NATIVE_VOLUME[1:], order)),
                ("count", R.grid_count(gd, NATIVE_VOLUME[1:], order).cpu(),
                 R.grid_count(grid.double(), NATIVE_VOLUME[1:], order)),
                ("grad", R.grid_grad(xd, gd, order).cpu(), R.grid_grad(x.double(), grid.double(), order))):
            rel = ((got.double() - ref).abs().max() / ref.abs().max()).item()
            push[f"{name} {order}"] = rel
            require(rel <= TOL_NATIVE, f"grid_{name} order {order}: {rel:.3g} of max|ref| (tol {TOL_NATIVE})")
    feats = torch.randn((1, 3, 64 * 64), generator=g) + torch.arange(3.0)[None, :, None]
    labels = torch.randint(-1, 3, (1, 64 * 64), generator=g)
    fits = []
    for device in (dev, "cpu"):
        gmm = GaussianMixtureModel(3, 3, 2)
        gmm.learn(feats.to(device), labels.to(device))
        fits.append(([p.cpu() for p in gmm.params], gmm.apply(feats.to(device)).cpu()))
    (card_params, card_post), (cpu_params, cpu_post) = fits
    gmm_err = max(((c - r).abs().max() / r.abs().max()).item() for c, r in zip(card_params, cpu_params))
    post_err = (card_post - cpu_post).abs().max().item()
    print(f"native ops on the card against the CPU, {NATIVE_VOLUME} float32 volume, rotated and sheared "
          f"{NATIVE_GRID} grid: grid_pull orders 0-7 x {', '.join(NATIVE_BOUNDS)}: order 0 bit-identical, orders 1-7 "
          f"worst " + ", ".join(f"{k} {v:.3g}" for k, v in worst.items()) + f" of max|ref| against float64 (tol "
          f"{TOL_NATIVE}); " + ", ".join(f"{k} {v:.3g}" for k, v in push.items()) + f" (tol {TOL_NATIVE}; the "
          f"push's scatter-add in no fixed order); GMM learn {gmm_err:.3g} of max|ref|, apply {post_err:.3g} absolute "
          f"(tol {TOL_GMM}); the card's pulls {card_s:.2f} s, the whole check {time.perf_counter() - t0:.1f} s",
          flush=True)
    require(gmm_err <= TOL_GMM and post_err <= TOL_GMM, "the GMM on the card disagrees with the CPU")


def mednist_zoom_sites(sites: Counter, dev) -> dict:
    """Kernel 3 at each 2-D zoom shape the run gave it, a depth-1 volume (1, 1, 64, 64) to
    (1, 1, zh, zw) at order 1, border, the half-pixel map of ``Zoom``: against its plain
    version (TOL_RESAMPLE), timed beside it and ``F.interpolate(mode="bilinear",
    align_corners=False)``, which computes the same map. Returns the kernels-line numbers
    summed over the run's calls, with the calls and the time of one."""
    from monai_tpu_torch.ops.separable_resample import resample_plan, separable_resample_3d, separable_resample_3d_plain

    x = torch.rand((1, 1, *MEDNIST_IMAGE[1:]), generator=torch.Generator(device=dev).manual_seed(43), device=dev)
    rows, lines = [], []
    for (zh, zw), n in sorted(sites.items()):
        m = np.eye(4)
        for d, (n_in, n_out) in enumerate(zip(MEDNIST_IMAGE[1:], (zh, zw)), 1):
            m[d, d] = n_in / n_out
            m[d, 3] = (m[d, d] - 1.0) / 2.0
        out = (1, zh, zw)
        plan = resample_plan(x.shape, out, m, 1, "border")
        got = separable_resample_3d(x, m, out, 1, "border")
        ref = separable_resample_3d_plain(x, m, out, 1, "border")
        err, rel = rel_err(got, ref)
        require(rel <= TOL_RESAMPLE, f"kernel 3 at the zoom site {zh}x{zw}: {rel:.3g} of max|ref|")
        # the depth-1 volume (C, 1, 64, 64) is (N, C, H, W) to F.interpolate
        lib = lambda: F.interpolate(x, size=(zh, zw), mode="bilinear", align_corners=False)  # noqa: E731
        lib_err = (lib() - ref).abs().max().item()
        k_ms, p_ms = paired_ms(lambda: separable_resample_3d(x, m, out, 1, "border"),
                               lambda: separable_resample_3d_plain(x, m, out, 1, "border"), iters=50)
        lib_ms = cuda_ms(lib, iters=50)
        nbytes = 4.0 * (x.numel() + zh * zw)
        flops = 2.0 * plan.taps * sum(np.prod([(1, zh, zw)[d] if d in plan.order[:k + 1] else x.shape[1 + d]
                                               for d in range(3)]) for k in range(len(plan.order)))
        b_ms, o_ms = bound(nbytes, flops, torch.float32)
        rows.append((n, err, k_ms, p_ms, lib_ms, b_ms, o_ms))
        lines.append(f"{zh}x{zw} x{n} {k_ms:.4f}/{p_ms:.4f}/{lib_ms:.4f}/{max(b_ms, o_ms):.5f} ms "
                     f"(err {rel:.2g}, F.interpolate {lib_err:.2g})")
    calls = sum(r[0] for r in rows)
    summary = _summary(rows)  # the run's calls summed
    summary.update(launches=calls, sites=len(rows), per_call_ms=summary["ms"] / calls)
    print(f"kernel 3 at the MedNIST 2-D zoom sites (1, 1, 64, 64) -> (1, 1, zh, zw), order 1, border, "
          f"one call each (kernel / plain / F.interpolate / bound ms): " + "; ".join(lines)
          + f"; the run's {calls} calls {summary['ms']:.4f} ms (plain {summary['plain_ms']:.4f}, F.interpolate "
          f"{summary['library_ms']:.4f}) against a bound of {summary['bound_ms']:.5f} ({summary['bound_by']}); a call "
          f"{summary['per_call_ms']:.4f} ms", flush=True)
    return summary


def mednist_step_profile(network, batch: dict, loss_fn) -> None:
    """One float32 training step of the DenseNet (forward, loss, backward, no optimizer)
    under ``torch.profiler`` after a warm-up: the device kernel time, the step's wall time
    on the host (five steps without the profiler) and the device's idle share of it, the
    launches of the cuDNN convs, the batch norms and the concatenations (by the aten ops
    that launch them and by kernel name), and the kernels by device time."""
    from torch.profiler import ProfilerActivity, profile

    def step():
        network.zero_grad(set_to_none=True)
        loss_fn(network(batch["image"]), batch["label"]).backward()

    network.train()
    walls = []
    for _ in range(6):  # a warm-up, then the step's wall without the profiler
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall_ms = statistics.median(walls[1:])
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    events = prof.key_averages()

    def device_ms(e) -> float:
        return getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0.0)) / 1e3

    kernels = sorted((e for e in events if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA),
                     key=device_ms, reverse=True)
    total = sum(device_ms(e) for e in kernels)
    n_kernels = sum(e.count for e in kernels)
    ops = {e.key: e.count for e in events}
    by_op = {name: sum(ops.get(f"aten::{op}", 0) for op in names) for name, names in (
        ("conv", ("cudnn_convolution", "convolution_backward")),
        ("batch norm", ("cudnn_batch_norm", "cudnn_batch_norm_backward", "native_batch_norm",
                        "native_batch_norm_backward")),
        ("cat", ("cat",)))}

    def kind(name: str) -> str:
        low = name.lower()
        if "cat" in low and "batched" in low:
            return "cat"
        if "bn_" in low or "batch_norm" in low:
            return "batch norm"
        if any(p in low for p in ("conv", "xmma", "gemm", "wgrad", "dgrad", "fprop")):
            return "conv"
        return "other"

    by_kernel = Counter()
    for e in kernels:
        by_kernel[kind(e.key)] += e.count
    print(f"mednist one float32 training step at {tuple(batch['image'].shape)} under torch.profiler: device kernel "
          f"time {total:.3f} ms in {n_kernels} launches, the step's wall {wall_ms:.3f} ms (median of 5 without the "
          f"profiler), idle share {max(0.0, 1 - total / wall_ms):.3f}; aten ops launching them {by_op}; launches by kernel name "
          f"{dict(by_kernel)}; kernels by "
          f"device time: " + "; ".join(f"{e.key[:60]} x{e.count} {device_ms(e):.3f} ms" for e in kernels[:10]),
          flush=True)


def mednist_bundle_phase(dev) -> dict:
    """Phase 13: the MedNIST bundle's train.json through ``monai_tpu_torch.bundle.run`` as it
    stands but for its bundle root, imports, initialize and optimizer (``torch.optim.Adam``
    at the file's 1e-5, for ``optax.adam``): the native ops first (``native_ops_check``);
    then the run, its cache fill, two epochs of 5 steps and a validation each, each batch,
    ``val_rocauc`` after each epoch, the checkpoint; kernel 3 counted against the
    ``RandZoomd`` draws that fired and checked at each zoom shape; ``RandRotated`` on the
    card against the CPU for one draw; the trained DenseNet against the CPU; one step's
    profile. Returns kernel 3's numbers at its 2-D sites."""
    from monai_tpu_torch.bundle import run
    from monai_tpu_torch.data import CacheDataset
    from monai_tpu_torch.engines import Events, SupervisedTrainer, Workflow
    from monai_tpu_torch.losses import CrossEntropyLoss
    from monai_tpu_torch.networks.nets import DenseNet121
    from monai_tpu_torch.ops.separable_resample import separable_resample_3d
    from monai_tpu_torch.transforms import (Compose, EnsureChannelFirstd, LoadImaged, RandRotated, RandZoomd,
                                            ScaleIntensityd)

    native_ops_check(dev)
    top = BUILD / "mednist_bundle"
    shutil.rmtree(top, ignore_errors=True)
    cfg = json.loads(MEDNIST_CONFIG.read_text())
    overrides = {"bundle_root": str(top), "imports": [i.replace("monai_tpu.", "monai_tpu_torch.") for i in cfg["imports"]],
                 "initialize": ["$import monai_tpu_torch", "$monai_tpu_torch.utils.set_determinism(seed=0)"],
                 "optimizer": {"_target_": "torch.optim.Adam", "_mode_": "partial", "lr": cfg["optimizer"]["learning_rate"]}}
    stamps, engines, batches, losses, aucs, zooms = [], {}, [], [], [], []
    fire, fill, zoom_call = Workflow.fire_event, CacheDataset.set_data, RandZoomd.__call__

    def recorded_fire(engine, event):
        kind = "trainer" if isinstance(engine, SupervisedTrainer) else "evaluator"
        engines[kind] = engine
        if kind == "trainer" and str(event) == str(Events.ITERATION_COMPLETED):  # the batch the step took
            image, label = engine.state.output["image"].data, engine.state.output["label"]
            batches.append((tuple(image.shape), image.dtype, image.device.type, tuple(label.shape), label.dtype,
                            label.device.type))
            losses.append(engine.state.output["loss"].item())
        if kind == "evaluator" and str(event) == str(Events.COMPLETED):
            aucs.append(engine.state.metrics.get("val_rocauc", float("nan")))
        if str(event) in (str(Events.STARTED), str(Events.EPOCH_STARTED), str(Events.EPOCH_COMPLETED),
                          str(Events.COMPLETED)):
            torch.cuda.synchronize()
            stamps.append((kind, str(event), engine.state.epoch, time.perf_counter()))
        return fire(engine, event)

    def timed_fill(dataset, data):
        t1 = time.perf_counter()
        fill(dataset, data)
        torch.cuda.synchronize()
        stamps.append(("cache", "filled", len(dataset._cache), time.perf_counter() - t1))

    def read_zoom(transform, data, lazy=None):  # each RandZoomd read: did its draw fire, and at what size
        out = zoom_call(transform, data, lazy)
        if transform.t._do_transform:
            zooms.append(tuple(int(np.floor(n * z)) for n, z in zip(MEDNIST_IMAGE[1:], transform.t._zoom)))
        return out

    Workflow.fire_event, CacheDataset.set_data, RandZoomd.__call__ = recorded_fire, timed_fill, read_zoom
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launch_counts()
    t0 = time.perf_counter()
    try:
        run(config_file=str(MEDNIST_CONFIG), **overrides)
        torch.cuda.synchronize()
    finally:
        Workflow.fire_event, CacheDataset.set_data, RandZoomd.__call__ = fire, fill, zoom_call
    total_s = time.perf_counter() - t0
    counts = all_launch_counts()
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    trainer, evaluator = engines["trainer"], engines["evaluator"]

    def at(kind, event, epoch):
        return next(t for n, e, ep, t in stamps if n == kind and e == event and ep == epoch)

    epochs = [at("trainer", str(Events.EPOCH_COMPLETED), e) - at("trainer", str(Events.EPOCH_STARTED), e)
              for e in (1, 2)]
    starts, ends = ([t for n, e, _, t in stamps if n == "evaluator" and e == str(ev)]
                    for ev in (Events.STARTED, Events.COMPLETED))
    vals = [b - a for a, b in zip(starts, ends)]
    fill_s = [t for n, e, _, t in stamps if n == "cache"]
    resized = [z for z in zooms if z != MEDNIST_IMAGE[1:]]  # a zoom that keeps 64x64 is the identity
    steps_per_epoch = len(MEDNIST_STEPS)
    launched = counts["separable_resample_3d"]
    print(f"mednist bundle train.json (python -m monai_tpu_torch.bundle run's function, the file's own synthetic "
          f"data): cache fill {fill_s[0] if fill_s else float('nan'):.3f} s ({trainer.data_loader.dataset.cache_num} "
          f"items); {trainer.state.epoch} epochs, {trainer.state.iteration} steps, "
          f"{trainer.state.iteration / sum(epochs):.3f} steps/s with the loader's reads ({sum(epochs):.3f} s; the "
          f"second epoch alone {steps_per_epoch / epochs[1]:.3f}); epochs "
          f"{', '.join(f'{t:.3f}' for t in epochs)} s; validations {', '.join(f'{t:.3f}' for t in vals)} s; "
          f"val_rocauc {', '.join(f'{v:.6f}' for v in aucs)}; the whole run {total_s:.1f} s with the parse, the "
          f"synthetic data and the net; peak memory {peak_gb:.3f} GB; RandZoomd draws that fired {len(zooms)}, that "
          f"resized {len(resized)} (sizes {sorted(Counter(resized).items())}); kernel 3 launches {launched}; "
          f"launches {counts}; losses " + ", ".join(f"{v:.4f}" for v in losses), flush=True)
    steps = len(MEDNIST_STEPS)
    require(trainer.state.epoch == 2 and trainer.state.iteration == 2 * steps,
            f"mednist bundle: {trainer.state.epoch} epochs, {trainer.state.iteration} steps, not 2 and {2 * steps}")
    require(len(losses) == 2 * steps and all(np.isfinite(v) for v in losses), "mednist bundle: a loss is not finite")
    want = [((b, *MEDNIST_IMAGE), torch.float32, "cuda", (b,), torch.int64, "cuda") for b in MEDNIST_STEPS] * 2
    require(batches == want, f"mednist bundle: batches {sorted(set(batches))}, not {sorted(set(want))}")
    require(len(aucs) == 2 and all(np.isfinite(v) and 0.0 <= v <= 1.0 for v in aucs),
            f"mednist bundle: val_rocauc {aucs}")
    require(launched == len(resized), f"mednist bundle: kernel 3 launched {launched} times for {len(resized)} "
                                      f"resizing RandZoomd draws")
    require(all(c == 0 for k, c in counts.items() if k != "separable_resample_3d"),
            f"mednist bundle: a kernel off this path launched: {counts}")
    network = trainer.network
    fresh = DenseNet121(2, 1, cfg["num_classes"], device="cpu")
    fresh.load_state_dict(torch.load(top / "models" / "model_final.ckpt", map_location="cpu", weights_only=True)["model"])
    require(all(torch.equal(v, network.state_dict()[k].cpu()) for k, v in fresh.state_dict().items()),
            "mednist bundle: the checkpoint is not the trained network")
    zoom = mednist_zoom_sites(Counter(resized), dev)

    # RandRotated on the card against the CPU, the same draw on the same image
    item = trainer.data_loader.dataset.data[0]
    outs = []
    for device in (dev, "cpu"):
        pre = Compose([LoadImaged(keys="image", device=device), EnsureChannelFirstd(keys="image"),
                       ScaleIntensityd(keys="image")])
        rot = RandRotated(keys="image", range_x=0.26, prob=1.0, keep_size=True).set_random_state(5)
        outs.append(rot(pre(dict(item)))["image"].data.cpu())
    err, rel = rel_err(outs[0], outs[1])
    print(f"RandRotated (angle {rot.t.x:.4f}) on the card against the CPU: {rel:.3g} of max|ref| (tol {TOL_RESAMPLE})",
          flush=True)
    require(rel <= TOL_RESAMPLE, "RandRotated on the card disagrees with the CPU")

    # the trained network against the CPU: a validation batch's forward, a batch-8 step
    val = next(iter(evaluator.data_loader))
    x_val = val["image"].data
    cpu = DenseNet121(2, 1, cfg["num_classes"], device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in network.state_dict().items()})
    card = copy.deepcopy(cpu).to(dev)
    with torch.no_grad():
        ref = cpu.eval()(x_val.cpu())
        got = card.eval()(x_val.to(dev)).cpu()
    fwd = (got - ref).abs().max().item() / ref.std().item()
    loss_fn = CrossEntropyLoss()
    first = next(iter(trainer.data_loader))
    x, y = first["image"].data, first["label"]
    results = []
    for net, device in ((cpu, "cpu"), (card, dev)):
        net.train()
        net.zero_grad(set_to_none=True)
        loss = loss_fn(net(x.to(device)), y.to(device))
        loss.backward()
        results.append((loss.item(), {k: p.grad.double().cpu().reshape(-1) for k, p in net.named_parameters()}))
    (loss_cpu, g_cpu), (loss_card, g_card) = results
    cosines = sorted((F.cosine_similarity(g_card[k][None], g_cpu[k][None]).item(), k) for k in g_cpu)
    loss_rel = abs(loss_card - loss_cpu) / abs(loss_cpu)
    print(f"mednist trained DenseNet121 on the card against the CPU: a validation batch {tuple(x_val.shape)} in eval "
          f"mode, max err {fwd:.3g} std of the CPU logits (tol {TOL_FWD_F32_MAX}); a batch-{x.shape[0]} float32 step's "
          f"loss {loss_card:.6f} against {loss_cpu:.6f} ({loss_rel:.3g} relative, tol {TOL_STEP_F32}), least grad "
          f"cosine {cosines[0][0]:.6f} ({cosines[0][1]}; tol {TRAIN_MIN_COSINE}; ReLU's kinks turn float32 order "
          f"differences into grad differences)", flush=True)
    require(fwd <= TOL_FWD_F32_MAX, "mednist: the trained network's forward on the card disagrees with the CPU")
    require(loss_rel <= TOL_STEP_F32 and cosines[0][0] >= TRAIN_MIN_COSINE,
            "mednist: the float32 step on the card disagrees with the CPU")
    mednist_step_profile(network, {"image": x.to(dev), "label": y.to(dev)}, loss_fn)
    del trainer, evaluator, engines, network, card
    torch.cuda.empty_cache()
    return zoom


def inference_phases(dev) -> tuple:
    """Phases 2 to 6, under ``torch.inference_mode()``: the forward kernels at the inference paths'
    shapes, the sliding windows, the forwards against the CPU, the Spleen path and the filtering
    path. Returns the per-forward summaries, the paths' launch counts and their kernels' numbers."""
    from monai_tpu_torch.data.utils import dense_patch_slices
    from monai_tpu_torch.inferers import SlidingWindowInferer, SlidingWindowInfererAdapt, compute_scan_interval
    from monai_tpu_torch.networks.nets import SwinUNETR, UNet

    # the sliding-window paths' networks: full width, random weights from seed 0, built on the CPU
    nets = {}
    for name, make in (("unet", lambda g: UNet(3, 1, 2, channels=(16, 32, 64, 128, 256), strides=(2, 2, 2, 2),
                                               num_res_units=2, generator=g, device="cpu")),
                       ("swinunetr", lambda g: SwinUNETR(1, 14, feature_size=24, generator=g, device="cpu"))):
        cpu = make(torch.Generator().manual_seed(0)).eval()
        nets[name] = (cpu, copy.deepcopy(cpu).to(dev), copy.deepcopy(cpu).to(dev, torch.bfloat16))
    interval = compute_scan_interval(VOLUME, ROI, 3, (0.25,) * 3)
    require(len(dense_patch_slices(VOLUME, ROI, interval)) == N_WINDOWS, f"a volume should have {N_WINDOWS} windows")

    with torch.inference_mode():
        # 2. each kernel against its plain version at the shapes each path gives it
        summaries = {}
        for name, batch in (("unet", UNET_BATCH), ("swinunetr", SWIN_BATCH)):
            window = torch.rand((batch, 1, *ROI), generator=torch.Generator(device=dev).manual_seed(1), device=dev)
            conv_sites, norm_sites, attn_sites, masks = record_sites(nets[name][2], window.to(torch.bfloat16))
            n_sites = (sum(conv_sites.values()), sum(norm_sites.values()), sum(attn_sites.values()))
            per_forward = UNET_PER_FORWARD if name == "unet" else SWIN_PER_FORWARD
            print(f"{name} sites per {batch}-window forward: {n_sites[0]} 3x3x3 stride-1 convs, {n_sites[1]} "
                  f"instance norms, {n_sites[2]} window attentions", flush=True)
            require(n_sites == per_forward[:3], f"{name} should have {per_forward[:3]} kernel sites, not {n_sites}")
            summaries[name] = (check_conv(conv_sites, batch, dev), check_norm(norm_sites, batch, dev),
                               check_attention(attn_sites, masks, dev) if attn_sites else None)

        # 3. the sliding-window inferers over 224x224x112 volumes; timed before the CPU
        # reference forwards below, as the loops are bound by the host
        unet_counts, _ = sliding_window("unet", SlidingWindowInferer(ROI, sw_batch_size=UNET_BATCH, overlap=0.25,
                                                                     mode="gaussian"),
                                        nets["unet"][2], UNET_PER_FORWARD, UNET_TIMING, dev, 2)
        adapt = SlidingWindowInfererAdapt(ROI, sw_batch_size=SWIN_BATCH, overlap=0.25, mode="gaussian")
        swin_counts, _ = sliding_window("swinunetr", adapt, nets["swinunetr"][2], SWIN_PER_FORWARD, SWIN_TIMING,
                                        dev, 14)
        require(adapt.sw_batch_size == SWIN_BATCH, f"the inferer adapted sw_batch_size to {adapt.sw_batch_size}")

        # 4. one forward per path against the CPU float32 forward, in float32, bfloat16 and
        # float16; and SwinUNETR at feature size 12 (head dim 4: window attention's generic
        # instance)
        for name, per_forward in (("unet", UNET_PER_FORWARD), ("swinunetr", SWIN_PER_FORWARD)):
            cpu, f32, bf16 = nets.pop(name)
            forward_check(name, cpu, f32, {torch.bfloat16: bf16, torch.float16: copy.deepcopy(cpu).to(dev, torch.float16)},
                          per_forward, dev)
            del cpu, f32, bf16
        cpu = SwinUNETR(1, 14, feature_size=12, generator=torch.Generator().manual_seed(0), device="cpu").eval()
        forward_check("swinunetr feature_size 12", cpu, copy.deepcopy(cpu).to(dev),
                      {torch.bfloat16: copy.deepcopy(cpu).to(dev, torch.bfloat16)}, SWIN_PER_FORWARD, dev)
        del nets, cpu
        torch.cuda.empty_cache()

        # 5. the Spleen inference path, its kernels at its shapes, and its checks against the CPU
        spleen_counts, spleen, image, logits, spleen5 = spleen_path(dev)

        # 6. the filtering path on the spleen path's data, and its checks
        filtering = filtering_path(dev, image, logits)
        del image, logits
    return summaries, unet_counts, swin_counts, spleen_counts, spleen, filtering, spleen5


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is false)")
    from monai_tpu_torch.ops._build import library, library_path

    torch.backends.cudnn.allow_tf32 = False  # float32 references in full float32
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s)", flush=True)

    # 1. build the CUDA kernels from the checkout's sources
    t0 = time.perf_counter()
    library()
    print(f"build: {library_path().name} in {time.perf_counter() - t0:.1f} s", flush=True)

    summaries, unet_counts, swin_sw_counts, spleen_counts, spleen, filtering, spleen5 = inference_phases(dev)

    # 7. the training path, outside inference mode
    train_counts, train = training_phase(dev)

    # 9. the BTCV SwinUNETR's float32 training step
    swin_counts, swin = swin_training_phase(dev)
    attn_bwd = swin["attention_backward"]

    # 8. the Spleen bundle's inference.json through the port's runner, file to file (after the
    # paths above: its set_determinism changes cuDNN's global settings)
    bundle_counts = bundle_phase(dev, spleen5)
    del spleen5

    # 10. the BTCV bundle's train.json through the port's runner (after the paths above, as it
    # sets the seed too)
    btcv_counts = btcv_bundle_phase(dev)
    trained = {k: swin_counts[k] + btcv_counts[k] for k in swin_counts}  # phases 9 and 10

    # 11 and 12. the BraTS bundle's and the Spleen bundle's train.json, each with kernel 1 at
    # its float32 sites
    brats_counts, brats = brats_bundle_phase(dev)
    spleen_train_counts, spleen_train = spleen_train_bundle_phase(dev)
    conv_trained = {k: brats_counts[k] + spleen_train_counts[k] for k in ("conv3d_3x3_same", "conv3d_3x3_wgrad")}

    # 13. the MedNIST bundle's train.json, the native ops its RandRotated needs, and kernel 3
    # at its 2-D zoom sites
    mednist_zoom = mednist_bundle_phase(dev)

    def f32_sites(summary: dict) -> dict:
        """A kernel's numbers summed over a float32 step's sites, for the kernels line."""
        return {key: v for key, v in summary.items() if key not in ("bytes_ms", "ops_ms", "bound_side")}

    # dw and the norm's backward: the bfloat16 UNet step's numbers, and the float32 Swin step's
    # under swin_train_float32 (dx's there too, under conv3d_3x3_same), and dw's at the float32
    # SegResNet and Spleen UNet steps (forward and dx under conv3d_3x3_same)
    training = [
        {"name": "conv3d_3x3_wgrad", "route": "cuda", "source": "monai_tpu_torch/csrc/conv3d_3x3_wgrad.cu",
         "replaces": "monai_tpu/ops/pallas_conv3d.py:200",
         "launches": train_counts["conv3d_3x3_wgrad"] + trained["conv3d_3x3_wgrad"] + conv_trained["conv3d_3x3_wgrad"],
         **train["dw"], "swin_train_float32": f32_sites(swin["dw"]), "segresnet_train_float32": f32_sites(brats["dw"]),
         "spleen_train_float32": f32_sites(spleen_train["dw"])},
        {"name": "instance_norm_prelu_backward", "route": "cuda", "source": "monai_tpu_torch/csrc/instance_norm.cu",
         "replaces": "monai_tpu/networks/layers/fast_norm.py:74",
         "launches": train_counts["instance_norm_prelu_backward"] + trained["instance_norm_prelu_backward"],
         **train["norm_backward"], "swin_train_float32": f32_sites(swin["norm_backward"])},
        {"name": "fused_window_attention_backward", "route": "cuda",
         "source": "monai_tpu_torch/csrc/window_attention_bwd.cu",
         "replaces": "monai_tpu/ops/pallas_window_attention.py:159",
         "launches": trained["fused_window_attention_backward"], **attn_bwd},
    ]

    def line(s: dict) -> str:
        lib = "none" if s["library_ms"] is None else f"{s['library_ms']:.4f}"
        side = s.get("bound_side", s["bound_by"])
        return f"{s['ms']:.4f} / {s['plain_ms']:.4f} / {lib} / {s['bound_ms']:.4f} ({side})"

    print("per training step at batch 4 (ms, kernel / plain / library / bound): " + "; ".join(
        f"{k} {line(train[k])}" for k in ("dw", "dx", "norm_backward")) + "; float32 swin " + "; ".join(
        f"{k} {line(swin[k])}" for k in ("dw", "dx", "norm_backward", "attention_backward", "attention_forward"))
        + "; float32 segresnet batch 1 " + "; ".join(f"{k} {line(brats[k])}" for k in ("forward", "dx", "dw"))
        + "; float32 spleen batch 8 " + "; ".join(f"{k} {line(spleen_train[k])}" for k in ("forward", "dx", "dw")),
        flush=True)

    def merged(i: int) -> dict:
        """The per-forward sums of kernel i over the UNet and SwinUNETR paths (bfloat16)."""
        a, b = summaries["unet"][i], summaries["swinunetr"][i]
        out = {k: a[k] + b[k] for k in ("ms", "plain_ms", "bound_ms", "bytes_ms", "ops_ms")}
        out["library_ms"] = None if a["library_ms"] is None else a["library_ms"] + b["library_ms"]
        out["max_abs_err"] = max(a["max_abs_err"], b["max_abs_err"], spleen["conv"]["max_abs_err"] if i == 0 else 0)
        return _bound_by(out)

    # the forward kernels' launches: the inference paths' and the training step's (forward and dx)
    kernels = [
        {"name": "conv3d_3x3_same", "route": "cuda", "source": "monai_tpu_torch/csrc/conv3d_3x3_same.cu",
         "replaces": "monai_tpu/ops/pallas_conv3d.py:91",
         "launches": unet_counts[0] + swin_sw_counts[0] + spleen_counts[0] + train_counts["conv3d_3x3_same"]
         + bundle_counts[0] + trained["conv3d_3x3_same"] + conv_trained["conv3d_3x3_same"],
         **merged(0), "swin_train_float32_dx": f32_sites(swin["dx"]),
         "segresnet_train_float32": f32_sites(brats["forward"]), "segresnet_train_float32_dx": f32_sites(brats["dx"]),
         "spleen_train_float32": f32_sites(spleen_train["forward"]),
         "spleen_train_float32_dx": f32_sites(spleen_train["dx"])},
        {"name": "instance_norm_prelu", "route": "cuda", "source": "monai_tpu_torch/csrc/instance_norm.cu",
         "replaces": "monai_tpu/networks/layers/fast_norm.py:44",
         "launches": unet_counts[1] + swin_sw_counts[1] + train_counts["instance_norm_prelu"]
         + trained["instance_norm_prelu"], **merged(1)},
        {"name": "fused_window_attention", "route": "cuda", "source": "monai_tpu_torch/csrc/window_attention.cu",
         "replaces": "monai_tpu/ops/pallas_window_attention.py:106",
         "launches": swin_sw_counts[2] + trained["fused_window_attention"], **summaries["swinunetr"][2],
         "swin_train_float32": f32_sites(swin["attention_forward"])},
        {"name": "separable_resample_3d", "route": "cuda", "source": "monai_tpu_torch/csrc/separable_resample_3d.cu",
         "replaces": "monai_tpu/ops/pallas_resample.py:117",
         "launches": spleen_counts[3] + bundle_counts[3] + mednist_zoom["launches"], **spleen["resample"],
         "mednist_zoom_2d": f32_sites(mednist_zoom)},
        {"name": "bilateral_filter_2d", "route": "cuda", "source": "monai_tpu_torch/csrc/bilateral_filter.cu",
         "replaces": "monai_tpu/ops/pallas_filtering.py:99", **filtering["B"]},
        {"name": "bilateral_filter_3d", "route": "cuda", "source": "monai_tpu_torch/csrc/bilateral_filter.cu",
         "replaces": "monai_tpu/ops/pallas_filtering.py:126", **filtering["A"]},
        *training,
    ]
    summaries["spleen"] = (spleen["conv"], None, None, spleen["resample"])
    print("per forward, the resample per volume (ms, kernel / plain / library / bound): " + "; ".join(
        f"{name} {k} {line(s)}" for name, ss in summaries.items()
        for k, s in zip(("conv", "norm", "attention", "resample"), ss) if s is not None), flush=True)
    for k in kernels:  # the bound's sides were for bound_by only
        del k["bytes_ms"], k["ops_ms"]
        k.pop("bound_side", None)
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
    sys.exit(0)
