#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port, monai_tpu_torch, on one NVIDIA GPU.

Drives the port's main path: the Spleen-CT 3-D UNet (channels 16-32-64-128-256,
strides 2, two residual units, instance norm, PReLU) at full width, with random
weights from a seed, under ``SlidingWindowInferer`` (roi 96³, overlap 0.25, gaussian
blend, 18 windows per 224x224x112 volume, one window batch of 18), in bfloat16.

  1. the card's name and power limit; the CUDA kernels built from the checkout's sources
  2. each kernel against its plain PyTorch version at every shape the main path gives
     it (batch of 18 windows), bfloat16 and float32: max error under a stated
     tolerance, and the kernel's and the plain version's times
  3. the sliding-window inferer over 224x224x112 volumes: output shape and finiteness,
     single-volume latency and vols/s, with the launch counts of that run
  4. one UNet forward on a 96³ window, on the card in float32 and in bfloat16, against
     the port's own CPU float32 forward of the same weights and input; the launch
     counters show 10 conv and 17 norm kernel launches for that forward

It prints the ``{"kernels": [...]}`` line and, last, ``{"ok": true, "device": ...}``.
Any failed check raises, so the exit code is not 0; so it is without a CUDA device.

Run from the repository root: ``python3 chip_smoke.py``
"""
from __future__ import annotations

import copy
import json
import statistics
import subprocess
import sys
import time
from collections import Counter

import torch

ROI = (96, 96, 96)
VOLUME = (224, 224, 112)
SW_BATCH = 18
N_LATENCY, N_THROUGHPUT = 10, 30

# Tolerances, relative to max|plain output|. bfloat16: both versions round an f32 sum to
# bf16 (8-bit significand), so they may differ by one bf16 step, <= 2^-7 of the value.
# float32: the sums differ only in order.
TOL_BF16, TOL_F32 = 1e-2, 1e-4
# UNet forward against the CPU float32 forward, relative to the std of the CPU logits:
# float32 on the card (tight), bfloat16 (loose: ~30 layers each rounding to bf16), and
# the share of voxels whose argmax class agrees.
TOL_FWD_F32_MAX, TOL_FWD_BF16_MEAN, MIN_ARGMAX_AGREE = 1e-3, 5e-2, 0.95


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


def paired_ms(kernel, plain) -> tuple[float, float]:
    """(kernel ms, plain ms), timed in turns plain, kernel, kernel, plain."""
    p1, k1, k2, p2 = cuda_ms(plain), cuda_ms(kernel), cuda_ms(kernel), cuda_ms(plain)
    return (k1 + k2) / 2, (p1 + p2) / 2


def rel_err(got: torch.Tensor, ref: torch.Tensor) -> tuple[float, float]:
    err = (got.float() - ref.float()).abs().max().item()
    return err, err / max(ref.float().abs().max().item(), 1e-30)


def record_sites(net, window):
    """The shapes the main path gives each kernel, read off one forward by hooks:
    Counter of (CI, CO, spatial) per 3x3x3 conv and of (C, spatial) per fused norm."""
    from monai_tpu_torch.networks.blocks.convolutions import Convolution
    from monai_tpu_torch.networks.layers.factories import Conv3d

    convs, norms, hooks = [], [], []
    for m in net.modules():
        if isinstance(m, Conv3d) and m.same_3x3x3:
            hooks.append(m.register_forward_hook(
                lambda mod, inp, out: convs.append((mod.in_channels, mod.out_channels, tuple(inp[0].shape[2:])))))
        if isinstance(m, Convolution) and m.fused_norm_prelu:
            hooks.append(m.register_forward_hook(
                lambda mod, inp, out: norms.append((out.shape[1], tuple(out.shape[2:])))))
    net(window)
    for h in hooks:
        h.remove()
    return Counter(convs), Counter(norms)


def check_conv(sites: Counter, dev) -> dict:
    from monai_tpu_torch.ops.conv3d import conv3d_3x3_same, conv3d_3x3_same_plain

    g = torch.Generator(device=dev).manual_seed(2)
    total_k = total_p = worst = 0.0
    for (ci, co, sp), count in sorted(sites.items()):
        for dtype, tol in ((torch.bfloat16, TOL_BF16), (torch.float32, TOL_F32)):
            x = torch.randn((SW_BATCH, *sp, ci), generator=g, device=dev).to(dtype)
            w = (torch.randn((3, 3, 3, ci, co), generator=g, device=dev) / (27 * ci) ** 0.5).to(dtype)
            b = torch.randn((co,), generator=g, device=dev).to(dtype)
            got, ref = conv3d_3x3_same(x, w, b), conv3d_3x3_same_plain(x, w, b)
            torch.cuda.synchronize()
            err, rel = rel_err(got, ref)
            require(rel <= tol, f"conv {ci}->{co} @{sp} {dtype}: max err {err:.3g} = {rel:.3g} x max|ref| > {tol}")
            msg = f"conv {ci:3d}->{co:3d} @{sp} x{count} {str(dtype)[6:]:8s} max_abs_err {err:.4g} ({rel:.3g} of max|ref|, tol {tol})"
            if dtype == torch.bfloat16:
                worst = max(worst, err)
                k_ms, p_ms = paired_ms(lambda: conv3d_3x3_same(x, w, b), lambda: conv3d_3x3_same_plain(x, w, b))
                total_k += count * k_ms
                total_p += count * p_ms
                msg += f"  kernel {k_ms:.4f} ms  plain {p_ms:.4f} ms"
            print(msg, flush=True)
    return {"max_abs_err": worst, "ms": total_k, "plain_ms": total_p}


def check_norm(sites: Counter, dev) -> dict:
    from monai_tpu_torch.networks.layers.fast_norm import instance_norm_prelu, instance_norm_prelu_plain

    g = torch.Generator(device=dev).manual_seed(3)
    total_k = total_p = worst = 0.0
    for (c, sp), count in sorted(sites.items()):
        for dtype, tol in ((torch.bfloat16, TOL_BF16), (torch.float32, TOL_F32)):
            x = (torch.randn((SW_BATCH, c, *sp), generator=g, device=dev) * 3 + 1).to(dtype)
            x = x.contiguous(memory_format=torch.channels_last_3d)
            slope = torch.full((1,), 0.25, device=dev, dtype=dtype)  # the main path: PReLU, one slope
            t0 = time.perf_counter()
            got = instance_norm_prelu(x, None, None, slope)
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t0
            ref = instance_norm_prelu_plain(x, None, None, slope)
            err, rel = rel_err(got, ref)
            require(rel <= tol, f"norm C={c} @{sp} {dtype}: max err {err:.3g} = {rel:.3g} x max|ref| > {tol}")
            msg = (f"norm C={c:3d} @{sp} x{count} {str(dtype)[6:]:8s} max_abs_err {err:.4g} "
                   f"({rel:.3g} of max|ref|, tol {tol})  first call {first_s:.2f} s")
            if dtype == torch.bfloat16:
                worst = max(worst, err)
                k_ms, p_ms = paired_ms(lambda: instance_norm_prelu(x, None, None, slope),
                                       lambda: instance_norm_prelu_plain(x, None, None, slope))
                total_k += count * k_ms
                total_p += count * p_ms
                msg += f"  kernel {k_ms:.4f} ms  plain {p_ms:.4f} ms"
            print(msg, flush=True)
    return {"max_abs_err": worst, "ms": total_k, "plain_ms": total_p}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is false)")
    from monai_tpu_torch.data.utils import dense_patch_slices
    from monai_tpu_torch.inferers import SlidingWindowInferer, compute_scan_interval
    from monai_tpu_torch.networks.layers.fast_norm import instance_norm_prelu
    from monai_tpu_torch.networks.nets import UNet
    from monai_tpu_torch.ops._build import library, library_path
    from monai_tpu_torch.ops.conv3d import conv3d_3x3_same

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

    # the main path's network: full width, random weights from seed 0, built on the CPU
    net_cpu = UNet(3, 1, 2, channels=(16, 32, 64, 128, 256), strides=(2, 2, 2, 2), num_res_units=2,
                   generator=torch.Generator().manual_seed(0)).eval()
    net_f32 = copy.deepcopy(net_cpu).to(dev)
    net_bf16 = copy.deepcopy(net_cpu).to(dev, torch.bfloat16)
    window = torch.rand((1, 1, *ROI), generator=torch.Generator().manual_seed(1))

    with torch.inference_mode():
        conv_sites, norm_sites = record_sites(net_bf16, window.to(dev, torch.bfloat16))
        print(f"sites: {sum(conv_sites.values())} 3x3x3 stride-1 convs, {sum(norm_sites.values())} "
              f"instance norm + PReLU", flush=True)
        require(sum(conv_sites.values()) == 10 and sum(norm_sites.values()) == 17,
                "the UNet should have 10 stride-1 3x3x3 convs and 17 norm + PReLU sites")

        # 2. each kernel against its plain version at the main path's shapes
        conv = check_conv(conv_sites, dev)
        norm = check_norm(norm_sites, dev)

        # 3. the main path: sliding-window inference over 224x224x112 volumes; timed
        # before the CPU reference forward below, as the loop is bound by the host
        interval = compute_scan_interval(VOLUME, ROI, 3, (0.25,) * 3)
        n_windows = len(dense_patch_slices(VOLUME, ROI, interval))
        require(n_windows == SW_BATCH, f"{n_windows} windows per volume, expected {SW_BATCH}")
        inferer = SlidingWindowInferer(ROI, sw_batch_size=SW_BATCH, overlap=0.25, mode="gaussian")
        gv = torch.Generator(device=dev).manual_seed(4)
        vols = [torch.rand((1, 1, *VOLUME), generator=gv, device=dev).to(torch.bfloat16) for _ in range(3)]
        calls = 0

        def predictor(w):
            nonlocal calls
            calls += 1
            return net_bf16(w)

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        conv3d_3x3_same.launches = instance_norm_prelu.launches = 0
        out = inferer(vols[0], predictor)  # warm-up
        lat = []
        for i in range(N_LATENCY):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = inferer(vols[i % 3], predictor)
            torch.cuda.synchronize()
            lat.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        for i in range(N_THROUGHPUT):
            out = inferer(vols[i % 3], predictor)
        torch.cuda.synchronize()
        vols_per_s = N_THROUGHPUT / (time.perf_counter() - t0)
        sw_counts = (conv3d_3x3_same.launches, instance_norm_prelu.launches)
        peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
        print(f"sliding window {VOLUME}: out {tuple(out.shape)} {out.dtype}; {vols_per_s:.3f} vols/s "
              f"({N_THROUGHPUT} volumes back to back); latency median {statistics.median(lat) * 1e3:.2f} ms "
              f"(min {min(lat) * 1e3:.2f}, {N_LATENCY} runs); peak memory {peak_gb:.2f} GB; "
              f"{calls} forwards, launches conv {sw_counts[0]}, norm {sw_counts[1]}", flush=True)
        require(tuple(out.shape) == (1, 2, *VOLUME) and bool(torch.isfinite(out).all()),
                "sliding-window output is not finite (1, 2, 224, 224, 112)")
        require(calls == 1 + N_LATENCY + N_THROUGHPUT and sw_counts == (10 * calls, 17 * calls),
                f"sliding window: {calls} forwards launched {sw_counts} kernels")
        require(all(n > 0 for n in sw_counts), "a kernel of the main path never launched")

        # 4. one forward against the CPU float32 forward; launch counts of one forward
        ref = net_cpu(window)
        std = ref.std().item()
        out_f32 = net_f32(window.to(dev)).cpu()
        conv3d_3x3_same.launches = instance_norm_prelu.launches = 0
        out_bf16 = net_bf16(window.to(dev, torch.bfloat16)).float().cpu()
        fwd_counts = (conv3d_3x3_same.launches, instance_norm_prelu.launches)
        d32 = (out_f32 - ref).abs()
        d16 = (out_bf16 - ref).abs()
        agree = (out_bf16.argmax(1) == ref.argmax(1)).float().mean().item()
        print(f"forward 96^3: logit std {std:.4g}; f32 card max err {d32.max().item():.4g} "
              f"({d32.max().item() / std:.3g} std, tol {TOL_FWD_F32_MAX}); bf16 card mean err "
              f"{d16.mean().item():.4g} ({d16.mean().item() / std:.3g} std, tol {TOL_FWD_BF16_MEAN}), "
              f"max {d16.max().item():.4g}; argmax agreement {agree:.5f} (min {MIN_ARGMAX_AGREE}); "
              f"launches per forward: conv {fwd_counts[0]}, norm {fwd_counts[1]}", flush=True)
        require(tuple(out_bf16.shape) == (1, 2, *ROI) and bool(torch.isfinite(out_bf16).all()),
                "bf16 forward output is not finite (1, 2, 96, 96, 96)")
        require(d32.max().item() / std <= TOL_FWD_F32_MAX, "f32 card forward disagrees with the CPU")
        require(d16.mean().item() / std <= TOL_FWD_BF16_MEAN, "bf16 card forward disagrees with the CPU")
        require(agree >= MIN_ARGMAX_AGREE, "bf16 argmax disagrees with the CPU")
        require(fwd_counts == (10, 17), f"one forward launched {fwd_counts}, not (10, 17) kernels")

    kernels = [
        {"name": "conv3d_3x3_same", "route": "cuda", "source": "monai_tpu_torch/csrc/conv3d_3x3_same.cu",
         "replaces": "monai_tpu/ops/pallas_conv3d.py:91", "launches": sw_counts[0], **conv},
        {"name": "instance_norm_prelu", "route": "triton", "source": "monai_tpu_torch/networks/layers/fast_norm.py",
         "replaces": "monai_tpu/networks/layers/fast_norm.py:44", "launches": sw_counts[1], **norm},
    ]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
    sys.exit(0)
