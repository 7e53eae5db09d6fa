#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port, monai_tpu_torch, on one NVIDIA GPU.

Drives the port's two sliding-window eval paths, each at full width with random weights
from a seed, in bfloat16, over 224x224x112 volumes (roi 96³, overlap 0.25, gaussian
blend, 18 windows per volume):

- UNet: the Spleen-CT 3-D UNet (channels 16-32-64-128-256, strides 2, two residual
  units, instance norm, PReLU) under ``SlidingWindowInferer``, one window batch of 18;
- SwinUNETR: ``SwinUNETR(1, 14, feature_size=24)`` (BTCV; depths 2-2-2-2, heads
  3-6-12-24, window 7) under ``SlidingWindowInfererAdapt``, window batches of 6.

  1. the card's name and power limit; the CUDA kernels built from the checkout's sources
  2. each kernel against its plain PyTorch version at every shape each path gives it
     (read off one forward by hooks), bfloat16 and float32: max error under a stated
     tolerance, and the kernel's and the plain version's times; the window attention
     also at head dim 16 (feature size 48)
  3. per path, the sliding-window inferer over 224x224x112 volumes: output shape and
     finiteness, single-volume latency, vols/s and peak memory, with the launch counts of
     that run (every count set to 0 just before it and read just after)
  4. per path, one forward on a 96³ window, on the card in float32 and in bfloat16,
     against the port's own CPU float32 forward of the same weights and input, with the
     launch counts of that forward

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
N_WINDOWS = 18  # per volume
UNET_BATCH, SWIN_BATCH = N_WINDOWS, 6
UNET_TIMING, SWIN_TIMING = (10, 30), (5, 10)  # (latency runs, throughput volumes)
# launches per forward: (3x3x3 conv, instance norm, window attention)
UNET_PER_FORWARD, SWIN_PER_FORWARD = (10, 17, 0), (20, 26, 8)

# Tolerances, relative to max|plain output|. bfloat16: both versions round an f32 sum to
# bf16 (8-bit significand), so they may differ by one bf16 step, <= 2^-7 of the value.
# float32: the sums differ only in order.
TOL_BF16, TOL_F32 = 1e-2, 1e-4
# A forward against the CPU float32 forward, relative to the std of the CPU logits:
# float32 on the card (tight: sums in another order), bfloat16 (loose: ~30-40 layers
# each rounding to bf16), and the share of voxels whose argmax class agrees. For the
# SwinUNETR's 14 classes with random weights, 5% of the voxels have a top-two margin
# below 0.026 std (the port's CPU float32 forward), so bf16 noise of ~0.01 std flips
# about 1% of them (0.9887 agreement between the CPU's bf16 and f32 forwards).
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


def paired_ms(kernel, plain, iters: int = 30) -> tuple[float, float]:
    """(kernel ms, plain ms), timed in turns plain, kernel, kernel, plain."""
    p1, k1, k2, p2 = (cuda_ms(f, iters) for f in (plain, kernel, kernel, plain))
    return (k1 + k2) / 2, (p1 + p2) / 2


def rel_err(got: torch.Tensor, ref: torch.Tensor) -> tuple[float, float]:
    err = (got.float() - ref.float()).abs().max().item()
    return err, err / max(ref.float().abs().max().item(), 1e-30)


def launch_counts() -> tuple[int, int, int]:
    from monai_tpu_torch.networks.layers.fast_norm import instance_norm_prelu
    from monai_tpu_torch.ops.conv3d import conv3d_3x3_same
    from monai_tpu_torch.ops.window_attention import fused_window_attention

    return conv3d_3x3_same.launches, instance_norm_prelu.launches, fused_window_attention.launches


def reset_launch_counts() -> None:
    from monai_tpu_torch.networks.layers.fast_norm import instance_norm_prelu
    from monai_tpu_torch.ops.conv3d import conv3d_3x3_same
    from monai_tpu_torch.ops.window_attention import fused_window_attention

    conv3d_3x3_same.launches = instance_norm_prelu.launches = fused_window_attention.launches = 0


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


def _summary(rows: list[tuple[int, float, float, float]]) -> dict:
    """rows of (count, bf16 max abs err, kernel ms, plain ms) -> the kernels-line numbers
    for one forward: worst error, summed times."""
    return {"max_abs_err": max((r[1] for r in rows), default=0.0), "ms": sum(r[0] * r[2] for r in rows),
            "plain_ms": sum(r[0] * r[3] for r in rows)}


def check_conv(sites: Counter, batch: int, dev) -> dict:
    from monai_tpu_torch.ops.conv3d import conv3d_3x3_same, conv3d_3x3_same_plain

    g = torch.Generator(device=dev).manual_seed(2)
    rows = []
    for (ci, co, sp), count in sorted(sites.items()):
        for dtype, tol in ((torch.bfloat16, TOL_BF16), (torch.float32, TOL_F32)):
            x = torch.randn((batch, *sp, ci), generator=g, device=dev).to(dtype)
            w = (torch.randn((3, 3, 3, ci, co), generator=g, device=dev) / (27 * ci) ** 0.5).to(dtype)
            b = torch.randn((co,), generator=g, device=dev).to(dtype)
            got, ref = conv3d_3x3_same(x, w, b), conv3d_3x3_same_plain(x, w, b)
            torch.cuda.synchronize()
            err, rel = rel_err(got, ref)
            require(rel <= tol, f"conv {ci}->{co} @{sp} {dtype}: max err {err:.3g} = {rel:.3g} x max|ref| > {tol}")
            msg = f"conv {ci:3d}->{co:3d} @{sp} x{count} {str(dtype)[6:]:8s} max_abs_err {err:.4g} ({rel:.3g} of max|ref|, tol {tol})"
            if dtype == torch.bfloat16:
                k_ms, p_ms = paired_ms(lambda: conv3d_3x3_same(x, w, b), lambda: conv3d_3x3_same_plain(x, w, b))
                rows.append((count, err, k_ms, p_ms))
                msg += f"  kernel {k_ms:.4f} ms  plain {p_ms:.4f} ms"
            print(msg, flush=True)
    return _summary(rows)


def check_norm(sites: Counter, batch: int, dev) -> dict:
    from monai_tpu_torch.networks.layers.fast_norm import instance_norm_prelu, instance_norm_prelu_plain

    g = torch.Generator(device=dev).manual_seed(3)
    rows = []
    for (c, sp, affine, slope), count in sorted(sites.items(), key=str):
        for dtype, tol in ((torch.bfloat16, TOL_BF16), (torch.float32, TOL_F32)):
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
            msg = (f"norm C={c:3d} @{sp} affine {affine} slope {slope} x{count} {str(dtype)[6:]:8s} max_abs_err "
                   f"{err:.4g} ({rel:.3g} of max|ref|, tol {tol})  first call {first_s:.2f} s")
            if dtype == torch.bfloat16:
                k_ms, p_ms = paired_ms(lambda: instance_norm_prelu(x, w, b, a),
                                       lambda: instance_norm_prelu_plain(x, w, b, a))
                rows.append((count, err, k_ms, p_ms))
                msg += f"  kernel {k_ms:.4f} ms  plain {p_ms:.4f} ms"
            print(msg, flush=True)
    return _summary(rows)


def check_attention(sites: Counter, masks: dict, dev) -> dict:
    """Every site, plus the first stage's masked site at head dim 16 (feature size 48),
    which is not counted in the per-forward sums."""
    from monai_tpu_torch.ops.window_attention import fused_window_attention, fused_window_attention_plain

    g = torch.Generator(device=dev).manual_seed(5)
    first = max(s for s in sites if s[4] is not None)
    extra = {(first[0], first[1], first[2], 16, first[4]): 0}
    rows = []
    for (b, h, n, d, nw), count in sorted(sites.items(), key=str) + list(extra.items()):
        for dtype, tol in ((torch.bfloat16, TOL_BF16), (torch.float32, TOL_F32)):
            q, k, v = (torch.randn((b, h, n, d), generator=g, device=dev).to(dtype) for _ in range(3))
            bias = torch.randn((h, n, n), generator=g, device=dev) * 0.5
            mask = None if nw is None else masks[nw]
            got = fused_window_attention(q, k, v, bias, mask)
            torch.cuda.synchronize()
            ref = fused_window_attention_plain(q, k, v, bias, mask)
            err, rel = rel_err(got, ref)
            require(rel <= tol, f"attention {(b, h, n, d, nw)} {dtype}: max err {err:.3g} = {rel:.3g} x max|ref| > {tol}")
            msg = (f"attention windows {b} heads {h} N {n} D {d} mask rows {nw} x{count} {str(dtype)[6:]:8s} "
                   f"max_abs_err {err:.4g} ({rel:.3g} of max|ref|, tol {tol})")
            if dtype == torch.bfloat16:
                k_ms, p_ms = paired_ms(lambda: fused_window_attention(q, k, v, bias, mask),
                                       lambda: fused_window_attention_plain(q, k, v, bias, mask), iters=10)
                rows.append((count, err, k_ms, p_ms))
                msg += f"  kernel {k_ms:.4f} ms  plain {p_ms:.4f} ms"
            print(msg, flush=True)
            del q, k, v, got, ref
    return _summary(rows)


def sliding_window(name: str, inferer, net, per_forward: tuple[int, int, int], timing: tuple[int, int], dev,
                   out_channels: int) -> tuple[tuple[int, int, int], int]:
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
          f"launches conv {counts[0]}, norm {counts[1]}, attention {counts[2]}", flush=True)
    require(tuple(out.shape) == (1, out_channels, *VOLUME) and bool(torch.isfinite(out).all()),
            f"{name} sliding-window output is not finite (1, {out_channels}, 224, 224, 112)")
    n_volumes = 1 + n_latency + n_throughput
    require(calls == n_volumes * N_WINDOWS // inferer.sw_batch_size, f"{name}: {calls} forwards for {n_volumes} volumes")
    require(counts == tuple(n * calls for n in per_forward), f"{name}: {calls} forwards launched {counts} kernels")
    require(all(c > 0 for c, n in zip(counts, per_forward) if n), f"{name}: a kernel of the path never launched")
    return counts, calls


def forward_check(name: str, net_cpu, net_f32, net_bf16, per_forward: tuple[int, int, int], dev) -> None:
    """One forward on a 96³ window on the card, float32 and bfloat16, against the CPU."""
    window = torch.rand((1, 1, *ROI), generator=torch.Generator().manual_seed(1))
    ref = net_cpu(window)
    std = ref.std().item()
    out_f32 = net_f32(window.to(dev)).cpu()
    reset_launch_counts()
    out_bf16 = net_bf16(window.to(dev, torch.bfloat16)).float().cpu()
    counts = launch_counts()
    d32, d16 = (out_f32 - ref).abs(), (out_bf16 - ref).abs()
    agree = (out_bf16.argmax(1) == ref.argmax(1)).float().mean().item()
    print(f"{name} forward 96^3: logit std {std:.4g}; f32 card max err {d32.max().item():.4g} "
          f"({d32.max().item() / std:.3g} std, tol {TOL_FWD_F32_MAX}); bf16 card mean err "
          f"{d16.mean().item():.4g} ({d16.mean().item() / std:.3g} std, tol {TOL_FWD_BF16_MEAN}), "
          f"max {d16.max().item():.4g}; argmax agreement {agree:.5f} (min {MIN_ARGMAX_AGREE}); "
          f"launches per forward: conv {counts[0]}, norm {counts[1]}, attention {counts[2]}", flush=True)
    require(tuple(out_bf16.shape) == tuple(ref.shape) and bool(torch.isfinite(out_bf16).all()),
            f"{name} bf16 forward output is not finite {tuple(ref.shape)}")
    require(d32.max().item() / std <= TOL_FWD_F32_MAX, f"{name} f32 card forward disagrees with the CPU")
    require(d16.mean().item() / std <= TOL_FWD_BF16_MEAN, f"{name} bf16 card forward disagrees with the CPU")
    require(agree >= MIN_ARGMAX_AGREE, f"{name} bf16 argmax disagrees with the CPU")
    require(counts == per_forward, f"{name}: one forward launched {counts}, not {per_forward} kernels")


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is false)")
    from monai_tpu_torch.data.utils import dense_patch_slices
    from monai_tpu_torch.inferers import SlidingWindowInferer, SlidingWindowInfererAdapt, compute_scan_interval
    from monai_tpu_torch.networks.nets import SwinUNETR, UNet
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

    # the two paths' networks: full width, random weights from seed 0, built on the CPU
    nets = {}
    for name, make in (("unet", lambda g: UNet(3, 1, 2, channels=(16, 32, 64, 128, 256), strides=(2, 2, 2, 2),
                                               num_res_units=2, generator=g)),
                       ("swinunetr", lambda g: SwinUNETR(1, 14, feature_size=24, generator=g))):
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
            require(n_sites == per_forward, f"{name} should have {per_forward} kernel sites, not {n_sites}")
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

        # 4. one forward per path against the CPU float32 forward
        forward_check("unet", *nets["unet"], UNET_PER_FORWARD, dev)
        forward_check("swinunetr", *nets["swinunetr"], SWIN_PER_FORWARD, dev)

    def merged(i: int) -> dict:
        a, b = summaries["unet"][i], summaries["swinunetr"][i]
        return {"max_abs_err": max(a["max_abs_err"], b["max_abs_err"]), "ms": a["ms"] + b["ms"],
                "plain_ms": a["plain_ms"] + b["plain_ms"]}

    kernels = [
        {"name": "conv3d_3x3_same", "route": "cuda", "source": "monai_tpu_torch/csrc/conv3d_3x3_same.cu",
         "replaces": "monai_tpu/ops/pallas_conv3d.py:91", "launches": unet_counts[0] + swin_counts[0], **merged(0)},
        {"name": "instance_norm_prelu", "route": "triton", "source": "monai_tpu_torch/networks/layers/fast_norm.py",
         "replaces": "monai_tpu/networks/layers/fast_norm.py:44", "launches": unet_counts[1] + swin_counts[1],
         **merged(1)},
        {"name": "fused_window_attention", "route": "cuda", "source": "monai_tpu_torch/csrc/window_attention.cu",
         "replaces": "monai_tpu/ops/pallas_window_attention.py:106", "launches": swin_counts[2],
         **summaries["swinunetr"][2]},
    ]
    print("per forward (ms, kernel / plain): " + "; ".join(
        f"{name} {k} {s['ms']:.4f} / {s['plain_ms']:.4f}" for name, ss in summaries.items()
        for k, s in zip(("conv", "norm", "attention"), ss) if s is not None), flush=True)
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
    sys.exit(0)
