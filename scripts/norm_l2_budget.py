#!/usr/bin/env python3
"""The instance-norm kernel's persistent path at two sites, under several L2 budgets.

The persistent grid walks the instances in groups whose slabs together fit an L2
budget (``fast_norm._L2_BUDGET``), so that the normalize pass finds in L2 what the sums
read. This times the kernel at the SwinUNETR path's (6, 96^3, 24) site (42.5 MB
instances) and the UNet path's (18, 96^3, 2) site (3.5 MB instances), bfloat16, with
the budget set to each value in turn, in the order a, b, ..., b, a, and prints each
time beside its plan, the bound (x read once, y written once at 3.35 TB/s) and the
time of ``F.instance_norm`` on the same channels-last tensor (the library call, without
the slope). Needs a CUDA device.

Run from the repository root: ``python3 scripts/norm_l2_budget.py``
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

SITES = {"swin (6, 24, 96^3)": (6, 24, 96), "unet (18, 2, 96^3)": (18, 2, 96)}
BUDGETS = {"24 MiB": 24 << 20, "every instance at once": 1 << 40}
HBM_BYTES_S = 3.35e12


def cuda_ms(fn, iters: int = 30, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("norm_l2_budget: no CUDA device")
    from monai_tpu_torch.networks.layers import fast_norm

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(3)
    shipped = fast_norm._L2_BUDGET
    with torch.inference_mode():
        for name, (b, c, n) in SITES.items():
            x = (torch.randn((b, c, n, n, n), generator=g, device=dev) * 3 + 1).to(torch.bfloat16)
            x = x.contiguous(memory_format=torch.channels_last_3d)
            w = (torch.rand((c,), generator=g, device=dev) + 0.5).to(torch.bfloat16)
            bias = torch.randn((c,), generator=g, device=dev).to(torch.bfloat16)
            a = torch.full((1,), 0.01, device=dev, dtype=torch.bfloat16)
            ref = fast_norm.instance_norm_prelu_plain(x, w, bias, a)
            bound = 2 * x.numel() * x.element_size() / HBM_BYTES_S * 1e3
            times = {k: [] for k in BUDGETS}
            plans = {}
            order = list(BUDGETS) + list(reversed(BUDGETS))
            for key in order:
                fast_norm._L2_BUDGET = BUDGETS[key]
                fast_norm.instance_norm_plan.cache_clear()
                fast_norm._launch_args.cache_clear()
                got = fast_norm.instance_norm_prelu(x, w, bias, a)
                torch.cuda.synchronize()
                err = (got.float() - ref.float()).abs().max().item() / ref.float().abs().max().item()
                if err > 1e-2:
                    raise SystemExit(f"norm_l2_budget: {name} at {key}: error {err:.3g} of max|ref|")
                times[key].append(cuda_ms(lambda: fast_norm.instance_norm_prelu(x, w, bias, a)))
                card, occ = fast_norm._card(0)
                plans[key] = fast_norm.instance_norm_plan(b, c, n ** 3, x.dtype, True, card, occ)
            fast_norm._L2_BUDGET = shipped
            fast_norm.instance_norm_plan.cache_clear()
            fast_norm._launch_args.cache_clear()
            lib = cuda_ms(lambda: F.instance_norm(x, weight=w, bias=bias, eps=1e-5))
            for key in BUDGETS:
                p = plans[key]
                print(f"{name} budget {key}: kernel {times[key][0]:.4f} / {times[key][1]:.4f} ms (in order "
                      f"{' '.join(str(round(t, 4)) for t in times[key])}); plan {p['path']}, {p['blocks']} blocks, "
                      f"{p['per_unit']} a unit, {p['units_per_group']} units a group x {p['unit_groups']}; "
                      f"bound {bound:.4f} ms", flush=True)
            print(f"{name}: F.instance_norm (no slope) {lib:.4f} ms", flush=True)
            del x, ref, got


if __name__ == "__main__":
    main()
