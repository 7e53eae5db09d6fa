#!/usr/bin/env python3
"""Time the conv's weight-gradient kernel (``conv3d_3x3_wgrad``) of one checkout at every
conv site of the two training steps, on the card.

The sites are those of tests/test_torch_conv3d_wgrad_plan.py (batch 4 of 96^3): the
bfloat16 UNet step's 10 and the float32 SwinUNETR step's 20. At each site the kernel of
the checkout at ``--root`` (its ``monai_tpu_torch``, built from its own sources) is
timed by CUDA events over ``--iters`` calls after a warm-up (queued behind a sleep of the
card, so that the time is the card's alone; and back to back as callers see it), beside cuDNN's
``aten.convolution_backward`` with dw's mask (TF32 off) and the bound (the bytes at
3.35 TB/s or the operations at 67 TFLOP/s in float32, 989 in bfloat16). It prints a line
a site and, last, one JSON object with the per-site times and each step's sums. To put
two versions side by side, run it for each in one call to the card, in turns (parent,
change, change, parent): python3 scripts/wgrad_ab.py --root build/parent.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
HBM_BYTES_S = 3.35e12
PEAK = {"float32": 67e12, "bfloat16": 989e12}
SLEEP_CYCLES = 40_000_000  # ~20 ms at the H100's clock: long enough for the host to queue the calls


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(HERE), help="the checkout whose monai_tpu_torch is timed")
    ap.add_argument("--iters", type=int, default=10, help="timed calls a site")
    ap.add_argument("--label", default="", help="a name for this run in its output")
    ap.add_argument("--check", action="store_true", help="also each site's max error against the plain version")
    args = ap.parse_args()
    root = Path(args.root).resolve()
    # the site tables come with this checkout's package; then the package is dropped, so that
    # --root's is the one imported
    sys.path[:0] = [str(HERE), str(HERE / "tests")]
    from test_torch_conv3d_wgrad_plan import SWIN_TRAIN_SITES, UNET_TRAIN_SITES

    for name in [m for m in sys.modules if m.split(".")[0] == "monai_tpu_torch"]:
        del sys.modules[name]
    sys.path.insert(0, str(root))
    import torch

    from monai_tpu_torch.ops._build import library
    from monai_tpu_torch.ops.conv3d import conv3d_3x3_wgrad, conv3d_3x3_wgrad_plain

    if not torch.cuda.is_available():
        raise SystemExit("wgrad_ab: no CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    library()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(7)

    def ms(fn, queued: bool = True) -> float:
        """Mean time of fn() between CUDA events around --iters calls. queued: the card first
        sleeps while the host queues the calls, so that the time is the card's alone (the
        wrapper's host time between launches hidden); else what back-to-back callers see."""
        for _ in range(2):
            fn()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        if queued:
            torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        for _ in range(args.iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / args.iters

    out = {"label": args.label, "root": str(root), "card": smi, "sites": [], "steps": {}}
    for step, sites, dtype in (("unet_train", UNET_TRAIN_SITES, torch.bfloat16),
                               ("swin_train", SWIN_TRAIN_SITES, torch.float32)):
        sums = {"kernel_ms": 0.0, "call_ms": 0.0, "cudnn_ms": 0.0, "bound_ms": 0.0}
        for (ci, co, sp), count in sites.items():
            x = torch.randn((4, *sp, ci), generator=gen, device=dev).to(dtype)
            g = torch.randn((4, *sp, co), generator=gen, device=dev).to(dtype)
            w = torch.zeros((co, ci, 3, 3, 3), device=dev, dtype=dtype)
            xc, gc = x.permute(0, 4, 1, 2, 3), g.permute(0, 4, 1, 2, 3)
            k_ms, call_ms = ms(lambda: conv3d_3x3_wgrad(x, g)), ms(lambda: conv3d_3x3_wgrad(x, g), queued=False)
            err = None
            if args.check:
                ref = conv3d_3x3_wgrad_plain(x, g).float()
                err = ((conv3d_3x3_wgrad(x, g).float() - ref).abs().max() / ref.abs().max()).item()
                del ref
            lib_ms = ms(lambda: torch.ops.aten.convolution_backward(gc, xc, w, None, [1, 1, 1], [1, 1, 1], [1, 1, 1],
                                                                    False, [0, 0, 0], 1, [False, True, False]))
            flops = 2.0 * 4 * math.prod(sp) * 27 * ci * co
            b_ms = max((x.numel() + g.numel() + 27 * ci * co) * x.element_size() / HBM_BYTES_S,
                       flops / PEAK[str(dtype)[6:]]) * 1e3
            row = {"step": step, "ci": ci, "co": co, "spatial": sp, "count": count, "dtype": str(dtype)[6:],
                   "kernel_ms": k_ms, "call_ms": call_ms, "cudnn_ms": lib_ms, "bound_ms": b_ms, "max_rel_err": err}
            out["sites"].append(row)
            for k in sums:
                sums[k] += count * row[k]
            print(f"{args.label} {step} {ci:3d}->{co:3d} @{sp} x{count} {row['dtype']}: kernel {k_ms:.4f} ms (a call "
                  f"back to back {call_ms:.4f}), cuDNN {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_ms / k_ms * 100:.1f}% "
                  f"of the kernel)" + ("" if err is None else f", max err {err:.3g} of max|ref|"), flush=True)
            del x, g, xc, gc
            torch.cuda.empty_cache()
        out["steps"][step] = sums
        print(f"{args.label} {step} dw a step: kernel {sums['kernel_ms']:.4f} ms (calls back to back "
              f"{sums['call_ms']:.4f}), cuDNN {sums['cudnn_ms']:.4f} ms, bound {sums['bound_ms']:.4f} ms", flush=True)
    print(smi)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
