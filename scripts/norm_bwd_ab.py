#!/usr/bin/env python3
"""Time the instance norm's backward kernel (``instance_norm_prelu_backward``) of one
checkout at every norm site of the two training steps, on the card.

The sites are tests/test_torch_norm_bwd_plan.py's (batch 4 of 96^3): the float32
SwinUNETR step's 26 and the bfloat16 UNet step's 17. At each site the kernel of the
checkout at ``--root`` (its ``monai_tpu_torch``, built from its own sources) is timed by
CUDA events over ``--iters`` calls after a warm-up, queued behind a sleep of the card so
that the time is the card's alone, and back to back as callers see it (the small sites
are bound by the wrapper's host time); beside its plain version, autograd's backward of
``F.instance_norm`` (the library call, without the slope) and the bound: x and g read
once and dx written once at 3.35 TB/s. The CUDA launches of one call are counted by the
profiler. It prints a line a site and a sum a step, and, last, one JSON object. To put two
versions side by side, run it for each in one call to the card, in turns (parent, change,
change, parent): ``python3 scripts/norm_bwd_ab.py --root build/parent``.

``--check`` adds each site's errors against the plain version (dx and the three sums,
relative to max|ref|) and whether two calls give the same bits. ``--groups`` times this
checkout's kernel at the (4, 48, 96^3) sites with each channel group forced in turn (48,
24, 16 and 8 float32 channels a unit; 48, 24 and 16 in bfloat16). ``--rows`` times a
plain read of x and g of the float32 (4, 48, 96^3) site, a channel group at a time, at
those groups (a probe built by nvcc from a source in this script): whether rows of 32
bytes at a 192-byte stride stream at the rate of whole rows. ``--train`` runs the float32
``SupervisedTrainer`` step of ``SwinUNETR(1, 14, feature_size=48)`` as chip_smoke.py phase
9 does (one fixed batch of 4 96^3 patches, AdamW, DiceCELoss, cuDNN's TF32 allowed as by
torch's default), 2 warm-up and 10 timed iterations: the median step between CUDA events,
the peak memory and the norm backward's launches a step.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import statistics
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
HBM_BYTES_S = 3.35e12
SLEEP_CYCLES = 40_000_000  # ~20 ms at the H100's clock: long enough for the host to queue the calls
PROBE = r"""
#include <cuda_runtime.h>
// x and g read once, 16 bytes a load, rows of rowvec vectors strvec vectors apart, four
// loads of each in flight a thread; the sum keeps the loads.
__global__ void read_rows(const uint4* x, const uint4* g, long long rows, int rowvec, long long strvec,
                          float* out) {
  const long long n = rows * rowvec, step = (long long)gridDim.x * blockDim.x;
  float acc = 0.f;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n; i += 4 * step) {
    uint4 a[4], b[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const long long j = i + q * step < n ? i + q * step : i;
      const long long o = j / rowvec * strvec + j % rowvec;
      a[q] = x[o];
      b[q] = g[o];
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) acc += __uint_as_float(a[q].x ^ b[q].w) + __uint_as_float(a[q].z ^ b[q].y);
  }
  if (acc == 1.2345f) *out = acc;
}
extern "C" int launch_read_rows(const void* x, const void* g, long long rows, int rowvec, long long strvec,
                                float* out, int blocks, int threads, void* stream) {
  read_rows<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(x), static_cast<const uint4*>(g), rows, rowvec, strvec, out);
  return (int)cudaGetLastError();
}
"""


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(HERE), help="the checkout whose monai_tpu_torch is timed")
    ap.add_argument("--iters", type=int, default=10, help="timed calls a site")
    ap.add_argument("--label", default="", help="a name for this run in its output")
    ap.add_argument("--check", action="store_true", help="also each site's errors and two calls bit for bit")
    ap.add_argument("--groups", action="store_true", help="the widest sites with each channel group forced")
    ap.add_argument("--rows", action="store_true", help="a read of x and g a channel group at a time")
    ap.add_argument("--train", action="store_true", help="also the float32 SwinUNETR training step")
    args = ap.parse_args()
    root = Path(args.root).resolve()
    # the site tables come with this checkout; then its package is dropped, so that --root's
    # is the one imported
    sys.path[:0] = [str(HERE), str(HERE / "tests")]
    from test_torch_norm_bwd_plan import SWIN_NORM_SITES, UNET_NORM_SITES

    for name in [m for m in sys.modules if m.split(".")[0] == "monai_tpu_torch"]:
        del sys.modules[name]
    sys.path.insert(0, str(root))
    import torch
    import torch.nn.functional as F

    from monai_tpu_torch.networks.layers import fast_norm
    from monai_tpu_torch.ops._build import library

    if not torch.cuda.is_available():
        raise SystemExit("norm_bwd_ab: no CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    library()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(8)
    bwd = fast_norm.instance_norm_prelu_backward

    def ms(fn, queued: bool = True) -> float:
        """Mean time of fn() between CUDA events around --iters calls. queued: the card first
        sleeps while the host queues the calls, so that the time is the card's alone; else
        what back-to-back callers see."""
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

    def cuda_launches(fn) -> int | None:
        """The CUDA kernels one call of fn launches, by the profiler (None where it sees
        none: then the sums a step count none for it)."""
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        try:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
        except RuntimeError:
            return None
        return sum(1 for e in prof.events() if "norm_bwd" in e.name) or None

    def inputs(bsz, c, sp, affine, slope, dtype):
        x = (torch.randn((bsz, c, *sp), generator=gen, device=dev) * 3 + 1).to(dtype)
        x = x.contiguous(memory_format=torch.channels_last_3d)
        gy = torch.randn((bsz, c, *sp), generator=gen, device=dev).to(dtype)
        gy = gy.contiguous(memory_format=torch.channels_last_3d)
        w = (torch.rand((c,), generator=gen, device=dev) + 0.5).to(dtype) if affine else None
        b = torch.randn((c,), generator=gen, device=dev).to(dtype) if affine else None
        a = None if slope is None else torch.full((1,), slope, device=dev, dtype=dtype)
        _, stats = fast_norm._forward(x, w, b, a, 1e-5, True)
        return x, gy, w, b, a, stats

    out = {"label": args.label, "root": str(root), "card": smi, "sites": [], "steps": {}}
    for step, sites, dtype in (("swin_train", SWIN_NORM_SITES, torch.float32),
                               ("unet_train", UNET_NORM_SITES, torch.bfloat16)):
        sums = {"kernel_ms": 0.0, "call_ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
                "cuda_launches": 0}
        for (c, sp, affine, slope), count in sites.items():
            x, gy, w, b, a, stats = inputs(4, c, sp, affine, slope, dtype)
            plan = fast_norm.instance_norm_backward_plan(4, c, math.prod(sp), dtype, True, *fast_norm._card(0))
            row = {"step": step, "c": c, "spatial": sp, "affine": affine, "slope": slope, "count": count,
                   "dtype": str(dtype)[6:], "plan": plan}
            if args.check:
                dx, s3 = bwd(gy, x, stats, w, b, a)
                again = bwd(gy, x, stats, w, b, a)
                ref_dx, ref_s = fast_norm.instance_norm_prelu_backward_plain(gy, x, stats, w, b, a)
                row["dx_err"] = ((dx.float() - ref_dx.float()).abs().max() / ref_dx.float().abs().max()).item()
                row["sums_err"] = max(((s_ - r_).abs().max() / r_.abs().max()).item()
                                      for s_, r_ in zip(s3, ref_s) if r_.abs().max().item() > 0)
                row["same_bits"] = torch.equal(dx, again[0]) and torch.equal(s3, again[1])
                del dx, s3, again, ref_dx, ref_s
            row["kernel_ms"] = ms(lambda: bwd(gy, x, stats, w, b, a))
            row["call_ms"] = ms(lambda: bwd(gy, x, stats, w, b, a), queued=False)
            row["plain_ms"] = ms(lambda: fast_norm.instance_norm_prelu_backward_plain(gy, x, stats, w, b, a))
            xl = x.detach().requires_grad_()
            with torch.enable_grad():
                y = F.instance_norm(xl, weight=w, bias=b, eps=1e-5)
            row["library_ms"] = ms(lambda: torch.autograd.grad(y, xl, gy, retain_graph=True))
            del y, xl
            row["cuda_launches"] = cuda_launches(lambda: bwd(gy, x, stats, w, b, a))
            row["bound_ms"] = 3 * x.numel() * x.element_size() / HBM_BYTES_S * 1e3
            out["sites"].append(row)
            for k in sums:
                sums[k] += count * (row[k] or 0)
            note = "" if not args.check else (f", dx err {row['dx_err']:.3g}, sums err {row['sums_err']:.3g}, two "
                                              f"calls bit for bit {row['same_bits']}")
            keys = ("path", "group", "units_per_group", "unit_groups", "per_unit", "stash", "stash_bytes")
            print(f"{args.label} {step} C={c:3d} @{sp} x{count} {row['dtype']}: kernel {row['kernel_ms']:.4f} ms (a "
                  f"call back to back {row['call_ms']:.4f}), plain {row['plain_ms']:.4f}, F.instance_norm backward "
                  f"{row['library_ms']:.4f}, bound {row['bound_ms']:.4f} ({row['bound_ms'] / row['kernel_ms']:.1%} "
                  f"of the kernel), CUDA launches {row['cuda_launches']}; plan "
                  + ", ".join(f"{k} {plan[k]}" for k in keys if k in plan) + note, flush=True)
            del x, gy, stats
            torch.cuda.empty_cache()
        out["steps"][step] = sums
        print(f"{args.label} {step} norm backward a step: kernel {sums['kernel_ms']:.4f} ms (calls back to back "
              f"{sums['call_ms']:.4f}), plain {sums['plain_ms']:.4f}, F.instance_norm backward "
              f"{sums['library_ms']:.4f}, bound {sums['bound_ms']:.4f} ({sums['bound_ms'] / sums['kernel_ms']:.1%}), "
              f"CUDA launches {sums['cuda_launches']}", flush=True)

    if args.groups:
        shipped = fast_norm.instance_norm_backward_plan
        for dtype, groups in ((torch.float32, (48, 24, 16, 8)), (torch.bfloat16, (48, 24, 16))):
            x, gy, w, b, a, stats = inputs(4, 48, (96, 96, 96), True, 0.01, dtype)
            ref = bwd(gy, x, stats, w, b, a)
            bound = 3 * x.numel() * x.element_size() / HBM_BYTES_S * 1e3
            times = {}
            for grp in list(groups) + list(reversed(groups)):
                fast_norm.instance_norm_backward_plan = lambda *p, _g=grp, **k: shipped(*p, **k, group=_g)
                fast_norm._backward_args.cache_clear()
                got = bwd(gy, x, stats, w, b, a)
                err = ((got[0].float() - ref[0].float()).abs().max() / ref[0].float().abs().max()).item()
                times.setdefault(grp, []).append(ms(lambda: bwd(gy, x, stats, w, b, a)))
                plan = fast_norm._backward_args((4, 48, 96, 96, 96), dtype, 0, True)[0]
                print(f"{args.label} groups (4, 48, 96^3) {str(dtype)[6:]} G {grp}: kernel {times[grp][-1]:.4f} ms, "
                      f"bound {bound:.4f} ({bound / times[grp][-1]:.1%}); dx against the shipped plan's {err:.3g}; "
                      f"{plan['unit_groups']} groups of {plan['units_per_group']}, stash {plan['stash']}, unit "
                      f"{plan['unit_bytes'] / 1e6:.1f} MB, held {plan['held_bytes'] / 1e6:.1f} MB", flush=True)
                del got
            fast_norm.instance_norm_backward_plan = shipped
            fast_norm._backward_args.cache_clear()
            out.setdefault("groups", {})[str(dtype)[6:]] = times
            del x, gy, stats, ref
            torch.cuda.empty_cache()

    if args.rows:
        from monai_tpu_torch.ops._build import NVCC_FLAGS, find_nvcc

        work = HERE / "build" / "norm_bwd_ab"
        work.mkdir(parents=True, exist_ok=True)
        (work / "probe.cu").write_text(PROBE)
        subprocess.run([find_nvcc(), *NVCC_FLAGS, "-shared", "-o", str(work / "probe.so"), str(work / "probe.cu")],
                       check=True)
        fn = ctypes.CDLL(str(work / "probe.so")).launch_read_rows
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        x = torch.randn((4, 96 ** 3, 48), generator=gen, device=dev)
        gy = torch.randn((4, 96 ** 3, 48), generator=gen, device=dev)
        sink = torch.zeros(1, device=dev)
        stream = torch.cuda.current_stream().cuda_stream
        rates = {}
        for grp in (48, 24, 16, 8, 8, 16, 24, 48):

            def read(grp=grp):
                for j in range(48 // grp):  # a channel group at a time, over every instance's voxels
                    err = fn(x.data_ptr() + 4 * j * grp, gy.data_ptr() + 4 * j * grp, 4 * 96 ** 3, grp // 4, 12,
                             sink.data_ptr(), 132 * 8, 256, stream)
                    if err:
                        raise RuntimeError(f"read_rows: error {err}")

            t = ms(read)
            rates.setdefault(grp, []).append(2 * x.numel() * 4 / t / 1e6)
            print(f"{args.label} rows: x and g of (4, 48, 96^3) float32, {grp} channels ({grp * 4} B) a row: "
                  f"{t:.4f} ms, {rates[grp][-1]:.1f} GB/s", flush=True)
        out["rows_gb_s"] = rates
        del x, gy

    if args.train:
        import functools

        from monai_tpu_torch.engines import Events, SupervisedTrainer
        from monai_tpu_torch.losses import DiceCELoss
        from monai_tpu_torch.networks.nets import SwinUNETR

        net = SwinUNETR(1, 14, feature_size=48, generator=torch.Generator().manual_seed(0), device="cpu").to(dev)
        g2 = torch.Generator(device=dev).manual_seed(22)
        batch = {"image": torch.rand((4, 1, 96, 96, 96), generator=g2, device=dev),
                 "label": torch.randint(0, 14, (4, 1, 96, 96, 96), generator=g2, device=dev).float()}
        warmup, timed = 2, 10
        trainer = SupervisedTrainer(device=dev, max_epochs=1, train_data_loader=[batch] * (warmup + timed),
                                    network=net,
                                    optimizer=functools.partial(torch.optim.AdamW, lr=1e-4, weight_decay=1e-5),
                                    loss_function=DiceCELoss(to_onehot_y=True, softmax=True))
        ends = []

        @trainer.on(Events.ITERATION_COMPLETED)
        def _record(engine):
            ends.append(torch.cuda.Event(enable_timing=True))
            ends[-1].record()
            if engine.state.iteration == warmup:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats(dev)
                bwd.launches = 0

        torch.backends.cudnn.allow_tf32 = True  # torch's default, as a user's process runs
        trainer.run()
        torch.cuda.synchronize()
        steps = [ends[i].elapsed_time(ends[i + 1]) for i in range(warmup - 1, len(ends) - 1)]
        peak = torch.cuda.max_memory_allocated(dev) / 1e9
        out["train"] = {"median_step_ms": statistics.median(steps), "steps_ms": steps, "peak_gb": peak,
                        "norm_backward_calls_a_step": bwd.launches / timed}
        print(f"{args.label} swin_train float32 step: median {statistics.median(steps):.3f} ms (min {min(steps):.3f}, "
              f"max {max(steps):.3f}) over {timed} steps; peak {peak:.2f} GB; norm backward {bwd.launches / timed:g} "
              f"calls a step", flush=True)
    print(smi)
    print(json.dumps(out, default=str))


if __name__ == "__main__":
    main()
