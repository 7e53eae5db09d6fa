#!/usr/bin/env python3
"""Time the window attention's backward kernel (``fused_window_attention_backward``) of one
checkout at every attention site of the float32 SwinUNETR step, on the card.

The sites are chip_smoke.py's ``SWIN_ATTN_SITES`` (batch 4 of 96^3, head dim 16) and the
same at head dim 8 (the bench SwinUNETR's width), float32. At each site the kernel of the
checkout at ``--root`` (its ``monai_tpu_torch``, built from its own sources) is timed by
CUDA events over ``--iters`` calls after a warm-up, queued behind a sleep of the card so
that the time is the card's alone, beside autograd's backward of
``F.scaled_dot_product_attention`` with bias + mask as one additive mask that takes a grad,
and the FLOP bound: the five N^2 D products as 3xTF32, three TF32 products each at the
tensor cores' 495 TFLOP/s, as the kernel computes them (the bytes and one exp a score lie
below it), with the old bound at the float32 FMA pipe's 67 TFLOP/s beside it. The masks are
random rows of 0 and -100. With ``--forward`` it also times the forward kernel in float32 at
the step's sites, and at the same sites at head dim 8, beside its plain version,
``F.scaled_dot_product_attention`` and the same two bounds of its two N^2 D products; there
``--check`` adds each site's output error against the plain version and log-sum-exp error
against ``torch.logsumexp`` (each relative to max|ref|) and whether two calls give the same
bits, and ``--fma`` times the FMA instance on the same inputs one element past a 16-byte
boundary. With
``--train`` it runs the float32 ``SupervisedTrainer`` step of ``SwinUNETR(1, 14,
feature_size=48)`` as chip_smoke.py phase 9 does (one fixed batch of 4 96^3 patches, AdamW,
DiceCELoss, cuDNN's TF32 allowed as by torch's default), 2 warm-up and 10 timed
iterations: the median step between CUDA events and the peak memory. It prints a line a
site and, last, one JSON object with the per-site times and their sums a step. To put two
versions side by side, run it for each in one call to the card, in turns (parent, change,
change, parent): python3 scripts/attn_bwd_ab.py --root build/parent.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
PEAK_F32, PEAK_TF32 = 67e12, 495e12
SLEEP_CYCLES = 40_000_000  # ~20 ms at the H100's clock: long enough for the host to queue the calls


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(HERE), help="the checkout whose monai_tpu_torch is timed")
    ap.add_argument("--iters", type=int, default=10, help="timed calls a site")
    ap.add_argument("--label", default="", help="a name for this run in its output")
    ap.add_argument("--forward", action="store_true", help="also the forward kernel at the step's sites")
    ap.add_argument("--check", action="store_true", help="with --forward: errors, log-sum-exp, same bits twice")
    ap.add_argument("--fma", action="store_true", help="with --forward: also time the FMA instance (unaligned)")
    ap.add_argument("--train", action="store_true", help="also the float32 SwinUNETR training step")
    args = ap.parse_args()
    root = Path(args.root).resolve()
    # the site table comes with this checkout; then its package is dropped, so that --root's
    # is the one imported
    sys.path[:0] = [str(HERE)]
    from chip_smoke import SWIN_ATTN_SITES

    for name in [m for m in sys.modules if m.split(".")[0] == "monai_tpu_torch"]:
        del sys.modules[name]
    sys.path.insert(0, str(root))
    import torch
    import torch.nn.functional as F

    from monai_tpu_torch.ops._build import library
    from monai_tpu_torch.ops.window_attention import (_forward, fused_window_attention,
                                                      fused_window_attention_backward, fused_window_attention_plain,
                                                      window_attention_plan)

    if not torch.cuda.is_available():
        raise SystemExit("attn_bwd_ab: no CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    library()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(7)
    masks = {}

    def ms(fn) -> float:
        """Mean device time of fn() between CUDA events around --iters calls queued behind a
        sleep of the card."""
        for _ in range(2):
            fn()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        for _ in range(args.iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / args.iters

    def inputs(b, h, n, d, nw):
        q, k, v, dout = (torch.randn((b, h, n, d), generator=gen, device=dev) for _ in range(4))
        q *= d ** -0.5
        bias = torch.randn((h, n, n), generator=gen, device=dev) * 0.5
        if nw is not None and (nw, n) not in masks:
            masks[nw, n] = (torch.rand((nw, n, n), generator=gen, device=dev) > 0.5).float() * -100.0
        return q, k, v, bias, None if nw is None else masks[nw, n], dout

    def unaligned(t):
        """t's values one element past a 16-byte boundary."""
        flat = torch.empty(t.numel() + 1, device=dev, dtype=t.dtype)
        flat[1:] = t.flatten()
        return flat[1:].view(t.shape)

    def sdpa_inputs(q, k, v, bias, mask, b, h, n, d, nw):
        groups = 1 if nw is None else nw
        add = bias if nw is None else bias[None] + mask[:, None]
        qs, ks, vs = (t.view(b // groups, groups, h, n, d) if nw else t for t in (q, k, v))
        return qs, ks, vs, add

    out = {"label": args.label, "root": str(root), "card": smi, "backward": [], "forward": [], "sums": {}}
    for dd in (16, 8):
        sums = {"kernel_ms": 0.0, "sdpa_ms": 0.0, "bound_ms": 0.0, "fma_bound_ms": 0.0}
        for (b, h, n, _, nw), count in SWIN_ATTN_SITES.items():
            q, k, v, bias, mask, dout = inputs(b, h, n, dd, nw)
            o, lse = _forward(q, k, v, bias, mask, with_lse=True)
            k_ms = ms(lambda: fused_window_attention_backward(q, k, v, bias, mask, o, dout, lse))
            qs, ks, vs, add = sdpa_inputs(q, k, v, bias, mask, b, h, n, dd, nw)
            qs, ks, vs, add = (t.detach().requires_grad_() for t in (qs, ks, vs, add))
            with torch.enable_grad():
                y = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=add, scale=1.0)
            gs = dout.view(y.shape)
            lib_ms = ms(lambda: torch.autograd.grad(y, (qs, ks, vs, add), gs, retain_graph=True))
            del y, qs, ks, vs, add
            flops = 5 * 2.0 * b * h * n * n * dd  # the five N^2 D products
            b_ms = 3 * flops / PEAK_TF32 * 1e3
            row = {"site": [b, h, n, dd, nw], "count": count, "kernel_ms": k_ms, "sdpa_ms": lib_ms, "bound_ms": b_ms,
                   "fma_bound_ms": flops / PEAK_F32 * 1e3}
            out["backward"].append(row)
            for key in sums:
                sums[key] += count * row[key]
            print(f"{args.label} backward windows {b} heads {h} N {n} D {dd} mask rows {nw} x{count} float32: kernel "
                  f"{k_ms:.4f} ms, SDPA autograd {lib_ms:.4f} ms, 3xTF32 FLOP bound {b_ms:.4f} ms ({b_ms / k_ms:.1%} "
                  f"of the kernel), old FMA-pipe bound {row['fma_bound_ms']:.4f} ms", flush=True)
            del q, k, v, bias, dout, o, lse
            torch.cuda.empty_cache()
        out["sums"][f"backward_d{dd}"] = sums
        print(f"{args.label} backward D {dd} a step: kernel {sums['kernel_ms']:.4f} ms, SDPA autograd "
              f"{sums['sdpa_ms']:.4f} ms, bound {sums['bound_ms']:.4f} ms, old FMA-pipe bound "
              f"{sums['fma_bound_ms']:.4f} ms", flush=True)
    for dd in (16, 8) if args.forward else ():
        sums = {"kernel_ms": 0.0, "plain_ms": 0.0, "sdpa_ms": 0.0, "fma_ms": 0.0, "bound_ms": 0.0,
                "fma_bound_ms": 0.0}
        with torch.no_grad():
            for (b, h, n, _, nw), count in SWIN_ATTN_SITES.items():
                q, k, v, bias, mask, _ = inputs(b, h, n, dd, nw)
                row = {"site": [b, h, n, dd, nw], "count": count,
                       "instance": window_attention_plan(q, k, v, bias, mask)["instance"]}
                note = ""
                if args.check:
                    got = fused_window_attention(q, k, v, bias, mask)
                    ref = fused_window_attention_plain(q, k, v, bias, mask)
                    row["max_err"] = ((got - ref).abs().max() / ref.abs().max()).item()
                    row["same_bits"] = torch.equal(got, fused_window_attention(q, k, v, bias, mask))
                    del got, ref
                    lse = _forward(q, k, v, bias, mask, with_lse=True)[1]
                    s = torch.matmul(q, k.transpose(-1, -2)) + bias
                    if mask is not None:
                        s = (s.view(b // nw, nw, h, n, n) + mask[None, :, None]).view(b, h, n, n)
                    lse_ref = torch.logsumexp(s, -1)
                    row["lse_err"] = ((lse - lse_ref).abs().max() / lse_ref.abs().max()).item()
                    del s, lse, lse_ref
                    note += (f", max err {row['max_err']:.3g} of max|ref|, log-sum-exp {row['lse_err']:.3g}, two "
                             f"calls bit for bit {row['same_bits']}")
                row["kernel_ms"] = ms(lambda: fused_window_attention(q, k, v, bias, mask))
                row["plain_ms"] = ms(lambda: fused_window_attention_plain(q, k, v, bias, mask))
                qs, ks, vs, add = sdpa_inputs(q, k, v, bias, mask, b, h, n, dd, nw)
                row["sdpa_ms"] = ms(lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=add, scale=1.0))
                row["fma_ms"] = 0.0
                if args.fma:
                    qo, ko, vo = unaligned(q), unaligned(k), unaligned(v)
                    assert window_attention_plan(qo, ko, vo, bias, mask)["instance"] == "fma"
                    row["fma_ms"] = ms(lambda: fused_window_attention(qo, ko, vo, bias, mask))
                    note += f", FMA instance {row['fma_ms']:.4f} ms"
                    del qo, ko, vo
                flops = 4.0 * b * h * n * n * dd  # the two N^2 D products
                row["bound_ms"], row["fma_bound_ms"] = 3 * flops / PEAK_TF32 * 1e3, flops / PEAK_F32 * 1e3
                out["forward"].append(row)
                for key in sums:
                    sums[key] += count * row[key]
                print(f"{args.label} forward windows {b} heads {h} N {n} D {dd} mask rows {nw} x{count} float32 "
                      f"instance {row['instance']}: kernel {row['kernel_ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
                      f"SDPA {row['sdpa_ms']:.4f} ms, 3xTF32 FLOP bound {row['bound_ms']:.4f} ms "
                      f"({row['bound_ms'] / row['kernel_ms']:.1%} of the kernel), old FMA-pipe bound "
                      f"{row['fma_bound_ms']:.4f} ms{note}", flush=True)
                del q, k, v, bias, qs, ks, vs, add
                torch.cuda.empty_cache()
        out["sums"][f"forward_d{dd}"] = sums
        print(f"{args.label} forward D {dd} a step: kernel {sums['kernel_ms']:.4f} ms, plain {sums['plain_ms']:.4f} "
              f"ms, SDPA {sums['sdpa_ms']:.4f} ms, FMA instance {sums['fma_ms']:.4f} ms, bound "
              f"{sums['bound_ms']:.4f} ms, old FMA-pipe bound {sums['fma_bound_ms']:.4f} ms", flush=True)
    masks.clear()
    torch.cuda.empty_cache()
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
        ends, losses = [], []

        @trainer.on(Events.ITERATION_COMPLETED)
        def _record(engine):
            losses.append(engine.state.output["loss"])
            ends.append(torch.cuda.Event(enable_timing=True))
            ends[-1].record()
            if engine.state.iteration == warmup:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats(dev)
                fused_window_attention_backward.launches = 0

        torch.backends.cudnn.allow_tf32 = True  # torch's default, as a user's process runs
        trainer.run()
        torch.cuda.synchronize()
        steps = [ends[i].elapsed_time(ends[i + 1]) for i in range(warmup - 1, len(ends) - 1)]
        peak = torch.cuda.max_memory_allocated(dev) / 1e9
        out["train"] = {"median_step_ms": statistics.median(steps), "steps_ms": steps, "peak_gb": peak,
                        "attention_backward_launches_a_step": fused_window_attention_backward.launches / timed,
                        "losses": [x.item() for x in losses]}
        print(f"{args.label} swin_train float32 step: median {statistics.median(steps):.3f} ms (min {min(steps):.3f}, "
              f"max {max(steps):.3f}) over {timed} steps; peak {peak:.2f} GB; attention backward "
              f"{fused_window_attention_backward.launches / timed:g} launches a step", flush=True)
    print(smi)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
