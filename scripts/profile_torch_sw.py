#!/usr/bin/env python3
"""Where the time of the port's sliding-window eval, filtering and training goes, on one NVIDIA GPU.

Runs a chip_smoke.py sliding-window path, filtering stage or training step and reports,
per volume (per step for ``--net train``):

- ``--net unet`` or ``swinunetr``: the same network, inferer, 224x224x112 volume and
  bfloat16 weights as chip_smoke.py;
- ``--net spleen``: the Spleen bundle's batch-norm UNet in float32 under
  SlidingWindowInferer(96, sw_batch_size=4, overlap=0.25) on a (1, 1, 270, 270, 224)
  volume, the preprocessed shape of a 512x512x90 CT (48 windows), with TF32 off as in
  chip_smoke.py;
- ``--net grid``: ``BilateralFilter.apply`` at its defaults (the bilateral grid) on a
  (1, 1, 270, 270, 224) float32 volume of uniform noise in [0, 1);
- ``--net crf``: ``CRF()`` over (1, 2, 270, 270, 224) float32 logits of standard normal
  noise with that volume as reference;
- ``--net train``: one ``SupervisedTrainer(amp=True)`` iteration of the bench UNet
  (chip_smoke.py phase 7: DiceCELoss, AdamW 1e-4 and 1e-4, a fixed batch of 4 96³
  patches), outside inference mode;

and for each:

- wall time with the profiler off (synchronised), and the host's enqueue time (the
  call returning, before the device finishes);
- under ``torch.profiler``: wall time, the device's kernel time (the sum of its kernels'
  durations, user annotations left out; one stream, so they do not overlap) and its idle
  share of the wall;
- the kernels by device time, the port's own first.

Run from the repository root: ``python3 scripts/profile_torch_sw.py --net swinunetr``
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

OWN = {"window_attention": "window attention (CUDA)", "conv3d_3x3_same": "3x3x3 conv (CUDA)",
       "norm_persistent": "instance norm (CUDA)", "norm_onchip": "instance norm (CUDA)",
       "bilateral_2d_kernel": "bilateral 2-D (CUDA)", "bilateral_3d_kernel": "bilateral 3-D (CUDA)",
       "conv3d_wgrad": "3x3x3 conv dw (CUDA)", "norm_bwd": "instance norm backward (CUDA)"}


def build(net_name: str, dev):
    """A call that runs one volume of the path."""
    from monai_tpu_torch.inferers import SlidingWindowInferer, SlidingWindowInfererAdapt
    from monai_tpu_torch.networks.blocks import CRF
    from monai_tpu_torch.networks.layers import BilateralFilter
    from monai_tpu_torch.networks.nets import SwinUNETR, UNet

    g = torch.Generator().manual_seed(0)
    gd = torch.Generator(device=dev).manual_seed(4)
    if net_name == "train":
        from monai_tpu_torch.engines import SupervisedTrainer
        from monai_tpu_torch.losses import DiceCELoss

        net = UNet(3, 1, 2, channels=(16, 32, 64, 128, 256), strides=(2, 2, 2, 2), num_res_units=2, generator=g,
                   device=dev)
        batch = {"image": torch.rand((4, 1, 96, 96, 96), generator=gd, device=dev),
                 "label": (torch.rand((4, 1, 96, 96, 96), generator=gd, device=dev) > 0.5).float()}
        trainer = SupervisedTrainer(device=dev, train_data_loader=[batch], network=net, amp=True,
                                    optimizer=torch.optim.AdamW(net.parameters(), lr=1e-4, weight_decay=1e-4),
                                    loss_function=DiceCELoss(to_onehot_y=True, softmax=True))

        def step():
            trainer.state.epoch = 0  # each call runs the one-batch epoch again
            trainer.run()

        return step
    if net_name in ("grid", "crf"):
        img = torch.rand((1, 1, 270, 270, 224), generator=gd, device=dev)
        if net_name == "grid":
            return lambda: BilateralFilter.apply(img)
        logits, crf = torch.randn((1, 2, 270, 270, 224), generator=gd, device=dev), CRF()
        return lambda: crf(logits, img)
    if net_name == "spleen":
        net = UNet(3, 1, 2, channels=(16, 32, 64, 128, 256), strides=(2, 2, 2, 2), num_res_units=2, norm="batch",
                   generator=g).eval().to(dev)
        inferer, shape, dtype = SlidingWindowInferer(96, sw_batch_size=4, overlap=0.25), (270, 270, 224), torch.float32
    else:
        if net_name == "unet":
            net = UNet(3, 1, 2, channels=(16, 32, 64, 128, 256), strides=(2, 2, 2, 2), num_res_units=2, generator=g)
            inferer = SlidingWindowInferer(96, sw_batch_size=18, overlap=0.25, mode="gaussian")
        else:
            net = SwinUNETR(1, 14, feature_size=24, generator=g)
            inferer = SlidingWindowInfererAdapt(96, sw_batch_size=6, overlap=0.25, mode="gaussian")
        net, shape, dtype = net.eval().to(dev, torch.bfloat16), (224, 224, 112), torch.bfloat16
    vol = torch.rand((1, 1, *shape), generator=gd, device=dev).to(dtype)
    return lambda: inferer(vol, net)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--net", choices=("unet", "swinunetr", "spleen", "grid", "crf", "train"), default="swinunetr")
    ap.add_argument("--volumes", type=int, default=5, help="volumes profiled, after 3 warm-ups")
    ap.add_argument("--top", type=int, default=25, help="kernels listed")
    ap.add_argument("--trace", help="write a chrome trace here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_sw: no CUDA device")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    torch.backends.cudnn.allow_tf32 = False
    n = args.volumes
    with torch.inference_mode(args.net != "train"):
        run = build(args.net, dev)
        for _ in range(3):
            run()
        torch.cuda.synchronize()
        enqueue, wall = [], []
        for _ in range(n):
            t0 = time.perf_counter()
            run()
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            enqueue.append(t1 - t0)
            wall.append(time.perf_counter() - t0)
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                run()
            torch.cuda.synchronize()
            prof_wall = (time.perf_counter() - t0) / n
    by_name: dict[str, list[float]] = defaultdict(lambda: [0.0, 0])
    for evt in prof.events():
        # a user annotation on the device's timeline (``Optimizer.step#AdamW.step``) spans
        # kernels that are counted on their own
        if evt.device_type == torch.autograd.DeviceType.CUDA and not getattr(evt, "is_user_annotation", False):
            rec = by_name[evt.name]
            rec[0] += evt.time_range.elapsed_us() / 1e3 / n
            rec[1] += 1
    device_ms = sum(v[0] for v in by_name.values())
    wall_ms, enq_ms = 1e3 * sum(wall) / n, 1e3 * sum(enqueue) / n
    print(f"{args.net}: {smi}; {n} volumes")
    print(f"per volume: wall {wall_ms:.3f} ms (profiler off), host enqueue {enq_ms:.3f} ms; under the profiler "
          f"wall {prof_wall * 1e3:.3f} ms; device kernel time {device_ms:.3f} ms; device idle "
          f"{1 - device_ms / wall_ms:.1%} of the profiler-off wall, {1 - device_ms / (prof_wall * 1e3):.1%} "
          f"under the profiler")
    own: dict[str, float] = defaultdict(float)
    for name, (ms, _) in by_name.items():
        for key, label in OWN.items():
            if key in name:
                own[label] += ms
    for label, ms in sorted(own.items()):
        print(f"  {label:28s} {ms:9.3f} ms/volume")
    print(f"  {'everything else':28s} {device_ms - sum(own.values()):9.3f} ms/volume")
    for name, (ms, count) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:args.top]:
        print(f"  {ms:9.3f} ms  x{count / n:6.1f}/vol  {name[:110]}")
    if args.trace:
        prof.export_chrome_trace(args.trace)


if __name__ == "__main__":
    main()
