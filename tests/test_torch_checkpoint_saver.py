"""The port's CheckpointSaver and StatsHandler against the JAX package's, on the CPU.

Each saver is driven by hand through a scripted run: per epoch, a key metric from a fixed
sequence (ties, a drop, a new best), the epoch's iterations, and the run's end. After
every event the files kept under ``save_dir`` must be named as the JAX saver names its
orbax checkpoints, for the key-metric rule (``key_metric_n_saved``, ties with and without
``key_metric_greater_or_equal``, ``key_metric_negative_sign``, a ``file_prefix``, a fixed
``key_metric_filename``) and the interval rule (epochs or iterations, ``n_saved``). The
port's files hold the weights of the epoch that named them. ``StatsHandler``'s print
loggers are called once an iteration and once an epoch, in place of the default lines, in
both packages.
"""
import os
import types

import numpy as np
import pytest
import torch
from flax import nnx

from monai_tpu.engines import Workflow as JaxWorkflow
from monai_tpu.handlers import CheckpointSaver as JaxSaver
from monai_tpu.handlers import StatsHandler as JaxStats
from monai_tpu_torch.engines.workflow import Workflow
from monai_tpu_torch.handlers import CheckpointSaver, StatsHandler

METRICS = [0.50, 0.70, 0.70, 0.60, 0.90, 0.10]
ITERS = 2


def _engine(key="val_mean_dice"):
    state = types.SimpleNamespace(epoch=0, iteration=0, max_epochs=len(METRICS), metrics={}, key_metric_name=key)
    return types.SimpleNamespace(state=state)


def _drive(saver, net, root, set_weights):
    """Run the scripted epochs through ``saver``; the sorted names under ``root`` after
    each event."""
    engine, seen = _engine(), []
    root.mkdir(parents=True, exist_ok=True)
    for epoch, metric in enumerate(METRICS, 1):
        engine.state.epoch = epoch
        set_weights(net, epoch)
        for _ in range(ITERS):
            engine.state.iteration += 1
            if saver.save_interval and not saver.epoch_level and engine.state.iteration % saver.save_interval == 0:
                saver.interval_completed(engine)
                seen.append(sorted(os.listdir(root)))
        engine.state.metrics = {"val_mean_dice": metric}
        if saver.save_key_metric:
            saver.metrics_completed(engine)
        if saver.save_interval and saver.epoch_level and epoch % saver.save_interval == 0:
            saver.interval_completed(engine)
        seen.append(sorted(os.listdir(root)))
    if saver.save_final:
        saver.completed(engine)
        seen.append(sorted(os.listdir(root)))
    return seen


CASES = {
    "best2": dict(save_key_metric=True, key_metric_n_saved=2),
    "best2_ge": dict(save_key_metric=True, key_metric_n_saved=2, key_metric_greater_or_equal=True),
    "best3_negative": dict(save_key_metric=True, key_metric_n_saved=3, key_metric_negative_sign=True),
    "best1_fixed_prefix": dict(save_key_metric=True, key_metric_filename="model.pt", file_prefix="spleen"),
    "epochs": dict(save_interval=2, n_saved=2, save_final=True, final_filename="model_final.ckpt"),
    "iterations": dict(save_interval=3, n_saved=2, epoch_level=False),
    "all": dict(save_key_metric=True, key_metric_n_saved=2, save_interval=1, n_saved=2, save_final=True),
}


def _jax_weights(net, epoch):
    net.kernel.set_value(np.full(net.kernel.get_value().shape, float(epoch), np.float32))


def _torch_weights(net, epoch):
    with torch.no_grad():
        net.weight.fill_(float(epoch))


@pytest.mark.parametrize("case", sorted(CASES))
def test_saver_keeps_the_files_jax_names(case, tmp_path):
    kw = CASES[case]
    jax_root, root = tmp_path / "jax", tmp_path / "port"
    jax_net = nnx.Linear(2, 3, rngs=nnx.Rngs(0))
    want = _drive(JaxSaver(str(jax_root), {"model": jax_net}, **kw), jax_net, jax_root, _jax_weights)
    net = torch.nn.Linear(2, 3)
    got = _drive(CheckpointSaver(str(root), {"model": net}, **kw), net, root, _torch_weights)
    assert got == want
    assert len({tuple(s) for s in got}) > 1  # the run saved, and (most cases) evicted
    for name in got[-1]:
        w = torch.load(root / name, weights_only=True)["model"]["weight"]
        epoch = int(name.split("epoch=")[1].split(".")[0]) if "epoch=" in name else None
        if epoch is not None:
            assert torch.equal(w, torch.full_like(w, float(epoch))), name
        elif "iteration=" in name:
            it = int(name.split("iteration=")[1].split(".")[0])
            assert torch.equal(w, torch.full_like(w, float((it - 1) // ITERS + 1))), name


def test_fixed_filename_refuses_several_best():
    for cls in (JaxSaver, CheckpointSaver):
        with pytest.raises(ValueError, match="only save 1 model"):
            cls("unused", {"model": object()}, save_key_metric=True, key_metric_filename="m.pt", key_metric_n_saved=2)


def test_stats_handler_print_loggers():
    calls = {}

    def counting(tag):
        def log(engine):
            calls[tag] = calls.get(tag, 0) + 1
        return log

    for pkg, wf_cls, stats_cls, kw in (("jax", JaxWorkflow, JaxStats, {}), ("port", Workflow, StatsHandler,
                                                                          {"device": "cpu"})):
        handler = stats_cls(iteration_print_logger=counting(f"{pkg}_it"), epoch_print_logger=counting(f"{pkg}_ep"))
        wf = wf_cls(max_epochs=2, data_loader=[{"x": 0}] * 3, handlers=[handler], decollate=False, **kw)
        wf._iteration = lambda engine, batch: {"loss": 0.0}
        wf.run()
    assert calls == {"jax_it": 6, "jax_ep": 2, "port_it": 6, "port_ep": 2}
