"""Evaluators (counterpart of monai_tpu/engines/evaluator.py: ``Evaluator`` and
``SupervisedEvaluator``): one epoch over the validation data, the network in eval mode,
each batch's output decollated and postprocessed item by item (``decollate=True``)."""
from __future__ import annotations

from collections.abc import Callable, Iterable, Sequence

import torch

from ..data.meta_image import MetaImage
from ..inferers.inferer import Inferer, SimpleInferer
from ..utils.enums import CommonKeys as Keys
from .events import IterationEvents
from .utils import default_prepare_batch
from .workflow import Workflow

__all__ = ["Evaluator", "SupervisedEvaluator"]


class Evaluator(Workflow):
    """One evaluation epoch. ``run`` puts the ``network`` in eval mode (``mode="eval"``)
    or train mode (``"train"``) for the run and gives it back its mode after.
    ``device=None`` is the CUDA card; pass ``device="cpu"`` for the CPU."""

    def __init__(self, device=None, val_data_loader: Iterable | None = None, epoch_length: int | None = None,
                 non_blocking: bool = False, prepare_batch: Callable = default_prepare_batch,
                 iteration_update: Callable | None = None, postprocessing: Callable | None = None,
                 key_val_metric: dict | None = None, additional_metrics: dict | None = None,
                 metric_cmp_fn: Callable = lambda cur, best: cur > best, val_handlers: Sequence | None = None,
                 amp: bool = False, mode: str = "eval", decollate: bool = True):
        super().__init__(device=device, max_epochs=1, data_loader=val_data_loader, epoch_length=epoch_length,
                         non_blocking=non_blocking, prepare_batch=prepare_batch, iteration_update=iteration_update,
                         postprocessing=postprocessing, key_metric=key_val_metric,
                         additional_metrics=additional_metrics, metric_cmp_fn=metric_cmp_fn, handlers=val_handlers,
                         amp=amp, decollate=decollate)
        if mode not in ("eval", "train"):
            raise ValueError(f"mode must be 'eval' or 'train', not {mode!r}")
        self.mode = mode

    def run(self, global_epoch: int = 1) -> None:
        """Evaluate once more: one epoch after those already run."""
        self.state.max_epochs = self.state.epoch + 1
        net = getattr(self, "network", None)
        was_training = net.training if isinstance(net, torch.nn.Module) else None
        if was_training is not None:
            net.train(self.mode == "train")
        try:
            super().run()
        finally:
            if was_training is not None:
                net.train(was_training)

    def get_stats(self, *vars_name: str) -> dict:
        return super().get_stats("output", "batch", *vars_name)


class SupervisedEvaluator(Evaluator):
    """Each batch's image through ``inferer`` and ``network`` without autograd, the
    predictions in float32. The network runs eagerly, as it is given. ``amp=True`` casts
    the input to bfloat16 and leaves the network's weights as they are, as the JAX
    evaluator does: each layer then runs in the type its rule gives a bfloat16 input and
    float32 weights (``networks.layers.factories``: a 3x3x3 stride-1 conv with
    min(CI, 128) >= 2 min(CO, 128) casts its kernel and runs in bfloat16, every other conv
    promotes to float32, and the layers after it see float32)."""

    def __init__(self, device=None, val_data_loader: Iterable | None = None, network: torch.nn.Module | None = None,
                 epoch_length: int | None = None, non_blocking: bool = False,
                 prepare_batch: Callable = default_prepare_batch, iteration_update: Callable | None = None,
                 inferer: Inferer | None = None, postprocessing: Callable | None = None,
                 key_val_metric: dict | None = None, additional_metrics: dict | None = None,
                 metric_cmp_fn: Callable = lambda cur, best: cur > best, val_handlers: Sequence | None = None,
                 amp: bool = False, mode: str = "eval", decollate: bool = True):
        super().__init__(device=device, val_data_loader=val_data_loader, epoch_length=epoch_length,
                         non_blocking=non_blocking, prepare_batch=prepare_batch, iteration_update=iteration_update,
                         postprocessing=postprocessing, key_val_metric=key_val_metric,
                         additional_metrics=additional_metrics, metric_cmp_fn=metric_cmp_fn,
                         val_handlers=val_handlers, amp=amp, mode=mode, decollate=decollate)
        self.network = network
        self.inferer = SimpleInferer() if inferer is None else inferer

    def _iteration(self, engine, batchdata: dict) -> dict:
        if batchdata is None:
            raise ValueError("Must provide batch data for current iteration.")
        batch = self.prepare_batch(batchdata, engine.state.device, engine.non_blocking)
        if len(batch) == 2:
            (inputs, targets), args, kwargs = batch, (), {}
        else:
            inputs, targets, args, kwargs = batch
        x = inputs.data if isinstance(inputs, MetaImage) else inputs
        x = x.to(torch.bfloat16) if self.amp else x
        with torch.no_grad():
            preds = self.inferer(x, self.network, *args, **kwargs)
        engine.fire_event(IterationEvents.FORWARD_COMPLETED)
        engine.fire_event(IterationEvents.MODEL_COMPLETED)
        return {Keys.IMAGE: inputs, Keys.LABEL: targets, Keys.PRED: preds.float()}
