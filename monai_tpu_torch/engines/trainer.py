"""Trainers (counterpart of monai_tpu/engines/trainer.py: ``Trainer`` and
``SupervisedTrainer``).

One iteration is the JAX package's train step, run eagerly: the loss, its backward
through the network (the 3x3x3 conv and instance-norm kernels' backward halves on the
card) and a ``torch.optim`` step. With ``amp=True`` it follows ``_build_step``: the
network runs on a bfloat16 view of its float32 parameters (``amp_model_view``), the
inputs are cast to bfloat16, and the predictions to float32 before the loss; the grads
arrive in float32 on the parameters. No loss scaling, as bfloat16 has float32's range.
"""
from __future__ import annotations

from collections.abc import Callable, Iterable, Sequence

import torch

from ..data.meta_image import MetaImage
from ..inferers.inferer import Inferer, SimpleInferer
from ..networks.utils import amp_model_view
from ..utils.enums import CommonKeys as Keys
from .events import IterationEvents
from .utils import default_prepare_batch
from .workflow import Workflow

__all__ = ["SupervisedTrainer", "Trainer"]


class Trainer(Workflow):
    """Base trainer."""

    def get_stats(self, *vars_name: str) -> dict:
        return super().get_stats("output", "batch", *vars_name)


class SupervisedTrainer(Trainer):
    """Supervised training: per iteration, forward, loss, backward and an optimizer step.

    ``optimizer`` is a ``torch.optim`` optimizer over ``network``'s parameters, or a
    callable that builds one from them (``functools.partial(torch.optim.AdamW, lr=1e-4)``,
    a bundle's ``"_mode_": "partial"``), as the JAX trainer binds an optax transformation
    to the network. ``amp=False`` runs the step in the network's own type (float32);
    ``optim_set_to_none`` clears the grads to None rather than to zeros before each step.
    ``train_handlers`` attach to the engine (``attach``) as the JAX trainer's do.
    ``decollate`` is off by default (the JAX package's is on): the handlers the bundles
    use (``StatsHandler``, ``ValidationHandler``, ``CheckpointSaver``) read the iteration's
    output dict as it is, and the step's postprocessing and metrics take the whole batch.
    A batch of ``MetaImage``s gives its data to the network and the loss.
    ``compile`` and ``compile_kwargs`` are taken for the JAX package's signature and do
    nothing: the step runs eagerly."""

    def __init__(self, device=None, max_epochs: int = 1, train_data_loader: Iterable | None = None,
                 network: torch.nn.Module | None = None, optimizer: torch.optim.Optimizer | Callable | None = None,
                 loss_function: Callable | None = None, epoch_length: int | None = None, non_blocking: bool = False,
                 prepare_batch: Callable = default_prepare_batch, iteration_update: Callable | None = None,
                 inferer: Inferer | None = None, postprocessing: Callable | None = None,
                 key_train_metric: dict | None = None, additional_metrics: dict | None = None,
                 metric_cmp_fn: Callable = lambda cur, best: cur > best, train_handlers: Sequence | None = None,
                 amp: bool = False, decollate: bool = False, optim_set_to_none: bool = False, compile: bool = True,
                 compile_kwargs: dict | None = None):
        super().__init__(device=device, max_epochs=max_epochs, data_loader=train_data_loader,
                         epoch_length=epoch_length, non_blocking=non_blocking, prepare_batch=prepare_batch,
                         iteration_update=iteration_update, postprocessing=postprocessing,
                         key_metric=key_train_metric, additional_metrics=additional_metrics,
                         metric_cmp_fn=metric_cmp_fn, handlers=train_handlers, amp=amp, decollate=decollate)
        self.network = network
        if optimizer is not None and not isinstance(optimizer, torch.optim.Optimizer):
            optimizer = optimizer(network.parameters())
        self.optimizer = optimizer
        self.loss_function = loss_function
        self.inferer = SimpleInferer() if inferer is None else inferer
        self.optim_set_to_none = optim_set_to_none
        self.compile = compile

    def _iteration(self, engine, batchdata: dict) -> dict:
        if batchdata is None:
            raise ValueError("Must provide batch data for current iteration.")
        batch = self.prepare_batch(batchdata, engine.state.device, engine.non_blocking)
        if len(batch) == 2:
            inputs, targets = batch
            args, kwargs = (), {}
        else:
            inputs, targets, args, kwargs = batch
        self.network.train()
        self.optimizer.zero_grad(set_to_none=self.optim_set_to_none)
        model = amp_model_view(self.network) if self.amp else self.network
        x = inputs.data if isinstance(inputs, MetaImage) else inputs
        y = targets.data if isinstance(targets, MetaImage) else targets
        x = x.to(torch.bfloat16) if self.amp else x
        preds = self.inferer(x, model, *args, **kwargs).float()
        engine.fire_event(IterationEvents.FORWARD_COMPLETED)
        loss = self.loss_function(preds, y).mean()
        engine.fire_event(IterationEvents.LOSS_COMPLETED)
        loss.backward()
        engine.fire_event(IterationEvents.BACKWARD_COMPLETED)
        self.optimizer.step()
        engine.fire_event(IterationEvents.MODEL_COMPLETED)
        return {Keys.IMAGE: inputs, Keys.LABEL: targets, Keys.PRED: preds.detach(), Keys.LOSS: loss.detach()}
