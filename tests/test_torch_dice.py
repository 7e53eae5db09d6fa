"""monai_tpu_torch's Dice losses and Dice metric against monai_tpu's, on the CPU.

The same numpy logits and labels, made from a seed, go through both packages: DiceLoss
and DiceCELoss at 2 and 3 classes, with softmax or sigmoid, with and without the
background, in float32 to 1e-5 (sums in another order). At 2 classes with softmax the
JAX DiceCELoss takes its two-class rewrite on the logit difference, and the port's
general path is held to it. compute_dice and DiceMetric (float64) likewise, on binarised
predictions, with and without empty classes.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from monai_tpu.losses import DiceCELoss as JaxDiceCELoss
from monai_tpu.losses import DiceLoss as JaxDiceLoss
from monai_tpu.metrics import DiceMetric as JaxDiceMetric
from monai_tpu.metrics import compute_dice as jax_compute_dice
from monai_tpu_torch.losses import DiceCELoss, DiceLoss
from monai_tpu_torch.metrics import DiceMetric, compute_dice, do_metric_reduction

TOL = dict(rtol=1e-5, atol=1e-5)


def _data(c: int, seed: int = 0, shape=(2, 6, 5, 4)):
    rng = np.random.RandomState(seed)
    logits = (rng.randn(shape[0], c, *shape[1:]) * 2).astype(np.float32)
    labels = rng.randint(0, c, (shape[0], 1, *shape[1:])).astype(np.float32)
    return logits, labels


ACTS = [dict(softmax=True), dict(sigmoid=True)]


@pytest.mark.parametrize("c", [2, 3])
@pytest.mark.parametrize("act", ACTS, ids=["softmax", "sigmoid"])
@pytest.mark.parametrize("include_background", [True, False])
@pytest.mark.parametrize("batch", [False, True])
def test_dice_loss_matches_jax(c, act, include_background, batch):
    logits, labels = _data(c)
    kw = dict(to_onehot_y=True, include_background=include_background, batch=batch, **act)
    got = DiceLoss(**kw)(torch.from_numpy(logits), torch.from_numpy(labels))
    ref = JaxDiceLoss(**kw)(jnp.asarray(logits), jnp.asarray(labels))
    np.testing.assert_allclose(got.item(), float(ref), **TOL)


@pytest.mark.parametrize("c", [2, 3])
@pytest.mark.parametrize("act", ACTS, ids=["softmax", "sigmoid"])
@pytest.mark.parametrize("include_background", [True, False])
def test_dice_ce_loss_matches_jax(c, act, include_background):
    logits, labels = _data(c, 1)
    kw = dict(to_onehot_y=True, include_background=include_background, **act)
    got = DiceCELoss(**kw)(torch.from_numpy(logits), torch.from_numpy(labels))
    ref = JaxDiceCELoss(**kw)(jnp.asarray(logits), jnp.asarray(labels))
    np.testing.assert_allclose(got.item(), float(ref), **TOL)


@pytest.mark.parametrize("reduction", ["none", "sum"])
def test_dice_ce_loss_options_match_jax(reduction):
    logits, labels = _data(3, 2)
    kw = dict(to_onehot_y=True, softmax=True, lambda_dice=0.3, lambda_ce=1.7, ce_weight=[0.2, 1.0, 2.0])
    got = DiceCELoss(**kw)(torch.from_numpy(logits), torch.from_numpy(labels))
    ref = JaxDiceCELoss(**kw)(jnp.asarray(logits), jnp.asarray(labels))
    np.testing.assert_allclose(got.item(), float(ref), **TOL)
    kw = dict(to_onehot_y=True, softmax=True, reduction=reduction, squared_pred=True, jaccard=True)
    got = DiceLoss(**kw)(torch.from_numpy(logits), torch.from_numpy(labels))
    ref = JaxDiceLoss(**kw)(jnp.asarray(logits), jnp.asarray(labels))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_dice_ce_loss_grad_is_finite_and_bfloat16_logits_work():
    logits, labels = _data(2, 3)
    x = torch.from_numpy(logits).requires_grad_()
    loss = DiceCELoss(to_onehot_y=True, softmax=True)(x, torch.from_numpy(labels))
    loss.backward()
    assert torch.isfinite(x.grad).all() and x.grad.abs().max() > 0
    bf = DiceCELoss(to_onehot_y=True, softmax=True)(x.detach().bfloat16().float(), torch.from_numpy(labels))
    np.testing.assert_allclose(bf.item(), loss.item(), rtol=1e-2)


def _binarised(c: int, seed: int):
    logits, labels = _data(c, seed)
    pred = np.eye(c, dtype=np.float32)[logits.argmax(1)].transpose(0, 4, 1, 2, 3)
    return pred, np.eye(c, dtype=np.float32)[labels[:, 0].astype(int)].transpose(0, 4, 1, 2, 3)


@pytest.mark.parametrize("c", [2, 3])
@pytest.mark.parametrize("include_background", [True, False])
@pytest.mark.parametrize("ignore_empty", [True, False])
def test_compute_dice_matches_jax(c, include_background, ignore_empty):
    pred, label = _binarised(c, 4)
    label[0, c - 1] = 0  # an empty class: NaN, or 1 / 0 by the prediction
    got = compute_dice(torch.from_numpy(pred), torch.from_numpy(label), include_background, ignore_empty)
    ref = jax_compute_dice(pred, label, include_background, ignore_empty)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


@pytest.mark.parametrize("c", [2, 3])
@pytest.mark.parametrize("include_background", [True, False])
@pytest.mark.parametrize("reduction", ["mean", "mean_batch", "sum", "none"])
def test_dice_metric_matches_jax(c, include_background, reduction):
    got_m = DiceMetric(include_background=include_background, reduction=reduction, get_not_nans=True)
    ref_m = JaxDiceMetric(include_background=include_background, reduction=reduction, get_not_nans=True)
    for seed in (5, 6):
        pred, label = _binarised(c, seed)
        got_m(torch.from_numpy(pred), torch.from_numpy(label))
        ref_m(pred, label)
    (got, got_n), (ref, ref_n) = got_m.aggregate(), ref_m.aggregate()
    np.testing.assert_allclose(got.numpy(), ref, **TOL)
    np.testing.assert_allclose(got_n.numpy(), ref_n, **TOL)
    got_m.reset()
    assert got_m.get_buffer() is None


def test_dice_metric_takes_a_list_of_samples_and_num_classes():
    pred, label = _binarised(3, 7)
    m = DiceMetric(num_classes=3)
    m([torch.from_numpy(p) for p in pred], [torch.from_numpy(t) for t in label])
    idx = DiceMetric(num_classes=3)
    idx(torch.from_numpy(pred.argmax(1)[:, None].astype(np.float32)),
        torch.from_numpy(label.argmax(1)[:, None].astype(np.float32)))
    np.testing.assert_allclose(m.aggregate().numpy(), idx.aggregate().numpy(), **TOL)
    f, nn = do_metric_reduction(torch.tensor([[float("nan"), 0.5], [1.0, float("nan")]]), "mean_channel")
    np.testing.assert_allclose(f.numpy(), [0.5, 1.0])
    np.testing.assert_allclose(nn.numpy(), [1.0, 1.0])
