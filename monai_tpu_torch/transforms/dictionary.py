"""Dictionary versions of the ported transforms (counterpart of
monai_tpu/transforms/dictionary.py): the ``<Name>d`` of each, ``Invertd`` and
``SaveImaged``. A random one draws once a call, from its own ``R``, and applies the same
draw to every key, in the JAX package's order of draws."""
from __future__ import annotations

from collections.abc import Mapping, Sequence

import numpy as np

from ..data.meta_image import MetaImage
from ..utils.enums import LazyAttr
from ..utils.misc import ensure_tuple_rep
from .compose import Compose
from .croppad_array import CropForeground, RandCropByPosNegLabel, RandSpatialCrop
from .intensity_array import (NormalizeIntensity, RandScaleIntensity, RandShiftIntensity, ScaleIntensity,
                              ScaleIntensityRange)
from .inverse import InvertibleTransform
from .io_array import LoadImage, SaveImage
from .post_array import Activations, AsDiscrete, MeanEnsemble, VoteEnsemble
from .spatial_array import Orientation, RandFlip, RandRotate, RandRotate90, RandZoom, Resize, Spacing
from .traits import LazyTrait
from .transform import MapTransform, Randomizable, RandomizableTransform
from .utility_array import ConvertToMultiChannelBasedOnBratsClasses, EnsureChannelFirst, FgBgToIndices
from .utils import is_positive

__all__ = ["LoadImaged", "EnsureChannelFirstd", "Orientationd", "Spacingd", "ScaleIntensityRanged", "Activationsd",
           "AsDiscreted", "CropForegroundd", "FgBgToIndicesd", "RandCropByPosNegLabeld", "RandFlipd", "RandRotate90d",
           "RandShiftIntensityd", "Invertd", "SaveImaged", "ConvertToMultiChannelBasedOnBratsClassesd",
           "NormalizeIntensityd", "RandScaleIntensityd", "RandSpatialCropd", "ScaleIntensityd", "RandRotated",
           "RandZoomd", "MeanEnsembled", "VoteEnsembled", "Resized"]


def _mapped(name: str, array_cls, call_kwargs: tuple = ()):
    """A ``<Name>d`` class: one ``array_cls`` applied to each key; the ``call_kwargs`` may
    be given per key."""

    per_key_args = set(call_kwargs)

    class _D(MapTransform, InvertibleTransform):
        def __init__(self, keys, allow_missing_keys: bool = False, **kwargs):
            MapTransform.__init__(self, keys, allow_missing_keys)
            self._per_key = {k: ensure_tuple_rep(kwargs.pop(k), len(self.keys)) for k in list(kwargs)
                             if k in per_key_args}
            self.t = array_cls(**kwargs)

        def __call__(self, data: Mapping, lazy: bool | None = None) -> dict:
            d = dict(data)
            for i, key in enumerate(self.key_iterator(d)):
                kw = {k: v[i] for k, v in self._per_key.items()}
                d[key] = self.t(d[key], lazy=lazy, **kw) if isinstance(self.t, LazyTrait) else self.t(d[key], **kw)
            return d

        def inverse(self, data: Mapping) -> dict:
            d = dict(data)
            if isinstance(self.t, InvertibleTransform):
                for key in self.key_iterator(d):
                    d[key] = self.t.inverse(d[key])
            return d

    _D.__name__ = _D.__qualname__ = name
    _D.__doc__ = f"Dictionary wrapper of :class:`{array_cls.__name__}`."
    return _D


Spacingd = _mapped("Spacingd", Spacing, call_kwargs=("mode", "padding_mode", "align_corners"))
Orientationd = _mapped("Orientationd", Orientation)
Resized = _mapped("Resized", Resize, call_kwargs=("mode", "align_corners"))
ScaleIntensityRanged = _mapped("ScaleIntensityRanged", ScaleIntensityRange)
ScaleIntensityd = _mapped("ScaleIntensityd", ScaleIntensity)
EnsureChannelFirstd = _mapped("EnsureChannelFirstd", EnsureChannelFirst)
NormalizeIntensityd = _mapped("NormalizeIntensityd", NormalizeIntensity)
ConvertToMultiChannelBasedOnBratsClassesd = _mapped("ConvertToMultiChannelBasedOnBratsClassesd",
                                                    ConvertToMultiChannelBasedOnBratsClasses)
Activationsd = _mapped("Activationsd", Activations, call_kwargs=("sigmoid", "softmax"))
AsDiscreted = _mapped("AsDiscreted", AsDiscrete, call_kwargs=("argmax", "to_onehot", "threshold"))


def _mapped_rand(name: str, array_cls, draw, call_kwargs: tuple = ()):
    """A random ``<Name>d``: ``draw(t, data)`` draws the parameters of the one
    ``array_cls`` ``t`` once a call, from the first key's data, and ``t`` applies them to
    every key; the ``call_kwargs`` may be given per key. Where ``t`` inverts, so does the
    ``<Name>d``, key by key; else its inverse leaves the data as it is, as the JAX
    package's does."""

    per_key_args = set(call_kwargs)

    class _RD(Randomizable, MapTransform, InvertibleTransform):
        def __init__(self, keys, allow_missing_keys: bool = False, **kwargs):
            MapTransform.__init__(self, keys, allow_missing_keys)
            self._per_key = {k: ensure_tuple_rep(kwargs.pop(k), len(self.keys)) for k in list(kwargs)
                             if k in per_key_args}
            self.t = array_cls(**kwargs)

        def set_random_state(self, seed=None, state=None):
            self.t.set_random_state(seed, state)
            Randomizable.set_random_state(self, seed, state)
            return self

        def randomize(self, data=None) -> None:
            draw(self.t, data)

        def __call__(self, data: Mapping, lazy: bool | None = None) -> dict:
            d = dict(data)
            keys = list(self.key_iterator(d))
            if not keys:
                return d
            first = d[keys[0]]
            self.randomize(first.data if isinstance(first, MetaImage) else first)
            for i, key in enumerate(self.key_iterator(d)):
                kw = {k: v[i] for k, v in self._per_key.items()}
                d[key] = (self.t(d[key], randomize=False, lazy=lazy, **kw) if isinstance(self.t, LazyTrait)
                          else self.t(d[key], randomize=False, **kw))
            return d

        def inverse(self, data: Mapping) -> dict:
            d = dict(data)
            if isinstance(self.t, InvertibleTransform):  # an intensity transform leaves the data as it is
                for key in self.key_iterator(d):
                    d[key] = self.t.inverse(d[key])
            return d

    _RD.__name__ = _RD.__qualname__ = name
    _RD.__doc__ = f"Dictionary wrapper of :class:`{array_cls.__name__}`: one draw a call, for every key."
    return _RD


def _rotate90_draw(t: RandRotate90, data) -> None:
    """The dictionary form draws k first, then the probability (the array form the other
    way round), as torch MONAI's and the JAX package's do."""
    t._rand_k = t.R.randint(t.max_k) + 1
    RandomizableTransform.randomize(t, None)


RandFlipd = _mapped_rand("RandFlipd", RandFlip, lambda t, data: t.randomize(None))
RandRotate90d = _mapped_rand("RandRotate90d", RandRotate90, _rotate90_draw)
RandShiftIntensityd = _mapped_rand("RandShiftIntensityd", RandShiftIntensity, lambda t, data: t.randomize(data))
RandScaleIntensityd = _mapped_rand("RandScaleIntensityd", RandScaleIntensity, lambda t, data: t.randomize(data))
# the JAX package's dictionary form draws from the first key's data shape, not its pending one
RandSpatialCropd = _mapped_rand("RandSpatialCropd", RandSpatialCrop, lambda t, data: t.randomize(data.shape[1:]))
RandRotated = _mapped_rand("RandRotated", RandRotate, lambda t, data: t.randomize(data),
                           call_kwargs=("mode", "padding_mode", "align_corners", "dtype"))
# the zoom factors a spatial axis from the first key's data shape
RandZoomd = _mapped_rand("RandZoomd", RandZoom, lambda t, data: t.randomize(data),
                         call_kwargs=("mode", "padding_mode", "align_corners", "dtype"))


class CropForegroundd(MapTransform, InvertibleTransform):
    """Crop every key to the foreground box of ``source_key``'s image (``CropForeground``,
    its ``k_divisible`` and pad ``mode``, one a key), and keep the box under
    ``start_coord_key`` and ``end_coord_key``."""

    def __init__(self, keys, source_key: str, select_fn=is_positive, channel_indices=None, margin=0,
                 allow_smaller: bool = True, k_divisible=1, mode="constant",
                 start_coord_key: str | None = "foreground_start_coord",
                 end_coord_key: str | None = "foreground_end_coord", allow_missing_keys: bool = False,
                 lazy: bool = False, **pad_kwargs):
        MapTransform.__init__(self, keys, allow_missing_keys)
        self.source_key = source_key
        self.start_coord_key = start_coord_key
        self.end_coord_key = end_coord_key
        self.cropper = CropForeground(select_fn=select_fn, channel_indices=channel_indices, margin=margin,
                                      allow_smaller=allow_smaller, k_divisible=k_divisible, lazy=lazy, **pad_kwargs)
        self.mode = ensure_tuple_rep(mode, len(self.keys))

    def __call__(self, data: Mapping, lazy: bool | None = None) -> dict:
        d = dict(data)
        box_start, box_end = self.cropper.compute_bounding_box(d[self.source_key])
        if self.start_coord_key is not None:
            d[self.start_coord_key] = box_start
        if self.end_coord_key is not None:
            d[self.end_coord_key] = box_end
        for key, mode in self.key_iterator(d, self.mode):
            d[key] = self.cropper.crop_pad(d[key], box_start, box_end, mode=mode, lazy=lazy)
        return d

    def inverse(self, data: Mapping) -> dict:
        d = dict(data)
        for key in self.key_iterator(d):
            d[key] = self.cropper.inverse(d[key])
        return d


class RandCropByPosNegLabeld(Randomizable, MapTransform):
    """``RandCropByPosNegLabel`` of every key around the same centers, drawn from
    ``label_key``'s label (and ``image_key``'s image for the background), or from the
    flat indices under ``fg_indices_key`` and ``bg_indices_key`` (``FgBgToIndicesd``'s),
    which are taken out of the dict: a list of ``num_samples`` dicts."""

    def __init__(self, keys, label_key: str, spatial_size, pos: float = 1.0, neg: float = 1.0,
                 num_samples: int = 1, image_key: str | None = None, image_threshold: float = 0.0,
                 fg_indices_key: str | None = None, bg_indices_key: str | None = None, allow_smaller: bool = False,
                 allow_missing_keys: bool = False, lazy: bool = False):
        MapTransform.__init__(self, keys, allow_missing_keys)
        self.label_key = label_key
        self.image_key = image_key
        self.fg_indices_key, self.bg_indices_key = fg_indices_key, bg_indices_key
        self.cropper = RandCropByPosNegLabel(spatial_size=spatial_size, pos=pos, neg=neg, num_samples=num_samples,
                                             image_threshold=image_threshold, allow_smaller=allow_smaller, lazy=lazy)

    def set_random_state(self, seed=None, state=None):
        super().set_random_state(seed, state)
        self.cropper.set_random_state(state=self.R)
        return self

    def randomize(self, label, image=None, fg_indices=None, bg_indices=None) -> None:
        self.cropper.randomize(label, image, fg_indices, bg_indices)

    def __call__(self, data: Mapping, lazy: bool | None = None) -> list[dict]:
        d = dict(data)
        fg = d.pop(self.fg_indices_key, None) if self.fg_indices_key is not None else None
        bg = d.pop(self.bg_indices_key, None) if self.bg_indices_key is not None else None
        self.randomize(d[self.label_key], d.get(self.image_key) if self.image_key else None, fg, bg)
        ret = [dict(d) for _ in range(self.cropper.num_samples)]
        for key in self.key_iterator(d):
            for i, im in enumerate(self.cropper(d[key], randomize=False, lazy=lazy)):
                ret[i][key] = im
        return ret


class FgBgToIndicesd(MapTransform):
    """``FgBgToIndices`` of each key's label (and ``image_key``'s image), stored under
    ``<key><fg_postfix>`` and ``<key><bg_postfix>``."""

    def __init__(self, keys, fg_postfix: str = "_fg_indices", bg_postfix: str = "_bg_indices",
                 image_key: str | None = None, image_threshold: float = 0.0, output_shape=None,
                 allow_missing_keys: bool = False):
        MapTransform.__init__(self, keys, allow_missing_keys)
        self.fg_postfix, self.bg_postfix = fg_postfix, bg_postfix
        self.image_key = image_key
        self.converter = FgBgToIndices(image_threshold, output_shape)

    def __call__(self, data: Mapping) -> dict:
        d = dict(data)
        image = d[self.image_key] if self.image_key else None
        for key in self.key_iterator(d):
            d[f"{key}{self.fg_postfix}"], d[f"{key}{self.bg_postfix}"] = self.converter(d[key], image)
        return d


class LoadImaged(MapTransform):
    """Load the NIfTI file named under each key into a MetaImage on ``device`` (None: the
    CUDA card)."""

    def __init__(self, keys, dtype=np.float32, allow_missing_keys: bool = False, device=None):
        MapTransform.__init__(self, keys, allow_missing_keys)
        self._loader = LoadImage(dtype, device=device)

    def __call__(self, data):
        d = dict(data)
        for key in self.key_iterator(d):
            d[key] = self._loader(d[key])
        return d


class Invertd(MapTransform):
    """Invert ``transform`` on predictions: graft the operations that ``transform``
    recorded on ``orig_keys``' images, with their affine and meta, onto each prediction
    and run ``transform.inverse`` (at nearest interpolation where ``nearest_interp``).
    The prediction so keeps its image's ``filename_or_obj``, which names its file in
    ``SaveImaged``, as in torch MONAI's Invertd (monai_tpu's keeps the prediction's own
    meta, and its files are named by a running index)."""

    def __init__(self, keys, transform: InvertibleTransform, orig_keys=None,
                 nearest_interp: bool | Sequence[bool] = True, allow_missing_keys: bool = False):
        MapTransform.__init__(self, keys, allow_missing_keys)
        if not isinstance(transform, InvertibleTransform):
            raise ValueError("transform is not invertible, can't invert transform for the data.")
        self.transform = transform
        self.orig_keys = ensure_tuple_rep(orig_keys, len(self.keys)) if orig_keys is not None else self.keys
        self.nearest_interp = ensure_tuple_rep(nearest_interp, len(self.keys))

    def __call__(self, data):
        d = dict(data)
        for key, orig_key, nearest_interp in self.key_iterator(d, self.orig_keys, self.nearest_interp):
            orig = d.get(orig_key)
            pred = MetaImage.ensure_meta(d[key])
            if isinstance(orig, MetaImage):
                pred = MetaImage(pred.data, affine=np.asarray(orig.affine).copy(), meta=dict(orig.meta),
                                 applied_operations=[dict(op) for op in orig.applied_operations])
            if nearest_interp:
                for op in pred.applied_operations:
                    if LazyAttr.INTERP_MODE in op:
                        op[LazyAttr.INTERP_MODE] = 0
            if isinstance(self.transform, MapTransform) or (
                    isinstance(self.transform, Compose)
                    and any(isinstance(t, MapTransform) for t in self.transform.transforms)):
                d[key] = self.transform.inverse({orig_key: pred})[orig_key]  # a dict pipeline
            else:
                d[key] = self.transform.inverse(pred)
        return d


class SaveImaged(MapTransform):
    """``SaveImage`` of each key's image, named from its own meta, or from the dict's
    ``meta_keys`` entry (``<key>_<meta_key_postfix>``) where the image is a bare tensor.
    A ``meta_keys`` entry that is an image of the dict (``"image"``) gives its meta: a
    prediction, a bare tensor, so carries its input's affine, original affine and file
    name, which ``resample`` and the file's name need."""

    def __init__(self, keys, meta_keys=None, meta_key_postfix: str = "meta_dict", output_dir: str = "./",
                 output_postfix: str = "trans", output_ext: str = ".nii.gz", resample: bool = False,
                 mode: str = "nearest", padding_mode: str = "border", output_dtype=np.float32,
                 allow_missing_keys: bool = False, squeeze_end_dims: bool = True, data_root_dir: str = "",
                 separate_folder: bool = True, print_log: bool = True, writer=None, folder_layout=None):
        MapTransform.__init__(self, keys, allow_missing_keys)
        self.saver = SaveImage(output_dir=output_dir, output_postfix=output_postfix, output_ext=output_ext,
                               output_dtype=output_dtype, resample=resample, mode=mode, padding_mode=padding_mode,
                               squeeze_end_dims=squeeze_end_dims, data_root_dir=data_root_dir,
                               separate_folder=separate_folder, print_log=print_log, writer=writer,
                               folder_layout=folder_layout)
        self.meta_keys = ensure_tuple_rep(meta_keys, len(self.keys))
        self.meta_key_postfix = ensure_tuple_rep(meta_key_postfix, len(self.keys))

    def __call__(self, data: Mapping) -> dict:
        d = dict(data)
        for key, meta_key, postfix in self.key_iterator(d, self.meta_keys, self.meta_key_postfix):
            if meta_key is None and postfix is not None:
                meta_key = f"{key}_{postfix}"
            meta = d.get(meta_key) if meta_key is not None else None
            self.saver(d[key], meta_data=meta.meta if isinstance(meta, MetaImage) else meta)
        return d


class MeanEnsembled(MapTransform):
    """``MeanEnsemble`` over the items of ``keys``, written to ``output_key`` (the first
    key by default)."""

    def __init__(self, keys, output_key: str | None = None, weights=None):
        MapTransform.__init__(self, keys)
        self.output_key = output_key if output_key is not None else self.keys[0]
        self.ensemble = MeanEnsemble(weights=weights)

    def __call__(self, data: Mapping) -> dict:
        d = dict(data)
        d[self.output_key] = self.ensemble([d[key] for key in self.key_iterator(d)])
        return d


class VoteEnsembled(MapTransform):
    """``VoteEnsemble`` over the items of ``keys``, written to ``output_key`` (the first
    key by default)."""

    def __init__(self, keys, output_key: str | None = None, num_classes: int | None = None):
        MapTransform.__init__(self, keys)
        self.output_key = output_key if output_key is not None else self.keys[0]
        self.ensemble = VoteEnsemble(num_classes=num_classes)

    def __call__(self, data: Mapping) -> dict:
        d = dict(data)
        d[self.output_key] = self.ensemble([d[key] for key in self.key_iterator(d)])
        return d
