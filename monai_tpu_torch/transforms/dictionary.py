"""Dictionary versions of the ported transforms (counterpart of
monai_tpu/transforms/dictionary.py): the ``<Name>d`` of each, ``Invertd`` and
``SaveImaged``."""
from __future__ import annotations

from collections.abc import Mapping, Sequence

import numpy as np

from ..data.meta_image import MetaImage
from ..utils.enums import LazyAttr
from ..utils.misc import ensure_tuple_rep
from .compose import Compose
from .intensity_array import ScaleIntensityRange
from .inverse import InvertibleTransform
from .io_array import LoadImage, SaveImage
from .post_array import Activations, AsDiscrete
from .spatial_array import Orientation, Spacing
from .traits import LazyTrait
from .transform import MapTransform
from .utility_array import EnsureChannelFirst

__all__ = ["LoadImaged", "EnsureChannelFirstd", "Orientationd", "Spacingd", "ScaleIntensityRanged", "Activationsd",
           "AsDiscreted", "Invertd", "SaveImaged"]


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
ScaleIntensityRanged = _mapped("ScaleIntensityRanged", ScaleIntensityRange)
EnsureChannelFirstd = _mapped("EnsureChannelFirstd", EnsureChannelFirst)
Activationsd = _mapped("Activationsd", Activations, call_kwargs=("softmax",))
AsDiscreted = _mapped("AsDiscreted", AsDiscrete, call_kwargs=("argmax",))


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
    ``meta_keys`` entry (``<key>_<meta_key_postfix>``) where the image is a bare
    tensor."""

    def __init__(self, keys, meta_keys=None, meta_key_postfix: str = "meta_dict", output_dir: str = "./",
                 output_postfix: str = "trans", output_ext: str = ".nii.gz", resample: bool = False,
                 output_dtype=np.float32, allow_missing_keys: bool = False, squeeze_end_dims: bool = True,
                 data_root_dir: str = "", separate_folder: bool = True, print_log: bool = True, writer=None,
                 folder_layout=None):
        MapTransform.__init__(self, keys, allow_missing_keys)
        self.saver = SaveImage(output_dir=output_dir, output_postfix=output_postfix, output_ext=output_ext,
                               output_dtype=output_dtype, resample=resample, squeeze_end_dims=squeeze_end_dims,
                               data_root_dir=data_root_dir, separate_folder=separate_folder, print_log=print_log,
                               writer=writer, folder_layout=folder_layout)
        self.meta_keys = ensure_tuple_rep(meta_keys, len(self.keys))
        self.meta_key_postfix = ensure_tuple_rep(meta_key_postfix, len(self.keys))

    def __call__(self, data: Mapping) -> dict:
        d = dict(data)
        for key, meta_key, postfix in self.key_iterator(d, self.meta_keys, self.meta_key_postfix):
            if meta_key is None and postfix is not None:
                meta_key = f"{key}_{postfix}"
            self.saver(d[key], meta_data=d.get(meta_key) if meta_key is not None else None)
        return d
