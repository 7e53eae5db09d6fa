"""Datalists (counterpart of monai_tpu/apps/datasets.py: ``load_decathlon_datalist``,
``make_synthetic_datalist`` and ``make_synthetic_classification_datalist``): a Decathlon
``dataset.json`` read into a list of items, or a synthetic Decathlon-style or MedNIST-style
NIfTI dataset written to disk, the fallback of the bundles' configs where no real data is
staged."""
from __future__ import annotations

import json
import os
from pathlib import Path

import numpy as np

from ..data.nifti import write_nifti
from ..data.synthetic import create_test_image_2d, create_test_image_3d

__all__ = ["load_decathlon_datalist", "make_synthetic_classification_datalist", "make_synthetic_datalist"]


def load_decathlon_datalist(data_list_file_path: str, is_segmentation: bool = True,
                            data_list_key: str = "training", base_dir: str | None = None) -> list[dict]:
    """The items of section ``data_list_key`` of a Decathlon ``dataset.json``, each
    relative path joined to ``base_dir`` (the file's directory by default); a ``test``
    section of bare paths becomes ``{"image": path}`` items."""
    path = Path(data_list_file_path)
    if not path.is_file():
        raise ValueError(f"Data list file {data_list_file_path} does not exist.")
    with open(path) as json_file:
        json_data = json.load(json_file)
    if data_list_key not in json_data:
        raise ValueError(f'Data list {data_list_key} not specified in "{data_list_file_path}".')
    items = json_data[data_list_key]
    if data_list_key == "test" and not isinstance(items[0], dict):
        items = [{"image": i} for i in items]
    base = str(path.parent) if base_dir is None else base_dir
    for item in items:
        for k, v in item.items():
            if isinstance(v, str) and not os.path.isabs(v):
                item[k] = os.path.normpath(os.path.join(base, v))
    return items


def make_synthetic_datalist(dataset_dir: str, num_images: int = 8, spatial_size=(64, 64, 64),
                            num_seg_classes: int = 1, section_splits=(0.75, 0.25), seed: int = 0,
                            overwrite: bool = False) -> dict:
    """Write ``num_images`` 3-D phantoms (``imagesTr/img000.nii.gz``, float32) and their labels
    (``labelsTr/seg000.nii.gz``, uint8) under ``dataset_dir``, drawn from one
    ``RandomState(seed)`` as the JAX package draws them (files already there are kept
    unless ``overwrite``), and return ``{"training": [...], "validation": [...]}`` items
    of ``{"image": path, "label": path}``, split by ``section_splits``."""
    root = Path(dataset_dir)
    (root / "imagesTr").mkdir(parents=True, exist_ok=True)
    (root / "labelsTr").mkdir(parents=True, exist_ok=True)
    rs = np.random.RandomState(seed)
    items = []
    for i in range(num_images):
        img_p = str(root / "imagesTr" / f"img{i:03d}.nii.gz")
        seg_p = str(root / "labelsTr" / f"seg{i:03d}.nii.gz")
        if overwrite or not (os.path.exists(img_p) and os.path.exists(seg_p)):
            im, seg = create_test_image_3d(*spatial_size, num_objs=4, rad_max=max(3, min(spatial_size) // 3),
                                           num_seg_classes=num_seg_classes, random_state=rs)
            write_nifti(im.astype(np.float32), img_p)
            write_nifti(seg.astype(np.uint8), seg_p)
        items.append({"image": img_p, "label": seg_p})
    n_train = max(1, int(round(section_splits[0] * num_images)))
    return {"training": items[:n_train], "validation": items[n_train:] or items[-1:]}


def make_synthetic_classification_datalist(dataset_dir: str, num_images: int = 32, spatial_size=(64, 64),
                                           num_classes: int = 3, seed: int = 0, overwrite: bool = False) -> dict:
    """Write ``num_images`` 2-D float32 phantoms (``img000_c0.nii.gz``) under ``dataset_dir``,
    image ``i`` of class ``i % num_classes`` drawn with ``i % num_classes + 1`` circles, from
    one ``RandomState(seed)`` as the JAX package draws them (files already there are kept
    unless ``overwrite``), and return ``{"training": [...], "validation": [...]}`` items of
    ``{"image": path, "label": class}``, the first 75% for training."""
    root = Path(dataset_dir)
    root.mkdir(parents=True, exist_ok=True)
    rs = np.random.RandomState(seed)
    items = []
    for i in range(num_images):
        cls = int(i % num_classes)
        img_p = str(root / f"img{i:03d}_c{cls}.nii.gz")
        if overwrite or not os.path.exists(img_p):
            im, _ = create_test_image_2d(*spatial_size, num_objs=cls + 1, rad_max=10, rad_min=4, random_state=rs)
            write_nifti(im.astype(np.float32), img_p)
        items.append({"image": img_p, "label": cls})
    n_train = max(1, int(round(0.75 * num_images)))
    return {"training": items[:n_train], "validation": items[n_train:] or items[-1:]}
