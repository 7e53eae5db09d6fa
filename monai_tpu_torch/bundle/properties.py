"""The properties a bundle workflow must or may have, each with its config id
(counterpart of monai_tpu/bundle/properties.py)."""
from __future__ import annotations

__all__ = ["InferProperties", "MetaProperties", "TrainProperties"]


def _props(*rows: tuple[str, str, bool, str]) -> dict:
    return {name: {"description": desc, "required": required, "id": id_} for name, desc, required, id_ in rows}


TrainProperties = _props(
    ("bundle_root", "root path of the bundle.", True, "bundle_root"),
    ("device", "target device to execute the bundle workflow.", False, "device"),
    ("dataset_dir", "directory path of the dataset.", True, "dataset_dir"),
    ("trainer", "training workflow engine.", True, "train::trainer"),
    ("max_epochs", "max number of epochs to execute the training.", True, "train::trainer::max_epochs"),
    ("train_dataset", "dataset for the training.", True, "train::dataset"),
    ("train_dataset_data", "data source for the training dataset.", False, "train::dataset::data"),
    ("train_inferer", "inferer to execute forward on the network.", False, "train::inferer"),
    ("train_handlers", "event handlers for the training.", False, "train::handlers"),
    ("train_preprocessing", "preprocessing for the training inputs.", False, "train::preprocessing"),
    ("train_postprocessing", "postprocessing for the training outputs.", False, "train::postprocessing"),
    ("train_key_metric", "key metric for the training.", False, "train::key_metric"),
    ("evaluator", "validation workflow engine.", False, "validate::evaluator"),
    ("val_interval", "validation interval in epochs.", False, "val_interval"),
    ("val_handlers", "event handlers for the validation.", False, "validate::handlers"),
    ("val_dataset", "dataset for the validation.", False, "validate::dataset"),
    ("val_dataset_data", "data source for the validation dataset.", False, "validate::dataset::data"),
    ("val_inferer", "inferer for the validation.", False, "validate::inferer"),
    ("val_preprocessing", "preprocessing for the validation inputs.", False, "validate::preprocessing"),
    ("val_postprocessing", "postprocessing for the validation outputs.", False, "validate::postprocessing"),
    ("val_key_metric", "key metric for the validation.", False, "validate::key_metric"),
)

InferProperties = _props(
    ("bundle_root", "root path of the bundle.", True, "bundle_root"),
    ("device", "target device to execute the bundle workflow.", False, "device"),
    ("network_def", "network module for the inference.", True, "network_def"),
    ("inferer", "inferer to execute forward on the network.", True, "inferer"),
    ("preprocessing", "preprocessing for the input data.", False, "preprocessing"),
    ("postprocessing", "postprocessing for the model output.", False, "postprocessing"),
    ("key_metric", "key metric for the inference.", False, "key_metric"),
    ("dataset_dir", "directory path of the dataset.", False, "dataset_dir"),
    ("dataset_data", "data source for the inference dataset.", False, "dataset::data"),
    ("evaluator", "inference workflow engine.", False, "evaluator"),
)

MetaProperties = _props(
    ("version", "bundle version", False, "_meta_::version"),
    ("monai_version", "required monai version for the bundle", False, "_meta_::monai_version"),
    ("pytorch_version", "required pytorch version for the bundle", False, "_meta_::pytorch_version"),
    ("numpy_version", "required numpy version", False, "_meta_::numpy_version"),
    ("description", "description of the bundle", False, "_meta_::description"),
    ("spatial_shape", "spatial shape of the inputs", False, "_meta_::network_data_format::inputs::image::spatial_shape"),
    ("channel_def", "channel definition of the outputs", False,
     "_meta_::network_data_format::outputs::pred::channel_def"),
)
