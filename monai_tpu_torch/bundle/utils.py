"""The bundle config DSL's keys and the default metadata (counterpart of
monai_tpu/bundle/utils.py). The keys are the config-file syntax and match monai_tpu's
and torch MONAI's; the metadata names the port's, torch's and numpy's versions."""
from __future__ import annotations

import numpy
import torch

__all__ = ["DEFAULT_METADATA", "EXPR_KEY", "ID_REF_KEY", "ID_SEP_KEY", "MACRO_KEY", "MERGE_KEY"]

ID_REF_KEY = "@"    # start of a reference to a ConfigItem
ID_SEP_KEY = "::"   # separator for the ID of a ConfigItem
EXPR_KEY = "$"      # start of a ConfigExpression
MACRO_KEY = "%"     # start of a macro of a config
MERGE_KEY = "+"     # prefix indicating merge instead of override for multi-config reads

DEFAULT_METADATA = {
    "version": "0.0.1",
    "changelog": {"0.0.1": "Initial version"},
    "monai_tpu_torch_version": "0.1.0",
    "pytorch_version": torch.__version__.split("+")[0],
    "numpy_version": numpy.__version__,
    "required_packages_version": {},
    "task": "Describe what the network predicts",
    "description": "A longer description of what the network does, use context, inputs, outputs, etc.",
    "authors": "Your Name Here",
    "copyright": "Copyright (c) Your Name Here",
    "network_data_format": {"inputs": {}, "outputs": {}},
}
