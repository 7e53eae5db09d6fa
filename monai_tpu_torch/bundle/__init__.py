"""The bundle runner (counterpart of monai_tpu/bundle/): config files, their DSL, and
the workflows that run them."""
from .config_item import ComponentLocator, ConfigComponent, ConfigExpression, ConfigItem, Instantiable
from .config_parser import ConfigParser
from .properties import InferProperties, MetaProperties, TrainProperties
from .reference_resolver import ReferenceResolver
from .scripts import (ckpt_export, create_workflow, download, init_bundle, load, load_exported_network, run,
                      run_workflow, update_kwargs, verify_metadata, verify_net_in_out)
from .utils import DEFAULT_METADATA, EXPR_KEY, ID_REF_KEY, ID_SEP_KEY, MACRO_KEY, MERGE_KEY
from .workflows import BundleWorkflow, ConfigWorkflow, PythonicWorkflow
