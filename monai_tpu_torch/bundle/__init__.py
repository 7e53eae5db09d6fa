"""The bundle runner (counterpart of monai_tpu/bundle/): config files, their DSL, and
the workflows that run them."""
from .config_item import ComponentLocator, ConfigComponent, ConfigExpression, ConfigItem, Instantiable
from .config_parser import ConfigParser
from .properties import InferProperties, MetaProperties, TrainProperties
from .reference_resolver import ReferenceResolver
from .scripts import run, update_kwargs
from .utils import DEFAULT_METADATA, EXPR_KEY, ID_REF_KEY, ID_SEP_KEY, MACRO_KEY, MERGE_KEY
from .workflows import BundleWorkflow, ConfigWorkflow
