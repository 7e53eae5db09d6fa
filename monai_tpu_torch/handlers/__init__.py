from .checkpoint import CheckpointLoader
from .ignite_metric import from_engine
