from .checkpoint import CheckpointLoader, CheckpointSaver
from .handlers import StatsHandler, ValidationHandler
from .ignite_metric import IgniteMetricHandler, MeanDice, from_engine
