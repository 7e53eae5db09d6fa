from .meandice import DiceMetric, compute_dice
from .metric import Cumulative, CumulativeIterationMetric, IterationMetric, Metric
from .utils import do_metric_reduction, ignore_background
from .regression import ROCAUCMetric, compute_roc_auc
