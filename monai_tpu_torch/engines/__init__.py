from .evaluator import Evaluator, SupervisedEvaluator
from .events import EventEmitter, Events, IterationEvents
from .trainer import SupervisedTrainer, Trainer
from .utils import default_prepare_batch
from .workflow import State, Workflow
