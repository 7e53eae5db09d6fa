from .algo_gen import Algo, AlgoGen, SegAlgo
from .analyzer import DataAnalyzer, strenum_representer
from .auto_runner import AutoRunner
from .bundle_gen import BundleAlgo, BundleGen, algo_templates, register_algo_template
from .ensemble_builder import (AlgoEnsemble, AlgoEnsembleBestByFold, AlgoEnsembleBestN, AlgoEnsembleBuilder,
                               EnsembleBuilder, EnsembleRunner)
from .hpo_gen import GridHPOGen, HPOGen, NNIGen, OptunaGen, RandomHPOGen
from .transforms import EnsureSameShaped
from .utils import (algo_from_pickle, algo_to_pickle, export_bundle_algo_history, get_name_from_algo_id,
                    import_bundle_algo_history)
