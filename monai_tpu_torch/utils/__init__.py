from .backend import full_float32, get_torch_dtype, resolve_device, to_numpy, to_torch
from .enums import (AlgoKeys, BlendMode, CommonKeys, CompInitMode, DataStatsKeys, GridSampleMode, GridSamplePadMode,
                    ImageStatsKeys, LabelStatsKeys, LazyAttr, LossReduction, MetaKeys, MetricReduction, SpaceKeys, StrEnum,
                    TraceKeys)
from .misc import (ensure_tuple, ensure_tuple_rep, ensure_tuple_size, fall_back_tuple, first, get_seed,
                   issequenceiterable, set_determinism)
from .module import OptionalImportError, instantiate, locate, optional_import
