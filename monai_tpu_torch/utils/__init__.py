from .backend import get_torch_dtype, resolve_device, to_numpy, to_torch
from .enums import BlendMode, GridSampleMode, GridSamplePadMode, LazyAttr, MetaKeys, SpaceKeys, StrEnum, TraceKeys
from .misc import ensure_tuple, ensure_tuple_rep, ensure_tuple_size, fall_back_tuple, first, issequenceiterable
