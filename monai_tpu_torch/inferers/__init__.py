from .inferer import Inferer, SimpleInferer, SlidingWindowInferer
from .utils import compute_scan_interval, sliding_window_inference
