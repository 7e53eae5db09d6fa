"""Auto3DSeg's engine side (counterpart of monai_tpu/auto3dseg/): the statistical
operations, the case and summary analyzers, ``SegSummarizer``, and the ``Algo`` and
``AlgoGen`` interfaces."""
from .algo_gen import Algo, AlgoGen
from .analyzer import (Analyzer, FgImageStats, FgImageStatsSumm, FilenameStats, ImageHistogram, ImageHistogramSumm,
                       ImageStats, ImageStatsSumm, LabelStats, LabelStatsSumm)
from .operations import Operations, SampleOperations, SummaryOperations
from .seg_summarizer import SegSummarizer
