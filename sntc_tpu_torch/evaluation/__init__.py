from sntc_tpu_torch.evaluation.binary import BinaryClassificationEvaluator
from sntc_tpu_torch.evaluation.multiclass import (
    MulticlassClassificationEvaluator,
    MulticlassMetrics,
)

__all__ = [
    "BinaryClassificationEvaluator",
    "MulticlassClassificationEvaluator",
    "MulticlassMetrics",
]
