from sntc_tpu_torch.evaluation.multiclass import (
    MulticlassClassificationEvaluator,
    MulticlassMetrics,
)

__all__ = ["MulticlassClassificationEvaluator", "MulticlassMetrics"]
