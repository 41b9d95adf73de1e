from sntc_tpu_torch.evaluation.binary import BinaryClassificationEvaluator
from sntc_tpu_torch.evaluation.clustering import ClusteringEvaluator
from sntc_tpu_torch.evaluation.multiclass import (
    MulticlassClassificationEvaluator,
    MulticlassMetrics,
)
from sntc_tpu_torch.evaluation.ranking import (
    MultilabelClassificationEvaluator,
    RankingEvaluator,
)
from sntc_tpu_torch.evaluation.regression import RegressionEvaluator

__all__ = [
    "BinaryClassificationEvaluator",
    "ClusteringEvaluator",
    "MulticlassClassificationEvaluator",
    "MulticlassMetrics",
    "MultilabelClassificationEvaluator",
    "RankingEvaluator",
    "RegressionEvaluator",
]
