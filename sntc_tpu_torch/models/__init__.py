from sntc_tpu_torch.models.base import (
    ClassificationModel,
    ClassifierEstimator,
)
from sntc_tpu_torch.models.tree.random_forest import (
    RandomForestClassificationModel,
    RandomForestClassifier,
    from_numpy_forest,
)

__all__ = [
    "ClassificationModel",
    "ClassifierEstimator",
    "RandomForestClassificationModel",
    "RandomForestClassifier",
    "from_numpy_forest",
]
