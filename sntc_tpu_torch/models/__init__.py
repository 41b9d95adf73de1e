from sntc_tpu_torch.models.base import (
    ClassificationModel,
    ClassifierEstimator,
)
from sntc_tpu_torch.models.one_vs_rest import OneVsRest, OneVsRestModel
from sntc_tpu_torch.models.tree.decision_tree import (
    DecisionTreeClassificationModel,
    DecisionTreeClassifier,
)
from sntc_tpu_torch.models.tree.gbt import (
    GBTClassificationModel,
    GBTClassifier,
)
from sntc_tpu_torch.models.tree.random_forest import (
    RandomForestClassificationModel,
    RandomForestClassifier,
    from_numpy_forest,
)

__all__ = [
    "ClassificationModel",
    "ClassifierEstimator",
    "DecisionTreeClassificationModel",
    "DecisionTreeClassifier",
    "GBTClassificationModel",
    "GBTClassifier",
    "OneVsRest",
    "OneVsRestModel",
    "RandomForestClassificationModel",
    "RandomForestClassifier",
    "from_numpy_forest",
]
