from sntc_tpu_torch.models.tree.decision_tree import (
    DecisionTreeClassificationModel,
    DecisionTreeClassifier,
)
from sntc_tpu_torch.models.tree.gbt import (
    GBTClassificationModel,
    GBTClassifier,
    fit_gbt_ovr_vectorized,
)
from sntc_tpu_torch.models.tree.grower import Forest, grow_forest
from sntc_tpu_torch.models.tree.random_forest import (
    RandomForestClassificationModel,
    RandomForestClassifier,
    from_numpy_forest,
)

__all__ = [
    "DecisionTreeClassificationModel",
    "DecisionTreeClassifier",
    "Forest",
    "GBTClassificationModel",
    "GBTClassifier",
    "RandomForestClassificationModel",
    "RandomForestClassifier",
    "fit_gbt_ovr_vectorized",
    "from_numpy_forest",
    "grow_forest",
]
