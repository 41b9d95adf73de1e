from sntc_tpu_torch.models.tree.grower import Forest, grow_forest
from sntc_tpu_torch.models.tree.random_forest import (
    RandomForestClassificationModel,
    RandomForestClassifier,
    from_numpy_forest,
)

__all__ = [
    "Forest",
    "RandomForestClassificationModel",
    "RandomForestClassifier",
    "from_numpy_forest",
    "grow_forest",
]
