from sntc_tpu_torch.models.base import ClassificationModel
from sntc_tpu_torch.models.tree.random_forest import (
    RandomForestClassificationModel,
    from_numpy_forest,
)

__all__ = [
    "ClassificationModel",
    "RandomForestClassificationModel",
    "from_numpy_forest",
]
