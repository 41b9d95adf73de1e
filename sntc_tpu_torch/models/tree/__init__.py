from sntc_tpu_torch.models.tree.grower import Forest
from sntc_tpu_torch.models.tree.random_forest import (
    RandomForestClassificationModel,
    from_numpy_forest,
)

__all__ = ["Forest", "RandomForestClassificationModel", "from_numpy_forest"]
