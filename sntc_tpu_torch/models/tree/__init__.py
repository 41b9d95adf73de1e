from sntc_tpu_torch.models.tree.decision_tree import (
    DecisionTreeClassificationModel,
    DecisionTreeClassifier,
    DecisionTreeRegressionModel,
    DecisionTreeRegressor,
)
from sntc_tpu_torch.models.tree.gbt import (
    GBTClassificationModel,
    GBTClassifier,
    fit_gbt_ovr_vectorized,
)
from sntc_tpu_torch.models.tree.gbt_regressor import (
    GBTRegressionModel,
    GBTRegressor,
)
from sntc_tpu_torch.models.tree.grower import Forest, grow_forest
from sntc_tpu_torch.models.tree.random_forest import (
    RandomForestClassificationModel,
    RandomForestClassifier,
    from_numpy_forest,
)
from sntc_tpu_torch.models.tree.random_forest_regressor import (
    RandomForestRegressionModel,
    RandomForestRegressor,
)

__all__ = [
    "DecisionTreeClassificationModel",
    "DecisionTreeClassifier",
    "DecisionTreeRegressionModel",
    "DecisionTreeRegressor",
    "Forest",
    "GBTClassificationModel",
    "GBTClassifier",
    "GBTRegressionModel",
    "GBTRegressor",
    "RandomForestClassificationModel",
    "RandomForestClassifier",
    "RandomForestRegressionModel",
    "RandomForestRegressor",
    "fit_gbt_ovr_vectorized",
    "from_numpy_forest",
    "grow_forest",
]
