from sntc_tpu_torch.models.aft import (
    AFTSurvivalRegression,
    AFTSurvivalRegressionModel,
)
from sntc_tpu_torch.models.als import ALS, ALSModel
from sntc_tpu_torch.models.base import (
    ClassificationModel,
    ClassifierEstimator,
)
from sntc_tpu_torch.models.bisecting_kmeans import (
    BisectingKMeans,
    BisectingKMeansModel,
)
from sntc_tpu_torch.models.fpm import FPGrowth, FPGrowthModel
from sntc_tpu_torch.models.fm import (
    FMClassificationModel,
    FMClassifier,
    FMRegressionModel,
    FMRegressor,
)
from sntc_tpu_torch.models.gaussian_mixture import (
    GaussianMixture,
    GaussianMixtureModel,
)
from sntc_tpu_torch.models.glm import (
    GeneralizedLinearRegression,
    GeneralizedLinearRegressionModel,
)
from sntc_tpu_torch.models.isotonic import (
    IsotonicRegression,
    IsotonicRegressionModel,
)
from sntc_tpu_torch.models.kmeans import KMeans, KMeansModel
from sntc_tpu_torch.models.lda import LDA, LDAModel
from sntc_tpu_torch.models.linear_regression import (
    LinearRegression,
    LinearRegressionModel,
)
from sntc_tpu_torch.models.linear_svc import LinearSVC, LinearSVCModel
from sntc_tpu_torch.models.logistic_regression import (
    LogisticRegression,
    LogisticRegressionModel,
)
from sntc_tpu_torch.models.mlp import (
    MultilayerPerceptronClassificationModel,
    MultilayerPerceptronClassifier,
)
from sntc_tpu_torch.models.naive_bayes import NaiveBayes, NaiveBayesModel
from sntc_tpu_torch.models.one_vs_rest import OneVsRest, OneVsRestModel
from sntc_tpu_torch.models.pic import PowerIterationClustering
from sntc_tpu_torch.models.tree.decision_tree import (
    DecisionTreeClassificationModel,
    DecisionTreeClassifier,
    DecisionTreeRegressionModel,
    DecisionTreeRegressor,
)
from sntc_tpu_torch.models.tree.gbt import (
    GBTClassificationModel,
    GBTClassifier,
)
from sntc_tpu_torch.models.tree.gbt_regressor import (
    GBTRegressionModel,
    GBTRegressor,
)
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
    "AFTSurvivalRegression",
    "AFTSurvivalRegressionModel",
    "ALS",
    "ALSModel",
    "BisectingKMeans",
    "BisectingKMeansModel",
    "ClassificationModel",
    "ClassifierEstimator",
    "DecisionTreeClassificationModel",
    "DecisionTreeClassifier",
    "DecisionTreeRegressionModel",
    "DecisionTreeRegressor",
    "FMClassificationModel",
    "FMClassifier",
    "FMRegressionModel",
    "FMRegressor",
    "FPGrowth",
    "FPGrowthModel",
    "GBTClassificationModel",
    "GBTClassifier",
    "GBTRegressionModel",
    "GBTRegressor",
    "GaussianMixture",
    "GaussianMixtureModel",
    "GeneralizedLinearRegression",
    "GeneralizedLinearRegressionModel",
    "IsotonicRegression",
    "IsotonicRegressionModel",
    "KMeans",
    "KMeansModel",
    "LDA",
    "LDAModel",
    "LinearRegression",
    "LinearRegressionModel",
    "LinearSVC",
    "LinearSVCModel",
    "LogisticRegression",
    "LogisticRegressionModel",
    "MultilayerPerceptronClassificationModel",
    "MultilayerPerceptronClassifier",
    "NaiveBayes",
    "NaiveBayesModel",
    "OneVsRest",
    "OneVsRestModel",
    "PowerIterationClustering",
    "RandomForestClassificationModel",
    "RandomForestClassifier",
    "RandomForestRegressionModel",
    "RandomForestRegressor",
    "from_numpy_forest",
]
