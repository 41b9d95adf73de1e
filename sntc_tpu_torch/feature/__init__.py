from sntc_tpu_torch.feature.chisq_selector import (
    ChiSqSelector,
    ChiSqSelectorModel,
)
from sntc_tpu_torch.feature.dct import DCT
from sntc_tpu_torch.feature.pca import PCA, PCAModel
from sntc_tpu_torch.feature.scalers import (
    Binarizer,
    MaxAbsScaler,
    MaxAbsScalerModel,
    MinMaxScaler,
    MinMaxScalerModel,
    Normalizer,
    RobustScaler,
    RobustScalerModel,
)
from sntc_tpu_torch.feature.standard_scaler import (
    StandardScaler,
    StandardScalerModel,
)
from sntc_tpu_torch.feature.string_indexer import (
    IndexToString,
    StringIndexer,
    StringIndexerModel,
)
from sntc_tpu_torch.feature.univariate_selector import (
    UnivariateFeatureSelector,
    UnivariateFeatureSelectorModel,
)
from sntc_tpu_torch.feature.variance_selector import (
    VarianceThresholdSelector,
    VarianceThresholdSelectorModel,
)
from sntc_tpu_torch.feature.vector_assembler import VectorAssembler

__all__ = [
    "Binarizer",
    "ChiSqSelector",
    "ChiSqSelectorModel",
    "DCT",
    "IndexToString",
    "MaxAbsScaler",
    "MaxAbsScalerModel",
    "MinMaxScaler",
    "MinMaxScalerModel",
    "Normalizer",
    "PCA",
    "PCAModel",
    "RobustScaler",
    "RobustScalerModel",
    "StandardScaler",
    "StandardScalerModel",
    "StringIndexer",
    "StringIndexerModel",
    "UnivariateFeatureSelector",
    "UnivariateFeatureSelectorModel",
    "VarianceThresholdSelector",
    "VarianceThresholdSelectorModel",
    "VectorAssembler",
]
