from sntc_tpu_torch.feature.chisq_selector import (
    ChiSqSelector,
    ChiSqSelectorModel,
)
from sntc_tpu_torch.feature.dct import DCT
from sntc_tpu_torch.feature.discretizers import (
    Bucketizer,
    Imputer,
    ImputerModel,
    QuantileDiscretizer,
)
from sntc_tpu_torch.feature.encoders import (
    ElementwiseProduct,
    OneHotEncoder,
    OneHotEncoderModel,
    VectorSlicer,
)
from sntc_tpu_torch.feature.expansion import Interaction, PolynomialExpansion
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
from sntc_tpu_torch.feature.vector_indexer import (
    VectorIndexer,
    VectorIndexerModel,
    VectorSizeHint,
)

__all__ = [
    "Binarizer",
    "Bucketizer",
    "ChiSqSelector",
    "ChiSqSelectorModel",
    "DCT",
    "ElementwiseProduct",
    "Imputer",
    "ImputerModel",
    "IndexToString",
    "Interaction",
    "MaxAbsScaler",
    "MaxAbsScalerModel",
    "MinMaxScaler",
    "MinMaxScalerModel",
    "Normalizer",
    "OneHotEncoder",
    "OneHotEncoderModel",
    "PCA",
    "PCAModel",
    "PolynomialExpansion",
    "QuantileDiscretizer",
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
    "VectorIndexer",
    "VectorIndexerModel",
    "VectorSizeHint",
    "VectorSlicer",
]
