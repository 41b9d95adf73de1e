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
from sntc_tpu_torch.feature.hashing import FeatureHasher
from sntc_tpu_torch.feature.lsh import (
    BucketedRandomProjectionLSH,
    BucketedRandomProjectionLSHModel,
    MinHashLSH,
    MinHashLSHModel,
)
from sntc_tpu_torch.feature.pca import PCA, PCAModel
from sntc_tpu_torch.feature.rformula import RFormula, RFormulaModel
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
from sntc_tpu_torch.feature.sql_transformer import SQLTransformer
from sntc_tpu_torch.feature.standard_scaler import (
    StandardScaler,
    StandardScalerModel,
)
from sntc_tpu_torch.feature.string_indexer import (
    IndexToString,
    StringIndexer,
    StringIndexerModel,
)
from sntc_tpu_torch.feature.text import (
    IDF,
    CountVectorizer,
    CountVectorizerModel,
    HashingTF,
    IDFModel,
    NGram,
    RegexTokenizer,
    StopWordsRemover,
    Tokenizer,
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
from sntc_tpu_torch.feature.word2vec import Word2Vec, Word2VecModel

__all__ = [
    "Binarizer",
    "BucketedRandomProjectionLSH",
    "BucketedRandomProjectionLSHModel",
    "Bucketizer",
    "ChiSqSelector",
    "ChiSqSelectorModel",
    "CountVectorizer",
    "CountVectorizerModel",
    "DCT",
    "ElementwiseProduct",
    "FeatureHasher",
    "HashingTF",
    "IDF",
    "IDFModel",
    "Imputer",
    "ImputerModel",
    "IndexToString",
    "Interaction",
    "MaxAbsScaler",
    "MaxAbsScalerModel",
    "MinHashLSH",
    "MinHashLSHModel",
    "MinMaxScaler",
    "MinMaxScalerModel",
    "NGram",
    "Normalizer",
    "OneHotEncoder",
    "OneHotEncoderModel",
    "PCA",
    "PCAModel",
    "PolynomialExpansion",
    "QuantileDiscretizer",
    "RFormula",
    "RFormulaModel",
    "RegexTokenizer",
    "RobustScaler",
    "RobustScalerModel",
    "SQLTransformer",
    "StandardScaler",
    "StandardScalerModel",
    "StopWordsRemover",
    "StringIndexer",
    "StringIndexerModel",
    "Tokenizer",
    "UnivariateFeatureSelector",
    "UnivariateFeatureSelectorModel",
    "VarianceThresholdSelector",
    "VarianceThresholdSelectorModel",
    "VectorAssembler",
    "VectorIndexer",
    "VectorIndexerModel",
    "VectorSizeHint",
    "VectorSlicer",
    "Word2Vec",
    "Word2VecModel",
]
