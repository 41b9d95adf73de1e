from sntc_tpu_torch.feature.chisq_selector import (
    ChiSqSelector,
    ChiSqSelectorModel,
)
from sntc_tpu_torch.feature.string_indexer import (
    IndexToString,
    StringIndexer,
    StringIndexerModel,
)
from sntc_tpu_torch.feature.vector_assembler import VectorAssembler

__all__ = [
    "ChiSqSelector",
    "ChiSqSelectorModel",
    "IndexToString",
    "StringIndexer",
    "StringIndexerModel",
    "VectorAssembler",
]
