from sntc_tpu_torch.feature.chisq_selector import ChiSqSelectorModel
from sntc_tpu_torch.feature.string_indexer import (
    IndexToString,
    StringIndexerModel,
)
from sntc_tpu_torch.feature.vector_assembler import VectorAssembler

__all__ = [
    "ChiSqSelectorModel",
    "IndexToString",
    "StringIndexerModel",
    "VectorAssembler",
]
