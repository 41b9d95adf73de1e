"""Serving-time pipeline compilation: the stable import path of the
fusion compiler (``sntc_tpu_torch.fuse``), as ``sntc_tpu/serve/fuse.py``
is of the JAX package's."""

from sntc_tpu_torch.fuse import compile_pipeline, compile_serving
from sntc_tpu_torch.fuse.rules import fold_scalers

__all__ = [
    "compile_pipeline",
    "compile_serving",
    "fold_scalers",
]
