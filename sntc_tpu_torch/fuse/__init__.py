"""Whole-pipeline fusion — one device dispatch per fusible run.

Counterpart of ``sntc_tpu/fuse``:

* :func:`compile_pipeline` — compile a fitted ``PipelineModel`` for
  serving (rewrite rules, maximal-segment fusion, head packing);
  :func:`compile_serving` is its alias, the serve command's entry;
* :class:`FusedSegment` / :func:`fused_segments` / :func:`fusion_stats`
  — the compiled artifact and its evidence counters;
* :func:`attach_device_domain` — hand a device fault domain to every
  segment;
* :func:`fold_scalers` — the scaler → LR/MLP weight fold.

The capability registry (``fuse.registry``) is private to this package:
the port registers the stages it has there.
"""

from sntc_tpu_torch.fuse.planner import (
    FusedSegment,
    attach_device_domain,
    compile_pipeline,
    fused_segments,
    fusion_stats,
)
from sntc_tpu_torch.fuse.rules import fold_scalers

compile_serving = compile_pipeline

__all__ = [
    "FusedSegment",
    "attach_device_domain",
    "compile_pipeline",
    "compile_serving",
    "fold_scalers",
    "fused_segments",
    "fusion_stats",
]
