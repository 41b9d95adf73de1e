"""The port's hand-written CUDA kernels for Hopper (``sm_90a``).

==================  ===========================  ==============================
kernel              source                       replaces (Pallas, JAX package)
==================  ===========================  ==============================
forest_traversal    csrc/forest_traversal.cu     sntc_tpu/kernels/forest.py
pad_assemble        csrc/pad_rows.cu             sntc_tpu/kernels/assemble.py
tree_hist           csrc/tree_hist.cu            sntc_tpu/ops/pallas_histogram.py
==================  ===========================  ==============================

Each wrapper launches its kernel on a CUDA tensor and computes its plain
PyTorch version on a CPU tensor; there is no switch and no fallback
between the two.  ``LAUNCHES`` counts the kernel launches per name, and
``PAD_LAUNCH_SHAPES`` ``pad_assemble``'s per block shape.  Every call
also counts into the metrics plane's ``sntc_kernel_dispatch_total``
under its kernel name and ``impl="cuda"`` (a launch) or ``impl="plain"``
(the plain version on CPU tensors), the JAX package's ``pallas`` and
``interpret``; the count adds no synchronisation with the card.
"""

from sntc_tpu_torch.kernels._build import (
    LAUNCHES,
    PAD_LAUNCH_SHAPES,
    reset_launches,
)

__all__ = ["LAUNCHES", "PAD_LAUNCH_SHAPES", "reset_launches"]
