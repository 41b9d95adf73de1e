"""Fit-side tensor operations: quantile binning, binned histograms and
the LBFGS/OWLQN minimizer."""

from sntc_tpu_torch.ops.binning import bin_features, quantile_bin_edges
from sntc_tpu_torch.ops.histogram import binned_contingency, chi_square
from sntc_tpu_torch.ops.lbfgs import LbfgsResult, full_f32, minimize_lbfgs

__all__ = [
    "quantile_bin_edges",
    "bin_features",
    "binned_contingency",
    "chi_square",
    "LbfgsResult",
    "full_f32",
    "minimize_lbfgs",
]
