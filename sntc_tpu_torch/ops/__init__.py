"""Fit-side tensor operations: quantile binning, binned histograms and
the LBFGS/OWLQN minimizer."""

from sntc_tpu_torch.ops.lbfgs import LbfgsResult, full_f32, minimize_lbfgs

__all__ = ["LbfgsResult", "full_f32", "minimize_lbfgs"]
