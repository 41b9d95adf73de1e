"""Fit-side tensor operations: quantile binning and binned histograms."""
