"""Algebraic rewrite rules the fusion pass runs BEFORE partitioning.

Counterpart of ``sntc_tpu/fuse/rules.py``.  Rule 1 (scaler folding): a
``StandardScalerModel`` feeding a logistic-regression head or an MLP's
first layer folds exactly into the head's weights,

    x' = (x - μ)·f        (f = 1/σ, 0 for constant features)
    x'W + b  =  x(f⊙W) + (b - (μ⊙f)W)

so the scaler stage disappears instead of costing a pass of its own.
The fold runs in float64 numpy, as the JAX package's does, so both
packages serve the same float32 weights.  The scaler is dropped only
when the head is its SOLE consumer; if a later stage reads the scaled
column the pair is left to the partitioner, which keeps the column.
"""

from __future__ import annotations

import numpy as np

from sntc_tpu_torch.core.base import Transformer
from sntc_tpu_torch.feature.standard_scaler import StandardScalerModel
from sntc_tpu_torch.models.logistic_regression import LogisticRegressionModel
from sntc_tpu_torch.models.mlp import (
    MultilayerPerceptronClassificationModel,
    _layer_sizes,
)


def _fold_into_lr(
    scaler: StandardScalerModel, model: LogisticRegressionModel
) -> LogisticRegressionModel:
    mu, f = scaler.affine()
    W = model.coefficientMatrix.astype(np.float64)  # [K, D]
    b = model.interceptVector.astype(np.float64)
    W2 = W * f[None, :]
    b2 = b - W2 @ mu
    folded = LogisticRegressionModel(
        coefficient_matrix=W2.astype(np.float32),
        intercepts=b2.astype(np.float32),
        is_binomial=model.is_binomial,
        device=model.device,
    )
    folded.setParams(**model.paramValues())
    folded.set("featuresCol", scaler.getInputCol())
    return folded


def _fold_into_mlp(
    scaler: StandardScalerModel, model: MultilayerPerceptronClassificationModel
) -> MultilayerPerceptronClassificationModel:
    mu, f = scaler.affine()
    layers = tuple(int(v) for v in model.getLayers())
    d_in, d_h = _layer_sizes(layers)[0]
    theta = model.weights.astype(np.float64)  # a writable copy
    W1 = theta[: d_in * d_h].reshape(d_in, d_h)
    b1 = theta[d_in * d_h : d_in * d_h + d_h]
    W1_new = f[:, None] * W1
    b1_new = b1 - (mu * f) @ W1
    theta[: d_in * d_h] = W1_new.reshape(-1)
    theta[d_in * d_h : d_in * d_h + d_h] = b1_new
    folded = MultilayerPerceptronClassificationModel(
        weights=theta.astype(np.float32), layers=list(layers),
        device=model.device,
    )
    folded.setParams(**{
        k: v for k, v in model.paramValues().items() if k != "layers"
    })
    folded.set("featuresCol", scaler.getInputCol())
    return folded


_FOLDABLE = {
    LogisticRegressionModel: _fold_into_lr,
    MultilayerPerceptronClassificationModel: _fold_into_mlp,
}


def _consumes(stage: Transformer, col: str) -> bool:
    return col in stage.input_columns()


def fold_scalers(stages: list) -> list:
    """Apply rule 1 over a fitted stage list; non-matching patterns pass
    through untouched.  Returns a NEW list (the input is not mutated)."""
    out: list = []
    i = 0
    while i < len(stages):
        s = stages[i]
        nxt = stages[i + 1] if i + 1 < len(stages) else None
        fold = _FOLDABLE.get(type(nxt)) if nxt is not None else None
        if (
            isinstance(s, StandardScalerModel)
            and fold is not None
            and nxt.getFeaturesCol() == s.getOutputCol()
            and not any(
                _consumes(later, s.getOutputCol()) for later in stages[i + 2:]
            )
        ):
            out.append(fold(s, nxt))
            i += 2
        else:
            out.append(s)
            i += 1
    return out
