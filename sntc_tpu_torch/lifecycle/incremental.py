"""Incremental-fit states: the sufficient statistics a ``partial_fit``
call folds one mini-batch into.

Counterpart of ``sntc_tpu/lifecycle/incremental.py``.  The estimators
own the math (``NaiveBayes.partial_fit``, ``LogisticRegression.
partial_fit``: the summarizer passes their batch fits run, on the
estimator's device); the states here are the host float64 accumulators
those methods carry between calls, so the serving layer can hold them
without touching estimator internals.

Equivalence contract (``tests/test_torch_lifecycle.py``):

* **NaiveBayes**: class weights and the per-(class, feature) moments are
  additive, so ``partial_fit`` over K shards rebuilds the batch fit's
  float64 statistics up to float32 summation order (discrete types: θ
  within 1e-5 relative).  The gaussian variance comes from the
  accumulated pilot-shifted moments (one pass) where the batch fit runs
  a second pass about the class means: the same statistic, rounded
  differently (μ within 1e-4, σ² within 1e-2 relative).
* **LogisticRegression**: the logistic loss has no finite sufficient
  statistic, so each call is the MLlib streaming recipe: the
  standardization moments accumulate exactly, and an LBFGS run on the
  new shard starts from the previous solution, with ``decay``
  discounting the old moments.  The contract is behavioural: held-out
  predictions agree with the batch fit on iid shards (≥ 95 %).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np


@dataclass
class NBPartialFitState:
    """Decayable per-(class, feature) moments (host float64).

    ``s_sh`` / ``sq_sh`` are Σw·(x−p) and Σw·(x−p)² about the pilot row
    ``p`` fixed by the first call, so every shard shifts about the same
    row and the sums equal one pass over all the data.  ``decay`` < 1 on
    an update down-weights the history."""

    n_classes: int
    n_features: int
    pilot: np.ndarray  # [F] f32, fixed at the first update
    cw: np.ndarray = field(default=None)  # [C] f64 class weights
    s_sh: np.ndarray = field(default=None)  # [C, F] f64 Σ w (x-p)
    sq_sh: np.ndarray = field(default=None)  # [C, F] f64 Σ w (x-p)²
    batches_seen: int = 0
    rows_seen: int = 0

    def __post_init__(self):
        if self.cw is None:
            self.cw = np.zeros(self.n_classes, np.float64)
            self.s_sh = np.zeros((self.n_classes, self.n_features),
                                 np.float64)
            self.sq_sh = np.zeros_like(self.s_sh)

    def update(self, cw, s_sh, sq_sh, n_rows: int, decay: float = 1.0):
        if not 0.0 < decay <= 1.0:
            raise ValueError("decay must lie in (0, 1]")
        self.cw = decay * self.cw + np.asarray(cw, np.float64)
        self.s_sh = decay * self.s_sh + np.asarray(s_sh, np.float64)
        self.sq_sh = decay * self.sq_sh + np.asarray(sq_sh, np.float64)
        self.batches_seen += 1
        self.rows_seen += int(n_rows)
        return self


@dataclass
class LRPartialFitState:
    """Decayed standardization moments and the warm-start solution.

    The moments (``s1``/``s2``/``cnt``/``class_counts``) are additive and
    accumulate exactly; the coefficients are kept in the ORIGINAL
    feature space (the standardization moves from call to call) and
    rescaled into each call's optimization space for the warm start."""

    d: int
    k: int
    binomial: bool
    s1: np.ndarray = field(default=None)  # [D] f64 Σ w x
    s2: np.ndarray = field(default=None)  # [D] f64 Σ w x²
    cnt: float = 0.0
    class_counts: np.ndarray = field(default=None)  # [K] f64
    coef_orig: Optional[np.ndarray] = None  # [D, rows] original space
    intercepts: Optional[np.ndarray] = None  # [rows]
    batches_seen: int = 0
    rows_seen: int = 0

    def __post_init__(self):
        if self.s1 is None:
            self.s1 = np.zeros(self.d, np.float64)
            self.s2 = np.zeros(self.d, np.float64)
            self.class_counts = np.zeros(self.k, np.float64)

    @property
    def rows(self) -> int:
        """Coefficient columns: 1 for binomial, K for multinomial."""
        return 1 if self.binomial else self.k

    def update(self, s1, s2, cnt, class_counts, n_rows: int,
               decay: float = 1.0):
        if not 0.0 < decay <= 1.0:
            raise ValueError("decay must lie in (0, 1]")
        self.s1 = decay * self.s1 + np.asarray(s1, np.float64)
        self.s2 = decay * self.s2 + np.asarray(s2, np.float64)
        self.cnt = decay * self.cnt + float(cnt)
        self.class_counts = decay * self.class_counts + np.asarray(
            class_counts, np.float64)
        self.batches_seen += 1
        self.rows_seen += int(n_rows)
        return self


def incremental_estimator_for(model, mesh=None, device=None):
    """An estimator whose ``partial_fit`` continues ``model`` (the serve
    command's ``--partial-fit``): the candidate head is refit from live
    labelled batches with the incumbent's own hyperparameters, on
    ``device`` (default: the model's), or over ``mesh`` (default: the
    mesh's first device).  Supported heads: the two estimators with a
    sufficient-statistic ``partial_fit`` (LR / NB)."""
    from sntc_tpu_torch.models.logistic_regression import (
        LogisticRegression,
        LogisticRegressionModel,
    )
    from sntc_tpu_torch.models.naive_bayes import (
        NaiveBayes,
        NaiveBayesModel,
    )

    if isinstance(model, LogisticRegressionModel):
        cls = LogisticRegression
    elif isinstance(model, NaiveBayesModel):
        cls = NaiveBayes
    else:
        raise ValueError(
            f"no incremental estimator for {type(model).__name__}; "
            "partial_fit supports LogisticRegressionModel and "
            "NaiveBayesModel heads"
        )
    if mesh is None and device is None:
        device = model.device
    est = cls(device=device, mesh=mesh)
    est.setParams(**{name: val for name, val in model.paramValues().items()
                     if est.hasParam(name)})
    return est
