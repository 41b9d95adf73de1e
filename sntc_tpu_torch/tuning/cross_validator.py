"""Model tuning: ParamGridBuilder, CrossValidator, TrainValidationSplit.

Counterpart of ``sntc_tpu/tuning/cross_validator.py`` (Spark's
``CrossValidator``): a k-fold × parameter-grid search, the metric
averaged over folds per grid point, the best point refit on the whole
frame; ``TrainValidationSplit`` is the single-split variant.  The folds
come from the host's ``np.random.default_rng(seed)`` and the split from
``Frame.random_split``, so a seed makes the JAX package's folds.

Estimators with ``supports_batched_grid``/``_fit_grid``
(LogisticRegression) fit the whole grid as lanes of one LBFGS loop on
their device, and a bare LogisticRegression fits the whole k-fold ×
grid sweep that way (``_fit_grid_folds``).  A Pipeline whose grid names
only its head's params fits its feature prefix once per fold or split,
transforms both sides through the fusion compiler once, and sweeps only
the head.  Other estimators fit sequentially, and a ``parallelism`` > 1
request logs a warning.  ``SNTC_TUNING_BATCH=0`` makes the sequential
path run instead (both paths run on the device); ``faultTolerant``
fits cell by cell under a retry policy and records a failed cell as NaN.
"""

from __future__ import annotations

import logging
import os
from itertools import product
from typing import Any, Dict, List, Optional

import numpy as np

from sntc_tpu_torch.core.base import Estimator, Model, Pipeline, PipelineModel
from sntc_tpu_torch.core.frame import Frame, to_host
from sntc_tpu_torch.core.params import Param, validators
from sntc_tpu_torch.resilience import (
    RetryPolicy,
    emit_event,
    fault_point,
    with_retries,
)

logger = logging.getLogger(__name__)

# the default per-cell policy when faultTolerant=True and the caller
# didn't pass one: one in-place retry, near-immediate (a CV cell failure
# is usually deterministic — the retry catches transient device/host
# flakes, then the cell degrades to NaN)
_DEFAULT_CV_POLICY = RetryPolicy(
    max_attempts=2, base_delay_s=0.01, max_delay_s=0.5, jitter=0.0
)


def _is_batched(estimator, grid) -> bool:
    return (
        os.environ.get("SNTC_TUNING_BATCH", "1") != "0"
        and hasattr(estimator, "supports_batched_grid")
        and estimator.supports_batched_grid(grid)
    )


def _pipeline_grid_plan(estimator, grid):
    """``(prefix_stages, head_estimator)`` when ``estimator`` is a
    Pipeline whose grid params ALL target its final stage (an
    Estimator) — the plan that lets tuning fit the feature prefix ONCE
    per fold/split and sweep only the head.  None otherwise (including
    an empty grid, where there is nothing to sweep).

    Name-based grids on a Pipeline are resolved against the final
    estimator by definition; a grid key no stage can own still fails
    loudly in ``copy`` exactly as before."""
    if not isinstance(estimator, Pipeline):
        return None
    keys = set().union(*grid) if grid else set()
    if not keys:
        return None
    stages = estimator.getStages()
    if not stages or not isinstance(stages[-1], Estimator):
        return None
    head = stages[-1]
    if not all(head.hasParam(k) for k in keys):
        return None
    return list(stages[:-1]), head


def _estimator_reads(head) -> list:
    """Columns the head estimator's fit consumes: its declared input
    columns (``PipelineStage.input_columns`` — overridable by stages
    with nonstandard input params) plus label/weight, which only exist
    at fit time — so the fused prefix keeps every column the head sweep
    needs."""
    out = list(head.input_columns())
    for name in ("labelCol", "weightCol"):
        if not head.hasParam(name) or not head.isDefined(name):
            continue
        val = head.getOrDefault(name)
        if val:
            out.append(val)
    return out


def _fit_prefix_transform(prefix_stages, head, frame: Frame):
    """Fit the feature prefix on ``frame`` and transform it ONCE through
    the whole-pipeline fusion compiler (``sntc_tpu_torch.fuse``): one device
    program per fusible run instead of a per-stage host round trip, and
    the result is reused across every grid point.  Returns
    ``(prefix PipelineModel, fused prefix or None, transformed frame)``."""
    from sntc_tpu_torch.fuse import compile_pipeline

    if not prefix_stages:
        return PipelineModel(stages=[]), None, frame
    prefix = Pipeline(stages=list(prefix_stages)).fit(frame)
    fused = compile_pipeline(
        prefix, keep=_estimator_reads(head), fuse_heads=False
    )
    return prefix, fused, fused.transform(frame)


def _fit_with_params(estimator, frame: Frame, params, plan=None):
    """One full fit of ``estimator`` under a grid-point override map,
    honoring the pipeline-grid plan (params bind to the head stage)."""
    if plan is None:
        return estimator.copy(params).fit(frame)
    prefix_stages, head = plan
    return Pipeline(
        stages=list(prefix_stages) + [head.copy(params)]
    ).fit(frame)


def _grid_fit(estimator, train: Frame, grid):
    """Yields one fitted model per grid point, in order: one lane loop
    when the estimator supports it, otherwise a sequential loop
    (lazy, so the caller holds at most one sequential model at a time).
    Pipeline estimators with a head-only grid fit the feature prefix
    ONCE and sweep just the head (batched when the head supports it),
    yielding full PipelineModels."""
    plan = _pipeline_grid_plan(estimator, grid)
    if plan is not None:
        prefix_stages, head = plan
        prefix, _, head_train = _fit_prefix_transform(
            prefix_stages, head, train
        )
        for model in _grid_fit(head, head_train, grid):
            yield PipelineModel(stages=prefix.getStages() + [model])
        return
    if _is_batched(estimator, grid):
        yield from estimator._fit_grid(train, grid)
        return
    for params in grid:
        yield estimator.copy(params).fit(train)


def _warn_parallelism_noop(estimator, grid, parallelism: int):
    if parallelism <= 1:
        return
    if not _is_batched(estimator, grid):
        logger.warning(
            "parallelism=%d has no effect for %s: grid fits run "
            "sequentially (each fit runs on the whole device); "
            "estimators with a batched grid path (e.g. LogisticRegression) "
            "overlap grid points automatically",
            parallelism, type(estimator).__name__,
        )


class ParamGridBuilder:
    def __init__(self):
        self._grid: Dict[str, List[Any]] = {}

    def addGrid(self, param, values) -> "ParamGridBuilder":
        name = param if isinstance(param, str) else param.name
        self._grid[name] = list(values)
        return self

    def baseOn(self, **fixed) -> "ParamGridBuilder":
        for k, v in fixed.items():
            self._grid[k] = [v]
        return self

    def build(self) -> List[Dict[str, Any]]:
        if not self._grid:
            return [{}]
        names = list(self._grid)
        return [
            dict(zip(names, combo))
            for combo in product(*(self._grid[n] for n in names))
        ]


class _TuningParams:
    numFolds = Param("cross-validation folds", default=3, validator=validators.gteq(2))
    seed = Param("fold split seed", default=0)
    parallelism = Param(
        "accepted for API parity; batched-grid estimators overlap grid "
        "points on-device regardless, others warn and run sequentially",
        default=1,
        validator=validators.gteq(1),
    )
    collectSubModels = Param("keep every (fold, grid) sub-model", default=False,
                             validator=validators.is_bool())
    foldCol = Param(
        "optional column of user-assigned fold indices in [0, numFolds)",
        default=None,
    )
    faultTolerant = Param(
        "retry a failed (fold, grid) cell fit under the resilience "
        "policy, then record NaN for that cell and keep the grid "
        "search alive instead of aborting (forces per-cell sequential "
        "fits — fault isolation needs cell-granular execution)",
        default=False,
        validator=validators.is_bool(),
    )


class CrossValidator(_TuningParams, Estimator):
    def __init__(self, estimator=None, estimatorParamMaps=None, evaluator=None,
                 retryPolicy=None, **kwargs):
        super().__init__(**kwargs)
        if estimator is None or evaluator is None:
            raise ValueError("CrossValidator requires estimator and evaluator")
        self.estimator = estimator
        self.estimatorParamMaps = estimatorParamMaps or [{}]
        self.evaluator = evaluator
        # in-memory only (not persisted): the per-cell policy used when
        # faultTolerant=True; defaults to one quick in-place retry
        self.retryPolicy = retryPolicy

    def _fit(self, frame: Frame) -> "CrossValidatorModel":
        k = self.getNumFolds()
        if self.getFoldCol():
            raw = to_host(frame[self.getFoldCol()])
            fold_of = raw.astype(np.int64)
            if not np.array_equal(raw.astype(np.float64), fold_of):
                raise ValueError("foldCol values must be integers")
            if fold_of.min(initial=0) < 0 or fold_of.max(initial=0) >= k:
                raise ValueError(
                    f"foldCol values must lie in [0, numFolds={k})"
                )
            present = np.bincount(fold_of, minlength=k)
            if (present == 0).any():
                empty = np.flatnonzero(present == 0).tolist()
                raise ValueError(
                    f"foldCol leaves folds {empty} empty: every fold in "
                    f"[0, numFolds={k}) needs rows (an empty fold would be "
                    "silently fit/scored on nothing)"
                )
        else:
            rng = np.random.default_rng(self.getSeed())
            fold_of = rng.integers(0, k, size=frame.num_rows)
        grid = self.estimatorParamMaps
        metrics = np.zeros((len(grid), k))
        sub_models: Optional[List[List[Model]]] = (
            [[] for _ in grid] if self.getCollectSubModels() else None
        )

        plan = _pipeline_grid_plan(self.estimator, grid)
        # the hoisted head is what actually sweeps the grid — warn about
        # ITS batching capability, not the (never-batched) Pipeline shell
        _warn_parallelism_noop(
            self.estimator if plan is None else plan[1], grid,
            self.getParallelism(),
        )
        if self.getFaultTolerant():
            self._fit_folds_tolerant(frame, fold_of, k, grid, metrics,
                                     sub_models, plan)
        elif plan is not None:
            # Pipeline estimator, head-only grid: per fold, fit the
            # feature prefix ONCE and push train AND valid through the
            # fused prefix program once — every grid point reuses the
            # on-device-transformed features instead of re-running the
            # whole feature chain (sntc_tpu_torch.fuse; the head sweep still
            # batches on-device when the head supports grids)
            self._fit_folds_pipeline(frame, fold_of, k, grid, metrics,
                                     sub_models, plan)
        else:
            # strongest path: the whole k-fold × grid sweep as one lane
            # loop on the device (folds are per-lane weight masks; the
            # rows upload once) — available when the estimator supports batched grids
            fold_models = None
            if _is_batched(self.estimator, grid) and hasattr(
                self.estimator, "_fit_grid_folds"
            ):
                fold_models = self.estimator._fit_grid_folds(
                    frame, grid, fold_of, k
                )
            for fold in range(k):
                valid = frame.filter(fold_of == fold)
                models = (
                    fold_models[fold]
                    if fold_models is not None
                    else _grid_fit(
                        self.estimator, frame.filter(fold_of != fold), grid
                    )
                )
                for gi, model in enumerate(models):
                    metrics[gi, fold] = self.evaluator.evaluate(
                        model.transform(valid)
                    )
                    if sub_models is not None:
                        sub_models[gi].append(model)

        larger = self.evaluator.isLargerBetter()
        if self.getFaultTolerant():
            # degraded cells are NaN: average each grid point over its
            # SURVIVING folds; a grid point with no surviving fold can
            # never win
            counts = (~np.isnan(metrics)).sum(axis=1)
            if not counts.any():
                raise RuntimeError(
                    "CrossValidator: every (fold, grid) cell failed "
                    "even under the fault-tolerance policy"
                )
            sums = np.nansum(metrics, axis=1)
            avg = np.where(
                counts > 0, sums / np.maximum(counts, 1),
                -np.inf if larger else np.inf,
            )
        else:
            avg = metrics.mean(axis=1)
        best_idx = int(np.argmax(avg)) if larger else int(np.argmin(avg))
        refit = lambda: _fit_with_params(
            self.estimator, frame, grid[best_idx], plan
        )
        if self.getFaultTolerant():
            # the final refit deserves the same transient-flake cover as
            # the cells — losing the whole surviving sweep to one blip
            # at the finish line would defeat the tolerance
            best_model = with_retries(
                refit, self.retryPolicy or _DEFAULT_CV_POLICY,
                site="cv.fit",
            )
        else:
            best_model = refit()
        return CrossValidatorModel(
            bestModel=best_model,
            avgMetrics=avg.tolist(),
            bestIndex=best_idx,
            subModels=sub_models,
            estimator=self.estimator,
            evaluator=self.evaluator,
            estimatorParamMaps=grid,
        )

    def _fit_folds_pipeline(self, frame, fold_of, k, grid, metrics,
                            sub_models, plan) -> None:
        """The hoisted pipeline sweep: per fold, the feature prefix is
        fit once and both splits flow through the fused prefix program
        once; grid points fit and score on the ALREADY-transformed
        frames (metrics are identical to fitting the whole pipeline per
        cell — the prefix has no grid params by construction).
        Sub-models are full PipelineModels, as the sequential path
        produces."""
        prefix_stages, head = plan
        for fold in range(k):
            prefix, fused_prefix, head_train = _fit_prefix_transform(
                prefix_stages, head, frame.filter(fold_of != fold)
            )
            head_valid = (
                fused_prefix.transform(frame.filter(fold_of == fold))
                if fused_prefix is not None
                else frame.filter(fold_of == fold)
            )
            for gi, model in enumerate(_grid_fit(head, head_train, grid)):
                metrics[gi, fold] = self.evaluator.evaluate(
                    model.transform(head_valid)
                )
                if sub_models is not None:
                    sub_models[gi].append(
                        PipelineModel(stages=prefix.getStages() + [model])
                    )

    def _fit_folds_tolerant(self, frame, fold_of, k, grid, metrics,
                            sub_models, plan=None) -> None:
        """Per-(fold, grid-point) execution under the resilience policy:
        each cell fit+evaluate retries per ``retryPolicy`` (site
        ``cv.fit``), and on exhaustion the cell records NaN with a
        structured ``cv_cell_degraded`` event — the grid search
        continues.  Cell-granular by construction: the lane loop
        cannot isolate one lane's failure (and the pipeline-grid
        plan's prefix hoist is likewise skipped — a cell is the WHOLE
        pipeline fit, so one cell's poison cannot leak into another's
        shared features)."""
        policy = self.retryPolicy or _DEFAULT_CV_POLICY
        for fold in range(k):
            valid = frame.filter(fold_of == fold)
            train = frame.filter(fold_of != fold)
            for gi, params in enumerate(grid):
                def _cell(params=params):
                    fault_point("cv.fit")
                    model = _fit_with_params(
                        self.estimator, train, params, plan
                    )
                    return model, self.evaluator.evaluate(
                        model.transform(valid)
                    )

                try:
                    model, metric = with_retries(
                        _cell, policy, site="cv.fit"
                    )
                except Exception as e:
                    metrics[gi, fold] = np.nan
                    emit_event(
                        event="cv_cell_degraded", site="cv.fit",
                        fold=fold, grid_index=gi, error=repr(e),
                    )
                    logger.warning(
                        "CrossValidator: fold %d grid point %d failed "
                        "(%r); cell recorded as NaN", fold, gi, e,
                    )
                    if sub_models is not None:
                        sub_models[gi].append(None)
                    continue
                metrics[gi, fold] = metric
                if sub_models is not None:
                    sub_models[gi].append(model)

    # -- persistence: a saved CrossValidator round-trips its full spec
    # (estimator + evaluator stages, grid in JSON), Spark ReadWrite parity

    def _sub_stages(self):
        return [self.estimator, self.evaluator]

    def _save_extra(self):
        return {"estimatorParamMaps": self.estimatorParamMaps}, {}

    @classmethod
    def _from_sub_stages(cls, stages, params, extra=None):
        obj = cls(
            estimator=stages[0], evaluator=stages[1],
            estimatorParamMaps=(extra or {}).get("estimatorParamMaps")
            or [{}],
        )
        obj.setParams(**params)
        return obj


class CrossValidatorModel(Model):
    """Best-model wrapper; carries ``avgMetrics`` per grid point and —
    for Spark save/load parity — the tuning spec (``estimator``,
    ``evaluator``, ``estimatorParamMaps``), all of which round-trip
    through ``save``/``load`` so a loaded result can re-run the search.
    ``subModels`` are in-memory only (not persisted)."""

    def __init__(self, bestModel: Model = None, avgMetrics: List[float] = None,
                 bestIndex: int = 0, subModels=None, estimator=None,
                 evaluator=None, estimatorParamMaps=None, **kwargs):
        super().__init__(**kwargs)
        self.bestModel = bestModel
        self.avgMetrics = avgMetrics or []
        self.bestIndex = bestIndex
        self.subModels = subModels
        self.estimator = estimator
        self.evaluator = evaluator
        self.estimatorParamMaps = estimatorParamMaps or []

    def transform(self, frame: Frame) -> Frame:
        return self.bestModel.transform(frame)

    def _has_spec(self) -> bool:
        return self.estimator is not None and self.evaluator is not None

    def _sub_stages(self):
        stages = [self.bestModel]
        if self._has_spec():
            stages += [self.estimator, self.evaluator]
        return stages

    def _save_extra(self):
        return {
            "avgMetrics": self.avgMetrics,
            "bestIndex": self.bestIndex,
            "estimatorParamMaps": self.estimatorParamMaps or None,
            "has_spec": self._has_spec(),
        }, {}

    @classmethod
    def _from_sub_stages(cls, stages, params, extra=None):
        extra = extra or {}
        est = ev = None
        if extra.get("has_spec") and len(stages) >= 3:
            est, ev = stages[1], stages[2]
        obj = cls(
            bestModel=stages[0],
            avgMetrics=extra.get("avgMetrics") or [],
            bestIndex=int(extra.get("bestIndex", 0)),
            estimator=est,
            evaluator=ev,
            estimatorParamMaps=extra.get("estimatorParamMaps"),
        )
        obj.setParams(**params)
        return obj


class _TvsParams:
    trainRatio = Param("train fraction", default=0.75, validator=validators.in_range(0, 1))
    seed = Param("split seed", default=0)
    parallelism = Param(
        "accepted for API parity; batched-grid estimators overlap grid "
        "points on-device regardless, others warn and run sequentially",
        default=1, validator=validators.gteq(1),
    )
    collectSubModels = Param("keep every grid-point sub-model", default=False,
                             validator=validators.is_bool())


class TrainValidationSplit(_TvsParams, Estimator):
    def __init__(self, estimator=None, estimatorParamMaps=None, evaluator=None,
                 **kwargs):
        super().__init__(**kwargs)
        if estimator is None or evaluator is None:
            raise ValueError(
                "TrainValidationSplit requires estimator and evaluator"
            )
        self.estimator = estimator
        self.estimatorParamMaps = estimatorParamMaps or [{}]
        self.evaluator = evaluator

    def _fit(self, frame: Frame) -> "TrainValidationSplitModel":
        ratio = self.getTrainRatio()
        train, valid = frame.random_split(
            [ratio, 1 - ratio], seed=self.getSeed()
        )
        grid = self.estimatorParamMaps
        metrics = []
        sub_models: Optional[List[Model]] = (
            [] if self.getCollectSubModels() else None
        )
        plan = _pipeline_grid_plan(self.estimator, grid)
        # the hoisted head is what actually sweeps the grid — warn about
        # ITS batching capability, not the (never-batched) Pipeline shell
        _warn_parallelism_noop(
            self.estimator if plan is None else plan[1], grid,
            self.getParallelism(),
        )
        if plan is not None:
            # pipeline-grid hoist (mirrors CrossValidator): the feature
            # prefix fits once and BOTH splits flow through the fused
            # prefix program once; only the head sweeps the grid
            prefix_stages, head = plan
            prefix, fused_prefix, head_train = _fit_prefix_transform(
                prefix_stages, head, train
            )
            head_valid = (
                fused_prefix.transform(valid)
                if fused_prefix is not None
                else valid
            )
            for model in _grid_fit(head, head_train, grid):
                metrics.append(
                    self.evaluator.evaluate(model.transform(head_valid))
                )
                if sub_models is not None:
                    sub_models.append(
                        PipelineModel(stages=prefix.getStages() + [model])
                    )
        else:
            for model in _grid_fit(self.estimator, train, grid):
                metrics.append(
                    self.evaluator.evaluate(model.transform(valid))
                )
                if sub_models is not None:
                    sub_models.append(model)
        arr = np.asarray(metrics)
        best_idx = (
            int(np.argmax(arr))
            if self.evaluator.isLargerBetter()
            else int(np.argmin(arr))
        )
        best_model = _fit_with_params(
            self.estimator, frame, grid[best_idx], plan
        )
        return TrainValidationSplitModel(
            bestModel=best_model, validationMetrics=metrics,
            bestIndex=best_idx, subModels=sub_models,
            estimator=self.estimator, evaluator=self.evaluator,
            estimatorParamMaps=grid,
        )

    def _sub_stages(self):
        return [self.estimator, self.evaluator]

    def _save_extra(self):
        return {"estimatorParamMaps": self.estimatorParamMaps}, {}

    @classmethod
    def _from_sub_stages(cls, stages, params, extra=None):
        obj = cls(
            estimator=stages[0], evaluator=stages[1],
            estimatorParamMaps=(extra or {}).get("estimatorParamMaps")
            or [{}],
        )
        obj.setParams(**params)
        return obj


class TrainValidationSplitModel(Model):
    """Best-model wrapper; persistence mirrors
    :class:`CrossValidatorModel` (spec + metrics round-trip,
    ``subModels`` in-memory only)."""

    def __init__(self, bestModel: Model = None, validationMetrics=None,
                 bestIndex: int = 0, subModels=None, estimator=None,
                 evaluator=None, estimatorParamMaps=None, **kwargs):
        super().__init__(**kwargs)
        self.bestModel = bestModel
        self.validationMetrics = validationMetrics or []
        self.bestIndex = bestIndex
        self.subModels = subModels
        self.estimator = estimator
        self.evaluator = evaluator
        self.estimatorParamMaps = estimatorParamMaps or []

    def transform(self, frame: Frame) -> Frame:
        return self.bestModel.transform(frame)

    def _has_spec(self) -> bool:
        return self.estimator is not None and self.evaluator is not None

    def _sub_stages(self):
        stages = [self.bestModel]
        if self._has_spec():
            stages += [self.estimator, self.evaluator]
        return stages

    def _save_extra(self):
        return {
            "validationMetrics": self.validationMetrics,
            "bestIndex": self.bestIndex,
            "estimatorParamMaps": self.estimatorParamMaps or None,
            "has_spec": self._has_spec(),
        }, {}

    @classmethod
    def _from_sub_stages(cls, stages, params, extra=None):
        extra = extra or {}
        est = ev = None
        if extra.get("has_spec") and len(stages) >= 3:
            est, ev = stages[1], stages[2]
        obj = cls(
            bestModel=stages[0],
            validationMetrics=extra.get("validationMetrics") or [],
            bestIndex=int(extra.get("bestIndex", 0)),
            estimator=est,
            evaluator=ev,
            estimatorParamMaps=extra.get("estimatorParamMaps"),
        )
        obj.setParams(**params)
        return obj
