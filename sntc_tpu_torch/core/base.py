"""Estimator / Transformer / Pipeline — the pipeline API.

Counterpart of ``sntc_tpu/core/base.py`` (Spark ML's pipeline
abstractions): ``Transformer.transform(frame) -> frame`` appends
columns, ``Estimator.fit(frame) -> Model`` learns a fitted Transformer,
and a ``Pipeline`` fits its stages in order into a ``PipelineModel``,
which applies its fitted stages in order.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from sntc_tpu_torch.core.frame import Frame
from sntc_tpu_torch.core.params import Param, Params


class PipelineStage(Params):
    """Common base of every stage."""

    # the input-column param names input_columns() discovers; a stage
    # reading columns through other params overrides input_columns()
    _INPUT_COL_PARAMS = ("inputCol", "featuresCol", "inputCols")

    def input_columns(self) -> List[str]:
        """Column names this stage reads (the fusion planner's view of
        which columns a later stage still needs)."""
        out: List[str] = []
        for name in self._INPUT_COL_PARAMS:
            if not self.hasParam(name) or not self.isDefined(name):
                continue
            val = self.getOrDefault(name)
            if val is None:
                continue
            out.extend(val if isinstance(val, (list, tuple)) else [val])
        return out


class Transformer(PipelineStage):
    def transform(self, frame: Frame) -> Frame:
        raise NotImplementedError

    def transform_async(self, frame: Frame):
        """Dispatch this transform without blocking on device results.

        Returns a zero-arg ``finalize`` callable that materializes and
        returns the output Frame.  Device-backed models override this to
        enqueue their kernels and defer the device→host copy (CUDA work
        is asynchronous; only the copy blocks), so a caller can prepare
        the next batch while the card computes this one.  The default
        runs synchronously and is always correct.

        ``finalize`` may be invoked more than once and from another
        thread than the dispatching one; overrides close over immutable
        per-call state only.
        """
        out = self.transform(frame)
        return lambda: out


class Estimator(PipelineStage):
    def fit(self, frame: Frame, params: Optional[Dict[str, Any]] = None) -> "Model":
        """Fit on ``frame``; ``params`` is a one-shot override map
        (Spark's ``fit(dataset, paramMap)``)."""
        if params:
            return self.copy(params).fit(frame)
        return self._fit(frame)

    def _fit(self, frame: Frame) -> "Model":
        raise NotImplementedError


class Evaluator(PipelineStage):
    """Metric computer over a predictions Frame (Spark's
    ``ml/evaluation/Evaluator``)."""

    def evaluate(self, frame: Frame) -> float:
        raise NotImplementedError

    def isLargerBetter(self) -> bool:
        return True


class Model(Transformer):
    """A fitted Transformer."""


class Pipeline(Estimator):
    """Chain of stages; ``fit`` returns a :class:`PipelineModel`.

    Spark semantics: stages before the last estimator are applied in
    order — transformers transform the running frame, each estimator is
    fit on it and its fitted model transforms it for the stages after.
    Nothing is transformed after the last estimator."""

    stages = Param("pipeline stages (Transformers and Estimators), applied in order")

    def __init__(self, stages: Optional[List[PipelineStage]] = None, **kwargs: Any):
        super().__init__(**kwargs)
        if stages is not None:
            self.set("stages", list(stages))

    def _fit(self, frame: Frame) -> "PipelineModel":
        stages = self.getStages()
        for stage in stages:
            if not isinstance(stage, (Transformer, Estimator)):
                raise TypeError(
                    f"pipeline stage {stage!r} is neither Transformer nor Estimator"
                )
        last_est = max(
            (i for i, s in enumerate(stages) if isinstance(s, Estimator)),
            default=-1,
        )
        fitted: List[Transformer] = []
        current = frame
        for i, stage in enumerate(stages):
            if isinstance(stage, Estimator):
                model = stage.fit(current)
                fitted.append(model)
                if i < last_est:
                    current = model.transform(current)
            else:
                fitted.append(stage)
                if i < last_est:
                    current = stage.transform(current)
        return PipelineModel(stages=fitted)


class PipelineModel(Model):
    """Fitted pipeline: applies each fitted stage's transform in order."""

    stages = Param("fitted pipeline stages (all Transformers)")

    def __init__(self, stages: Optional[List[Transformer]] = None, **kwargs: Any):
        super().__init__(**kwargs)
        if stages is not None:
            self.set("stages", list(stages))

    def transform(self, frame: Frame) -> Frame:
        current = frame
        for stage in self.getStages():
            current = stage.transform(current)
        return current

    def transform_async(self, frame: Frame):
        """Stages before the last device-dispatching stage run now; that
        stage's dispatch is deferred to its own ``transform_async``, and
        trailing host-only stages (e.g. ``IndexToString`` on the
        prediction) run inside finalize."""
        stages = self.getStages()
        if not stages:
            return lambda: frame
        split = len(stages) - 1
        for i in reversed(range(len(stages))):
            if (
                type(stages[i]).transform_async
                is not Transformer.transform_async
            ):
                split = i
                break
        current = frame
        for stage in stages[:split]:
            current = stage.transform(current)
        fin = stages[split].transform_async(current)
        tail = stages[split + 1:]
        if not tail:
            return fin

        def finalize():
            out = fin()
            for stage in tail:
                out = stage.transform(out)
            return out

        return finalize
