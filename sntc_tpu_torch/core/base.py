"""Transformer / Model / PipelineModel — the serving half of the pipeline API.

Counterpart of ``sntc_tpu/core/base.py`` (Spark ML's pipeline
abstractions): ``Transformer.transform(frame) -> frame`` appends columns
and a ``PipelineModel`` applies its fitted stages in order.  The port
serves fitted pipelines; estimators and ``Pipeline.fit`` come with the
fit-side slice.
"""

from __future__ import annotations

from typing import Any, List, Optional

from sntc_tpu_torch.core.frame import Frame
from sntc_tpu_torch.core.params import Param, Params


class PipelineStage(Params):
    """Common base of every stage."""


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


class Model(Transformer):
    """A fitted Transformer."""


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
