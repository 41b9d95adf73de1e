"""Shared classifier plumbing — the ``ProbabilisticClassifier`` analog.

Counterpart of ``sntc_tpu/models/base.py``: a classifier estimator
extracts ``(X, y, w)`` from the frame; a classification model's
``transform`` appends ``rawPrediction`` (margins), ``probability`` and
``prediction`` (float64 index) columns; binary models honor
``threshold`` and any model per-class ``thresholds``.

A subclass implements ``_predict_all_dev(X) -> [N, 2K+1]``: one packed
tensor of raw | prob | prediction computed on the model's device, so a
micro-batch costs one device→host copy.  That copy, and a head's upload
of host features, are recorded in the transfer ledger.

**The host-serve crossover**, the JAX package's placement rule: a model
with a host path (``_predict_raw_prob_host``: the MLP and LR heads, in
numpy) serves a batch whose features are host numpy, of at most
``SNTC_SERVE_HOST_ROWS`` rows, on the host, from ``transform`` and
``transform_async`` alike; a larger batch, a model without a host path,
or features already in a tensor (a batch ``pad_assemble`` padded on the
card, a stage's device output) dispatch the packed device program, so
the rule never adds a round trip.  Unset, the variable defaults to the
head's ``HOST_SERVE_ROWS``, set from the H100 readings of
``chip_smoke.py`` phase 15 (c).  It is a placement rule, never a
response to an error, and a fused segment does not consult it: it calls
``_predict_all_dev`` itself.  Set the variable to 0 to serve every batch
on the device.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from sntc_tpu_torch.core.base import Estimator, Model
from sntc_tpu_torch.core.frame import Frame, to_host
from sntc_tpu_torch.core.params import Param, validators
from sntc_tpu_torch.utils.profiling import (
    active_ledgers,
    record_movement,
    upload,
)


class ClassifierParams:
    featuresCol = Param("feature vector column", default="features")
    labelCol = Param("label index column", default="label")
    predictionCol = Param("output prediction column", default="prediction")
    rawPredictionCol = Param("output margins column", default="rawPrediction")
    probabilityCol = Param("output probability column", default="probability")


class CheckpointParams:
    """Mid-fit checkpoint/resume: with both params set, an estimator
    saves its state every ``checkpointInterval`` boosting rounds under
    ``checkpointDir`` (``mlio/optimizer_checkpoint.py``), and a re-run
    fit with the same directory resumes where it stopped."""

    checkpointInterval = Param(
        "persist optimizer state every N iterations/boosting rounds "
        "(-1 = off); a re-run fit with the same checkpointDir resumes",
        default=-1,
    )
    checkpointDir = Param("directory for mid-fit optimizer state", default=None)


class ClassifierEstimator(ClassifierParams, Estimator):
    """Base estimator: extracts (X, y, w) from the frame, on the host."""

    weightCol = Param("optional row weight column", default=None)

    def _extract(self, frame: Frame):
        X = to_host(frame[self.getFeaturesCol()])
        if X.ndim != 2:
            raise ValueError(
                f"featuresCol {self.getFeaturesCol()!r} must be a vector "
                "column (use VectorAssembler)"
            )
        X = X.astype(np.float32, copy=False)
        y_raw = to_host(frame[self.getLabelCol()]).astype(np.float64)
        y = y_raw.astype(np.int32)
        if not np.array_equal(y_raw, y.astype(np.float64)) or (y < 0).any():
            raise ValueError("labelCol must contain non-negative integer indices")
        wcol = self.getWeightCol()
        w = (
            to_host(frame[wcol]).astype(np.float32)
            if wcol
            else np.ones(len(y), dtype=np.float32)
        )
        return X, y, w


def pack_serve_outputs(raw: torch.Tensor, prob: torch.Tensor,
                       thr: torch.Tensor, mode: str) -> torch.Tensor:
    """probability→prediction under ``mode`` (see ``_threshold_mode``),
    then raw | prob | prediction packed into ONE ``[N, 2K+1]`` tensor."""
    if mode == "thresholds":
        zero = thr == 0
        scaled = prob / torch.where(zero, torch.ones_like(thr), thr)[None, :]
        inf = torch.full_like(prob, float("inf"))
        scaled = torch.where(
            zero[None, :], torch.where(prob > 0, inf, -inf), scaled
        )
        pred = torch.argmax(scaled, dim=1)
    elif mode == "binary":
        pred = (prob[:, 1] > thr[0]).long()
    else:
        pred = torch.argmax(prob, dim=1)
    return torch.cat([raw, prob, pred[:, None].to(raw.dtype)], dim=1)


class DeviceHeadMixin:
    """Serving inputs of a head whose parameters live on ``self.device``
    (set ``self._thr_cache = None`` at construction): the features as
    float32 on that device, and the threshold vector, rebuilt only when
    the threshold params change."""

    def _serve_args(self):
        mode, thr = self._threshold_mode()
        key = (mode, thr.tobytes())
        if self._thr_cache is None or self._thr_cache[0] != key:
            self._thr_cache = (key, torch.from_numpy(thr).to(self.device))
        return mode, self._thr_cache[1]

    def _features_on_device(self, X) -> torch.Tensor:
        if isinstance(X, torch.Tensor):
            return X.to(device=self.device, dtype=torch.float32)
        return upload(np.require(X, np.float32, ["C", "W"]), self.device)

    def replica_on(self, device):
        """This head with its parameters on ``device``, built once a
        device through its own save/load pair and sharing this head's
        params (a threshold set here holds there): a serve mesh's row
        block runs on its shard's device."""
        device = torch.device(device)
        replicas = self.__dict__.setdefault("_replicas", {})
        rep = replicas.get(device)
        if rep is None:
            extra, arrays = self._save_extra()
            rep = type(self)._load_from(self.paramValues(), extra, arrays,
                                        device)
            rep._paramMap = self._paramMap
            rep = replicas.setdefault(device, rep)
        return rep


class ClassificationModel(ClassifierParams, Model):
    """Base fitted model: margins -> probability -> prediction columns."""

    threshold = Param(
        "binary decision threshold on P(class 1)",
        default=0.5,
        validator=validators.in_range(0.0, 1.0),
    )
    thresholds = Param(
        "per-class thresholds (length numClasses, at most one zero); "
        "prediction = argmax(probability[k] / thresholds[k])",
        default=None,
    )

    @property
    def num_classes(self) -> int:
        raise NotImplementedError

    def _predict_all_dev(self, X) -> torch.Tensor:
        """Packed ``[N, 2K+1]`` raw | prob | prediction on the model's
        device (enqueued, not waited for)."""
        raise NotImplementedError

    def has_device_serve(self) -> bool:
        """True when this model has a packed device program
        (``_predict_all_dev``): the capability the fusion planner checks
        before fusing a head into a segment."""
        return (type(self)._predict_all_dev
                is not ClassificationModel._predict_all_dev)

    def _raw_predict(self, X) -> torch.Tensor:
        """Margins ``[N, K]`` on the model's device (K=2 for binary:
        ``[-margin, margin]``): the raw block of the packed program."""
        return self._predict_all_dev(X)[:, : self.num_classes]

    def _threshold_mode(self):
        """(mode, thr) describing the probability→prediction rule:
        ``mode`` picks the rule, ``thr`` is its float32 parameter
        vector."""
        ts = self.getThresholds()
        if ts is not None:
            ts = np.asarray(ts, np.float64)
            if ts.shape != (self.num_classes,):
                raise ValueError(
                    f"thresholds length {ts.shape} must equal "
                    f"numClasses {self.num_classes}"
                )
            if (ts < 0).any() or (ts == 0).sum() > 1:
                raise ValueError(
                    "thresholds must be non-negative with at most one zero"
                )
            return "thresholds", ts.astype(np.float32)
        if self.num_classes == 2:
            return "binary", np.asarray([self.getThreshold()], np.float32)
        return "argmax", np.zeros(1, np.float32)

    def serve_flops(self, n_rows: int) -> float:
        """FLOPs of the matrix products of the packed serve program on
        ``n_rows`` rows (a fused segment's roofline counts them); 0 for a
        head that runs none."""
        return 0.0

    # the most rows of host features served on the host when
    # SNTC_SERVE_HOST_ROWS is unset (a head with a host path sets it)
    HOST_SERVE_ROWS = 0

    def _predict_raw_prob_host(self, X: np.ndarray):
        """The host (numpy) predict path ``(raw, prob)`` of a float32
        feature matrix, where a subclass has one: the crossover serves a
        batch of at most :meth:`_host_serve_rows` rows through it."""
        raise NotImplementedError

    def has_host_serve(self) -> bool:
        """True when this model has a host predict path."""
        return (type(self)._predict_raw_prob_host
                is not ClassificationModel._predict_raw_prob_host)

    def _host_serve_rows(self) -> int:
        env = os.environ.get("SNTC_SERVE_HOST_ROWS")
        return self.HOST_SERVE_ROWS if env is None else int(env)

    def _prob_to_prediction(self, prob: np.ndarray) -> np.ndarray:
        """The probability→prediction rule of :meth:`_threshold_mode`,
        in numpy (float64 indices)."""
        mode, thr = self._threshold_mode()
        if mode == "thresholds":
            ts = thr.astype(np.float64)
            zero = ts == 0
            scaled = prob / np.where(zero, 1.0, ts)
            # Spark: p/0 -> +inf when p > 0; a 0/0 class never wins
            scaled = np.where(
                zero[None, :], np.where(prob > 0, np.inf, -np.inf), scaled
            )
            return np.argmax(scaled, axis=1).astype(np.float64)
        if mode == "binary":
            return (prob[:, 1] > thr[0]).astype(np.float64)
        return np.argmax(prob, axis=1).astype(np.float64)

    def _build_output(self, frame: Frame, raw, prob) -> Frame:
        out = frame
        if self.getRawPredictionCol():
            out = out.with_column(self.getRawPredictionCol(), raw)
        if self.getProbabilityCol():
            out = out.with_column(self.getProbabilityCol(), prob)
        if self.getPredictionCol():
            out = out.with_column(self.getPredictionCol(),
                                  self._prob_to_prediction(prob))
        return out

    def transform(self, frame: Frame) -> Frame:
        return self.transform_async(frame)()

    def transform_async(self, frame: Frame):
        """Host features at or below the host-serve crossover, on a model
        with a host path, are served on the host (see the module docs).
        Otherwise enqueue the packed device program; finalize copies it
        to the host once and splits it into the output columns."""
        X = frame[self.getFeaturesCol()]
        if self.has_host_serve() and not isinstance(X, torch.Tensor) \
                and X.shape[0] <= self._host_serve_rows():
            out = self._build_output(frame, *self._predict_raw_prob_host(
                np.asarray(X).astype(np.float32, copy=False)))
            return lambda: out
        packed_dev = self._predict_all_dev(X)
        ledgers = active_ledgers()

        def finalize():
            packed = packed_dev.cpu().numpy()
            record_movement(ledgers, downloads=1, download_bytes=packed.nbytes)
            return self._with_packed(frame, packed)

        return finalize

    def _with_packed(self, frame: Frame, packed: np.ndarray) -> Frame:
        """``frame`` with the output columns of a host copy of the packed
        ``[N, 2K+1]`` raw | prob | prediction block."""
        k = self.num_classes
        out = frame
        if self.getRawPredictionCol():
            out = out.with_column(self.getRawPredictionCol(), packed[:, :k])
        if self.getProbabilityCol():
            out = out.with_column(
                self.getProbabilityCol(), packed[:, k : 2 * k]
            )
        if self.getPredictionCol():
            out = out.with_column(
                self.getPredictionCol(), packed[:, 2 * k].astype(np.float64)
            )
        return out
