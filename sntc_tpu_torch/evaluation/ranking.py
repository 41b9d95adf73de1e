"""RankingEvaluator and MultilabelClassificationEvaluator (Spark 3.0).

Counterpart of ``sntc_tpu/evaluation/ranking.py`` (Spark's
``RankingMetrics`` and ``MultilabelMetrics``).

RankingEvaluator (prediction: a ranked id array; label: the relevant
ids): ``meanAveragePrecision``, ``meanAveragePrecisionAtK`` (the sum cut
at k over ``min(|relevant|, k)``), ``precisionAtK`` (hits in the first k
over k), ``recallAtK`` (over ``|relevant|``) and ``ndcgAtK`` (binary
gains ``1/log2(i+2)`` against the ideal prefix).

MultilabelClassificationEvaluator (prediction and label: label sets):
subsetAccuracy, accuracy (the mean Jaccard; a row with both sets empty
is 0/0 = NaN, as Spark's bare division gives), hammingLoss (over the
distinct values of the LABEL column), the document-averaged
precision/recall/f1Measure, and micro precision/recall/F1 over global
counts.

Set arithmetic over ragged id arrays on the host, as in the JAX package.
"""

from __future__ import annotations

import numpy as np

from sntc_tpu_torch.core.base import Evaluator
from sntc_tpu_torch.core.frame import Frame
from sntc_tpu_torch.core.params import Param, validators


class RankingEvaluator(Evaluator):
    _METRICS = (
        "meanAveragePrecision",
        "meanAveragePrecisionAtK",
        "precisionAtK",
        "ndcgAtK",
        "recallAtK",
    )

    metricName = Param("ranking metric", default="meanAveragePrecision",
                       validator=validators.one_of(*_METRICS))
    predictionCol = Param("ranked predicted-id array column",
                          default="prediction")
    labelCol = Param("relevant-id array column", default="label")
    k = Param("cutoff for the @K metrics", default=10,
              validator=validators.gt(0))

    def evaluate(self, frame: Frame) -> float:
        metric = self.getMetricName()
        k = int(self.getK())
        preds = frame[self.getPredictionCol()]
        labels = frame[self.getLabelCol()]
        vals = []
        for p, l in zip(preds, labels):
            p = list(p)
            rel = set(l)
            if metric == "meanAveragePrecision":
                vals.append(self._avg_precision(p, rel, None))
            elif metric == "meanAveragePrecisionAtK":
                vals.append(self._avg_precision(p, rel, k))
            elif metric == "precisionAtK":
                hits = sum(1 for x in p[:k] if x in rel)
                vals.append(hits / k)
            elif metric == "recallAtK":
                hits = sum(1 for x in p[:k] if x in rel)
                vals.append(hits / max(len(rel), 1))
            else:  # ndcgAtK
                vals.append(self._ndcg(p, rel, k))
        return float(np.mean(vals)) if vals else 0.0

    @staticmethod
    def _avg_precision(p, rel, k) -> float:
        if not rel:
            return 0.0
        cut = p if k is None else p[:k]
        hits, score = 0, 0.0
        for i, x in enumerate(cut):
            if x in rel:
                hits += 1
                score += hits / (i + 1)
        denom = len(rel) if k is None else min(len(rel), k)
        return score / denom

    @staticmethod
    def _ndcg(p, rel, k) -> float:
        if not rel:
            return 0.0
        dcg = sum(
            1.0 / np.log2(i + 2) for i, x in enumerate(p[:k]) if x in rel
        )
        ideal = sum(
            1.0 / np.log2(i + 2) for i in range(min(len(rel), k))
        )
        return float(dcg / ideal)


class MultilabelClassificationEvaluator(Evaluator):
    _METRICS = (
        "subsetAccuracy",
        "accuracy",
        "hammingLoss",
        "precision",
        "recall",
        "f1Measure",
        "microPrecision",
        "microRecall",
        "microF1Measure",
    )

    metricName = Param("multilabel metric", default="f1Measure",
                       validator=validators.one_of(*_METRICS))
    predictionCol = Param("predicted label-set array column",
                          default="prediction")
    labelCol = Param("true label-set array column", default="label")

    def isLargerBetter(self) -> bool:
        return self.getMetricName() != "hammingLoss"

    def evaluate(self, frame: Frame) -> float:
        metric = self.getMetricName()
        preds = [set(v) for v in frame[self.getPredictionCol()]]
        labels = [set(v) for v in frame[self.getLabelCol()]]
        n = len(preds)
        if n == 0:
            return 0.0
        if metric == "subsetAccuracy":
            return float(np.mean([p == l for p, l in zip(preds, labels)]))
        if metric == "accuracy":
            # Spark's MultilabelMetrics.accuracy: the mean Jaccard with a
            # bare 0/0 division (a row with both sets empty is NaN and
            # poisons the mean, as in Spark)
            return float(np.mean([
                len(p & l) / len(p | l) if (p or l) else float("nan")
                for p, l in zip(preds, labels)
            ]))
        if metric == "hammingLoss":
            # Spark's numLabels is the distinct count over the LABEL
            # column only (MultilabelMetrics.labels)
            universe = set().union(*labels) if labels else set()
            width = max(len(universe), 1)
            return float(
                sum(len(p ^ l) for p, l in zip(preds, labels))
                / (n * width)
            )
        if metric in ("precision", "recall", "f1Measure"):
            # mllib document-averaged forms
            if metric == "precision":
                return float(np.mean([
                    len(p & l) / max(len(p), 1) for p, l in zip(preds, labels)
                ]))
            if metric == "recall":
                return float(np.mean([
                    len(p & l) / max(len(l), 1) for p, l in zip(preds, labels)
                ]))
            return float(np.mean([
                2.0 * len(p & l) / max(len(p) + len(l), 1)
                for p, l in zip(preds, labels)
            ]))
        tp = sum(len(p & l) for p, l in zip(preds, labels))
        fp = sum(len(p - l) for p, l in zip(preds, labels))
        fn = sum(len(l - p) for p, l in zip(preds, labels))
        if metric == "microPrecision":
            return float(tp / max(tp + fp, 1))
        if metric == "microRecall":
            return float(tp / max(tp + fn, 1))
        return float(2.0 * tp / max(2 * tp + fp + fn, 1))
