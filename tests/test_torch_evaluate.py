"""The port's multiclass evaluator (every metric name), its ``evaluate``
command and ``train --estimator nb|svc`` against the JAX package's, on
the CPU.

Inputs: numpy-seeded labels, predictions, probabilities and row weights
(multiples of 1/4, exact in the JAX package's f32 confusion sums) for
the evaluator; 3 000 flows of the JAX package's synthetic generator
(seed 4) written as one day CSV for the commands.

Tolerances, each with what it measured here when set:

* every metric name, ``metricLabel`` (an absent class too), ``beta``,
  ``eps`` and ``weightCol``: within 1e-12 of the JAX evaluator's value
  (equal);
* ``evaluate`` on a JAX-saved and on a port-saved gaussian naive-Bayes
  pipeline: the JAX command's value within 1e-12 (equal);
* ``train --estimator nb`` against the JAX command on the same CSVs:
  held-out macro-F1 within 1e-3 (equal: the two models' float64
  likelihoods pick the same classes); ``--estimator svc`` (OneVsRest
  over LinearSVC, 100 LBFGS iterations per class, whose paths part once
  a hinge kink is crossed at another iterate; 15 classes, some of a few
  dozen rows): within 0.05 (0.0249: 0.6949 against 0.6700).
"""

import argparse
import io
import json
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

import sntc_tpu.app as jax_app
from sntc_tpu.app import _serving_form as jax_serving_form
from sntc_tpu.core.frame import Frame as JFrame
from sntc_tpu.evaluation import (
    MulticlassClassificationEvaluator as JEvaluator,
)
from sntc_tpu.fuse.planner import FusedSegment as JFusedSegment
from sntc_tpu.mlio import load_model as jax_load_model
from sntc_tpu.parallel.context import get_default_mesh
from sntc_tpu.data.synth import generate_frame as jax_generate_frame
from sntc_tpu_torch.app import build_parser, main, serving_form
from sntc_tpu_torch.core.frame import Frame
from sntc_tpu_torch.data import write_raw_csv
from sntc_tpu_torch.evaluation import MulticlassClassificationEvaluator
from sntc_tpu_torch.evaluation.multiclass import METRIC_NAMES
from sntc_tpu_torch.fuse import FusedSegment
from sntc_tpu_torch.mlio import load_model
from sntc_tpu_torch.models import LinearSVCModel, NaiveBayesModel
from jax_metrics_guard import own_jax_registry  # noqa: F401

torch.set_num_threads(1)

F1_MARGIN = {"nb": 1e-3, "svc": 0.05}


def _frame(n=600, k=5, seed=0):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, k, n).astype(np.float64)
    pred = np.where(rng.random(n) < 0.7, y,
                    rng.integers(0, k, n)).astype(np.float64)
    logits = rng.normal(size=(n, k))
    logits[np.arange(n), pred.astype(int)] += 2.0
    prob = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    prob[:5, :] = np.eye(k)[(y[:5].astype(int) + 1) % k]  # p_true == 0
    return {"label": y, "prediction": pred, "probability": prob,
            "w": rng.integers(1, 9, n) / 4.0}


CASES = [(name, {}) for name in METRIC_NAMES] + [
    ("precisionByLabel", {"metricLabel": 3.0}),
    ("falsePositiveRateByLabel", {"metricLabel": 2.0, "weightCol": "w"}),
    ("recallByLabel", {"metricLabel": 7.0}),  # absent from the frame
    ("fMeasureByLabel", {"metricLabel": 1.0, "beta": 0.5}),
    ("weightedFMeasure", {"beta": 2.0, "weightCol": "w"}),
    ("f1", {"weightCol": "w"}),
    ("logLoss", {"eps": 1e-3}),
    ("logLoss", {"weightCol": "w"}),
    ("hammingLoss", {"weightCol": "w"}),
]


@pytest.mark.parametrize("name,params", CASES,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(CASES)])
def test_every_metric_name_matches_the_jax_evaluator(name, params):
    cols = _frame()
    port = MulticlassClassificationEvaluator(metricName=name, **params)
    ref = JEvaluator(metricName=name, **params)
    a, b = port.evaluate(Frame(cols)), ref.evaluate(JFrame(cols))
    assert abs(a - b) <= 1e-12 * max(1.0, abs(b)), (a, b)
    assert port.isLargerBetter() == ref.isLargerBetter()
    # a tensor prediction column reads the same
    tcols = dict(cols, prediction=torch.from_numpy(cols["prediction"]))
    assert port.evaluate(Frame(tcols)) == a


def test_metric_names_are_the_jax_evaluators():
    assert METRIC_NAMES == JEvaluator._METRICS
    assert MulticlassClassificationEvaluator._METRICS == METRIC_NAMES
    assert build_parser().parse_args(
        ["evaluate", "--data", "d", "--model", "m", "--metric",
         "hammingLoss"]).metric == "hammingLoss"
    with pytest.raises(ValueError):
        MulticlassClassificationEvaluator(metricName="auc")


# -- the commands --------------------------------------------------------------


def _jax_args(cmd, **kw):
    base = dict(label_col="Label", binary=False, metric="macroF1", seed=0,
                test_fraction=0.2, max_iter=100, reg_param=1e-4,
                layers="78,64,15", num_trees=20, max_depth=5, step_size=0.1,
                max_bins=128, chisq_top=0, features_col="features",
                device_trace=None, model_out=None)
    base.update(kw)
    return argparse.Namespace(**base)


def _run(fn, *args) -> dict:
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert fn(*args) == 0
    return json.loads(buf.getvalue().strip().splitlines()[-1])


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """``train --estimator nb|svc`` by both packages' commands on one day
    CSV: ``{estimator: (port line, JAX line)}``, and the data dir."""
    root = tmp_path_factory.mktemp("cmds")
    raw = jax_generate_frame(3000, seed=4, min_class_fraction=0.005)
    (root / "data").mkdir()
    write_raw_csv(Frame({c: np.asarray(raw[c]) for c in raw.columns}),
                  str(root / "data" / "day.csv"))
    data = str(root / "data")
    out = {"data": data}
    for est in ("nb", "svc"):
        port = _run(main, ["train", "--data", data, "--estimator", est,
                           "--model-out", str(root / f"port_{est}"),
                           "--device", "cpu"])
        ref = _run(jax_app._cmd_train_body,
                   _jax_args("train", data=data, estimator=est,
                             model_out=str(root / f"jax_{est}")),
                   get_default_mesh())
        out[est] = (port, ref)
    return out


@pytest.mark.parametrize("est", ["nb", "svc"])
def test_train_command_reaches_the_jax_commands_macro_f1(trained, est):
    port, ref = trained[est]
    assert port["estimator"] == est and port["train_rows"] == ref["train_rows"]
    assert abs(port["macroF1"] - ref["macroF1"]) <= F1_MARGIN[est], (
        port["macroF1"], ref["macroF1"])
    assert port["kernel_launches"] == {"forest_traversal": 0,
                                       "pad_assemble": 0, "tree_hist": 0}
    head = load_model(port["model_out"], device="cpu").getStages()[-1]
    if est == "nb":
        assert isinstance(head, NaiveBayesModel)
        assert head.getModelType() == "gaussian"
        assert head.getFeaturesCol() == "rawFeatures"
    else:
        assert all(isinstance(m, LinearSVCModel) for m in head.models)
        assert len(port["lbfgs"]) == len(head.models)
        assert all(0 < s["iterations"] <= 100 for s in port["lbfgs"])


@pytest.mark.parametrize("est,want", [
    ("nb", ["VectorAssembler", "NaiveBayesModel", "IndexToString"]),
    ("svc", ["VectorAssembler", ["StandardScalerModel"], "OneVsRestModel",
             "IndexToString"]),
])
def test_saved_pipelines_serve_and_partition_as_the_jax_package(
    trained, est, want, tmp_path
):
    path = trained[est][0]["model_out"]
    jserved, _, _ = jax_serving_form(jax_load_model(path), "label", True)
    served, _, _ = serving_form(load_model(path, device="cpu"), "label", True)

    def partition(model, seg):
        return [[type(s).__name__ for s in st.fused_stages]
                if isinstance(st, seg) else type(st).__name__
                for st in model.getStages()]

    assert partition(jserved, JFusedSegment) == want
    assert partition(served, FusedSegment) == want
    inp = tmp_path / "in"
    inp.mkdir()
    live = jax_generate_frame(400, seed=6, dirty=False).drop("Label")
    write_raw_csv(Frame({c: np.asarray(live[c]) for c in live.columns}),
                  str(inp / "part_0000.csv"))
    summary = _run(main, ["serve", "--model", path, "--watch", str(inp),
                          "--out", str(tmp_path / "out"), "--checkpoint",
                          str(tmp_path / "ckpt"), "--shape-buckets", "256",
                          "--once", "--device", "cpu"])
    assert summary["batches"] == 1 and summary["rows"] == 400


@pytest.mark.parametrize("saved_by", ["jax", "port"])
@pytest.mark.parametrize("metric", ["macroF1", "accuracy", "hammingLoss",
                                    "logLoss"])
def test_evaluate_command_prints_the_jax_commands_value(trained, saved_by,
                                                        metric):
    path = trained["nb"][0 if saved_by == "port" else 1]["model_out"]
    port = _run(main, ["evaluate", "--data", trained["data"], "--model",
                       path, "--metric", metric, "--device", "cpu"])
    ref = _run(jax_app.cmd_evaluate,
               _jax_args("evaluate", data=trained["data"], model=path,
                         metric=metric))
    assert set(port) == {"rows", metric} and port["rows"] == ref["rows"]
    assert abs(port[metric] - ref[metric]) <= 1e-12 * max(1.0, abs(ref[metric]))
