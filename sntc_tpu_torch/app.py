"""Command-line entry point of the port.

    python -m sntc_tpu_torch train --data data/days \\
        [--estimator mlp|lr|rf|gbt|dt] [--binary] [--layers 78,64,15] \\
        [--reg-param 1e-4] [--chisq-top 40] [--num-trees 20] \\
        [--max-depth 10] [--max-iter 100] [--step-size 0.1] \\
        [--max-bins 128] [--model-out m/] [--device cuda|cpu]
    python -m sntc_tpu_torch serve --model m/ --watch data/in \\
        --out data/out --checkpoint data/ckpt [--shape-buckets N] \\
        [--max-files-per-batch N] [--once] [--device cuda|cpu]

``train`` is the counterpart of ``cmd_train`` in ``sntc_tpu/app.py``:
read and clean every CSV of ``--data``, split off ``--test-fraction``
with ``--seed``, fit StringIndexer → VectorAssembler(78) → [ChiSqSelector
top ``--chisq-top``, or StandardScaler(withMean) for ``mlp``/``lr``] →
the estimator, report the held-out ``--metric`` as one JSON line (with
the kernel launch counts, and the LBFGS iterations, evaluations and
host reads of an ``mlp``/``lr`` fit), and save the fitted pipeline to
``--model-out`` in the format both packages load.  Ported so far: the
multilayer perceptron (``mlp``, the default: ``--layers``, which track
the data's width and class count while left at their default, and
``--max-iter`` LBFGS iterations; bench config 2), logistic regression
(``lr``: ``--reg-param``, ``--max-iter``; bench config 1 with
``--binary``), the random forest (``rf``), OneVsRest over
gradient-boosted trees (``gbt``: ``--max-iter`` rounds of
``--step-size``, bench config 4 with ``--chisq-top 0 --max-iter 10
--max-depth 4``) and the single decision tree (``dt``); ``gbt`` and
``dt`` bin ``--max-bins`` ways.

``serve`` is the counterpart of ``cmd_serve`` in its plain form: load a
saved pipeline, take off the LABEL ``StringIndexerModel`` (live
flows carry no label), map predictions back to label strings with
``IndexToString``, and serve every CSV micro-batch in the watch
directory through a shape-bucketed ``BatchPredictor``, one
``batch_*.csv`` of ``prediction`` and ``predictedLabel`` per batch,
committing offsets so a restart resumes exactly once.  The pipeline is
served staged (the JAX package's ``--no-fuse`` form).
"""

from __future__ import annotations

import argparse
import json
import signal
import sys
import time
from typing import List, Optional

from sntc_tpu_torch.device import resolve_device


def strip_label_indexer(model, label_index_col: str):
    """Remove the LABEL indexing while keeping any feature-column
    indexing; returns ``(stages, labels)`` with ``labels`` None when no
    label indexer was found."""
    from sntc_tpu_torch.feature.string_indexer import (
        StringIndexerModel,
        _resolve_cols,
    )

    stages, labels = [], None
    for s in model.getStages():
        if isinstance(s, StringIndexerModel):
            ins, outs = _resolve_cols(s)
            if label_index_col in outs:
                j = outs.index(label_index_col)
                labels = s.labelsArray[j]
                keep = [k for k in range(len(outs)) if k != j]
                if keep:
                    reduced = StringIndexerModel(
                        labelsArray=[s.labelsArray[k] for k in keep],
                    )
                    reduced.setParams(
                        inputCols=[ins[k] for k in keep],
                        outputCols=[outs[k] for k in keep],
                        handleInvalid=s.getHandleInvalid(),
                        stringOrderType=s.getStringOrderType(),
                    )
                    stages.append(reduced)
                continue
        stages.append(s)
    return stages, labels


def serving_form(model, label_index_col: str = "label"):
    """One loaded checkpoint → its servable form: ``(model, labels,
    out_cols)``."""
    from sntc_tpu_torch.core.base import PipelineModel
    from sntc_tpu_torch.feature.string_indexer import IndexToString

    out_cols = ["prediction"]
    labels = None
    if isinstance(model, PipelineModel):
        stages, labels = strip_label_indexer(model, label_index_col)
        tail = []
        if labels is not None:
            tail = [IndexToString(
                inputCol="prediction", outputCol="predictedLabel",
                labels=labels,
            )]
            out_cols = ["prediction", "predictedLabel"]
        model = PipelineModel(stages=stages + tail)
    return model, labels, out_cols


# estimators of the JAX package's train command, and those ported
TRAIN_ESTIMATORS = ["lr", "mlp", "rf", "gbt", "dt", "nb", "svc"]
PORTED_ESTIMATORS = ["lr", "mlp", "rf", "gbt", "dt"]
TRAIN_DEFAULT_LAYERS = "78,64,15"


def _build_estimator(args, device):
    """The estimator ``--estimator`` names, as the JAX command builds
    it."""
    from sntc_tpu_torch.models import (
        DecisionTreeClassifier,
        GBTClassifier,
        LogisticRegression,
        MultilayerPerceptronClassifier,
        OneVsRest,
        RandomForestClassifier,
    )

    if args.estimator == "lr":
        return LogisticRegression(
            device=device, maxIter=args.max_iter, regParam=args.reg_param
        )
    if args.estimator == "mlp":
        layers = [int(v) for v in args.layers.split(",")]
        return MultilayerPerceptronClassifier(
            device=device, layers=layers, maxIter=args.max_iter,
            seed=args.seed,
        )
    if args.estimator == "rf":
        return RandomForestClassifier(
            device=device, numTrees=args.num_trees, maxDepth=args.max_depth,
            seed=args.seed,
        )
    if args.estimator == "gbt":
        return OneVsRest(
            classifier=GBTClassifier(
                device=device, maxIter=args.max_iter, maxDepth=args.max_depth,
                stepSize=args.step_size, seed=args.seed,
                maxBins=args.max_bins,
            ),
        )
    return DecisionTreeClassifier(
        device=device, maxDepth=args.max_depth, maxBins=args.max_bins,
        seed=args.seed,
    )


def _feature_stages(args, device, with_scaler: bool):
    from sntc_tpu_torch.data import CICIDS2017_FEATURES
    from sntc_tpu_torch.feature import (
        ChiSqSelector,
        StandardScaler,
        StringIndexer,
        VectorAssembler,
    )

    stages = [
        StringIndexer(inputCol=args.label_col, outputCol="label",
                      handleInvalid="skip"),
        VectorAssembler(inputCols=CICIDS2017_FEATURES,
                        outputCol="rawFeatures", handleInvalid="skip"),
    ]
    if args.chisq_top:
        stages.append(ChiSqSelector(
            device=device, numTopFeatures=args.chisq_top,
            featuresCol="rawFeatures", labelCol="label",
            outputCol=args.features_col,
        ))
    elif with_scaler:
        stages.append(StandardScaler(
            device=device, inputCol="rawFeatures",
            outputCol=args.features_col, withMean=True,
        ))
    return stages


def _track_layers(args, train, n_features: int) -> None:
    """Default ``--layers`` follow the data's width and class count; a
    non-default mismatch is refused."""
    import numpy as np

    n_classes = int(np.unique(train[args.label_col].astype(str)).size)
    layers = [int(v) for v in args.layers.split(",")]
    is_default = args.layers == TRAIN_DEFAULT_LAYERS
    for pos, want, what in (
        (0, n_features, "input width / feature count"),
        (-1, n_classes, "output width / class count"),
    ):
        if layers[pos] != want:
            if is_default:
                layers[pos] = want  # default layers track the data
            else:
                raise SystemExit(
                    f"--layers {what} mismatch: {layers[pos]} != {want}"
                )
    args.layers = ",".join(str(v) for v in layers)


def _load_data(args):
    import numpy as np

    from sntc_tpu_torch.data import clean_flows, load_csv_dir

    df = clean_flows(load_csv_dir(args.data))
    if args.binary:
        df = df.with_column(
            args.label_col,
            np.where(
                df[args.label_col].astype(str) == "BENIGN", "benign", "attack"
            ).astype(object),
        )
    return df


def cmd_train(args) -> int:
    from sntc_tpu_torch.core.base import Pipeline
    from sntc_tpu_torch.data import CICIDS2017_FEATURES
    from sntc_tpu_torch.evaluation import MulticlassClassificationEvaluator
    from sntc_tpu_torch.kernels import LAUNCHES
    from sntc_tpu_torch.mlio import save_model

    if args.estimator not in PORTED_ESTIMATORS:
        raise SystemExit(
            f"estimator {args.estimator!r} is not ported yet (ported: "
            f"{', '.join(PORTED_ESTIMATORS)})"
        )
    device = resolve_device(args.device)
    if device.type == "cuda":
        from sntc_tpu_torch.kernels._build import library

        library()  # build (or load) the kernels before the fit is timed
    df = _load_data(args)
    train, test = df.random_split(
        [1 - args.test_fraction, args.test_fraction], seed=args.seed
    )
    with_scaler = args.estimator in ("lr", "mlp")
    # the estimator reads the last feature stage's column: the selector's
    # or the scaler's output, or the assembler's unscaled features (the
    # trees) without either
    features_col = (args.features_col if args.chisq_top or with_scaler
                    else "rawFeatures")
    if args.estimator == "mlp":
        _track_layers(args, train,
                      args.chisq_top or len(CICIDS2017_FEATURES))
    est = _build_estimator(args, device)
    est.set("featuresCol", features_col)
    pipe = Pipeline(stages=_feature_stages(args, device, with_scaler) + [est])
    t0 = time.perf_counter()
    model = pipe.fit(train)
    fit_s = time.perf_counter() - t0
    value = MulticlassClassificationEvaluator(
        metricName=args.metric
    ).evaluate(model.transform(test))
    if args.model_out:
        save_model(model, args.model_out)
    line = {
        "estimator": args.estimator, "train_rows": train.num_rows,
        "fit_wall_clock_s": round(fit_s, 3), args.metric: value,
        "model_out": args.model_out, "kernel_launches": dict(LAUNCHES),
    }
    stats = getattr(model.getStages()[-1], "optimizer_stats", None)
    if stats is not None:
        line["lbfgs"] = stats
    print(json.dumps(line))
    return 0


def cmd_serve(args) -> int:
    from sntc_tpu_torch.kernels import LAUNCHES
    from sntc_tpu_torch.mlio import load_model
    from sntc_tpu_torch.serve import (
        CsvDirSink,
        FileStreamSource,
        StreamingQuery,
    )

    device = resolve_device(args.device)
    if device.type == "cuda":
        from sntc_tpu_torch.kernels._build import library

        library()  # build (or load) the kernels before the first batch
    model, _labels, out_cols = serving_form(
        load_model(args.model, device=device), args.label_index_col
    )
    q = StreamingQuery(
        model,
        FileStreamSource(args.watch),
        CsvDirSink(args.out, columns=out_cols),
        args.checkpoint,
        max_batch_offsets=args.max_files_per_batch,
        shape_buckets=args.shape_buckets,
        device=device,
    )
    try:
        if args.once:
            t0 = time.perf_counter()
            n = q.process_available()
            seconds = time.perf_counter() - t0
            print(json.dumps({
                "batches": n,
                "rows": q.rows_served,
                "seconds": seconds,
                "device": str(device),
                "kernel_launches": dict(LAUNCHES),
                "compile_events": q.predictor.compile_events,
                "progress": q.recentProgress,
            }))
            return 0
        # poll loop: SIGTERM / Ctrl-C stops between batches; a restart on
        # the same checkpoint resumes exactly once from the offset log
        stop = []
        signal.signal(signal.SIGTERM, lambda *_: stop.append(1))
        try:
            while not stop:
                if q.process_available() == 0:
                    time.sleep(args.poll_interval)
        except KeyboardInterrupt:
            pass
        return 0
    finally:
        q.close()


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="sntc_tpu_torch",
        description="PyTorch/CUDA training and serving of sntc_tpu pipelines",
    )
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("train", help="fit a pipeline, report held-out metric")
    p.add_argument("--data", required=True,
                   help="directory of CICIDS2017-schema day CSVs")
    p.add_argument("--label-col", default="Label")
    p.add_argument("--binary", action="store_true",
                   help="benign-vs-attack relabel")
    p.add_argument("--metric", default="macroF1",
                   choices=["macroF1", "f1", "accuracy", "weightedPrecision",
                            "weightedRecall"])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--estimator", default="mlp", choices=TRAIN_ESTIMATORS)
    p.add_argument("--model-out", default=None)
    p.add_argument("--test-fraction", type=float, default=0.2)
    p.add_argument("--max-iter", type=int, default=100,
                   help="LBFGS iterations (mlp, lr); boosting rounds (gbt)")
    p.add_argument("--reg-param", type=float, default=1e-4,
                   help="regularization strength (lr)")
    p.add_argument("--layers", default=TRAIN_DEFAULT_LAYERS,
                   help="layer sizes (mlp); the default tracks the data's "
                   "width and class count")
    p.add_argument("--num-trees", type=int, default=20)
    p.add_argument("--max-depth", type=int, default=5)
    p.add_argument("--step-size", type=float, default=0.1,
                   help="boosting shrinkage (gbt)")
    p.add_argument("--max-bins", type=int, default=128,
                   help="quantile bins per feature (gbt, dt)")
    p.add_argument("--chisq-top", type=int, default=0,
                   help="if > 0, select this many features by chi-square")
    p.add_argument("--features-col", default="features")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without CUDA) or cpu")
    p.set_defaults(fn=cmd_train)

    p = sub.add_parser("serve", help="serve CSV micro-batches of a directory")
    p.add_argument("--model", required=True, help="saved pipeline directory")
    p.add_argument("--watch", required=True, help="input CSV directory")
    p.add_argument("--out", required=True, help="output CSV directory")
    p.add_argument("--checkpoint", required=True,
                   help="offset/commit WAL directory (exactly-once resume)")
    p.add_argument("--label-index-col", default="label",
                   help="outputCol of the LABEL StringIndexer to strip")
    p.add_argument("--max-files-per-batch", type=int, default=None,
                   help="micro-batch size in source files (default: all "
                   "available files form one batch)")
    p.add_argument("--shape-buckets", type=int, default=0,
                   help="pad micro-batches up to power-of-two row buckets "
                   "with this floor (0 = off)")
    p.add_argument("--once", action="store_true",
                   help="drain available files, print a JSON summary, exit")
    p.add_argument("--poll-interval", type=float, default=1.0)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without CUDA) or cpu")
    p.set_defaults(fn=cmd_serve)
    return ap


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
