"""Command-line entry point of the port.

    python -m sntc_tpu_torch train --data data/days \\
        [--estimator mlp|lr|rf|gbt|dt|nb|svc] [--binary] \\
        [--layers 78,64,15] [--metric macroF1] \\
        [--reg-param 1e-4] [--chisq-top 40] [--num-trees 20] \\
        [--max-depth 10] [--max-iter 100] [--step-size 0.1] \\
        [--max-bins 128] [--model-out m/] [--metrics-out PATH] \\
        [--trace-out PATH] [--device-trace DIR] [--device cuda|cpu]
    python -m sntc_tpu_torch serve --model m/ --watch data/in \\
        --out data/out --checkpoint data/ckpt [--shape-buckets N] \\
        [--max-files-per-batch N] [--pipeline-depth 2] \\
        [--prefetch-batches 2] [--read-workers 4] [--fuse|--no-fuse] \\
        [--wal-mode files|append] [--wal-compact-every 256] \\
        [--wal-keep-commits 64] [--batch-retry-attempts 2] \\
        [--max-batch-failures 3] [--dead-letter-keep 200] \\
        [--device-faults|--no-device-faults] [--health-json PATH] \\
        [--max-batch-wall-time S] [--disk-budget-mb MB] \\
        [--row-policy strict|salvage|permissive] [--row-dead-letter DIR] \\
        [--autotune|--no-autotune] [--max-pending-batches N] \\
        [--shed-policy oldest|sample] [--slo-p99-ms MS] \\
        [--slo-min-rows-per-sec R] [--slo-max-shed-rate F] \\
        [--controller|--no-controller] [--partial-fit] \\
        [--drift-window N] [--drift-threshold 0.25] [--promote-from DIR] \\
        [--shadow-window 8] [--promote-margin 0.05] [--metrics-out PATH] \\
        [--trace-out PATH] [--device-trace DIR] [--standby-root DIR] \\
        [--repl-barrier-every 1] [--once] [--device cuda|cpu]
    python -m sntc_tpu_torch evaluate --model m/ --data data/days \\
        [--metric macroF1] [--device cuda|cpu]
    python -m sntc_tpu_torch serve-daemon --tenants T.json --root R \\
        [--shape-buckets N] [--pipeline-depth 1] [--tenant-weight 1] \\
        [--max-rows-per-sec R] [--max-pending-batches N] \\
        [--quarantine-after 3] [--quarantine-cooldown 30] \\
        [--stop-after 3] [--controller] [--root-disk-budget-mb MB] \\
        [--health-json PATH] [--standby-root DIR] [--once] \\
        [--device cuda|cpu]
    python -m sntc_tpu_torch fleet-serve --tenants T.json --root R \\
        [--workers 2 | --worker-ids w0,w1] [--lease-ttl 5] \\
        [--boot-grace 30] [--dead-grace S] [--vnodes 64] [--slack 1.25] \\
        [--drain-timeout 60] [--standby-root DIR] [daemon flags]
    python -m sntc_tpu_torch fsck ROOT [--tenant-tree | --fleet-root] \\
        [--standby DIR] [--no-repair] [--report PATH]
    python -m sntc_tpu_torch fleet-restore-retired ROOT [NAME --dest DIR]

``train`` is the counterpart of ``cmd_train`` in ``sntc_tpu/app.py``:
read and clean every CSV of ``--data``, split off ``--test-fraction``
with ``--seed``, fit StringIndexer → VectorAssembler(78) → [ChiSqSelector
top ``--chisq-top``, or StandardScaler(withMean) for ``mlp``/``lr``/
``svc``] → the estimator, report the held-out ``--metric`` (any name of
the multiclass evaluator) as one JSON line (with the kernel launch
counts, and the LBFGS iterations, evaluations and host reads of an
``mlp``/``lr`` fit, one block per class for ``svc``), and save the
fitted pipeline to ``--model-out`` in the format both packages load.
Every estimator of the JAX command: the multilayer perceptron (``mlp``,
the default: ``--layers``, which track the data's width and class count
while left at their default, and ``--max-iter`` LBFGS iterations; bench
config 2), logistic regression (``lr``: ``--reg-param``,
``--max-iter``; bench config 1 with ``--binary``), the random forest
(``rf``), OneVsRest over gradient-boosted trees (``gbt``:
``--max-iter`` rounds of ``--step-size``, bench config 4 with
``--chisq-top 0 --max-iter 10 --max-depth 4``), the single decision
tree (``dt``), gaussian naive Bayes (``nb``) and OneVsRest over linear
SVMs (``svc``: ``--max-iter``, ``--reg-param``); ``gbt`` and ``dt`` bin
``--max-bins`` ways.  The estimators without a scaler or a selector
read the assembler's unscaled features.

``evaluate`` is the counterpart of ``cmd_evaluate``: load a pipeline
either package saved, read and clean the CSVs of ``--data``, and print
``{"rows": ..., <metric>: ...}`` for the whole of it.

``serve`` is the counterpart of ``cmd_serve``, with its defaults: load
a saved pipeline, take off the LABEL ``StringIndexerModel`` (live flows
carry no label), map predictions back to label strings with
``IndexToString``, compile it with the whole-pipeline fusion compiler
(``--fuse``; ``--no-fuse`` serves it staged), and serve every CSV
micro-batch of the watch directory through a shape-bucketed
``BatchPredictor``, one ``batch_*.csv`` of ``prediction`` and
``predictedLabel`` per batch, committing offsets so a restart resumes
exactly once.  ``--pipeline-depth`` above 1 arms the pipelined engine:
that many batches in flight, the sink write on a delivery thread and
``--prefetch-batches`` background reads; ``--read-workers`` parse a
multi-file batch in parallel; ``--wal-mode`` picks the WAL format.  The
JAX command's ``--no-fuse --pipeline-depth 1 --wal-mode append`` is the
serial, staged form.  The JAX command's failure handling is on by
default: ``--batch-retry-attempts`` tries a batch's read and sink in
place, a batch failing ``--max-batch-failures`` rounds is dead-lettered
(``<checkpoint>/dead_letter/``) and committed, ``--device-faults``
answers CUDA errors on the card (an OOM splits the batch; a device that
keeps failing stops the command non-zero with the batch in the WAL).
``--once`` drains what is there (one round per batch) and prints one
JSON summary line; without it the command runs the supervised loop
(``--health-json``, ``--max-batch-wall-time``, ``--disk-budget-mb``: the
checkpoint root's bytes against a budget, a breach DEGRADED), which
SIGTERM drains, and prints ``{"batches", "drained", "health"}``.
``--row-policy salvage|permissive`` arms row admission against
``CICIDS2017_CONTRACT`` and per-line salvage in the CSV parser: poison
rows and ragged lines are excised into the row dead letters
(``--row-dead-letter``, default ``<checkpoint>/dead_letter_rows/``)
while the clean rows serve; ``strict`` (the default) trusts the input.
``--autotune`` arms the ingest autotuner: ``--read-workers``,
``--prefetch-batches`` and ``--pipeline-depth`` become cold-start values
that it resizes live, every decision an ``autotune_decision`` event.
The supervised loop sheds load past ``--max-pending-batches``
micro-batches of backlog (``--shed-policy oldest`` drops the oldest
offsets, ``sample`` serves the backlog row-subsampled; journaled to
``<checkpoint>/shed.jsonl``).  Any ``--slo-*`` target arms the SLO
controller (``--no-controller`` keeps the knobs at their flags), which
steers the depth, the bucket floor, the shed cap and, through a tuner
of its own, the source's pools, journaling to
``<checkpoint>/controller.jsonl``; with it armed ``--autotune`` builds
no second tuner (one owner a knob).
The model lifecycle: ``--drift-window N`` arms the drift monitor
(``drift_detected``, the model DEGRADED); ``--promote-from DIR`` shadows
a candidate checkpoint and promotes it when its macro-F1 leads by
``--promote-margin`` over ``--shadow-window`` labelled batches (published
over ``--model`` with the incumbent kept at ``.prev``,
``<checkpoint>/model_marker.json`` and ``promotion.jsonl``, swapped in
between batches); ``--partial-fit`` refits a candidate head (LR / NB)
from the live labelled batches.  Only the two that can swap keep the
head out of the fused segments; drift alone keeps full fusion.
``--standby-root DIR`` replicates the checkpoint's durable tree and the
sink to ``DIR/default/`` at each commit, with a sealed barrier every
``--repl-barrier-every`` commits (``resilience.replicate``); the plane
is closed (a final ship and barrier) on every exit, and the summary
line carries its ``status()`` under ``replication``.

``train`` and ``serve`` take the JAX commands' obs flags:
``--metrics-out PATH`` writes the metrics registry as Prometheus text at
exit, ``--trace-out PATH`` arms the span tracer and writes its spans as
Chrome-trace JSON at exit (both also when the run fails), and
``--device-trace DIR`` wraps the fit or the serve in a
``torch.profiler`` capture.  With ``SNTC_OBS_COST_ANALYSIS=1`` the fused
segments also count their roofline (``fusion``'s ``roofline``,
``sntc_mfu_ratio``).

``serve-daemon`` is the counterpart of ``cmd_serve_daemon``: every
tenant of ``--tenants`` (a JSON ``{"tenants": [{"id", "model", "watch",
"out", ...}]}``, each entry overriding any daemon flag's default) is one
engine under ``<root>/tenant/<id>/``, all scheduled on one thread by
``serve.tenancy.ServeDaemon``; tenants that name one checkpoint share
its served model and predictor.  ``--once`` serves what is there, drains
and prints ``{"batches", "tenants": {id: state}, "recompiles_after_warmup",
"drained", "health", ...}``; without it SIGTERM drains.  A device that
keeps failing drains the daemon and exits 1.  ``--standby-root``
replicates every tenant to ``DIR/<id>/``.

``fleet-serve`` is the counterpart of ``cmd_fleet_serve``: a coordinator
(``serve.fleet.FleetCoordinator``) over ``--workers`` worker processes,
each this command re-invoked with ``--fleet-worker-id`` (a
``FleetWorker`` over a ``ServeDaemon`` on ``--device``).  A worker's
line is ``{"worker", "tenants", "device", "device_failed",
"kernel_launches", "pad_launch_shapes"}``; it exits 1 when its device
domain failed (its tenants then migrate off it).
``fleet-restore-retired`` copies a retired dead-source tree into
``--dest`` after verifying it (no NAME lists them).

``fsck`` is the counterpart of ``cmd_fsck``: doctor a serve checkpoint
root (``--tenant-tree``: a serve-daemon root and every tenant's;
``--fleet-root``: a fleet root; ``--standby DIR``: also every replica
under a standby root against its manifest and the primary), repair
what is safe unless ``--no-repair``, print one JSON report (also to
``--report``) and exit 1 when unrepairable damage remains.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
from typing import List, Optional

from sntc_tpu_torch.device import resolve_device
from sntc_tpu_torch.evaluation.multiclass import METRIC_NAMES
from sntc_tpu_torch.obs.trace import span


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


def serving_form(model, label_index_col: str = "label", fuse: bool = False,
                 fuse_heads: bool = True):
    """One loaded checkpoint → its servable form: ``(model, labels,
    out_cols)``; with ``fuse``, compiled through the whole-pipeline
    fusion compiler (``fuse_heads=False`` keeps the head a plain stage,
    swappable by the lifecycle)."""
    from sntc_tpu_torch.core.base import PipelineModel
    from sntc_tpu_torch.feature.string_indexer import IndexToString
    from sntc_tpu_torch.fuse import compile_serving

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
        if fuse:
            model = compile_serving(model, fuse_heads=fuse_heads)
    return model, labels, out_cols


# estimators of the JAX package's train command
TRAIN_ESTIMATORS = ["lr", "mlp", "rf", "gbt", "dt", "nb", "svc"]
TRAIN_DEFAULT_LAYERS = "78,64,15"


def _build_estimator(args, device):
    """The estimator ``--estimator`` names, as the JAX command builds
    it."""
    from sntc_tpu_torch.models import (
        DecisionTreeClassifier,
        GBTClassifier,
        LinearSVC,
        LogisticRegression,
        MultilayerPerceptronClassifier,
        NaiveBayes,
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
    if args.estimator == "nb":
        return NaiveBayes(device=device, modelType="gaussian")
    if args.estimator == "svc":
        return OneVsRest(classifier=LinearSVC(
            device=device, maxIter=args.max_iter, regParam=args.reg_param))
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


def _obs_start(args) -> None:
    """Arm what a command's obs flags ask for, before any work:
    ``--trace-out`` enables the span tracer for the process."""
    if getattr(args, "trace_out", None):
        from sntc_tpu_torch.obs import enable_tracing

        enable_tracing()


def _obs_finish(args) -> None:
    """Publish what a command's obs flags ask for, at exit (a failed run
    too): the Prometheus text snapshot (``--metrics-out``, atomic) and
    the spans as Chrome-trace JSON (``--trace-out``)."""
    if getattr(args, "metrics_out", None):
        from sntc_tpu_torch.obs import registry

        registry().write_prometheus(args.metrics_out)
    if getattr(args, "trace_out", None):
        from sntc_tpu_torch.obs import tracer

        t = tracer()
        if t is not None:
            t.export_chrome_trace(args.trace_out)


def _device_trace_ctx(args):
    """``--device-trace DIR``: a ``torch.profiler`` capture around the
    run, so device work lines up with the host spans; a null context
    when the flag is unset."""
    if getattr(args, "device_trace", None):
        from sntc_tpu_torch.obs import device_trace

        return device_trace(args.device_trace)
    return contextlib.nullcontext()


def _add_obs_flags(p) -> None:
    p.add_argument("--metrics-out", default=None, metavar="PATH",
                   help="write the process metrics registry as a "
                   "Prometheus text snapshot here (atomic; at exit, a "
                   "failed run included)")
    p.add_argument("--trace-out", default=None, metavar="PATH",
                   help="arm the span tracer and export the host-stage "
                   "timeline as Chrome-trace JSON here at exit "
                   "(loadable in chrome://tracing / ui.perfetto.dev)")
    p.add_argument("--device-trace", default=None, metavar="DIR",
                   help="additionally capture a torch.profiler "
                   "(CUDA kernel-level) trace of the run into DIR "
                   "for Perfetto/TensorBoard")


def cmd_train(args) -> int:
    _obs_start(args)
    # published in finally: a failed fit is the run whose partial
    # metrics and spans the flags were armed to see
    try:
        return _cmd_train_body(args)
    finally:
        _obs_finish(args)


def _cmd_train_body(args) -> int:
    from sntc_tpu_torch.core.base import Pipeline
    from sntc_tpu_torch.data import CICIDS2017_FEATURES
    from sntc_tpu_torch.evaluation import MulticlassClassificationEvaluator
    from sntc_tpu_torch.kernels import LAUNCHES
    from sntc_tpu_torch.mlio import save_model

    device = resolve_device(args.device)
    if device.type == "cuda":
        from sntc_tpu_torch.kernels._build import library

        library()  # build (or load) the kernels before the fit is timed
    df = _load_data(args)
    train, test = df.random_split(
        [1 - args.test_fraction, args.test_fraction], seed=args.seed
    )
    with_scaler = args.estimator in ("lr", "mlp", "svc")
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
    with _device_trace_ctx(args), span("train.fit",
                                       estimator=args.estimator):
        model = pipe.fit(train)
    fit_s = time.perf_counter() - t0
    with span("train.evaluate"):
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
    head = model.getStages()[-1]
    stats = getattr(head, "optimizer_stats", None)
    if stats is not None:
        line["lbfgs"] = stats
    elif args.estimator == "svc":  # one LBFGS fit per class
        line["lbfgs"] = [m.optimizer_stats for m in head.models]
    print(json.dumps(line))
    return 0


def cmd_evaluate(args) -> int:
    from sntc_tpu_torch.evaluation import MulticlassClassificationEvaluator
    from sntc_tpu_torch.mlio import load_model

    device = resolve_device(args.device)
    if device.type == "cuda":
        from sntc_tpu_torch.kernels._build import library

        library()
    model = load_model(args.model, device=device)
    df = _load_data(args)
    value = MulticlassClassificationEvaluator(
        metricName=args.metric
    ).evaluate(model.transform(df))
    print(json.dumps({"rows": df.num_rows, args.metric: value}))
    return 0


def _arm_lifecycle(args, model, raw_model, labels, device):
    """The serve command's LifecycleManager, or None when no lifecycle
    flag is given: ``--drift-window`` arms the drift monitor,
    ``--promote-from`` shadows a candidate checkpoint, ``--partial-fit``
    refits one from the live labelled batches (LR / NB heads)."""
    if not (args.partial_fit or args.drift_window > 0 or args.promote_from):
        return None
    from sntc_tpu_torch.lifecycle import (
        DriftMonitor,
        LifecycleManager,
        ModelPromoter,
        incremental_estimator_for,
        terminal_head,
    )

    drift = None
    if args.drift_window > 0:
        drift = DriftMonitor(window=args.drift_window,
                             threshold=args.drift_threshold).attach()
    promoter = None
    if args.promote_from or args.partial_fit:
        promoter = ModelPromoter(
            model, incumbent_raw=raw_model, serving_path=args.model,
            checkpoint_dir=args.checkpoint, window=args.shadow_window,
            margin=args.promote_margin, label_col="Label", labels=labels,
            bucket_rows=args.shape_buckets, device=device,
        )
        if args.partial_fit:
            try:  # fail fast on a head with no partial_fit
                incremental_estimator_for(terminal_head(model))
            except ValueError as e:
                raise SystemExit(f"--partial-fit: {e}")
        if args.promote_from:
            promoter.load_candidate(args.promote_from)
    return LifecycleManager(
        drift=drift, promoter=promoter, partial_fit=args.partial_fit,
        n_classes=len(labels) if labels is not None else None,
        device=device)


def _build_source(args, contract, pipelined: bool):
    """The serve command's source and its socket listeners.

    ``--from-capture``: the watch directory holds raw pcap / NetFlow
    captures, and a stateful keyed-window operator computes the
    CICIDS2017 features live (crash-safe state under
    ``<checkpoint>/flow_state``).  ``--listen-udp`` / ``--listen-tcp``:
    the watch directory becomes the ingress spool, into which a
    supervised listener seals socket payloads (NetFlow v5 datagrams over
    UDP, length-prefixed CSV rows over TCP) as replayable capture files.
    Either way the rows ride the same admission, predict and sink path
    as CSV files."""
    from sntc_tpu_torch.serve import FileStreamSource

    source_kwargs = dict(
        prefetch_batches=args.prefetch_batches if pipelined else 0,
        read_workers=args.read_workers,
    )
    if args.listen_udp is not None or args.listen_tcp is not None:
        from sntc_tpu_torch.serve import ingress as _ingress

        columns = None
        if args.listen_tcp is not None:
            # framed TCP rows carry values only: the sealed CSV files
            # name them in the admission contract's column order
            from sntc_tpu_torch.data.schema import CICIDS2017_CONTRACT

            columns = list((contract or CICIDS2017_CONTRACT).columns)
        return _ingress.build_ingress(
            args.watch,
            listen_udp=args.listen_udp,
            listen_tcp=args.listen_tcp,
            spool_mb=args.ingress_spool_mb,
            columns=columns,
            source_kwargs=dict(source_kwargs,
                               parse_salvage=contract is not None),
        )
    if args.from_capture:
        from sntc_tpu_torch.flow import FlowCaptureSource

        return FlowCaptureSource(
            args.watch,
            format=args.from_capture,
            flow_timeout=args.flow_timeout,
            activity_timeout=args.flow_activity_timeout,
            allowed_lateness=args.flow_lateness,
            max_state_packets=args.flow_max_packets,
            state_dir=os.path.join(args.checkpoint, "flow_state"),
            **source_kwargs,
        ), []
    return FileStreamSource(
        args.watch, parse_salvage=contract is not None, **source_kwargs,
    ), []


def _flow_summary(source) -> Optional[dict]:
    """The flow operator's counters and the parser in use, for a
    capture source; None otherwise."""
    stats = getattr(source, "flow_stats", None)
    if stats is not None:
        return stats()
    parser = getattr(source, "parser", None)
    return {"parser": parser()} if parser is not None else None


def cmd_serve(args) -> int:
    _obs_start(args)
    try:
        return _cmd_serve_body(args)
    finally:
        _obs_finish(args)


def _cmd_serve_body(args) -> int:
    if args.from_capture and (args.listen_udp is not None
                              or args.listen_tcp is not None):
        raise SystemExit(
            "--listen-udp/--listen-tcp spool their own capture format; "
            "drop --from-capture (UDP serves NetFlow v5 directly)"
        )
    from sntc_tpu_torch.kernels import LAUNCHES, PAD_LAUNCH_SHAPES
    from sntc_tpu_torch.mlio import load_model
    from sntc_tpu_torch.resilience import (
        DeviceFaultDomain,
        HealthState,
        QuerySupervisor,
        RetryPolicy,
        default_breakers,
    )
    from sntc_tpu_torch.serve import (
        BatchPredictor,
        CsvDirSink,
        StreamingQuery,
    )

    # --row-policy salvage|permissive admits rows against the canonical
    # contract (poison rows excised to the row dead letters) and arms
    # per-line salvage in the CSV parser; strict trusts the input
    contract = None
    if args.row_policy != "strict":
        from sntc_tpu_torch.data.schema import CICIDS2017_CONTRACT

        contract = CICIDS2017_CONTRACT.with_mode(args.row_policy)
    # any --slo-* declares a setpoint and arms the controller in the
    # supervised loop; it owns the ingest tuner, so --autotune then builds
    # none of its own (two owners would double-steer the same knobs)
    slo = None
    if args.controller and (args.slo_p99_ms or args.slo_min_rows_per_sec
                            or args.slo_max_shed_rate):
        from sntc_tpu_torch.serve import SloPolicy

        slo = SloPolicy(slo_p99_ms=args.slo_p99_ms,
                        slo_min_rows_per_sec=args.slo_min_rows_per_sec,
                        slo_max_shed_rate=args.slo_max_shed_rate)
    autotuner = None
    if args.autotune and slo is None:
        from sntc_tpu_torch.data.autotune import IngestAutotuner

        autotuner = IngestAutotuner()
    device = resolve_device(args.device)
    if device.type == "cuda":
        from sntc_tpu_torch.kernels._build import library

        library()  # build (or load) the kernels before the first batch
    raw_model = load_model(args.model, device=device)
    # only a lifecycle that can SWAP models keeps the head out of the
    # fused segments (a fused head is a constant of its segment); drift
    # monitoring alone keeps full fusion
    swap_armed = bool(args.partial_fit or args.promote_from)
    model, labels, out_cols = serving_form(
        raw_model, args.label_index_col, args.fuse,
        fuse_heads=not swap_armed,
    )
    lifecycle = _arm_lifecycle(args, model, raw_model, labels, device)
    if args.device_faults:
        # CUDA errors are classified and answered on the card: an OOM
        # splits the batch, other kinds re-dispatch it, and a device
        # that keeps failing stops the query
        model = BatchPredictor(model, bucket_rows=args.shape_buckets,
                               device=device,
                               device_domain=DeviceFaultDomain())
    # depth > 1 arms the pipelined engine: the overlapped sink delivery
    # and the source's background prefetch
    pipelined = args.pipeline_depth > 1
    source, ingress_listeners = _build_source(args, contract, pipelined)
    # a served query moves past a poison batch: reads and sink writes
    # retry in place, and a batch that fails --max-batch-failures rounds
    # is dead-lettered and committed
    retries = max(1, args.batch_retry_attempts)
    q = StreamingQuery(
        model,
        source,
        CsvDirSink(args.out, columns=out_cols),
        args.checkpoint,
        max_batch_offsets=args.max_files_per_batch,
        pipeline_depth=args.pipeline_depth,
        overlap_sink=pipelined,
        autotuner=autotuner,
        shape_buckets=args.shape_buckets,
        wal_mode=args.wal_mode,
        wal_compact_every=args.wal_compact_every,
        wal_keep_commits=args.wal_keep_commits,
        device=device,
        breakers=default_breakers(),
        retry_policy=(
            RetryPolicy(max_attempts=retries, base_delay_s=0.2, jitter=0.1)
            if retries > 1 else None
        ),
        max_batch_failures=(
            args.max_batch_failures if args.max_batch_failures > 0 else None
        ),
        dead_letter_keep=args.dead_letter_keep,
        schema_contract=contract,
        row_dead_letter_dir=args.row_dead_letter,
        lifecycle=lifecycle,
    )
    dom = q.predictor.device_domain
    repl_plane = None
    if args.standby_root:
        # warm-standby replication: ship the checkpoint's durable tree
        # and the sink to <standby-root>/default/, sealing a commit
        # barrier every --repl-barrier-every commits
        from sntc_tpu_torch.resilience.replicate import ReplicationPlane

        repl_plane = ReplicationPlane(
            args.checkpoint, args.standby_root,
            barrier_every=args.repl_barrier_every, sink_dir=args.out,
        )
        q.commit_listener = repl_plane.on_commit

    def _replication_status():
        # the final ship and barrier come before a summary line reads
        # the plane: no replicated tail strands
        if repl_plane is None:
            return None
        repl_plane.close()
        return repl_plane.status()

    if ingress_listeners:
        from sntc_tpu_torch.serve import ingress as _ingress

        # retention prunes only below the committed horizon, and the
        # listeners go live only once the engine that replays their
        # spool exists
        _ingress.wire_committed_offset(source, q.committed_end)
        for listener in ingress_listeners:
            listener.start()
    try:
        if args.once:
            t0 = time.perf_counter()
            with _device_trace_ctx(args):
                n = q.process_available()
                if ingress_listeners:
                    # settle the front door (intake stops, the tail
                    # seals), then serve what it sealed: --once drains
                    # the spool too
                    for listener in ingress_listeners:
                        listener.drain()
                    n += q.process_available()
            seconds = time.perf_counter() - t0
            print(json.dumps({
                "batches": n,
                "rows": q.rows_served,
                "seconds": seconds,
                "device": str(device),
                "kernel_launches": dict(LAUNCHES),
                "pad_launch_shapes": dict(PAD_LAUNCH_SHAPES),
                "compile_events": q.predictor.compile_events,
                "pipeline_stats": q.pipeline_stats(),
                "fusion": q.predictor.fusion_stats(),
                "progress": q.recentProgress,
                "device_faults": dom.stats() if dom is not None else None,
                "breakers": {site: br.snapshot()
                             for site, br in q.breakers.items()},
                "quarantined": q.quarantined_batches,
                "flow": _flow_summary(source),
                "ingress": (source.spool.stats.snapshot()
                            if ingress_listeners else None),
                "replication": _replication_status(),
            }))
            return 0
        # the supervised loop: SIGTERM (and Ctrl-C) drains, commits the
        # in-flight batches, writes drain_marker.json and exits 0; a
        # restart on the same checkpoint resumes exactly once
        sup = QuerySupervisor(q, max_pending_batches=args.max_pending_batches,
                              shed_policy=args.shed_policy,
                              max_batch_wall_time=args.max_batch_wall_time,
                              health_json=args.health_json, slo=slo,
                              disk_budget_mb=args.disk_budget_mb)
        sup.install_signal_handlers()
        if ingress_listeners:
            # SIGTERM settles the front door first (intake stops, the
            # ring's tail seals durably), then asks the engine to drain:
            # nothing a sender was acked (the sealed file) dies in memory
            import signal as _signal

            def _drain_ingress_then_engine(signum, frame):
                for listener in ingress_listeners:
                    try:
                        listener.drain()
                    except Exception:
                        pass
                sup.request_drain("SIGTERM")

            _signal.signal(_signal.SIGTERM, _drain_ingress_then_engine)
        print(f"serving: watching {args.watch} -> {args.out} (checkpoint "
              f"{args.checkpoint}); SIGTERM/Ctrl-C drains", file=sys.stderr)
        try:
            with _device_trace_ctx(args):
                status = sup.run(poll_interval=args.poll_interval)
        except KeyboardInterrupt:
            status = sup.drain_now("KeyboardInterrupt")
        except Exception as e:
            # the query stopped (a failed device, or a failure with the
            # quarantine unarmed): the batch's intent stays in the WAL
            # for a restart, and the exit is non-zero
            sup.health.report("engine", HealthState.UNHEALTHY,
                              reason=f"query stopped: {e!r}")
            if args.health_json:
                sup.write_health_json()
            status = sup.status()
            print(f"serve stopped: {e!r}", file=sys.stderr)
            print(json.dumps({
                "batches": status["engine"]["batches_done"],
                "drained": False,
                "health": status["health"]["overall"],
                "error": repr(e),
                "replication": _replication_status(),
            }))
            return 1
        finally:
            sup.close()  # unsubscribe the health monitor
        print(json.dumps({
            "batches": status["engine"]["batches_done"],
            "drained": status["drained"],
            "health": status["health"]["overall"],
            "replication": _replication_status(),
        }))
        return 0
    finally:
        if repl_plane is not None:
            repl_plane.close()
        for listener in ingress_listeners:
            try:
                listener.close()
            except Exception:
                pass
        q.stop()
        source.close()
        if lifecycle is not None and lifecycle.drift is not None:
            lifecycle.drift.detach()


def cmd_serve_daemon(args) -> int:
    """Multi-tenant serving (counterpart of the JAX ``cmd_serve_daemon``):
    N tenant streams over one shared program cache, fairly scheduled and
    isolated (``serve.tenancy``).  ``--tenants`` is JSON, ``{"tenants":
    [{"id", "model": <checkpoint>, "watch", "out", ...}]}``; an entry may
    override any daemon flag's default.  Tenants naming the same
    checkpoint share one predictor.  Exit 1 when the shared device
    failed."""
    from sntc_tpu_torch.kernels import LAUNCHES, PAD_LAUNCH_SHAPES
    from sntc_tpu_torch.serve import ServeDaemon

    _obs_start(args)
    device = resolve_device(args.device)
    if device.type == "cuda":
        from sntc_tpu_torch.kernels._build import library

        library()  # build (or load) the kernels before the first batch
    specs = _load_tenant_specs(args, device)
    daemon = ServeDaemon(
        specs, args.root,
        shape_buckets=args.shape_buckets,
        pipeline_depth=args.pipeline_depth,
        health_json=args.health_json,
        metrics_out=args.metrics_out,
        autotune=args.autotune,
        controller=args.controller,
        disk_budget_mb=args.root_disk_budget_mb,
        dead_letter_keep=args.dead_letter_keep,
        device_faults=args.device_faults,
        device=device,
        standby_root=args.standby_root,
        repl_barrier_every=args.repl_barrier_every,
    )
    try:
        if args.once:
            with _device_trace_ctx(args):
                n = daemon.process_available()
            # the --once pass is the warmup: the drain after it must
            # dispatch no new row shape
            daemon.mark_warm()
            daemon.drain()
            status = daemon.status()
        else:
            daemon.install_signal_handlers()
            print(f"serve-daemon: {len(specs)} tenants -> {args.root}; "
                  "SIGTERM/Ctrl-C drains every tenant", file=sys.stderr)
            try:
                with _device_trace_ctx(args):
                    status = daemon.run(poll_interval=args.poll_interval)
            except KeyboardInterrupt:
                daemon.request_drain("KeyboardInterrupt")
                daemon.drain()
                status = daemon.status()
            n = status["aggregate"]["batches_done"]
    finally:
        daemon.close()
        _obs_finish(args)
    print(json.dumps({
        "batches": n,
        "tenants": {
            tid: row["state"] for tid, row in status["tenants"].items()
        },
        "recompiles_after_warmup": status["recompiles_after_warmup"],
        "drained": status["drained"],
        "health": status["health"]["overall"],
        "device": str(device),
        "device_failed": status["device_failed"],
        "kernel_launches": dict(LAUNCHES),
        "pad_launch_shapes": dict(PAD_LAUNCH_SHAPES),
    }))
    return 1 if status["device_failed"] else 0


def _load_tenant_specs(args, device) -> list:
    """The ``--tenants`` catalog: each distinct checkpoint is loaded and
    compiled once (tenants naming it share the served model object, so
    the daemon gives them one predictor), the flags fill the defaults."""
    from sntc_tpu_torch.mlio import load_model
    from sntc_tpu_torch.resilience import RetryPolicy
    from sntc_tpu_torch.serve import TenantSpec

    with open(args.tenants) as f:
        doc = json.load(f)
    entries = doc["tenants"] if isinstance(doc, dict) else doc
    if not entries:
        raise SystemExit(f"{args.tenants}: no tenants declared")
    retries = max(1, args.batch_retry_attempts)
    defaults = {
        "weight": args.tenant_weight,
        "max_rows_per_sec": args.max_rows_per_sec,
        "max_pending_batches": args.max_pending_batches,
        "shed_policy": args.shed_policy,
        "quarantine_after": args.quarantine_after,
        "quarantine_cooldown_s": args.quarantine_cooldown,
        "stop_after": args.stop_after,
        "from_capture": args.from_capture,
        "slo_p99_ms": args.slo_p99_ms,
        "slo_min_rows_per_sec": args.slo_min_rows_per_sec,
        "slo_max_shed_rate": args.slo_max_shed_rate,
        "disk_budget_mb": args.disk_budget_mb,
        "max_batch_offsets": args.max_files_per_batch,
        "max_batch_failures": (
            args.max_batch_failures if args.max_batch_failures > 0
            else None
        ),
        "retry_policy": (
            RetryPolicy(max_attempts=retries, base_delay_s=0.2, jitter=0.1)
            if retries > 1 else None
        ),
        # the listener flags are each tenant's default ingress block (a
        # tenant's own block replaces it); port 0 is ephemeral a tenant
        "ingress": (
            {"listen_udp": args.listen_udp, "listen_tcp": args.listen_tcp,
             "spool_mb": args.ingress_spool_mb}
            if (args.listen_udp is not None or args.listen_tcp is not None)
            else None
        ),
    }
    served_by_path = {}

    def _served(path):
        if path not in served_by_path:
            model, _labels, out_cols = serving_form(
                load_model(path, device=device), args.label_index_col,
                args.fuse)
            served_by_path[path] = (model, out_cols)
        return served_by_path[path]

    specs = []
    for entry in entries:
        e = dict(entry)
        path = e.get("model")
        if not isinstance(path, str):
            raise SystemExit(
                f"tenant {e.get('id')!r}: 'model' must be a checkpoint "
                "path"
            )
        model, out_cols = _served(path)
        e["model"] = model
        e.setdefault("out_columns", out_cols)
        policy = e.get("row_policy", None if args.row_policy == "strict"
                       else args.row_policy)
        if policy is not None and policy != "strict":
            from sntc_tpu_torch.data.schema import CICIDS2017_CONTRACT

            e["row_policy"] = policy
            e["schema_contract"] = CICIDS2017_CONTRACT.with_mode(policy)
        else:
            e.pop("row_policy", None)
        specs.append(TenantSpec.from_dict(e, defaults))
    return specs


def _add_daemon_flags(p) -> None:
    """The JAX ``serve-daemon`` flags (shared with ``fleet-serve``), with
    its help texts and defaults (its compile watchdog is not ported)."""
    p.add_argument("--tenants", required=True, metavar="JSON",
                   help="tenant spec file: {\"tenants\": [{\"id\", "
                   "\"model\", \"watch\", \"out\", ...per-tenant "
                   "overrides}]}")
    p.add_argument("--root", required=True,
                   help="daemon root: per-tenant checkpoints/WALs/"
                   "dead-letters land under <root>/tenant/<id>/")
    p.add_argument("--label-index-col", default="label")
    p.add_argument("--max-files-per-batch", type=int, default=1,
                   help="micro-batch size in source files, per tenant "
                   "(TenantSpec max_batch_offsets)")
    p.add_argument("--pipeline-depth", type=int, default=1,
                   help="per-tenant in-flight micro-batches; > 1 arms "
                   "each tenant's overlapped sink delivery")
    p.add_argument("--shape-buckets", type=int, default=0,
                   help="power-of-two row bucketing for the SHARED "
                   "predictors (compile once per bucket across all "
                   "tenants of a pipeline); 0 = off")
    p.add_argument("--fuse", action="store_true", dest="fuse",
                   default=True,
                   help="compile each distinct tenant pipeline with the "
                   "whole-pipeline fusion compiler (default)")
    p.add_argument("--no-fuse", action="store_false", dest="fuse")
    p.add_argument("--autotune", action="store_true", dest="autotune",
                   default=False,
                   help="arm per-tenant ingest autotuners drawing from "
                   "ONE shared tuning budget (total extra parse "
                   "threads / staged ranges / pipeline slots capped "
                   "across the fleet)")
    p.add_argument("--no-autotune", action="store_false",
                   dest="autotune")
    p.add_argument("--tenant-weight", type=float, default=1.0,
                   help="default fair-share weight (TenantSpec weight): "
                   "deficit round-robin credits per scheduling round")
    p.add_argument("--max-rows-per-sec", type=float, default=None,
                   help="default per-tenant admission rate quota "
                   "(TenantSpec max_rows_per_sec): a token bucket "
                   "charged at commit throttles a flooding tenant at "
                   "its own edge; unset = unlimited")
    p.add_argument("--max-pending-batches", type=int, default=None,
                   help="default per-tenant backlog cap (TenantSpec "
                   "max_pending_batches): surplus is shed through the "
                   "tenant's own journaled shed path")
    p.add_argument("--shed-policy", default="oldest",
                   choices=["oldest", "sample"],
                   help="default per-tenant shed policy (TenantSpec "
                   "shed_policy)")
    p.add_argument("--quarantine-after", type=int, default=3,
                   help="unhealthy strikes (quarantine/retry_exhausted/"
                   "breaker_open events tagged with the tenant) before "
                   "the tenant is QUARANTINED (TenantSpec "
                   "quarantine_after)")
    p.add_argument("--quarantine-cooldown", type=float, default=30.0,
                   metavar="S",
                   help="seconds a QUARANTINED tenant holds before "
                   "probation back to OK (TenantSpec "
                   "quarantine_cooldown_s)")
    p.add_argument("--stop-after", type=int, default=3,
                   help="quarantine episodes before the tenant is "
                   "STOPPED and its breakers evicted (TenantSpec "
                   "stop_after)")
    p.add_argument("--row-policy", default="strict",
                   choices=["strict", "salvage", "permissive"],
                   help="default per-tenant data-plane admission "
                   "(TenantSpec row_policy) against the canonical "
                   "CICIDS2017 contract")
    p.add_argument("--from-capture", default=None,
                   choices=["pcap", "netflow"],
                   help="default per-tenant raw-capture mode "
                   "(TenantSpec from_capture): tenants' watch dirs "
                   "hold capture files and each tenant runs its own "
                   "stateful flow-window operator (state under "
                   "tenant/<id>/ckpt/flow_state); per-tenant "
                   "'flow_options' in the tenants JSON tunes the "
                   "window knobs")
    p.add_argument("--slo-p99-ms", type=float, default=None,
                   help="default per-tenant p99 latency SLO "
                   "(TenantSpec slo_p99_ms; per-tenant JSON "
                   "overrides); the --controller setpoint; "
                   "0/unset = undeclared")
    p.add_argument("--slo-min-rows-per-sec", type=float, default=None,
                   help="default per-tenant throughput-floor SLO "
                   "(TenantSpec slo_min_rows_per_sec); 0/unset = "
                   "undeclared")
    p.add_argument("--slo-max-shed-rate", type=float, default=None,
                   help="default per-tenant shed-rate SLO bound "
                   "(TenantSpec slo_max_shed_rate, a fraction in "
                   "(0, 1]); 0/unset = undeclared")
    p.add_argument("--controller", action="store_true",
                   dest="controller", default=False,
                   help="arm the closed-loop SLO controller: one "
                   "guarded knob step per window toward the declared "
                   "per-tenant SLOs (protect compliant tenants, "
                   "degrade the violator throttle->shed->escalate), "
                   "owning the per-tenant ingest tuners; decisions "
                   "journaled to <root>/controller.jsonl")
    p.add_argument("--no-controller", action="store_false",
                   dest="controller",
                   help="keep every serving knob at its flag value")
    p.add_argument("--batch-retry-attempts", type=int, default=2)
    p.add_argument("--max-batch-failures", type=int, default=3,
                   help="default per-tenant poison-batch threshold "
                   "(TenantSpec max_batch_failures); 0 = first failure "
                   "surfaces (and strikes the tenant)")
    p.add_argument("--disk-budget-mb", type=float, default=None,
                   metavar="MB",
                   help="default per-tenant disk byte budget "
                   "(TenantSpec disk_budget_mb): the tenant/<id>/ "
                   "subtree is measured into sntc_disk_bytes{tenant=} "
                   "each round and a breach degrades THAT tenant's "
                   "health; 0/unset = measure only")
    p.add_argument("--root-disk-budget-mb", type=float, default=None,
                   metavar="MB",
                   help="global disk byte budget for the whole daemon "
                   "root (all tenants + shared journals)")
    p.add_argument("--dead-letter-keep", type=int, default=200,
                   metavar="N",
                   help="per-tenant dead-letter retention: keep the "
                   "newest N evidence files per dead-letter dir "
                   "(counted dead_letter_dropped); 0 = unbounded")
    p.add_argument("--device-faults", action="store_true",
                   dest="device_faults", default=True,
                   help="arm ONE device fault domain shared by every "
                   "tenant's predictor (tenants share the card): CUDA "
                   "errors are answered per kind and never strike a "
                   "tenant's ladder; a device that keeps failing drains "
                   "the daemon and exits 1 (default)")
    p.add_argument("--no-device-faults", action="store_false",
                   dest="device_faults",
                   help="device errors ride the generic per-tenant "
                   "retry/quarantine machinery")
    p.add_argument("--poll-interval", type=float, default=1.0)
    p.add_argument("--once", action="store_true",
                   help="drain available files across all tenants and "
                   "exit")
    p.add_argument("--health-json", default=None, metavar="PATH",
                   help="atomically rewrite the daemon status dump "
                   "(per-tenant states, compile ledger, health, "
                   "breakers) here every scheduling round")
    p.add_argument("--listen-udp", type=int, default=None, metavar="PORT",
                   help="default per-tenant UDP ingress (TenantSpec "
                   "ingress): each tenant's watch dir becomes its own "
                   "ingress spool behind a supervised NetFlow v5 "
                   "listener — use 0 (ephemeral, published in "
                   "<watch>/ingress_stats.json) so tenants never "
                   "collide on a port; per-tenant 'ingress' JSON "
                   "blocks override")
    p.add_argument("--listen-tcp", type=int, default=None, metavar="PORT",
                   help="default per-tenant framed-TCP row ingress "
                   "(TenantSpec ingress); 0 = ephemeral per tenant, "
                   "published in the tenant's ingress_stats.json")
    p.add_argument("--ingress-spool-mb", type=float, default=None,
                   metavar="MB",
                   help="default per-tenant ingress spool byte budget "
                   "(TenantSpec ingress spool_mb): over it TCP pauses "
                   "reads and UDP sheds at ingress, counted — never "
                   "ENOSPC death")
    p.add_argument("--standby-root", default=None, metavar="DIR",
                   help="warm-standby replication: every tenant's "
                   "durable tree (+ sink) replicates to <DIR>/<tenant>/ "
                   "with sealed manifests and commit barriers; a fleet "
                   "coordinator also restores from the replica when a "
                   "dead worker's primary tree cannot ship")
    p.add_argument("--repl-barrier-every", type=int, default=1,
                   metavar="N",
                   help="seal a replication commit barrier every N "
                   "commits per tenant (ReplicationPlane "
                   "barrier_every); 1 = tightest RPO")
    _add_obs_flags(p)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without CUDA) or cpu")


def cmd_fleet_serve(args) -> int:
    """The elastic serve fleet (counterpart of the JAX ``cmd_fleet_serve``;
    ``serve.fleet``): one coordinator process over N worker processes,
    each a plain ``ServeDaemon`` over its assigned tenants.  SIGTERM or
    Ctrl-C raises the fleet drain marker and sends SIGTERM to every
    worker.  The coordinator re-invokes the command line
    (``sys.argv``) with ``--fleet-worker-id`` for each worker; a worker
    whose device domain failed exits 1."""
    import itertools
    import signal as _signal
    import subprocess

    from sntc_tpu_torch.serve.fleet import FleetCoordinator, FleetWorker

    if args.fleet_worker_id:
        from sntc_tpu_torch.kernels import LAUNCHES, PAD_LAUNCH_SHAPES

        device = resolve_device(args.device)
        worker = FleetWorker(
            args.fleet_worker_id, args.root, {},
            daemon_kwargs=dict(
                shape_buckets=args.shape_buckets,
                pipeline_depth=args.pipeline_depth,
                autotune=args.autotune,
                dead_letter_keep=args.dead_letter_keep,
                device_faults=args.device_faults,
                device=device,
                standby_root=args.standby_root,
                repl_barrier_every=args.repl_barrier_every,
            ),
            controller=args.controller,
        )
        if device.type == "cuda":
            # CUDA's context comes up before the first lease, inside the
            # coordinator's boot grace (its init may hold the GIL)
            import torch

            torch.cuda.init()
        # the lease renews from here on: the kernels' load, the models'
        # loads and the first batch never read as a dead worker
        worker.start_heartbeat()
        if device.type == "cuda":
            from sntc_tpu_torch.kernels._build import library

            library()
        worker.specs = {
            s.tenant_id: s for s in _load_tenant_specs(args, device)
        }
        status = worker.run(poll_interval=args.poll_interval)
        print(json.dumps({
            "worker": args.fleet_worker_id,
            "tenants": {
                tid: row["state"]
                for tid, row in status.get("tenants", {}).items()
            },
            "device": str(device),
            "device_failed": bool(status.get("device_failed", False)),
            "kernel_launches": dict(LAUNCHES),
            "pad_launch_shapes": dict(PAD_LAUNCH_SHAPES),
        }))
        return 1 if status.get("device_failed") else 0

    _obs_start(args)
    with open(args.tenants) as f:
        doc = json.load(f)
    entries = doc["tenants"] if isinstance(doc, dict) else doc
    if not entries:
        raise SystemExit(f"{args.tenants}: no tenants declared")

    class _PlacementSpec:
        """The coordinator needs placement facts only; it loads no
        model (the workers do)."""

        def __init__(self, entry):
            self.placement_cost = entry.get("placement_cost")
            self.weight = float(entry.get("weight", args.tenant_weight))
            self.pinned_worker = entry.get("pinned_worker")

    specs = {e["id"]: _PlacementSpec(e) for e in entries}
    worker_ids = (
        args.worker_ids.split(",") if args.worker_ids
        else [f"w{i}" for i in range(args.workers)]
    )
    procs = {}
    child_argv = [sys.executable, "-m", "sntc_tpu_torch"] + sys.argv[1:]

    def _spawn(wid):
        procs[wid] = subprocess.Popen(
            child_argv + ["--fleet-worker-id", wid]
        )

    fresh_ids = itertools.count(len(worker_ids))

    def _scale_out(reason):
        wid = f"w{next(fresh_ids)}"
        _spawn(wid)
        return wid

    coord = FleetCoordinator(
        args.root, worker_ids, specs,
        lease_ttl_s=args.lease_ttl, boot_grace_s=args.boot_grace,
        dead_grace_s=args.dead_grace,
        vnodes=args.vnodes, slack=args.slack,
        scale_out_hook=_scale_out,
        standby_root=args.standby_root,
    )
    stop = {"sig": None}

    def _term(signum, frame):
        stop["sig"] = signum

    for sig in (_signal.SIGTERM, _signal.SIGINT):
        try:
            _signal.signal(sig, _term)
        except ValueError:
            pass
    for wid in worker_ids:
        _spawn(wid)
    print(f"fleet-serve: coordinator over {len(worker_ids)} workers x "
          f"{len(specs)} tenants -> {args.root}; SIGTERM/Ctrl-C drains "
          "the fleet", file=sys.stderr)
    try:
        while stop["sig"] is None:
            coord.tick()
            time.sleep(args.poll_interval)
    finally:
        # raise the fleet drain marker (the workers' loops watch it),
        # then SIGTERM every worker and wait
        coord.drain_fleet(f"signal {stop['sig']}")
        for p in procs.values():
            if p.poll() is None:
                p.terminate()
        deadline = time.time() + args.drain_timeout
        for p in procs.values():
            try:
                p.wait(timeout=max(0.1, deadline - time.time()))
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        coord.tick()
        coord.close()
        _obs_finish(args)
    print(json.dumps(coord.status()))
    return 0


def _add_fleet_flags(p) -> None:
    """The JAX ``fleet-serve`` flags beyond the daemon's, with its
    defaults."""
    p.add_argument("--workers", type=int, default=2, metavar="N",
                   help="worker processes to spawn (ids w0..wN-1); "
                   "each runs a plain ServeDaemon over its assigned "
                   "tenant slice under <root>/worker/<id>/")
    p.add_argument("--worker-ids", default=None, metavar="IDS",
                   help="explicit comma-separated worker ids "
                   "(overrides --workers; the ids TenantSpec "
                   "pinned_worker entries must name)")
    p.add_argument("--lease-ttl", type=float, default=5.0, metavar="S",
                   help="worker lease TTL (FleetCoordinator "
                   "lease_ttl_s): a worker whose heartbeat marker is "
                   "older is declared DEAD and its tenants migrate to "
                   "the survivors")
    p.add_argument("--boot-grace", type=float, default=30.0,
                   metavar="S",
                   help="first-heartbeat grace (FleetCoordinator "
                   "boot_grace_s): how long a spawned worker may take "
                   "to come up before it counts as dead")
    p.add_argument("--dead-grace", type=float, default=None,
                   metavar="S",
                   help="ship fence (FleetCoordinator dead_grace_s): "
                   "a dead worker's tenant trees only ship after its "
                   "lease stays expired this much LONGER, with a final "
                   "lease re-read (default: 2 x lease TTL)")
    p.add_argument("--vnodes", type=int, default=64,
                   help="virtual nodes per worker on the consistent-"
                   "hash ring (FleetCoordinator vnodes)")
    p.add_argument("--slack", type=float, default=1.25,
                   help="bounded-load placement slack (FleetCoordinator "
                   "slack): per-worker capacity = slack x total "
                   "placement cost / workers")
    p.add_argument("--drain-timeout", type=float, default=60.0,
                   metavar="S",
                   help="seconds to wait for workers to settle after "
                   "the SIGTERM fan-out before killing them")
    p.add_argument("--fleet-worker-id", default=None,
                   help="internal: run as the named fleet WORKER "
                   "instead of the coordinator (the coordinator "
                   "re-invokes itself with this flag per worker)")


def cmd_fsck(args) -> int:
    """Doctor a checkpoint root (or a tenant tree): one JSON report;
    exit 0 when the tree is (now) clean, 1 when unrepairable damage
    remains."""
    from sntc_tpu_torch.resilience.storage import fsck

    if args.fleet_root:
        from sntc_tpu_torch.serve.fleet import fsck_fleet

        report = fsck_fleet(args.root, repair=not args.no_repair)
    else:
        report = fsck(args.root, repair=not args.no_repair,
                      tenant_tree=args.tenant_tree)
    if args.standby:
        # anti-entropy: every tenant replica under the standby root
        # against its sealed manifest and against the primary under
        # ROOT; each mismatch journals replica_diverged and fails
        from sntc_tpu_torch.resilience.replicate import fsck_standby

        standby_report = fsck_standby(
            args.standby, primary_root=args.root,
            repair=not args.no_repair,
        )
        report["standby"] = standby_report
        report["ok"] = report["ok"] and standby_report["ok"]
    text = json.dumps(report, indent=1)
    if args.report:
        with open(args.report, "w") as f:
            f.write(text + "\n")
    print(text)
    return 0 if report["ok"] else 1


def cmd_fleet_restore_retired(args) -> int:
    """Recover a retired dead-source tenant tree: verify
    ``<root>/fleet/retired/<name>`` and copy it into an explicit
    destination with a sealed restore manifest, never back into the
    serving namespace.  With no NAME, list what is restorable.  Exit 1
    when the tree fails verification."""
    from sntc_tpu_torch.serve.fleet import (
        RETIRED_DIR,
        fleet_meta_dir,
        restore_retired,
    )

    rdir = os.path.join(fleet_meta_dir(args.root), RETIRED_DIR)
    if not args.name:
        names = sorted(
            d for d in (os.listdir(rdir) if os.path.isdir(rdir) else [])
            if not d.startswith(".")
        )
        print(json.dumps({"root": args.root, "retired": names}))
        return 0
    if not args.dest:
        raise SystemExit("--dest is required to restore a tree")
    report = restore_retired(args.root, args.name, args.dest,
                             repair=not args.no_repair)
    print(json.dumps(report, indent=1))
    return 0 if report["ok"] else 1


def cmd_synth(args) -> int:
    """Write schema-identical synthetic day CSVs (numpy only)."""
    from sntc_tpu_torch.data import write_day_csvs

    paths = write_day_csvs(
        args.out, n_rows_per_day=args.rows // args.days, n_days=args.days,
        seed=args.seed,
    )
    print(json.dumps({"files": paths}))
    return 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="sntc_tpu_torch",
        description="PyTorch/CUDA training and serving of sntc_tpu pipelines",
    )
    sub = ap.add_subparsers(dest="cmd", required=True)

    def common(p):
        p.add_argument("--data", required=True,
                       help="directory of CICIDS2017-schema day CSVs")
        p.add_argument("--label-col", default="Label")
        p.add_argument("--binary", action="store_true",
                       help="benign-vs-attack relabel")
        p.add_argument("--metric", default="macroF1", choices=METRIC_NAMES)
        p.add_argument("--seed", type=int, default=0)
        p.add_argument("--device", default="cuda",
                       help="cuda (default; raises without CUDA) or cpu")

    p = sub.add_parser("train", help="fit a pipeline, report held-out metric")
    common(p)
    p.add_argument("--estimator", default="mlp", choices=TRAIN_ESTIMATORS)
    p.add_argument("--model-out", default=None)
    p.add_argument("--test-fraction", type=float, default=0.2)
    p.add_argument("--max-iter", type=int, default=100,
                   help="LBFGS iterations (mlp, lr, svc); boosting rounds "
                   "(gbt)")
    p.add_argument("--reg-param", type=float, default=1e-4,
                   help="regularization strength (lr, svc)")
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
    _add_obs_flags(p)
    p.set_defaults(fn=cmd_train)

    p = sub.add_parser("evaluate", help="evaluate a saved model on CSVs")
    common(p)
    p.add_argument("--model", required=True, help="saved pipeline directory")
    p.set_defaults(fn=cmd_evaluate)

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
    p.add_argument("--pipeline-depth", type=int, default=2,
                   help="in-flight micro-batches; > 1 also arms the "
                   "pipelined engine (overlapped sink delivery + source "
                   "prefetch); 1 = fully serial")
    p.add_argument("--shape-buckets", type=int, default=0,
                   help="pad micro-batches up to power-of-two row buckets "
                   "with this floor (0 = off)")
    p.add_argument("--read-workers", type=int, default=4,
                   help="per-file read/parse pool width for multi-file "
                   "micro-batches (the ingest graph's parse-stage "
                   "workers; --autotune resizes it live)")
    p.add_argument("--autotune", action="store_true", dest="autotune",
                   default=False,
                   help="arm the ingest autotuner: resize "
                   "--read-workers / --prefetch-batches / "
                   "--pipeline-depth live from observed stage "
                   "latencies (hysteresis-guarded; every decision "
                   "journaled as autotune_decision events and "
                   "sntc_ingest_* metrics)")
    p.add_argument("--no-autotune", action="store_false", dest="autotune",
                   help="keep the ingest pools at their flag values")
    p.add_argument("--prefetch-batches", type=int, default=2,
                   help="background source reads staged ahead of the "
                   "engine (pipelined mode only); 0 = off")
    p.add_argument("--fuse", action="store_true", dest="fuse", default=True,
                   help="compile the serving pipeline with the whole-"
                   "pipeline fusion compiler: fold the scaler into the "
                   "model and serve each fusible stage run as one device "
                   "dispatch (default)")
    p.add_argument("--no-fuse", action="store_false", dest="fuse",
                   help="serve the staged pipeline unfused")
    p.add_argument("--wal-mode", default="files",
                   choices=["files", "append"],
                   help="WAL format under --checkpoint: 'files' (one json "
                   "per intent/commit) or 'append' (one fsynced JSONL log "
                   "per side, compacted per --wal-compact-every)")
    p.add_argument("--wal-compact-every", type=int, default=256,
                   metavar="N",
                   help="append-WAL compaction interval in commits; "
                   "0 = never compact")
    p.add_argument("--wal-keep-commits", type=int, default=64, metavar="N",
                   help="files-WAL retention: committed intent/commit "
                   "pairs older than the last N are pruned; 0 = keep "
                   "forever")
    p.add_argument("--batch-retry-attempts", type=int, default=2,
                   help="in-place attempts per read/sink stage before a "
                   "round counts as failed (1 = no retry)")
    p.add_argument("--max-batch-failures", type=int, default=3,
                   help="failed rounds before a poison batch is "
                   "dead-lettered and committed; 0 = the first failure "
                   "stops the query")
    p.add_argument("--dead-letter-keep", type=int, default=200, metavar="N",
                   help="dead-letter retention: keep the newest N evidence "
                   "files; 0 = unbounded")
    p.add_argument("--device-faults", action="store_true",
                   dest="device_faults", default=True,
                   help="arm the device fault domain: classify CUDA errors "
                   "(OOM / compile / device lost), split a batch on OOM, "
                   "re-dispatch it on the others, stop the query after "
                   "3 device faults in a row (default)")
    p.add_argument("--no-device-faults", action="store_false",
                   dest="device_faults",
                   help="device errors take the generic retry/quarantine "
                   "path")
    p.add_argument("--health-json", default=None, metavar="PATH",
                   help="atomically rewrite a health/breaker/engine status "
                   "dump here every engine tick (supervised loop)")
    p.add_argument("--max-pending-batches", type=int, default=None,
                   help="load-shed when the source backlog exceeds this "
                   "many micro-batches (default: never shed)")
    p.add_argument("--shed-policy", default="oldest",
                   choices=["oldest", "sample"],
                   help="shed the oldest surplus offsets, or process the "
                   "whole backlog row-subsampled (journaled either way)")
    p.add_argument("--max-batch-wall-time", type=float, default=None,
                   metavar="S", help="watchdog: flag a batch running "
                   "longer than this as UNHEALTHY (watchdog_stall event)")
    p.add_argument("--slo-p99-ms", type=float, default=None,
                   help="declared p99 batch-latency SLO: arms the "
                   "closed-loop controller, which steers the serving "
                   "knobs (pipeline depth, shape-bucket floor, shed, "
                   "ingest pools) toward it with hysteresis-guarded "
                   "journaled decisions; 0/unset = undeclared")
    p.add_argument("--slo-min-rows-per-sec", type=float, default=None,
                   help="declared throughput-floor SLO (binds while "
                   "the source has backlog); arms the controller "
                   "like --slo-p99-ms; 0/unset = undeclared")
    p.add_argument("--slo-max-shed-rate", type=float, default=None,
                   help="declared bound on the per-window fraction of "
                   "offsets load shedding may drop; arms the "
                   "controller; 0/unset = undeclared")
    p.add_argument("--controller", action="store_true",
                   dest="controller", default=True,
                   help="allow the closed-loop SLO controller (armed "
                   "by any --slo-* flag; decisions journaled to "
                   "<checkpoint>/controller.jsonl) — default")
    p.add_argument("--no-controller", action="store_false",
                   dest="controller",
                   help="keep every serving knob at its flag value "
                   "even when SLOs are declared")
    p.add_argument("--disk-budget-mb", type=float, default=None,
                   metavar="MB",
                   help="byte budget for the checkpoint root: usage is "
                   "measured into sntc_disk_* gauges each tick and a "
                   "breach emits disk_budget_exceeded (DEGRADED health); "
                   "unset = measure only")
    p.add_argument("--row-policy", default="strict",
                   choices=["strict", "salvage", "permissive"],
                   help="row admission against the CICIDS2017 contract: "
                   "strict = a poison batch fails whole; salvage = poison "
                   "rows and ragged lines are excised to the row dead "
                   "letters and the clean rows serve; permissive = "
                   "non-finite values become 0, then salvage")
    p.add_argument("--row-dead-letter", default=None, metavar="DIR",
                   help="row dead-letter directory (default: "
                   "<checkpoint>/dead_letter_rows): one JSONL per batch "
                   "with file/line/raw text/reason per excised row")
    p.add_argument("--partial-fit", action="store_true",
                   help="incrementally refit a candidate head (LR/NB "
                   "sufficient-statistic partial_fit) from live "
                   "labeled batches and shadow it for promotion")
    p.add_argument("--drift-window", type=int, default=0, metavar="N",
                   help="arm the drift monitor: Jensen-Shannon "
                   "divergence of the last N committed batches' "
                   "prediction-mix/score histograms against the first "
                   "N (drift_detected event + model DEGRADED on "
                   "breach); 0 = off")
    p.add_argument("--drift-threshold", type=float, default=0.25,
                   help="divergence breach level for --drift-window")
    p.add_argument("--promote-from", default=None, metavar="DIR",
                   help="candidate model checkpoint to shadow-score on "
                   "live batches; promoted (atomic publish over "
                   "--model, incumbent retained at .prev, "
                   "between-batches hot-swap) when its macro-F1 beats "
                   "the incumbent over --shadow-window batches")
    p.add_argument("--shadow-window", type=int, default=8, metavar="N",
                   help="labeled batches the promotion gate averages "
                   "macro-F1 over")
    p.add_argument("--promote-margin", type=float, default=0.05,
                   help="macro-F1 lead the candidate must hold over "
                   "the incumbent to promote; with --partial-fit the "
                   "candidate is a refit of the incumbent, so refit "
                   "jitter re-promotes every window at margin 0")
    p.add_argument("--from-capture", default=None,
                   choices=["pcap", "netflow"],
                   help="serve RAW captures: --watch holds pcap/.nf5 "
                   "capture files and a stateful keyed-window operator "
                   "computes the CICIDS2017 flow features live "
                   "(crash-safe state under <checkpoint>/flow_state); "
                   "unset = the default precomputed-CSV mode")
    p.add_argument("--flow-timeout", type=float, default=120.0,
                   metavar="S",
                   help="session-window quiet gap: a flow idle longer "
                   "than this (behind the watermark) is COMPLETE and "
                   "its feature row emits (CICFlowMeter's flow "
                   "timeout)")
    p.add_argument("--flow-activity-timeout", type=float, default=5.0,
                   metavar="S",
                   help="Active/Idle split gap inside a flow window "
                   "(CICFlowMeter's activity timeout; pcap only)")
    p.add_argument("--flow-lateness", type=float, default=5.0,
                   metavar="S",
                   help="allowed event-time lateness: the watermark "
                   "trails the max seen timestamp by this much; "
                   "records behind the watermark drop with reason "
                   "late_record (journaled, counted)")
    p.add_argument("--flow-max-packets", type=int, default=500_000,
                   help="hard cap on buffered records across all open "
                   "windows: beyond it the oldest flows force-evict "
                   "early (reason state_cap) so operator state stays "
                   "bounded under any replay")
    p.add_argument("--listen-udp", type=int, default=None, metavar="PORT",
                   help="live network front door: bind a supervised "
                   "UDP listener for NetFlow v5 datagrams; --watch "
                   "becomes the ingress SPOOL the listener seals "
                   "replayable capture files into (0 = ephemeral "
                   "port, published in <watch>/ingress_stats.json); "
                   "loss is counted, never silent")
    p.add_argument("--listen-tcp", type=int, default=None, metavar="PORT",
                   help="live network front door: bind a framed TCP "
                   "row listener (4-byte big-endian length + one CSV "
                   "row per frame); --watch becomes the ingress "
                   "spool; torn frames quarantine, over-budget spool "
                   "pauses reads (sender backpressure)")
    p.add_argument("--ingress-spool-mb", type=float, default=None,
                   metavar="MB",
                   help="ingress spool byte budget: TCP pauses reads "
                   "over it, UDP sheds at ingress (counted "
                   "spool_over_budget) after a committed-file prune "
                   "— bounded disk instead of ENOSPC death; unset = "
                   "unbudgeted")
    p.add_argument("--standby-root", default=None, metavar="DIR",
                   help="warm-standby replication: continuously "
                   "replicate the checkpoint's durable artifact tree "
                   "(+ the sink) to <DIR>/default/ with sealed manifests "
                   "and commit barriers, so a lost primary disk promotes "
                   "from the replica with measured RPO/RTO; unset = no "
                   "replication")
    p.add_argument("--repl-barrier-every", type=int, default=1,
                   metavar="N",
                   help="seal a replication commit barrier every N "
                   "engine commits (ReplicationPlane barrier_every): "
                   "1 = every commit (tightest RPO), larger trades "
                   "barrier lag for ship amortization")
    _add_obs_flags(p)
    p.add_argument("--once", action="store_true",
                   help="drain available files, print a JSON summary, exit")
    p.add_argument("--poll-interval", type=float, default=1.0)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without CUDA) or cpu")
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser(
        "serve-daemon",
        help="multi-tenant streaming inference: N tenant streams, one "
        "shared program cache, fair scheduling, per-tenant isolation")
    _add_daemon_flags(p)
    p.set_defaults(fn=cmd_serve_daemon)

    p = sub.add_parser(
        "fleet-serve",
        help="elastic serve fleet: one coordinator process supervising "
        "N serve-daemon workers with leases, consistent-hash placement, "
        "worker-death recovery and tenant migration")
    _add_daemon_flags(p)
    _add_fleet_flags(p)
    p.set_defaults(fn=cmd_fleet_serve)

    p = sub.add_parser(
        "fsck",
        help="verify and repair every durable artifact under a checkpoint "
        "root (WAL seals and tails, journals, markers, model manifests); "
        "a JSON report; exit 1 when unrepairable damage remains")
    p.add_argument("root", help="checkpoint root to doctor (a serve "
                   "--checkpoint dir, or a serve-daemon root with "
                   "--tenant-tree)")
    p.add_argument("--tenant-tree", action="store_true",
                   help="also walk every <root>/tenant/<id>/ckpt")
    p.add_argument("--fleet-root", action="store_true",
                   help="treat ROOT as a fleet coordinator root: doctor "
                   "the fleet metadata (assignment marker + journal, "
                   "leases, request journals, sealed migration "
                   "manifests, torn mid-ship copies, retired trees) plus "
                   "every <root>/worker/<id>/ daemon tree; an "
                   "unrepairable migration manifest exits 1")
    p.add_argument("--no-repair", action="store_true",
                   help="report only: no truncations, no quarantines, no "
                   "tmp sweeps")
    p.add_argument("--standby", default=None, metavar="DIR",
                   help="anti-entropy: also check every tenant replica "
                   "under this warm-standby root (sealed manifest, "
                   "replica content hashes, primary-vs-replica for "
                   "files both sides hold); each divergence journals "
                   "replica_diverged and exits 1 (with repair, the "
                   "diverged replica copy quarantines so the next ship "
                   "re-seeds it)")
    p.add_argument("--report", default=None, metavar="PATH",
                   help="also write the JSON report here")
    p.set_defaults(fn=cmd_fsck)

    p = sub.add_parser(
        "fleet-restore-retired",
        help="recover a retired dead-source tenant tree "
        "(fleet/retired/<tid>.<wid>.<epoch>): verify and copy it into "
        "an explicit --dest with a sealed restore manifest; no NAME "
        "lists what is restorable")
    p.add_argument("root", help="fleet coordinator root")
    p.add_argument("name", nargs="?", default=None,
                   help="retired tree name (<tid>.<wid>.<epoch>); omit "
                   "to list")
    p.add_argument("--dest", default=None, metavar="DIR",
                   help="destination directory for the verified copy "
                   "(required with NAME; never the serving namespace)")
    p.add_argument("--no-repair", action="store_true",
                   help="verify only: no torn-tail truncations inside "
                   "the retired tree")
    p.set_defaults(fn=cmd_fleet_restore_retired)

    p = sub.add_parser("synth",
                       help="write schema-identical synthetic day CSVs")
    p.add_argument("--out", required=True)
    p.add_argument("--rows", type=int, default=80_000)
    p.add_argument("--days", type=int, default=8)
    p.add_argument("--seed", type=int, default=0)
    p.set_defaults(fn=cmd_synth)
    return ap


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
