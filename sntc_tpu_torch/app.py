"""Command-line entry point of the port.

    python -m sntc_tpu_torch serve --model m/ --watch data/in \\
        --out data/out --checkpoint data/ckpt [--shape-buckets N] \\
        [--max-files-per-batch N] [--once] [--device cuda|cpu]

Counterpart of ``cmd_serve`` in ``sntc_tpu/app.py`` in its plain form:
load a saved pipeline, take off the LABEL ``StringIndexerModel`` (live
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
        description="PyTorch/CUDA serving of sntc_tpu pipelines",
    )
    sub = ap.add_subparsers(dest="cmd", required=True)
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
