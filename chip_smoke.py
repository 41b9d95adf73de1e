"""Smoke run of sntc_tpu_torch on one NVIDIA GPU: kernels, serve path, numbers.

    python3 chip_smoke.py [--verbose-build] [--out-json PATH]

Run from the root of a checkout, on a machine with a CUDA card.  Phases,
each of which fails the run (non-zero exit, no result line):

1. print the card's name and power limit; build the CUDA kernels from
   ``sntc_tpu_torch/kernels/csrc`` (into ``sntc_tpu_torch/_build``);
2. hold every kernel against its plain PyTorch version on the card, at
   the serve path's full-width shapes — bitwise, the stated tolerance of
   both kernels (they only compare and copy);
3. serve the full-width config-3 random-forest pipeline (78 CICIDS2017
   features -> ChiSq top 40 -> 20 trees of depth 10, 15 classes ->
   IndexToString) built from a seed, over six CSV micro-batches, through
   ``python -m sntc_tpu_torch serve --device cuda``.  The serving process
   starts with every launch count at 0 and reports its counts in its
   summary line; each kernel of the path must have launched.  Every input
   row must come back predicted, equal to the plain path on the same card;
4. time each kernel at the serve path's shapes with CUDA events beside
   its plain version, a PyTorch library call where one computes the same
   function, and its bound; print them as one JSON line, then the card's
   line, then the result line.

Exits non-zero without CUDA, and in a directory that holds this script
and nothing else of the repository.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from sntc_tpu_torch.core.base import PipelineModel
from sntc_tpu_torch.core.frame import Frame
from sntc_tpu_torch.data import (
    CICIDS2017_FEATURES,
    CICIDS2017_LABELS,
    clean_flows,
    generate_frame,
    write_raw_csv,
)
from sntc_tpu_torch.feature import (
    ChiSqSelectorModel,
    StringIndexerModel,
    VectorAssembler,
)
from sntc_tpu_torch.kernels import _build
from sntc_tpu_torch.kernels.assemble import pad_rows_cuda, pad_rows_reference
from sntc_tpu_torch.kernels.forest import (
    forest_leaf_stats_cuda,
    forest_leaf_stats_reference,
)
from sntc_tpu_torch.app import serving_form
from sntc_tpu_torch.data import load_csv
from sntc_tpu_torch.mlio import load_model, save_model
from sntc_tpu_torch.models import from_numpy_forest
from sntc_tpu_torch.models.tree.random_forest import _rf_serve
from sntc_tpu_torch.serve import BatchPredictor, CsvDirSink, bucket_rows_for

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 0
TREES, DEPTH, TOP, CLASSES = 20, 10, 40, 15  # bench config 3
BATCHES = [512, 1000, 1024, 2048, 50000, 65536]  # rows per micro-batch
BUCKET_FLOOR = 256
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
FP32_OPS_PER_S = 67e12  # H100 SXM, non-tensor-core fp32


def log(*a):
    print(*a, flush=True)


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]


def random_forest(rng, T, depth, F, S, dtype=np.float32, leaf_p=0.1,
                  quantiles=None):
    """Dense-heap forest: internal nodes split on a random feature (at a
    per-feature data quantile when ``quantiles [Q, F]`` is given), a
    ``leaf_p`` share of nodes above the last level end early as leaves
    (their subtrees stay absent, -2), leaves hold random class counts."""
    M = 2 ** (depth + 1) - 1
    feat = np.full((T, M), -2, np.int32)
    thr = np.zeros((T, M), dtype)
    leaf = np.zeros((T, M, S), dtype)
    for t in range(T):
        stack = [(0, 0)]
        while stack:
            node, d = stack.pop()
            if d < depth and rng.random() >= leaf_p:
                f = int(rng.integers(0, F))
                feat[t, node] = f
                thr[t, node] = (
                    rng.normal() if quantiles is None
                    else quantiles[rng.integers(0, len(quantiles)), f]
                )
                stack += [(2 * node + 1, d + 1), (2 * node + 2, d + 1)]
            else:
                feat[t, node] = -1
                leaf[t, node] = rng.integers(0, 50, S).astype(dtype)
    return feat, thr, leaf


def time_ms(fn, iters=20) -> float:
    """Mean time of ``fn`` on the card, by CUDA events over ``iters``
    calls after a warmup."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    if a.shape != b.shape or a.dtype != b.dtype:
        raise SystemExit(f"shape/dtype mismatch: {a.shape} {a.dtype} "
                         f"vs {b.shape} {b.dtype}")
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


# -- phase 2: kernels against their plain versions ---------------------------


def check_kernels(dev) -> dict:
    rng = np.random.default_rng(SEED)
    errs = {"forest_traversal": 0.0, "pad_assemble": 0.0}
    for n, dtype in ((65536, np.float32), (4097, np.float64),
                     (1000, np.float32)):
        feat, thr, leaf = random_forest(rng, TREES, DEPTH, TOP, CLASSES, dtype)
        X = rng.normal(size=(n, TOP)).astype(dtype)
        X[rng.random(X.shape) < 0.01] = np.nan  # NaN goes left
        args = [torch.from_numpy(a).to(dev) for a in (X, feat, thr, leaf)]
        out = forest_leaf_stats_cuda(*args, max_depth=DEPTH)
        ref = forest_leaf_stats_reference(*args, max_depth=DEPTH)
        torch.cuda.synchronize()
        err = max_abs_err(out, ref)
        if not torch.equal(out, ref):
            raise SystemExit(f"forest_traversal N={n} {dtype.__name__}: "
                             f"differs from the plain version ({err})")
        errs["forest_traversal"] = max(errs["forest_traversal"], err)
        log(f"forest_traversal N={n} T={TREES} depth={DEPTH} F={TOP} "
            f"S={CLASSES} {dtype.__name__}: bitwise equal")
    for n in (1, 1000, 4097, 50000):
        target = bucket_rows_for(n, BUCKET_FLOOR)
        for dtype in (torch.float32, torch.float64):
            a = torch.randn((n, len(CICIDS2017_FEATURES)), dtype=dtype,
                            device=dev)
            out = pad_rows_cuda(a, target)
            ref = pad_rows_reference(a, target)
            torch.cuda.synchronize()
            if not torch.equal(out, ref):
                raise SystemExit(f"pad_assemble N={n} {dtype}: differs "
                                 "from the plain version")
            errs["pad_assemble"] = max(errs["pad_assemble"],
                                       max_abs_err(out, ref))
            log(f"pad_assemble [{n}, 78] -> [{target}, 78] {dtype}: "
                "bitwise equal")
    return errs


# -- phase 3: the serve path -------------------------------------------------


def build_pipeline(traffic: Frame, dev):
    """Full-width config-3 pipeline from the seed: label indexer,
    assembler of the 78 features, a ChiSq top-40 select, and a 20-tree
    depth-10 forest whose thresholds are per-feature data quantiles."""
    rng = np.random.default_rng(SEED + 1)
    selected = sorted(rng.choice(len(CICIDS2017_FEATURES), TOP,
                                 replace=False).tolist())
    X = np.stack([traffic[CICIDS2017_FEATURES[j]] for j in selected], axis=1)
    quantiles = np.quantile(X, np.linspace(0.02, 0.98, 49), axis=0)
    feat, thr, leaf = random_forest(rng, TREES, DEPTH, TOP, CLASSES,
                                    leaf_p=0.0, quantiles=quantiles)
    indexer = StringIndexerModel(labels=CICIDS2017_LABELS)
    indexer.setParams(inputCol="Label", outputCol="label",
                      handleInvalid="skip")
    stages = [
        indexer,
        VectorAssembler(inputCols=CICIDS2017_FEATURES,
                        outputCol="rawFeatures"),
        ChiSqSelectorModel(selected_features=selected,
                           featuresCol="rawFeatures", labelCol="label",
                           outputCol="features", numTopFeatures=TOP),
        from_numpy_forest(feat, thr, leaf, DEPTH, CLASSES, device=dev,
                          n_features=TOP),
    ]
    return PipelineModel(stages=stages), selected


def plain_predictions(rf, selected, batch: Frame, dev) -> np.ndarray:
    """The same forest over the same rows, padded to the same bucket,
    with the plain traversal (same shapes, so the same summation order
    in the PyTorch reductions that follow the walk)."""
    n = batch.num_rows
    X = np.stack([batch[CICIDS2017_FEATURES[j]] for j in selected], axis=1)
    X = X[np.minimum(np.arange(bucket_rows_for(n, BUCKET_FLOOR)), n - 1)]
    mode, thr = rf._serve_args()
    packed = _rf_serve(
        rf._features_on_device(X), *rf._device_forest(), thr,
        max_depth=DEPTH, mode=mode, traverse=forest_leaf_stats_reference,
    )
    return packed[:n, 2 * CLASSES].cpu().numpy().astype(np.float64)


def serve(dev, work: str) -> dict:
    import pyarrow.csv as pacsv

    t0 = time.perf_counter()
    traffic = clean_flows(generate_frame(sum(BATCHES) + 2000, seed=SEED))
    traffic = traffic.slice(0, sum(BATCHES)).drop("Label")
    pipeline, selected = build_pipeline(traffic, dev)
    model_dir = os.path.join(work, "model")
    save_model(pipeline, model_dir)
    watch = os.path.join(work, "in")
    os.makedirs(watch)
    batches, start = [], 0
    for i, n in enumerate(BATCHES):
        b = traffic.slice(start, start + n)
        write_raw_csv(b, os.path.join(watch, f"part_{i:04d}.csv"))
        batches.append(b)
        start += n
    log(f"traffic: {sum(BATCHES)} rows in micro-batches {BATCHES} "
        f"({time.perf_counter() - t0:.1f} s to generate and write)")

    out_dir = os.path.join(work, "out")
    cmd = [sys.executable, "-m", "sntc_tpu_torch", "serve",
           "--model", model_dir, "--watch", watch, "--out", out_dir,
           "--checkpoint", os.path.join(work, "ckpt"),
           "--shape-buckets", str(BUCKET_FLOOR), "--max-files-per-batch", "1",
           "--once", "--device", dev.type]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                          timeout=600)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise SystemExit(f"serve failed ({proc.returncode}):\n{proc.stderr}")
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    log(f"serve: {summary['batches']} batches, {summary['rows']} rows in "
        f"{summary['seconds']:.3f} s of serving ({wall:.1f} s with process "
        "start)")
    if summary["batches"] != len(BATCHES) or summary["rows"] != sum(BATCHES):
        raise SystemExit(f"serve covered {summary}, expected {BATCHES}")

    rf = pipeline.getStages()[-1]
    for i, (b, n) in enumerate(zip(batches, BATCHES)):
        t = pacsv.read_csv(os.path.join(out_dir, f"batch_{i:06d}.csv"))
        pred = t.column("prediction").to_numpy()
        labels = t.column("predictedLabel").to_pylist()
        if len(pred) != n or len(labels) != n:
            raise SystemExit(f"batch {i}: {len(pred)} predictions for {n} rows")
        if not np.isfinite(pred).all() or pred.min() < 0 \
                or pred.max() >= CLASSES:
            raise SystemExit(f"batch {i}: predictions out of range")
        if labels != [CICIDS2017_LABELS[int(p)] for p in pred]:
            raise SystemExit(f"batch {i}: predictedLabel disagrees")
        plain = plain_predictions(rf, selected, b, dev)
        if not np.array_equal(pred, plain):
            bad = int((pred != plain).sum())
            raise SystemExit(f"batch {i}: {bad} predictions differ from "
                             "the plain path")
    log("serve: every row predicted; predictions equal the plain path")
    launches = summary["kernel_launches"]
    want = {
        "forest_traversal": len(BATCHES),
        "pad_assemble": sum(bucket_rows_for(n, BUCKET_FLOOR) != n
                            for n in BATCHES),
    }
    if launches != want:
        raise SystemExit(f"launches {launches}, expected {want}")
    summary["batches_rows"] = BATCHES
    return summary


# -- phase 4: times ----------------------------------------------------------


def _device_ms(prof) -> dict:
    """Device time (ms) of each kernel and copy a profiler window saw,
    largest first: device-side events only (the host ops that launched
    them would count the same time twice), without CUPTI's own
    "Activity Buffer Request" records."""
    out = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA \
                or e.name.startswith("Activity Buffer"):
            continue
        name = e.name if len(e.name) <= 60 else e.name[:57] + "..."
        out[name] = out.get(name, 0.0) + e.time_range.elapsed_us() / 1e3
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def breakdown(dev, work: str) -> list:
    """Host-clock stages of the largest batches, served in this process
    exactly as the serve command does (after one warm pass): CSV read,
    predict (ending in the device→host copy), sink write; and the device
    time a profiler window over the predict saw, hence its idle share."""
    model, _, out_cols = serving_form(
        load_model(os.path.join(work, "model"), device=dev))
    pred = BatchPredictor(model, bucket_rows=BUCKET_FLOOR, device=dev)
    sink = CsvDirSink(os.path.join(work, "breakdown"), columns=out_cols)
    rows = []
    for i, n in enumerate(BATCHES):
        if n < 50000:
            continue
        path = os.path.join(work, "in", f"part_{i:04d}.csv")
        pred.predict_frame(load_csv(path))  # warm pass
        t0 = time.perf_counter()
        frame = load_csv(path)
        t1 = time.perf_counter()
        out = pred.predict_frame(frame)
        t2 = time.perf_counter()
        sink.add_batch(i, out)
        t3 = time.perf_counter()
        acts = [torch.profiler.ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=acts) as prof:
            pred.predict_frame(frame)
        ops = _device_ms(prof) if dev.type == "cuda" else {}
        device_ms = sum(ops.values()) if ops else None
        predict_ms = (t2 - t1) * 1e3
        rows.append({
            "rows": n, "read_ms": (t1 - t0) * 1e3, "predict_ms": predict_ms,
            "sink_ms": (t3 - t2) * 1e3, "device_ms": device_ms,
            "device_idle_share": None if not device_ms
            else max(0.0, 1.0 - device_ms / predict_ms),
            "top_device_ops_ms": dict(list(ops.items())[:5]),
        })
    return rows


def forest_work(X, feature, threshold, leaf_stats, depth: int):
    """(bytes, comparisons) that ``forest_traversal`` needs on these
    inputs: each element the walks read, counted once — the X values
    compared, the feature index of every slot visited, the threshold of
    every internal slot visited, the stats row of every leaf reached —
    plus the ``[T, N, S]`` output, written once; one comparison per
    internal slot on each (tree, row) walk."""
    T, M = feature.shape
    N, F = X.shape
    S, item, dev = leaf_stats.shape[2], X.element_size(), X.device
    node = torch.zeros((T, N), dtype=torch.long, device=dev)
    walking = torch.ones((T, N), dtype=torch.bool, device=dev)
    slot0 = (torch.arange(T, device=dev) * M)[:, None]
    rows = torch.arange(N, device=dev)[None, :] * F
    feat_read = torch.zeros(T * M, dtype=torch.bool, device=dev)
    thr_read = torch.zeros_like(feat_read)
    x_read = torch.zeros(N * F, dtype=torch.bool, device=dev)
    comparisons = 0
    for _ in range(depth):
        f = feature.gather(1, node).long()
        feat_read[(slot0 + node)[walking]] = True
        walking &= f >= 0
        fc = f.clamp_min(0)
        thr_read[(slot0 + node)[walking]] = True
        x_read[(rows + fc)[walking]] = True
        comparisons += int(walking.sum())
        xv = X.t().gather(0, fc)
        child = 2 * node + 1 + (xv >= threshold.gather(1, node)).long()
        node = torch.where(walking, child, node)
    leaf_read = torch.zeros(T * M, dtype=torch.bool, device=dev)
    leaf_read[(slot0 + node).flatten()] = True
    nbytes = (int(x_read.sum()) * item + int(feat_read.sum()) * 4
              + int(thr_read.sum()) * item + int(leaf_read.sum()) * S * item
              + T * N * S * item)
    return nbytes, comparisons


def measure(dev, errs: dict, launches: dict) -> list:
    rng = np.random.default_rng(SEED + 2)
    # forest_traversal at the largest micro-batch of the serve path
    n = max(BATCHES)
    feat, thr, leaf = random_forest(rng, TREES, DEPTH, TOP, CLASSES,
                                    leaf_p=0.0)
    X = rng.normal(size=(n, TOP)).astype(np.float32)
    args = [torch.from_numpy(a).to(dev) for a in (X, feat, thr, leaf)]
    M = feat.shape[1]
    f_bytes, f_ops = forest_work(*args, depth=DEPTH)
    forest = {
        "name": "forest_traversal", "route": "cuda",
        "source": "sntc_tpu_torch/kernels/csrc/forest_traversal.cu",
        "replaces": "sntc_tpu/kernels/forest.py:92",
        "launches": launches["forest_traversal"],
        "max_abs_err": errs["forest_traversal"],
        "ms": time_ms(lambda: forest_leaf_stats_cuda(*args, max_depth=DEPTH)),
        "plain_ms": time_ms(
            lambda: forest_leaf_stats_reference(*args, max_depth=DEPTH)),
        "bound_ms": max(f_bytes / HBM_BYTES_PER_S, f_ops / FP32_OPS_PER_S) * 1e3,
        "bound_by": "bytes" if f_bytes / HBM_BYTES_PER_S
        >= f_ops / FP32_OPS_PER_S else "operations",
        "library_ms": None,
        "shape": f"X [{n}, {TOP}] f32, T={TREES}, M={M}, S={CLASSES}; "
                 f"needs {f_bytes} B, {f_ops} comparisons",
    }
    # pad_assemble at the largest padded micro-batch: 78 f64 columns
    n = max(b for b in BATCHES if bucket_rows_for(b, BUCKET_FLOOR) != b)
    target = bucket_rows_for(n, BUCKET_FLOOR)
    a = torch.randn((n, len(CICIDS2017_FEATURES)), dtype=torch.float64,
                    device=dev)
    idx = torch.clamp(torch.arange(target, device=dev), max=n - 1)
    p_bytes = (n + target) * a.shape[1] * 8
    pad = {
        "name": "pad_assemble", "route": "cuda",
        "source": "sntc_tpu_torch/kernels/csrc/pad_rows.cu",
        "replaces": "sntc_tpu/kernels/assemble.py:69",
        "launches": launches["pad_assemble"],
        "max_abs_err": errs["pad_assemble"],
        "ms": time_ms(lambda: pad_rows_cuda(a, target)),
        "plain_ms": time_ms(lambda: pad_rows_reference(a, target)),
        "bound_ms": p_bytes / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes",
        "library_ms": time_ms(lambda: a.index_select(0, idx)),
        "shape": f"[{n}, 78] f64 -> [{target}, 78]; needs {p_bytes} B",
    }
    return [forest, pad]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--verbose-build", action="store_true",
                    help="show the compiler's output (registers, spills)")
    ap.add_argument("--out-json", default=None,
                   help="also write every number of the run to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = gpu_line()
    log(f"card: {card}")
    _build.library(verbose=args.verbose_build)
    log(f"kernels built via {_build.BUILD_INFO['route']} in "
        f"{_build.BUILD_INFO['seconds']:.1f} s [{card}]")

    errs = check_kernels(dev)
    with tempfile.TemporaryDirectory(prefix="sntc_chip_smoke_") as work:
        summary = serve(dev, work)
        stages = breakdown(dev, work)
    kernels = measure(dev, errs, summary["kernel_launches"])

    rows_per_s = summary["rows"] / summary["seconds"]
    log(f"serve throughput: {rows_per_s:.0f} rows/s over {summary['rows']} "
        f"rows, batches {BATCHES}, bucket floor {BUCKET_FLOOR} [{card}]")
    for p in summary["progress"]:
        log(f"  batch {p['batchId']}: {p['numInputRows']} rows in "
            f"{p['durationMs']:.2f} ms [{card}]")
    for b in stages:
        log(f"breakdown of a {b['rows']}-row batch: read {b['read_ms']:.2f} "
            f"ms, predict {b['predict_ms']:.2f} ms (device busy "
            f"{b['device_ms']} ms, idle share {b['device_idle_share']}), "
            f"sink {b['sink_ms']:.2f} ms; top device ops "
            f"{b['top_device_ops_ms']} [{card}]")
    for k in kernels:
        log(f"{k['name']} {k['shape']}: {k['ms']:.4f} ms (plain "
            f"{k['plain_ms']:.4f} ms, library {k['library_ms']}, bound "
            f"{k['bound_ms']:.4f} ms by {k['bound_by']}); {k['launches']} "
            f"launches over {len(BATCHES)} batches [{card}]")
    if args.out_json:
        os.makedirs(os.path.dirname(os.path.abspath(args.out_json)),
                    exist_ok=True)
        with open(args.out_json, "w") as f:
            json.dump({"card": card, "build": dict(_build.BUILD_INFO),
                       "serve": summary, "rows_per_s": rows_per_s,
                       "breakdown": stages,
                       "kernels": kernels}, f, indent=1)
    print(json.dumps({"kernels": [
        {k2: v for k2, v in k.items() if k2 != "shape"} for k in kernels
    ]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
