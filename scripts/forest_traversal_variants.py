"""Time builds of forest_traversal that differ in their constants, at
every launch shape of config 3's serve and evaluation.

    python3 scripts/forest_traversal_variants.py
        [--variant NAME:CONST=V[,CONST=V]]... [--baseline NAME=PATH.cu]...
        [--out-json PATH]

Run from the root of a checkout on a machine with a CUDA card and nvcc.
Builds ``sntc_tpu_torch/kernels/csrc/forest_traversal.cu`` once per
variant with its named ``constexpr`` constants pinned (by default one,
the source as it is) and other sources with the same entry points
(``--baseline``).  Every build is held bitwise against the plain version
on every case, then timed in turns by ``chip_smoke.kernel_device_ms``
(device time a launch, 100 launches queued back to back):
``chip_smoke.py``'s random depth-10 forest and the served config-3
forest over traffic rows, each at 512, 2 048, 49 950 and 65 536 rows,
and a depth-15 forest, a GBT-like one (depth 5, S=1) and an f64 one at
65 536 rows.  It prints one line per case.
"""

from __future__ import annotations

import os
import sys
import tempfile

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as smoke  # noqa: E402
from kernel_variants import build, in_turns, parse_args, write_json  # noqa: E402
from sntc_tpu_torch.data import clean_flows, generate_frame  # noqa: E402
from sntc_tpu_torch.kernels import _build  # noqa: E402
from sntc_tpu_torch.kernels.forest import (  # noqa: E402
    forest_leaf_stats_reference,
)

SRC = os.path.join(_build.CSRC, "forest_traversal.cu")
ENTRY = {torch.float32: "sntc_forest_leaf_stats_f32",
         torch.float64: "sntc_forest_leaf_stats_f64"}


def launcher(lib, args, depth: int):
    """A call of ``lib``'s entry point, as the wrapper makes it."""
    X, feat, thr, leaf = args
    N, F = X.shape
    T, M = feat.shape
    S = leaf.shape[2]
    fn = getattr(lib, ENTRY[X.dtype])
    stream = _build.stream_handle(X.device)

    def call():
        out = torch.empty((T, N, S), dtype=X.dtype, device=X.device)
        err = fn(X.data_ptr(), feat.data_ptr(), thr.data_ptr(),
                 leaf.data_ptr(), out.data_ptr(), N, F, T, M, S, depth,
                 stream)
        if err != 0:
            raise SystemExit(f"launch failed: CUDA error {err}")
        return out
    return call


def cases(dev) -> dict:
    """(args, depth) by name: the smoke's shapes on its two forests, and
    a deep, a GBT-like and an f64 forest at the largest batch."""
    rng = np.random.default_rng(smoke.SEED + 2)
    T, D, F, S = smoke.TREES, smoke.DEPTH, smoke.TOP, smoke.CLASSES
    n_max = max(smoke.FOREST_ROWS)
    forest = smoke.random_forest(rng, T, D, F, S, leaf_p=0.0)
    X = rng.normal(size=(n_max, F)).astype(np.float32)
    on = lambda *a: [torch.from_numpy(x).to(dev) for x in a]  # noqa: E731
    Xd, fd = on(X)[0], on(*forest)
    traffic = clean_flows(generate_frame(n_max + 2000, seed=smoke.SEED))
    pipe, selected = smoke.build_pipeline(traffic.slice(0, n_max), dev)
    rf = pipe.getStages()[-1]
    Xs = np.stack([traffic[smoke.CICIDS2017_FEATURES[j]] for j in selected],
                  axis=1)[:n_max]
    Xt, ft = rf._features_on_device(Xs), list(rf._device_forest())
    out = {}
    for n in smoke.FOREST_ROWS:
        out[f"random depth-{D}, N={n}"] = ([Xd[:n].contiguous(), *fd], D)
        out[f"served config-3, N={n}"] = ([Xt[:n].contiguous(), *ft], D)
    for name, depth, s, dtype, leaf_p in (
            ("depth 15", 15, S, np.float32, 0.1),
            ("GBT-like depth 5, S=1", 5, 1, np.float32, 0.0),
            (f"f64 depth {D}", D, S, np.float64, 0.0)):
        f, t, l = smoke.random_forest(rng, T, depth, F, s, dtype,
                                      leaf_p=leaf_p)
        out[f"{name}, N={n_max}"] = (
            on(X.astype(dtype), f, t, l), depth)
    return out


def main() -> int:
    args, variants, baselines = parse_args(__doc__, {"source": {}})
    if not torch.cuda.is_available():
        print("forest_traversal_variants: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = smoke.gpu_line()
    with tempfile.TemporaryDirectory(prefix="sntc_forest_variants_") as work:
        libs = build(work, SRC, variants, baselines, ENTRY.values())
    rows = []
    for name, (a, depth) in cases(dev).items():
        ref = forest_leaf_stats_reference(*a, max_depth=depth)
        launch = {k: launcher(lib, a, depth) for k, lib in libs.items()}
        for k, call in launch.items():
            if not torch.equal(call(), ref):
                raise SystemExit(f"{name}: the {k} build differs from the "
                                 "plain version")
        del ref
        ms = in_turns(launch, smoke.kernel_device_ms)
        nbytes, _ = smoke.forest_work(*a, depth=depth)
        bound = nbytes / smoke.HBM_BYTES_PER_S * 1e3
        rows.append({"case": name, "bytes": nbytes, "bound_ms": bound,
                     "device_ms": ms})
        best = min(ms, key=lambda k: min(ms[k]))
        print(f"{name} (bound {bound:.4f} ms), device ms a launch: "
              + ", ".join(f"{k} {' '.join(f'{x:.4f}' for x in v)}"
                          for k, v in ms.items())
              + f"; fastest {best} [{card}]", flush=True)
    write_json(args.out_json, card=card, variants=variants,
               baselines=baselines, rows=rows)
    return 0


if __name__ == "__main__":
    sys.exit(main())
