"""Time builds of tree_hist that differ in their constants, at every
launch shape of config 3's fit.

    python3 scripts/tree_hist_crossover.py [--variant NAME:CONST=V[,CONST=V]]...
        [--baseline NAME=PATH.cu]... [--out-json PATH]

Run from the root of a checkout on a machine with a CUDA card and nvcc.
``sntc_tpu_torch/kernels/csrc/tree_hist.cu`` picks its regime by shape
(the shared-memory histograms or one thread per row with reductions in
L2); the switch and the rows regime's sizes are named constants.  This
script builds that source once per variant, each with the named
constants pinned (by default two: ``shared``, the shared regime
wherever a whole feature fits, and ``rows``, the rows regime
everywhere), and optionally other sources with the same entry point
(``--baseline``, e.g. the parent commit's; the entry point takes the
stats' tree stride since the per-tree-stats form, so an older source
needs that argument added).  It records the inputs of
the 12 launches of one full-width fit (``chip_smoke.py``'s train split
and pipeline), adds ``chip_smoke.py``'s uniform shapes, its root level
cut to 1 to 8 trees and GBT's shape at 1 to 64 nodes, and times every build on every case with CUDA events,
in turns (forward, then backward), each result held against the plain
version first: bitwise on integer stats, within HIST_TOL of each cell's
absolute sum on fractional ones.  It prints one line per case and
build.  The switch itself stays a constant in the source; this script
only measures where it should sit.
"""

from __future__ import annotations

import os
import sys
import tempfile

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as smoke  # noqa: E402
from kernel_variants import build, in_turns, parse_args, write_json  # noqa: E402
from sntc_tpu_torch.kernels import _build  # noqa: E402
from sntc_tpu_torch.kernels.histogram import (  # noqa: E402
    tree_hist_plan,
    tree_hist_reference,
)

SRC = os.path.join(_build.CSRC, "tree_hist.cu")
DEFAULT_VARIANTS = {"shared": {"kMaxSmemScans": str(1 << 62)},
                    "rows": {"kMaxSmemScans": "0"}}
SMEM_FLOATS = 96 * 1024 // 4  # kSmemFloats of the source


def gbt_cases(gbt: dict) -> dict:
    """GBT's shape (one tree, 128 bins, S=3, fractional) at 1 to 64
    nodes, node ids uniform from a seeded generator."""
    gen = torch.Generator(device=gbt["node_idx"].device).manual_seed(7)
    out = {}
    for nodes in (1, 2, 4, 8, 16, 32, 64):
        c = dict(gbt, n_nodes=nodes)
        c["node_idx"] = torch.randint(
            0, nodes, gbt["node_idx"].shape, generator=gen,
            device=gbt["node_idx"].device, dtype=torch.int32)
        out[f"gbt {nodes} nodes"] = c
    return out


def agrees(out: torch.Tensor, c: dict, ref: torch.Tensor) -> bool:
    if c["integer"]:
        return torch.equal(out, ref)
    args_, kw = smoke._hist_args(c)
    bins, node, stats, w = args_
    scale = tree_hist_reference(bins, node, stats.abs(),
                                None if w is None else w.abs(), **kw)
    return bool(((out - ref).abs() <= smoke.HIST_TOL * scale).all())


def launcher(lib, c: dict):
    """A call of ``lib``'s entry point on case ``c``, as the wrapper
    makes it: a zeroed output, then the launch."""
    bins, node, stats, w = c["binned_t"], c["node_idx"], c["stats"], c["weights"]
    F, N = bins.shape
    T, S = node.shape[0], stats.shape[-1]
    shape = (T, F, c["n_nodes"] * c["n_bins"], S)
    stride = N * S if stats.ndim == 3 else 0  # per-tree or shared stats
    stream = _build.stream_handle(stats.device)

    def call():
        out = torch.zeros(shape, dtype=torch.float32, device=stats.device)
        err = lib.sntc_tree_hist_f32(
            bins.data_ptr(), node.data_ptr(),
            None if w is None else w.data_ptr(), stats.data_ptr(),
            out.data_ptr(), N, F, T, c["n_nodes"], c["n_bins"], S, stride,
            stream)
        if err != 0:
            raise SystemExit(f"launch failed: CUDA error {err}")
        return out
    return call


def main() -> int:
    args, variants, baselines = parse_args(__doc__, DEFAULT_VARIANTS)
    if not torch.cuda.is_available():
        print("tree_hist_crossover: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = smoke.gpu_line()
    with tempfile.TemporaryDirectory(prefix="sntc_crossover_") as work:
        libs = build(work, SRC, variants, baselines,
                     ["sntc_tree_hist_f32"])
        data = smoke.fit_data(work)
        uniform = smoke.hist_cases(data["train"], dev)
        smoke.pipeline(dev, smoke.DEPTH).fit(data["train"])  # warm pass
        with smoke.recording_tree_hist() as calls:
            smoke.pipeline(dev, smoke.DEPTH).fit(data["train"])
        torch.cuda.synchronize()
        cases = {}
        for i, (c, (level, nodes)) in enumerate(zip(calls,
                                                    smoke.fit_launches())):
            cases[f"launch {i}: level {level}, {nodes} nodes"] = c
        cases.update({f"uniform {k}": v for k, v in uniform.items()
                      if k != "gbt"})
        cases.update(gbt_cases(uniform["gbt"]))
        root = uniform["root level"]
        for T in (1, 2, 4, 8):
            cases[f"uniform root level, {T} trees"] = dict(
                root, node_idx=root["node_idx"][:T].contiguous(),
                weights=root["weights"][:T].contiguous())
        rows = []
        for name, c in cases.items():
            args_, kw = smoke._hist_args(c)
            ref = tree_hist_reference(*args_, **kw)
            launch = {k: launcher(lib, c) for k, lib in libs.items()}
            for k, call in launch.items():
                if not agrees(call(), c, ref):
                    raise SystemExit(f"{name}: the {k} build differs from "
                                     "the plain version")
            del ref
            ms = in_turns(launch, smoke.time_ms)
            F, N = c["binned_t"].shape
            T, S = c["node_idx"].shape[0], c["stats"].shape[-1]
            feat_floats = c["n_nodes"] * c["n_bins"] * S
            row = {"case": name, "F": F, "N": N, "T": T, "S": S,
                   "nodes": c["n_nodes"], "bins": c["n_bins"],
                   "whole_feats_per_block": SMEM_FLOATS // feat_floats,
                   "ms": ms,
                   "current_plan": tree_hist_plan(N, F, T, c["n_nodes"],
                                                  c["n_bins"], S)}
            rows.append(row)
            best = min(ms, key=lambda k: min(ms[k]))
            print(f"{name} [{F}, {N}] T={T}, {c['n_nodes']} nodes, "
                  f"B={c['n_bins']}, S={S}, {row['whole_feats_per_block']} "
                  f"whole features a block: "
                  + ", ".join(f"{k} {v}" for k, v in ms.items())
                  + f" ms; fastest {best} [{card}]", flush=True)
    write_json(args.out_json, card=card, variants=variants,
               baselines=baselines, rows=rows)
    return 0


if __name__ == "__main__":
    sys.exit(main())
