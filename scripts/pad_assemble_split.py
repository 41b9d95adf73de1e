"""Where one ``pad_assemble`` call spends its time, in process, on a CUDA card.

    python3 scripts/pad_assemble_split.py [--rows 60000] [--target 65536]
        [--seed 8] [--reps 7] [--out-json PATH]

Run from the root of a checkout (``PYTHONPATH=.``) on a machine with a
CUDA card.  It writes ``--rows`` synthetic flows (``generate_frame``,
the 78 CICIDS2017 features) as CSV and reads them back as the serve
command does (float64 and int64 columns), then times the parts of
``pad_assemble(frame, target, valid, "cuda")`` on that batch and on the
same batch after the admission contract's float32 cast
(``CICIDS2017_CONTRACT.admit``, the block of ``--row-policy salvage``):

* ``pack``: the host's packing of the 78 columns into one block, both
  ways: row-major ``[N, C]`` (one strided copy a column, as the package
  packed before the column-major redesign) and column-major ``[C, N]``
  (one contiguous copy a column), each into a new array as
  ``pad_assemble`` packs; and column-major into one array kept from
  call to call (what a new array's first touch of its pages costs);
  host clock;
* ``upload``: the block's pageable copy to the card, synchronized;
* ``launch``: the device time of one ``pad_rows_cuda`` launch on the
  row-major block and, where the checkout's wrapper takes it, on the
  column-major view (``chip_smoke.kernel_device_ms``: CUDA events
  around launches queued behind a spin);
* ``call``: the whole ``pad_assemble`` call followed by a synchronize,
  host clock;

and the host's time a call of ``pad_rows_cuda`` at ``[1000, 78]`` f64 ->
1024 against ``index_select``'s (host clock over many calls, no
synchronize inside; and ``chip_smoke.time_ms``, CUDA events a call).
Host times are the min, median and max of ``--reps`` repetitions after
two warmups.  The last line is one JSON object with every number and
the card's name and power limit.  ``chip_smoke.py`` calls :func:`split`
on phases 8 and 12's batches.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

from chip_smoke import gpu_line, kernel_device_ms, time_ms
from sntc_tpu_torch.core.frame import Frame, to_host
from sntc_tpu_torch.data import (
    CICIDS2017_CONTRACT,
    generate_frame,
    load_csv,
    write_raw_csv,
)
from sntc_tpu_torch.kernels.assemble import pad_assemble, pad_rows_cuda
from sntc_tpu_torch.utils.profiling import upload


def host_ms(fn, reps: int) -> list:
    """[min, median, max] of ``fn``'s host time in ms (``fn`` ends in a
    synchronize where it touches the card), after two warmups."""
    for _ in range(2):
        fn()
    t = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        t.append((time.perf_counter() - t0) * 1e3)
    return [min(t), float(np.median(t)), max(t)]


def numeric_block(frame: Frame) -> tuple:
    """The host columns ``pad_assemble`` packs into its block (the 1-D
    numeric ones; a flow batch has one item size) and the block's dtype."""
    host = {n: to_host(frame[n]) for n in frame.columns}
    names = [n for n, a in host.items()
             if a.ndim == 1 and a.dtype.kind in "fi"]
    sizes = {host[n].dtype.itemsize for n in names}
    if len(sizes) != 1:
        raise SystemExit(f"expected one item size, got {sizes}")
    return host, names, np.float64 if sizes == {8} else np.float32


def pack_rows(host: dict, names: list, n: int, dt) -> np.ndarray:
    block = np.empty((n, len(names)), dt)
    for j, name in enumerate(names):
        block.view(host[name].dtype)[:, j] = host[name]
    return block


def pack_cols(host: dict, names: list, n: int, dt,
              block_t: np.ndarray | None = None) -> np.ndarray:
    if block_t is None:
        block_t = np.empty((len(names), n), dt)
    for j, name in enumerate(names):
        block_t.view(host[name].dtype)[j] = host[name]
    return block_t


def takes_column_major(dev) -> bool:
    """Whether this checkout's wrapper launches on a column-major view."""
    try:
        pad_rows_cuda(torch.zeros((2, 8), device=dev).t(), 8)
    except ValueError:
        return False
    return True


def split(frame: Frame, target: int, valid: np.ndarray, dev,
          reps: int = 7) -> dict:
    """The parts of one ``pad_assemble(frame, target, valid, dev)``
    call (see the module docs); ms."""
    host, names, dt = numeric_block(frame)
    n = frame.num_rows
    rows = pack_rows(host, names, n, dt)
    cols = pack_cols(host, names, n, dt)
    if not np.array_equal(rows.view(np.uint8).reshape(n, -1),
                          np.ascontiguousarray(cols.T).view(np.uint8)
                          .reshape(n, -1)):
        raise SystemExit("the two packs differ")

    def up():
        upload(cols, dev)
        torch.cuda.synchronize()

    def call():
        pad_assemble(frame, target, valid, dev)
        torch.cuda.synchronize()

    row_dev = torch.from_numpy(rows).to(dev)
    out = {
        "block": f"[{n}, {len(names)}] {np.dtype(dt).name} -> {target}",
        "pack_row_major_ms": host_ms(
            lambda: pack_rows(host, names, n, dt), reps),
        "pack_column_major_ms": host_ms(
            lambda: pack_cols(host, names, n, dt), reps),
        "pack_column_major_kept_array_ms": host_ms(
            lambda: pack_cols(host, names, n, dt, cols), reps),
        "upload_ms": host_ms(up, reps),
        "upload_bytes": int(cols.nbytes),
        "launch_row_major_device_ms": kernel_device_ms(
            lambda: pad_rows_cuda(row_dev, target)),
        "launch_column_major_device_ms": None,
        "call_ms": host_ms(call, reps),
    }
    if takes_column_major(dev):
        col_dev = torch.from_numpy(cols).to(dev).t()
        out["launch_column_major_device_ms"] = kernel_device_ms(
            lambda: pad_rows_cuda(col_dev, target))
    return out


def small_call(dev, n: int = 1000, target: int = 1024, calls: int = 200,
               reps: int = 7) -> dict:
    """The host's time a call at a small bucket: ``pad_rows_cuda`` on a
    contiguous ``[n, 78]`` f64 block (and its column-major view where
    the wrapper takes it) against ``index_select`` of the same rows;
    us a call, host clock over ``calls`` calls; and ms a call by CUDA
    events."""
    a = torch.randn((n, 78), dtype=torch.float64, device=dev)
    idx = torch.clamp(torch.arange(target, device=dev), max=n - 1)
    fns = {"pad_rows_cuda": lambda: pad_rows_cuda(a, target),
           "index_select": lambda: a.index_select(0, idx)}
    if takes_column_major(dev):
        a_t = a.t().contiguous().t()
        fns["pad_rows_cuda column-major"] = lambda: pad_rows_cuda(a_t, target)
    out = {}
    for name, fn in fns.items():
        def many(fn=fn):
            for _ in range(calls):
                fn()
        us = host_ms(many, reps)
        torch.cuda.synchronize()
        out[name] = {"host_us": [x * 1e3 / calls for x in us],
                     "event_ms": time_ms(fn)}
    return out


def flows(rows: int, seed: int, work: str) -> Frame:
    """``rows`` flows as the serve command reads them from CSV."""
    path = os.path.join(work, "flows.csv")
    write_raw_csv(generate_frame(rows, seed=seed).drop("Label"), path)
    return load_csv(path)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=60000)
    ap.add_argument("--target", type=int, default=65536)
    ap.add_argument("--seed", type=int, default=8)
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--out-json", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("pad_assemble_split: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = gpu_line()
    with tempfile.TemporaryDirectory(prefix="pad_split_") as work:
        frame = flows(args.rows, args.seed, work)
    valid = np.zeros(args.target, bool)
    valid[:args.rows] = True
    admitted = CICIDS2017_CONTRACT.admit(frame)
    valid32 = np.zeros(args.target, bool)
    valid32[:args.rows] = admitted.valid
    result = {
        "card": card,
        "f64": split(frame, args.target, valid, dev, args.reps),
        "f32": split(admitted.frame, args.target, valid32, dev, args.reps),
        "small_call": small_call(dev),
    }
    for key in ("f64", "f32"):
        print(f"{key}: {json.dumps(result[key])} [{card}]")
    print(f"small call: {json.dumps(result['small_call'])} [{card}]")
    if args.out_json:
        os.makedirs(os.path.dirname(os.path.abspath(args.out_json)),
                    exist_ok=True)
        with open(args.out_json, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
