"""Builds of one kernel source with named constants pinned, timed in
turns, for the variant scripts (``tree_hist_crossover.py``,
``forest_traversal_variants.py``).

:func:`parse_args` reads their common options (``--variant
NAME:CONST=V,...``, ``--baseline NAME=PATH.cu``, ``--out-json``);
:func:`build` compiles one shared library per variant (the source with
its ``constexpr`` constants replaced) and per baseline source, all
``nvcc`` processes started together, and binds the given entry points
with the signatures of ``sntc_tpu_torch.kernels._build``;
:func:`in_turns` times every build on one case, forward then backward.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess

from sntc_tpu_torch.kernels import _build


def parse_args(doc: str, default: dict):
    """The options, the variants (NAME -> constants; ``default`` unless
    ``--variant`` is given) and the baselines (NAME -> path)."""
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("--variant", action="append", default=[],
                    help="NAME:CONST=VALUE[,CONST=VALUE] (repeatable; "
                         f"replaces the default {', '.join(default)})")
    ap.add_argument("--baseline", action="append", default=[],
                    help="NAME=PATH of another source with the same entry "
                         "points (repeatable), e.g. a parent commit's")
    ap.add_argument("--out-json", default=None)
    args = ap.parse_args()
    variants = default
    if args.variant:
        variants = {}
        for v in args.variant:
            name, _, consts = v.partition(":")
            variants[name] = dict(kv.split("=", 1) for kv in consts.split(",")
                                  if kv)
    return args, variants, dict(b.split("=", 1) for b in args.baseline)


def in_turns(launch: dict, timer) -> dict:
    """NAME -> [ms, ms]: ``timer`` of each build's call in ``launch``,
    in turns, forward, then backward."""
    ms = {k: [] for k in launch}
    for k in list(launch) + list(launch)[::-1]:
        ms[k].append(timer(launch[k]))
    return ms


def write_json(path, **record) -> None:
    if path:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            json.dump(record, f, indent=1)


def pin(src: str, consts: dict, what: str) -> str:
    """``src`` with each ``constexpr <type> NAME = ...;`` set to its
    value in ``consts``; each name must occur once."""
    for name, value in consts.items():
        pattern = rf"(constexpr\s+\w+\s+{name}\s*=\s*)[^;]+;"
        if len(re.findall(pattern, src)) != 1:
            raise SystemExit(f"{name} not found once in {what}")
        src = re.sub(pattern, rf"\g<1>{value};", src)
    return src


def build(work: str, src_path: str, variants: dict, baselines: dict,
          entries) -> dict:
    """One bound library per variant (NAME -> constants) and baseline
    (NAME -> path of another source with the same entry points),
    compiled in parallel into ``work``."""
    what = os.path.basename(src_path)
    stem = os.path.splitext(what)[0]
    with open(src_path) as f:
        text = f.read()
    sources = {name: pin(text, consts, what)
               for name, consts in variants.items()}
    for name, path in baselines.items():
        with open(path) as f:
            sources[name] = f.read()
    procs = {}
    for name, src in sources.items():
        cu = os.path.join(work, f"{stem}_{name}.cu")
        with open(cu, "w") as f:
            f.write(src)
        so = os.path.join(work, f"lib{stem}_{name}.so")
        procs[name] = (so, subprocess.Popen(
            [_build._nvcc(), "-std=c++17", "-Xcompiler", "-fPIC", "-shared",
             "-Xptxas=-v", *_build.CUDA_FLAGS, cu, "-o", so],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, p) in procs.items():
        out, _ = p.communicate()
        if p.returncode != 0:
            raise SystemExit(f"nvcc failed for {name}:\n{out}")
        regs = re.findall(r"Used (\d+) registers", out)
        spills = re.findall(r"(\d+) bytes spill stores", out)
        print(f"built {name}: registers per kernel {regs}, spill stores "
              f"{spills} B", flush=True)
        lib = ctypes.CDLL(so)
        for fn in entries:
            getattr(lib, fn).argtypes = _build._SIGNATURES[fn]
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs
