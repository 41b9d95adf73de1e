"""The kernel library's build stamp, and the serve command's startup
split, on the CPU.

``kernels._build.library()`` loads a built library directly when the
stamp beside it matches the sources, the flags and the torch and CUDA
versions, and builds again when the stamp is missing or stale; a library
that fails to load raises ``KernelBuildError`` either way (no fallback).
The card itself is faked here (``torch.cuda.is_available``), and the
builds are stubs: these tests check which route ``library()`` takes, not
a build.  ``serve --once`` reports its ``startup`` block (on the CPU:
the import time, the model's load and the first batch).
"""

import contextlib
import io
import json
import os
import shutil

import numpy as np
import pytest
import torch

from sntc_tpu_torch.data import generate_frame, write_raw_csv
from sntc_tpu_torch.kernels import _build


@pytest.fixture
def fake_build(tmp_path, monkeypatch):
    """A build directory of its own, a faked card, stub builds that
    record their calls and 'build' a file that is no library."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    build = tmp_path / "_build"
    monkeypatch.setattr(_build, "CSRC", str(csrc))
    monkeypatch.setattr(_build, "BUILD_DIR", str(build))
    monkeypatch.setattr(_build, "STAMP", str(build / "k.stamp.json"))
    monkeypatch.setattr(_build, "_LIB", None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    import torch.utils.cpp_extension as ext

    monkeypatch.setattr(ext, "is_ninja_available", lambda: False)
    calls = []

    def stub(sources, verbose):
        calls.append(sorted(os.path.basename(s) for s in sources))
        path = build / "libstub.so"
        path.write_bytes(b"not a shared object")
        return str(path)

    monkeypatch.setattr(_build, "_build_with_nvcc", stub)
    return {"csrc": csrc, "build": build, "calls": calls}


def test_stamp_hashes_sources_and_flags(fake_build, monkeypatch):
    srcs = [os.path.join(_build.CSRC, s) for s in _build.SOURCES]
    a = _build.source_stamp(srcs)
    assert a == _build.source_stamp(srcs)
    with open(srcs[0], "a") as f:
        f.write("\n// touched\n")
    b = _build.source_stamp(srcs)
    assert b != a
    monkeypatch.setattr(_build, "CUDA_FLAGS", _build.CUDA_FLAGS + ["-G"])
    assert _build.source_stamp(srcs) not in (a, b)


def test_missing_or_stale_stamp_builds_and_stamps(fake_build):
    with pytest.raises(_build.KernelBuildError):
        _build.library()
    assert len(fake_build["calls"]) == 1  # no stamp: built
    rec = json.load(open(_build.STAMP))
    srcs = [os.path.join(_build.CSRC, s) for s in _build.SOURCES]
    assert rec["stamp"] == _build.source_stamp(srcs)
    assert rec["path"].endswith("libstub.so")
    # a source changes: the stamp is stale, the next call builds again
    with open(srcs[1], "a") as f:
        f.write("\n// changed\n")
    assert _build._stamped(_build.source_stamp(srcs)) is None
    with pytest.raises(_build.KernelBuildError):
        _build.library()
    assert len(fake_build["calls"]) == 2


def test_matching_stamp_loads_without_building(fake_build):
    srcs = [os.path.join(_build.CSRC, s) for s in _build.SOURCES]
    os.makedirs(fake_build["build"])
    lib = fake_build["build"] / "libbuilt.so"
    lib.write_bytes(b"still not a shared object")
    _build._write_stamp(_build.source_stamp(srcs), str(lib))
    assert _build._stamped(_build.source_stamp(srcs)) == str(lib)
    # the stamped library is loaded as it is: its load failure raises,
    # and nothing is built in its place
    with pytest.raises(_build.KernelBuildError, match="failed"):
        _build.library()
    assert fake_build["calls"] == []
    # a verbose build asks for the compiler: it builds whatever the stamp
    with pytest.raises(_build.KernelBuildError):
        _build.library(verbose=True)
    assert len(fake_build["calls"]) == 1
    # a stamp whose library is gone does not count
    os.remove(json.load(open(_build.STAMP))["path"])
    assert _build._stamped(_build.source_stamp(srcs)) is None


def test_serve_once_reports_its_startup(tmp_path):
    from sntc_tpu_torch.app import main

    data, watch = tmp_path / "days", tmp_path / "in"
    data.mkdir()
    watch.mkdir()
    frame = generate_frame(1500, seed=3, dirty=False)
    write_raw_csv(frame, str(data / "day.csv"))
    write_raw_csv(frame.slice(0, 300).drop("Label"),
                  str(watch / "part_0000.csv"))
    model = str(tmp_path / "m")
    with contextlib.redirect_stdout(io.StringIO()):
        assert main(["train", "--data", str(data), "--estimator", "lr",
                     "--binary", "--max-iter", "5", "--model-out", model,
                     "--device", "cpu"]) == 0
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(["serve", "--model", model, "--watch", str(watch),
                     "--out", str(tmp_path / "out"), "--checkpoint",
                     str(tmp_path / "ckpt"), "--once", "--device",
                     "cpu"]) == 0
    summary = json.loads(buf.getvalue().strip().splitlines()[-1])
    st = summary["startup"]
    assert summary["rows"] == 300
    assert set(st) == {"imported_at", "model_s", "first_batch_s"}
    assert abs(st["imported_at"] - __import__("time").time()) < 600
    assert st["model_s"] >= 0 and st["first_batch_s"] > 0
    assert np.isfinite(st["first_batch_s"])
