"""The port's capture parsers and data writers against the JAX package's,
on the CPU.

Both sides are numpy and the same C++ sources, so every comparison is
bitwise:

* the native and the Python pcap / NetFlow v5 parsers of both packages
  on the same bytes, torn and corrupted captures included
  (``tests/test_pcap.py``, ``tests/test_netflow.py``);
* the bytes of ``make_packet``, ``make_pcap`` and ``make_datagram``;
* ``packets_to_flow_frame`` and ``netflow_to_flow_frame``: the 78
  float32 columns;
* ``write_capture_stream``'s files and ground truth for both formats, at
  a small size (the JAX pcap writer is quadratic in the capture size);
* ``write_day_csvs`` and the two ``synth`` commands' files;
* parquet files cached by one package and loaded by the other;
* the loader: builders racing on one library, and the Python parsers
  when no compiler exists.
"""

import os
import threading

import numpy as np
import pytest

import sntc_tpu.app as jax_app
import sntc_tpu.native as JN
import sntc_tpu.native.netflow as jax_netflow
import sntc_tpu.native.pcap as jax_pcap
from sntc_tpu.core.frame import Frame as JFrame
from sntc_tpu.data import cache_parquet as jax_cache_parquet
from sntc_tpu.data.ingest import load_parquet as jax_load_parquet
from sntc_tpu.data.synth import generate_frame as jax_generate_frame
from sntc_tpu.data.synth import write_capture_stream as jax_write_capture
from sntc_tpu.data.synth import write_day_csvs as jax_write_day_csvs
import sntc_tpu_torch.native as PN
import sntc_tpu_torch.native._loader as loader
import sntc_tpu_torch.native.netflow as port_netflow
import sntc_tpu_torch.native.pcap as port_pcap
from sntc_tpu_torch import app as port_app
from sntc_tpu_torch.core.frame import Frame
from sntc_tpu_torch.data import (
    cache_parquet,
    generate_frame,
    load_parquet,
    write_capture_stream,
    write_day_csvs,
)
from sntc_tpu_torch.resilience import clear_events, recent_events
from jax_metrics_guard import own_jax_registry  # noqa: F401


@pytest.fixture(scope="module", autouse=True)
def _jax_parsers_built():
    """The JAX loader links its libraries in place at first use: another
    test process may be linking one this moment, so a load that fails
    on a half-written file is retried."""
    import time

    import sntc_tpu.native.netflow as jnf
    import sntc_tpu.native.pcap as jpc

    for _ in range(100):
        try:
            jpc._get_lib()
            jnf._get_lib()
            return
        except OSError:
            time.sleep(0.1)


def _packets(seed: int, n: int = 40):
    """Seeded (ts, packet bytes) pairs: TCP and UDP, both directions of
    a few endpoints, assorted payloads, flags and windows."""
    rng = np.random.default_rng(seed)
    out = []
    ts = 1_700_000_000.0
    for i in range(n):
        ts += float(rng.uniform(0.0, 0.7))
        a, b = 0x0A000001 + int(rng.integers(3)), 0x0A800001
        sp, dp = 1024 + int(rng.integers(4)), 80 + int(rng.integers(2))
        fwd = bool(rng.integers(2))
        proto = 6 if rng.uniform() < 0.8 else 17
        out.append((ts, PN.make_packet(
            a if fwd else b, b if fwd else a, sp if fwd else dp,
            dp if fwd else sp, proto=proto,
            payload=int(rng.integers(0, 600)),
            flags=int(rng.integers(256)), window=int(rng.integers(65536)),
        )))
    return out


def _records(seed: int, n: int):
    rng = np.random.default_rng(seed)
    recs = []
    for i in range(n):
        first = int(rng.integers(0, 1_000_000))
        recs.append((
            0xC0A80000 + int(rng.integers(50)), 0xC0A90000 + int(rng.integers(5)),
            int(rng.integers(1024, 65535)), int(rng.integers(1, 1024)),
            int(rng.choice([6, 17])), int(rng.integers(64)), 0,
            int(rng.integers(1, 100)), int(rng.integers(40, 100_000)),
            first, first + int(rng.integers(0, 5000)), 1, 2, 0, 0,
        ))
    return recs


def _frames_equal(a, b):
    assert list(a.columns) == list(b.columns)
    for c in a.columns:
        x, y = np.asarray(a[c]), np.asarray(b[c])
        assert x.dtype == y.dtype, c
        assert np.array_equal(x, y, equal_nan=True), c


def _all_parsers_pcap(data):
    """(port native, port Python, JAX native, JAX Python) parses."""
    return (port_pcap.parse_pcap(data), port_pcap._parse_pcap_py(data),
            jax_pcap.parse_pcap(data), jax_pcap._parse_pcap_py(data))


# ---------------------------------------------------------------------------
# the writers' bytes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("proto", [6, 17])
def test_make_packet_bytes_equal(proto):
    for payload in (0, 1, 100, 1400):
        args = (0x0A000001, 0x0A000002, 1234, 80)
        kw = dict(proto=proto, payload=payload, flags=0x12, window=999)
        assert PN.make_packet(*args, **kw) == JN.make_packet(*args, **kw)


@pytest.mark.parametrize("nanos", [False, True])
@pytest.mark.parametrize("linktype", [1, 101])
def test_make_pcap_bytes_equal(nanos, linktype):
    pkts = _packets(seed=3 + nanos)
    assert (PN.make_pcap(pkts, linktype=linktype, nanos=nanos)
            == JN.make_pcap(pkts, linktype=linktype, nanos=nanos))
    assert PN.make_pcap([]) == JN.make_pcap([])


@pytest.mark.parametrize("n", [0, 1, 17, 30])
def test_make_datagram_bytes_equal(n):
    recs = _records(seed=n, n=n)
    assert (PN.make_datagram(recs, seq=n, unix_secs=5)
            == JN.make_datagram(recs, seq=n, unix_secs=5))
    with pytest.raises(ValueError, match="at most 30"):
        PN.make_datagram(_records(seed=0, n=31))


# ---------------------------------------------------------------------------
# the parsers
# ---------------------------------------------------------------------------


def test_both_packages_use_the_native_parsers():
    assert PN.using_native() and PN.using_native_pcap()
    assert JN.using_native() and JN.using_native_pcap()
    # the port builds its own copies, never the JAX package's libraries
    for lib in (port_pcap._get_lib(), port_netflow._get_lib()):
        assert os.path.dirname(lib._name) == loader.BUILD_DIR


@pytest.mark.parametrize("nanos", [False, True])
def test_pcap_parsers_agree_bitwise(nanos):
    data = PN.make_pcap(_packets(seed=11), nanos=nanos)
    outs = _all_parsers_pcap(data)
    assert outs[0].shape == (40, PN.PCAP_FIELDS)
    for o in outs[1:]:
        assert np.array_equal(outs[0], o)
    assert PN.PCAP_FIELD_NAMES == JN.PCAP_FIELD_NAMES


def test_pcap_parsers_agree_on_torn_and_corrupt_captures():
    data = PN.make_pcap(_packets(seed=12))
    rng = np.random.default_rng(0)
    cases = [data[:24], data[:-7], data[: len(data) // 2], data[:40]]
    for _ in range(6):
        buf = bytearray(data)
        for pos in rng.integers(24, len(data), size=8):
            buf[int(pos)] = int(rng.integers(256))
        cases.append(bytes(buf))
    for case in cases:
        clear_events()
        outs = _all_parsers_pcap(case)
        for o in outs[1:]:
            assert np.array_equal(outs[0], o)
        assert PN.scan_truncation(case) == jax_pcap.scan_truncation(case)
        if PN.scan_truncation(case)[1]:
            (ev,) = recent_events(event="parse_truncated")
            assert ev["site"] == "source.parse" and ev["format"] == "pcap"
    # a bad magic is not a capture in either package
    bad = b"\x00" * 4 + data[4:]
    assert port_pcap.parse_pcap(bad) is None and jax_pcap.parse_pcap(bad) is None
    with pytest.raises(ValueError, match="bad global header"):
        PN.pcap_to_flow_frame(bad)


def test_netflow_parsers_agree_bitwise():
    recs = _records(seed=5, n=75)
    stream = b"".join(PN.make_datagram(recs[k:k + 30], seq=k)
                      for k in range(0, 75, 30))
    p = PN.parse_stream(stream)
    assert p.shape == (75, PN.NF5_FIELDS)
    assert np.array_equal(p, JN.parse_stream(stream))
    assert np.array_equal(p, port_netflow._parse_stream_py(stream))
    assert np.array_equal(p, jax_netflow._parse_stream_py(stream))
    one = PN.make_datagram(recs[:30])
    assert np.array_equal(PN.parse_datagram(one), JN.parse_datagram(one))
    assert np.array_equal(PN.parse_datagram(one),
                          port_netflow._parse_py(one))
    assert PN.NF5_FIELD_NAMES == JN.NF5_FIELD_NAMES


def test_netflow_parsers_agree_on_torn_and_corrupt_streams():
    recs = _records(seed=6, n=60)
    stream = b"".join(PN.make_datagram(recs[k:k + 30], seq=k)
                      for k in range(0, 60, 30))
    d1 = len(PN.make_datagram(recs[:30]))
    poisoned = stream[:d1] + b"\x00\x09" + stream[d1 + 2:]
    for case in (stream[:-5], stream[:-100], stream[: d1 + 10], poisoned,
                 stream[:d1 - 48 * 3 - 7]):
        clear_events()
        assert PN.scan_stream(case) == JN.netflow.scan_stream(case)
        got = PN.parse_stream(case)
        assert np.array_equal(got, JN.parse_stream(case))
        clean, reason = PN.scan_stream(case)
        if reason is not None:
            ev = recent_events(event="parse_truncated")
            assert ev and ev[0]["format"] == "netflow"
        # a single torn datagram salvages the records that fit
        if len(case) < d1:
            assert np.array_equal(PN.parse_datagram(case),
                                  JN.parse_datagram(case))
    assert PN.parse_datagram(b"\x00\x05") is None


# ---------------------------------------------------------------------------
# the meters
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("timeouts", [(120.0, 5.0), (0.5, 0.2)])
def test_packets_to_flow_frame_bitwise(timeouts):
    data = PN.make_pcap(_packets(seed=21, n=200))
    pkts = PN.parse_pcap(data)
    kw = dict(flow_timeout=timeouts[0], activity_timeout=timeouts[1])
    got = PN.packets_to_flow_frame(pkts, **kw)
    want = JN.packets_to_flow_frame(pkts, **kw)
    assert got.num_rows > 1
    _frames_equal(got, want)
    _frames_equal(PN.pcap_to_flow_frame(data, **kw),
                  JN.pcap_to_flow_frame(data, **kw))
    empty = PN.packets_to_flow_frame(np.zeros((0, PN.PCAP_FIELDS)))
    _frames_equal(empty, JN.packets_to_flow_frame(
        np.zeros((0, PN.PCAP_FIELDS))))


def test_netflow_to_flow_frame_bitwise():
    recs = PN.parse_stream(b"".join(
        PN.make_datagram(r, seq=k) for k, r in enumerate(
            [_records(seed=7, n=30), _records(seed=8, n=12)])))
    _frames_equal(PN.netflow_to_flow_frame(recs),
                  JN.netflow_to_flow_frame(recs))


# ---------------------------------------------------------------------------
# the stream writer, the day CSVs, the synth command, the parquet cache
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fmt", ["pcap", "netflow"])
@pytest.mark.parametrize("defer,flush", [(0.0, True), (0.25, True),
                                         (0.2, False)])
def test_write_capture_stream_bytes_equal(tmp_path, fmt, defer, flush):
    kw = dict(n_files=5, flows_per_file=9, packets_per_flow=6, seed=4,
              format=fmt, file_gap_s=2.0, defer_fraction=defer,
              flush=flush)
    a = write_capture_stream(str(tmp_path / "p"), **kw)
    b = jax_write_capture(str(tmp_path / "j"), **kw)
    assert [os.path.basename(f) for f in a["files"]] == [
        os.path.basename(f) for f in b["files"]]
    for fa, fb in zip(a["files"], b["files"]):
        with open(fa, "rb") as x, open(fb, "rb") as y:
            assert x.read() == y.read(), fa
    assert a["n_flows"] == b["n_flows"] == 45
    assert (a["flush_file"] is None) == (b["flush_file"] is None) == (
        not flush)
    key = "packets" if fmt == "pcap" else "records"
    assert np.array_equal(a[key], b[key])


def test_make_pcap_is_linear_in_the_capture(tmp_path):
    """The port's writer joins once: config 9's 62-file stream (93 696
    packets) writes in about a second, where the JAX writer's
    ``body +=`` copies the body once a packet."""
    import time

    t0 = time.perf_counter()
    info = write_capture_stream(
        str(tmp_path / "c9"), n_files=61, flows_per_file=256,
        packets_per_flow=6, seed=7, file_gap_s=30.0, defer_fraction=0.1,
        flush=True)
    assert time.perf_counter() - t0 < 30.0
    assert info["packets"].shape == (93_696, PN.PCAP_FIELDS)
    assert info["n_flows"] == 15_616 and len(info["files"]) == 62


def test_write_day_csvs_and_synth_commands_byte_identical(tmp_path):
    a = write_day_csvs(str(tmp_path / "p"), n_rows_per_day=120, n_days=3,
                       seed=5)
    b = jax_write_day_csvs(str(tmp_path / "j"), n_rows_per_day=120,
                           n_days=3, seed=5)
    for fa, fb in zip(a, b):
        with open(fa, "rb") as x, open(fb, "rb") as y:
            assert x.read() == y.read()
    argv = ["synth", "--rows", "300", "--days", "3", "--seed", "2"]
    assert port_app.main(argv + ["--out", str(tmp_path / "cp")]) == 0
    assert jax_app.main(argv + ["--out", str(tmp_path / "cj")]) == 0
    names = sorted(os.listdir(tmp_path / "cp"))
    assert names == sorted(os.listdir(tmp_path / "cj")) == [
        "day0.csv", "day1.csv", "day2.csv"]
    for n in names:
        assert ((tmp_path / "cp" / n).read_bytes()
                == (tmp_path / "cj" / n).read_bytes())


def test_synth_parser_defaults_match_the_jax_command():
    p = port_app.build_parser().parse_args(["synth", "--out", "x"])
    import argparse

    jp = None
    orig = argparse.ArgumentParser.parse_args

    def capture(self, args=None, namespace=None):
        nonlocal jp
        jp = orig(self, args, namespace)
        raise SystemExit(0)

    argparse.ArgumentParser.parse_args = capture
    try:
        with pytest.raises(SystemExit):
            jax_app.main(["synth", "--out", "x"])
    finally:
        argparse.ArgumentParser.parse_args = orig
    for k in ("out", "rows", "days", "seed"):
        assert getattr(p, k) == getattr(jp, k), k


def test_parquet_cache_crosses_packages(tmp_path):
    pf = generate_frame(500, seed=3)
    jf = jax_generate_frame(500, seed=3)
    cache_parquet(pf, str(tmp_path / "p" / "c.parquet"))
    jax_cache_parquet(jf, str(tmp_path / "j" / "c.parquet"))
    for mm in (True, False):
        got = load_parquet(str(tmp_path / "j" / "c.parquet"),
                           memory_map=mm)
        back = jax_load_parquet(str(tmp_path / "p" / "c.parquet"),
                                memory_map=mm)
        assert isinstance(got, Frame) and isinstance(back, JFrame)
        for c in pf.columns:
            for x, y in ((got[c], jf[c]), (back[c], pf[c])):
                x, y = np.asarray(x), np.asarray(y)
                if x.dtype == object:
                    assert list(x) == list(y), c
                else:
                    assert np.array_equal(x, y, equal_nan=True), c


# ---------------------------------------------------------------------------
# the loader
# ---------------------------------------------------------------------------


def test_loader_builds_race_free_into_the_build_dir(tmp_path, monkeypatch):
    """Eight builders of one library at once (threads here; the tier-1
    workers and the smoke's processes alike) each load a whole library:
    the compiler writes a name of its own and ``os.replace`` publishes
    it.  A source newer than the library rebuilds it."""
    monkeypatch.setattr(loader, "BUILD_DIR", str(tmp_path / "native"))
    src = os.path.join(os.path.dirname(port_pcap.__file__), "pcap.cpp")
    libs = [loader.NativeLib(src, "libpcapflow.so") for _ in range(8)]
    got = [None] * 8

    def build(i):
        got[i] = libs[i].get(port_pcap._configure)

    threads = [threading.Thread(target=build, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert all(g is not None for g in got)
    assert os.listdir(tmp_path / "native") == ["libpcapflow.so"]
    data = PN.make_pcap(_packets(seed=1, n=5))
    out = np.zeros((10, PN.PCAP_FIELDS))
    import ctypes

    n = got[0].pcap_parse(data, len(data), out.ctypes.data_as(
        ctypes.POINTER(ctypes.c_double)), 10)
    assert n == 5 and np.array_equal(out[:5], JN.parse_pcap(data))
    so = str(tmp_path / "native" / "libpcapflow.so")
    old = os.path.getmtime(src) - 100
    os.utime(so, (old, old))
    assert loader.NativeLib(src, "libpcapflow.so").get(
        port_pcap._configure) is not None
    assert os.path.getmtime(so) >= os.path.getmtime(src)


def test_python_parsers_take_over_without_a_compiler(tmp_path, monkeypatch):
    monkeypatch.setattr(loader, "BUILD_DIR", str(tmp_path / "none"))
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    for mod, name in ((port_pcap, "libpcapflow.so"),
                      (port_netflow, "libnetflow.so")):
        monkeypatch.setattr(mod, "_NATIVE", loader.NativeLib(
            mod._NATIVE.src, name))
    assert not PN.using_native_pcap() and not PN.using_native()
    data = PN.make_pcap(_packets(seed=9))
    assert np.array_equal(PN.parse_pcap(data), JN.parse_pcap(data))
    recs = PN.make_datagram(_records(seed=2, n=12))
    assert np.array_equal(PN.parse_stream(recs), JN.parse_stream(recs))
