"""The port's socket front door against the JAX package's, on the CPU.

The counterparts of ``tests/test_ingress.py`` without the daemon, over
real loopback sockets (every wait has its own deadline).  Each case runs
the same inputs through the JAX package's classes and the port's and
holds the two runs equal, bitwise: the counters' snapshots, the spool's
file names and bytes, ``ingress_stats.json`` (its ephemeral port aside)
and the frames the spool sources read back:

* UDP seal and replay, the idle tail seal, ring overflow conservation
  (``received == spooled + dropped``, exactly), the ``ingress.recv``
  fault, TCP torn and oversize frames with quarantine;
* spool retention below the committed horizon with stable offsets, the
  restart index, the budget shed, an IO fault at the seal, a close that
  discards (counted), ``capture_udp``'s resume;
* each package's spool source serving the other's spool, with the same
  ``ingress_stats.json`` keys;
* ``serve --listen-tcp`` with ``frame_rows`` payloads against the same
  rows served from a CSV file;
* an unkilled socket-fed engine of each package over the same payloads,
  and the port's killed at ``ingress.recv`` and at ``ingress.spool``,
  restarted and resent to: ``sent == committed + journaled drops``, the
  conservation law, and commits, sink and spool bytes equal the JAX
  run's (``scripts/chaos_crash_matrix.py`` ``run_ingress_kill_scenario``).
"""

import glob
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

import sntc_tpu.resilience as JR
from sntc_tpu.serve import ingress as J
from sntc_tpu.serve import netflow_source as JN
from sntc_tpu_torch import app as port_app
from sntc_tpu_torch import resilience as R
from sntc_tpu_torch.data import write_capture_stream
from sntc_tpu_torch.native import make_datagram
from sntc_tpu_torch.serve import ingress as P
from sntc_tpu_torch.serve import netflow_source as PN
from sntc_tpu_torch.serve.ingress import (
    FRAME_HEADER,
    QUARANTINE_DIR,
    CsvSpoolSource,
    IngressSpool,
    NetFlowSpoolSource,
    build_ingress,
    frame_rows,
)
from jax_metrics_guard import own_jax_registry  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SINK_COLS = ["Destination Port", "Flow Duration", "Total Fwd Packets",
             "Total Length of Fwd Packets", "Flow Bytes/s",
             "Flow Packets/s"]
#: each package's ingress module, capture sources and fault registry
PKGS = {"jax": (J, JN, JR), "port": (P, PN, R)}


@pytest.fixture(autouse=True)
def _clean_state():
    for res in (R, JR):
        res.clear()
        res.clear_events()
    yield
    for res in (R, JR):
        res.clear()
        res.clear_events()


@pytest.fixture(scope="module", autouse=True)
def _jax_parsers_built():
    """The JAX loader links its libraries in place at first use: another
    test process may be linking one this moment, so a load that fails
    on a half-written file is retried."""
    import sntc_tpu.native.netflow as jnf
    import sntc_tpu.native.pcap as jpc

    for _ in range(100):
        try:
            jpc._get_lib()
            jnf._get_lib()
            return
        except OSError:
            time.sleep(0.1)


def _dgram(n_records=2, dstport=80, seq=0):
    rec = (0xC0A80001, 0xC0A80002, 1234, dstport, 6, 0x12, 0,
           10, 1000, 1_000, 2_000, 0, 0, 0, 0)
    return make_datagram([rec] * n_records, seq=seq)


def _wait(predicate, timeout=10.0, interval=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(interval)
    return predicate()


def _law(snap):
    return snap["received"] == snap["spooled"] + sum(
        snap["dropped"].values())


def _udp():
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    s.settimeout(5.0)
    return s


def _spool_files(spool_dir):
    """Every file under a spool by its relative path: the bytes, and
    ``ingress_stats.json`` parsed without its ephemeral port."""
    out = {}
    for root, _dirs, files in os.walk(spool_dir):
        for name in files:
            path = os.path.join(root, name)
            rel = os.path.relpath(path, spool_dir)
            with open(path, "rb") as f:
                data = f.read()
            if name == "ingress_stats.json":
                data = json.loads(data)
                for key in ("port", "tcp_port"):
                    data.pop(key, None)
            out[rel] = data
    return out


def _columns(frame):
    """A frame as its columns' dtypes and bytes, comparable with ``==``."""
    return {c: (np.asarray(frame[c]).dtype.str,
                np.asarray(frame[c]).tobytes()) for c in frame.columns}


def _both(run, tmp_path):
    """``run(pkg, dir)`` for the JAX package and the port, each in a
    directory of its own; the two records must be equal.  The port's."""
    got = {pkg: run(pkg, str(tmp_path / pkg)) for pkg in PKGS}
    assert got["port"] == got["jax"]
    return got["port"]


# ---------------------------------------------------------------------------
# the listeners
# ---------------------------------------------------------------------------


def test_udp_roundtrip_seals_and_replays(tmp_path):
    def run(pkg, d):
        ing = PKGS[pkg][0]
        spool = ing.IngressSpool(d)
        lst = ing.UdpIngressListener(spool, ring_datagrams=64,
                                     seal_datagrams=2,
                                     seal_idle_s=0.1).start()
        try:
            tx = _udp()
            for i in range(4):
                tx.sendto(_dgram(seq=i), ("127.0.0.1", lst.port))
            tx.close()
            assert _wait(lambda: spool.stats.received == 4), (
                spool.stats.snapshot())
        finally:
            snap = lst.drain(timeout_s=10.0)
        stats = ing.IngressSpool.read_stats(d)
        assert stats["port"] == lst.port and stats["proto"] == "udp"
        src = ing.NetFlowSpoolSource(d)
        out = {"snap": snap, "files": _spool_files(d),
               "latest": src.latest_offset(),
               "frame": _columns(src.get_batch(0, 2))}
        src.close()
        return out

    got = _both(run, tmp_path)
    snap = got["snap"]
    assert (snap["received"], snap["spooled"], snap["dropped"]) == (4, 4, {})
    assert _law(snap) and snap["drained"] is True
    assert snap["sealed_files"] == 2 and got["latest"] == 2
    dtype, data = got["frame"]["Destination Port"]
    ports = np.frombuffer(data, dtype)
    assert ports.size == 8 and np.all(ports == 80.0)
    src = NetFlowSpoolSource(str(tmp_path / "port"))
    assert src.parser() == "native"
    src.close()


def test_udp_partial_group_idle_seals_without_drain(tmp_path):
    def run(pkg, d):
        ing = PKGS[pkg][0]
        spool = ing.IngressSpool(d)
        lst = ing.UdpIngressListener(spool, ring_datagrams=64,
                                     seal_datagrams=8,
                                     seal_idle_s=0.1).start()
        try:
            tx = _udp()
            for i in range(3):
                tx.sendto(_dgram(seq=i), ("127.0.0.1", lst.port))
            tx.close()
            assert _wait(lambda: spool.stats.spooled == 3, timeout=5.0)
            live = spool.stats.snapshot()
        finally:
            snap = lst.drain(timeout_s=10.0)
        return {"live": live, "snap": snap, "files": _spool_files(d)}

    got = _both(run, tmp_path)
    assert got["live"]["sealed_files"] == 1 and not got["live"]["drained"]
    snap = got["snap"]
    assert snap["received"] == 3 and snap["dropped"] == {} and _law(snap)


def test_udp_ring_overflow_conservation_exact(tmp_path):
    def run(pkg, d):
        ing = PKGS[pkg][0]
        spool = ing.IngressSpool(d)
        lst = ing.UdpIngressListener(spool, ring_datagrams=4,
                                     seal_datagrams=30)
        for i in range(10):
            lst._ingest(_dgram(seq=i))
        before = spool.stats.snapshot()
        lst.start()
        return {"before": before, "snap": lst.drain(timeout_s=10.0),
                "files": _spool_files(d)}

    got = _both(run, tmp_path)
    assert got["before"]["received"] == 10
    assert got["before"]["dropped"] == {"ring_overflow": 6}
    assert got["snap"]["spooled"] == 4 and _law(got["snap"])


def test_udp_recv_fault_drops_one_counted(tmp_path):
    def run(pkg, d):
        ing, _src, res = PKGS[pkg]
        spool = ing.IngressSpool(d)
        lst = ing.UdpIngressListener(spool, ring_datagrams=8,
                                     seal_datagrams=1,
                                     seal_idle_s=0.05).start()
        try:
            res.arm("ingress.recv", kind="exc", times=1)
            tx = _udp()
            tx.sendto(_dgram(seq=0), ("127.0.0.1", lst.port))
            assert _wait(lambda: spool.stats.dropped.get("recv_error") == 1)
            tx.sendto(_dgram(seq=1), ("127.0.0.1", lst.port))
            assert _wait(lambda: spool.stats.spooled == 1)
            tx.close()
        finally:
            snap = lst.drain(timeout_s=10.0)
        return {"snap": snap, "files": _spool_files(d)}

    got = _both(run, tmp_path)
    snap = got["snap"]
    assert snap["received"] == 2 and snap["dropped"] == {"recv_error": 1}
    assert _law(snap)
    assert got["files"]["capture_000000.nf5"] == _dgram(seq=1)


def test_tcp_roundtrip_torn_and_oversize(tmp_path):
    def run(pkg, d):
        ing = PKGS[pkg][0]
        spool = ing.IngressSpool(d, prefix="rows_", suffix=".csv")
        lst = ing.TcpRowIngress(spool, host="127.0.0.1", columns=["x", "y"],
                                seal_rows=2, seal_idle_s=0.1).start()
        try:
            c = socket.create_connection(("127.0.0.1", lst.port),
                                         timeout=5.0)
            c.sendall(frame_rows(["1,2", "3,4"]))
            c.close()
            assert _wait(lambda: spool.stats.spooled == 2)
            c = socket.create_connection(("127.0.0.1", lst.port),
                                         timeout=5.0)
            c.sendall(FRAME_HEADER.pack(100) + b"torn!")
            c.close()
            assert _wait(lambda: spool.stats.quarantined == 1)
            c = socket.create_connection(("127.0.0.1", lst.port),
                                         timeout=5.0)
            c.sendall(FRAME_HEADER.pack(64 << 20))
            assert _wait(
                lambda: spool.stats.dropped.get("oversize_frame") == 1)
            c.close()
        finally:
            snap = lst.drain(timeout_s=10.0)
        src = ing.CsvSpoolSource(d)
        out = {"snap": snap, "files": _spool_files(d),
               "frame": _columns(src.get_batch(0, 1))}
        src.close()
        return out

    got = _both(run, tmp_path)
    snap = got["snap"]
    assert snap["received"] == 4 and snap["spooled"] == 2
    assert snap["dropped"] == {"torn_frame": 1, "oversize_frame": 1}
    assert _law(snap)
    spool_dir = str(tmp_path / "port")
    (qfile,) = glob.glob(os.path.join(spool_dir, QUARANTINE_DIR, "*.bin"))
    assert open(qfile, "rb").read() == FRAME_HEADER.pack(100) + b"torn!"
    (sealed,) = sorted(glob.glob(os.path.join(spool_dir, "rows_*.csv")))
    assert open(sealed, "rb").read() == b"x,y\n1,2\n3,4\n"
    src = CsvSpoolSource(spool_dir)
    frame = src.get_batch(0, 1)
    assert np.allclose(frame["x"], [1.0, 3.0])
    assert np.allclose(frame["y"], [2.0, 4.0])
    src.close()


def test_frame_rows_bytes_equal():
    rows = ["1,2,3", "", "a,b", "x" * 300]
    assert frame_rows(rows) == J.frame_rows(rows)


# ---------------------------------------------------------------------------
# the spool
# ---------------------------------------------------------------------------


def test_spool_retention_prunes_committed_only_offsets_stable(tmp_path):
    def run(pkg, d):
        ing = PKGS[pkg][0]
        committed = {"v": 0}
        spool = ing.IngressSpool(d, keep_files=3,
                                 committed_offset_fn=lambda: committed["v"])
        payloads = [_dgram(seq=i) for i in range(11)]
        for p in payloads[:10]:
            assert spool.seal(p, units=1) is not None
        n_before = len(glob.glob(os.path.join(d, "capture_*.nf5")))
        committed["v"] = 8
        assert spool.seal(payloads[10], units=1) is not None
        out = {"n_before": n_before, "files": _spool_files(d),
               "pruned": spool.stats.pruned_files}
        src = ing.NetFlowSpoolSource(d)
        out["latest"] = src.latest_offset()
        with pytest.raises(ValueError, match="retention horizon") as err:
            src.get_batch(2, 4)
        out["horizon_error"] = str(err.value)
        out["frame"] = _columns(src.get_batch(8, 11))
        src.close()
        spool2 = ing.IngressSpool(d, keep_files=3,
                                  committed_offset_fn=lambda: committed["v"])
        out["resumed"] = os.path.basename(
            spool2.seal(_dgram(seq=99), units=1))
        out["pruned2"] = spool2.stats.pruned_files
        return out

    got = _both(run, tmp_path)
    assert got["n_before"] == 10
    assert sorted(n for n in got["files"] if n.startswith("capture_")) == [
        f"capture_{i:06d}.nf5" for i in (5, 6, 7, 8, 9, 10)]
    assert got["pruned"] == 5 and got["latest"] == 11
    dtype, data = got["frame"]["Destination Port"]
    assert np.frombuffer(data, dtype).size == 6
    assert got["resumed"] == "capture_000011.nf5" and got["pruned2"] == 5


def test_spool_restart_resumes_index_bitwise(tmp_path):
    payloads = [_dgram(n_records=i + 1, seq=i) for i in range(3)]

    def run(pkg, d):
        ing = PKGS[pkg][0]
        spool = ing.IngressSpool(d)
        for p in payloads:
            spool.seal(p, units=1)
        ing.IngressSpool(d).seal(b"tail", units=1)
        return _spool_files(d)

    files = _both(run, tmp_path)
    assert sorted(files) == [f"capture_{i:06d}.nf5" for i in range(4)] + [
        "ingress_stats.json"]
    for i, want in enumerate(payloads):
        assert files[f"capture_{i:06d}.nf5"] == want
    assert files["capture_000003.nf5"] == b"tail"


def test_spool_budget_and_io_fault_shed_counted(tmp_path):
    def run(pkg, d):
        ing, _src, res = PKGS[pkg]
        budget = ing.IngressSpool(os.path.join(d, "b"),
                                  spool_budget_mb=10 / (1 << 20))
        out = {"shed": budget.seal(b"x" * 100, units=3)}
        out["budget_dropped"] = dict(budget.stats.dropped)
        out["ok"] = os.path.basename(budget.seal(b"ok", units=1))
        out["budget_snap"] = budget.stats.snapshot()
        io = ing.IngressSpool(os.path.join(d, "io"))
        res.arm("ingress.spool", kind="enospc", times=1)
        out["doomed"] = io.seal(b"doomed", units=2)
        out["io_dropped"] = dict(io.stats.dropped)
        out["fine"] = os.path.basename(io.seal(b"fine", units=1))
        out["files"] = _spool_files(d)
        return out

    got = _both(run, tmp_path)
    assert got["shed"] is None
    assert got["budget_dropped"] == {"spool_over_budget": 3}
    assert got["ok"] == "capture_000000.nf5"
    assert got["budget_snap"]["received"] == 0
    assert got["doomed"] is None and got["io_dropped"] == {"spool_error": 2}
    assert got["fine"] == "capture_000000.nf5"


def test_listener_close_discards_counted(tmp_path):
    def run(pkg, d):
        ing = PKGS[pkg][0]
        spool = ing.IngressSpool(d)
        lst = ing.UdpIngressListener(spool, ring_datagrams=8,
                                     seal_datagrams=30)
        for i in range(3):
            lst._ingest(_dgram(seq=i))
        lst.start()
        lst.close()
        return {"snap": spool.stats.snapshot(), "files": _spool_files(d)}

    snap = _both(run, tmp_path)["snap"]
    assert snap["dropped"] == {"close_discard": 3} and snap["spooled"] == 0
    assert _law(snap)


def test_seal_near_horizon_writes_stats_through_throttle(tmp_path):
    def run(pkg, d):
        ing = PKGS[pkg][0]
        committed = {"off": 0}
        sp = ing.IngressSpool(d, committed_offset_fn=lambda: committed["off"],
                              keep_files=1)
        sp.stats_interval_s = 3600.0
        sp._stats_written_at = time.monotonic()
        assert sp.seal(b"a" * 32, 1)
        committed["off"] = 1
        assert sp.seal(b"b" * 32, 1)
        out = {"stats": ing.IngressSpool.read_stats(d)}
        for p in glob.glob(os.path.join(d, "capture_*.nf5")):
            os.unlink(p)
        sp2 = ing.IngressSpool(d, committed_offset_fn=lambda: committed[
            "off"], keep_files=1)
        out["resumed"] = os.path.basename(sp2.seal(b"c" * 32, 1))
        out["files"] = _spool_files(d)
        return out

    got = _both(run, tmp_path)
    assert got["stats"]["sealed_files"] == 2
    assert got["resumed"] == "capture_000002.nf5"


def test_capture_udp_resumes_past_existing_index(tmp_path):
    def run(pkg, d):
        capture_udp = PKGS[pkg][1].capture_udp
        os.makedirs(d)
        with open(os.path.join(d, "capture_000007.nf5"), "wb") as f:
            f.write(_dgram(seq=0))
        sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
        got = {}
        t = threading.Thread(target=lambda: got.update(n=capture_udp(
            port, d, 2, timeout_s=5.0, datagrams_per_file=1, sock=sock)))
        t.start()
        tx = _udp()
        deadline = time.monotonic() + 5.0
        while t.is_alive() and time.monotonic() < deadline:
            tx.sendto(_dgram(seq=1), ("127.0.0.1", port))
            time.sleep(0.02)
        t.join(timeout=10.0)
        tx.close()
        return {"captured": got.get("n"), "files": _spool_files(d)}

    got = _both(run, tmp_path)
    assert got["captured"] == 2
    assert sorted(got["files"]) == ["capture_000007.nf5",
                                    "capture_000008.nf5",
                                    "capture_000009.nf5"]
    assert got["files"]["capture_000009.nf5"] == _dgram(seq=1)


def test_build_ingress_requires_exactly_one_listener(tmp_path):
    for make in (build_ingress, J.build_ingress):
        with pytest.raises(ValueError, match="exactly one"):
            make(str(tmp_path / "s"))
        with pytest.raises(ValueError, match="exactly one"):
            make(str(tmp_path / "s"), listen_udp=0, listen_tcp=0)


# ---------------------------------------------------------------------------
# across packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_each_package_serves_the_others_spool(tmp_path, writer):
    """A spool sealed and pruned by one package's listener side replays
    through the other's spool source, offsets and frames equal."""
    spool_dir = str(tmp_path / "spool")
    mod = J if writer == "jax" else None
    Spool = J.IngressSpool if mod else IngressSpool
    committed = {"v": 0}
    sp = Spool(spool_dir, keep_files=2,
               committed_offset_fn=lambda: committed["v"])
    recs = [_dgram(n_records=1 + i % 3, dstport=80 + i, seq=i)
            for i in range(8)]
    for r in recs[:6]:
        sp.seal(r, units=1)
    committed["v"] = 5
    for r in recs[6:]:
        sp.seal(r, units=1)
    sp.publish_stats(port=1, proto="udp")
    a, b = NetFlowSpoolSource(spool_dir), J.NetFlowSpoolSource(spool_dir)
    assert a.latest_offset() == b.latest_offset() == 8
    assert a.files_for_range(3, 8) == b.files_for_range(3, 8)
    fa, fb = a.get_batch(3, 8), b.get_batch(3, 8)
    for c in fa.columns:
        assert np.array_equal(np.asarray(fa[c]), np.asarray(fb[c])), c
    for src in (a, b):
        with pytest.raises(ValueError, match="retention horizon"):
            src.get_batch(0, 2)
        src.close()
    stats = IngressSpool.read_stats(spool_dir)
    assert sorted(stats) == sorted([
        "received", "received_bytes", "spooled", "sealed_files",
        "pruned_files", "quarantined", "dropped", "drained", "next_idx",
        "port", "proto"])
    other = (IngressSpool if mod else J.IngressSpool)(spool_dir)
    assert os.path.basename(other.seal(b"z", units=1)) == (
        "capture_000008.nf5")


# ---------------------------------------------------------------------------
# the serve command
# ---------------------------------------------------------------------------


def _lr_model(tmp_path):
    from test_torch_flow import _jax_lr_model

    return _jax_lr_model(str(tmp_path / "model"))


def test_serve_listen_tcp_equals_the_csv_path(tmp_path):
    """``serve --listen-tcp`` with ``frame_rows`` payloads serves the same
    predictions as the same rows dropped in as one CSV file."""
    from sntc_tpu_torch.data import CICIDS2017_FEATURES, generate_frame
    from sntc_tpu_torch.data import clean_flows

    model = _lr_model(tmp_path)
    frame = clean_flows(generate_frame(60, seed=9))
    rows = [",".join(repr(float(frame[c][i])) for c in CICIDS2017_FEATURES)
            for i in range(frame.num_rows)]
    csv_dir = tmp_path / "csv"
    csv_dir.mkdir()
    (csv_dir / "rows.csv").write_text(
        ",".join(CICIDS2017_FEATURES) + "\n" + "\n".join(rows) + "\n")
    base = ["serve", "--model", model, "--pipeline-depth", "1",
            "--device", "cpu", "--poll-interval", "0.05"]
    assert port_app.main(base + [
        "--watch", str(csv_dir), "--out", str(tmp_path / "o_csv"),
        "--checkpoint", str(tmp_path / "c_csv"), "--once"]) == 0
    spool = str(tmp_path / "spool")
    env = dict(os.environ, PYTHONPATH=REPO, SNTC_FAULTS="")
    proc = subprocess.Popen(
        [sys.executable, "-m", "sntc_tpu_torch", *base, "--watch",
         spool, "--out", str(tmp_path / "o_tcp"), "--checkpoint",
         str(tmp_path / "c_tcp"), "--listen-tcp", "0"],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        assert _wait(lambda: (IngressSpool.read_stats(spool) or {}).get(
            "tcp_port") or proc.poll() is not None, timeout=90.0)
        assert proc.poll() is None, proc.communicate()
        port = IngressSpool.read_stats(spool)["tcp_port"]
        c = socket.create_connection(("127.0.0.1", port), timeout=5.0)
        c.sendall(frame_rows(rows))
        c.close()
        assert _wait(lambda: (IngressSpool.read_stats(spool) or {}).get(
            "spooled") == len(rows), timeout=30.0)
        assert _wait(lambda: sum(
            max(0, len(open(p).read().splitlines()) - 1) for p in glob.glob(
                str(tmp_path / "o_tcp" / "batch_*.csv"))) == len(rows),
            timeout=30.0)
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err[-2000:]
    assert json.loads(out.strip().splitlines()[-1])["drained"] is True
    stats = IngressSpool.read_stats(spool)
    assert stats["received"] == stats["spooled"] == len(rows)
    assert stats["dropped"] == {} and stats["drained"] is True

    def preds(d):
        import pyarrow.csv as pacsv

        out = []
        for p in sorted(glob.glob(os.path.join(d, "batch_*.csv"))):
            t = pacsv.read_csv(p)
            if t.num_rows:
                out += t.column("prediction").to_pylist()
        return out

    got, want = preds(str(tmp_path / "o_tcp")), preds(
        str(tmp_path / "o_csv"))
    assert got == want and len(got) == len(rows)


# ---------------------------------------------------------------------------
# process kills at the ingress sites
# ---------------------------------------------------------------------------

_WORKER = """
import json, os, signal, sys
from {pkg}.core.base import Transformer
from {pkg}.resilience import QuerySupervisor, arm
from {pkg}.serve import CsvDirSink, StreamingQuery
from {pkg}.serve.ingress import build_ingress, wire_committed_offset

class Identity(Transformer):
    def transform(self, frame):
        return frame

d, site, after = sys.argv[1], sys.argv[2], int(sys.argv[3])
if site:
    arm(site, kind="kill", after=after, times=1)
source, listeners = build_ingress(os.path.join(d, "spool"), listen_udp=0,
                                  keep_files=10_000, seal_every=1)
q = StreamingQuery(Identity(), source,
                   CsvDirSink(os.path.join(d, "out"), columns={cols!r}),
                   os.path.join(d, "ckpt"), max_batch_offsets=1{device})
wire_committed_offset(source, q.committed_end)
for l in listeners:
    l.start()
sup = QuerySupervisor(q)
sup.install_signal_handlers()

def drain(signum, frame):
    for l in listeners:
        l.drain()
    sup.request_drain("SIGTERM")

signal.signal(signal.SIGTERM, drain)
try:
    status = sup.run(poll_interval=0.05)
finally:
    for l in listeners:
        l.close()
print(json.dumps({{"drained": status["drained"]}}))
"""
#: the socket-fed engine of each package (the JAX one as its chaos
#: harness runs it, ``ingress_worker_main``)
WORKERS = {
    "jax": _WORKER.format(pkg="sntc_tpu", cols=SINK_COLS, device=""),
    "port": _WORKER.format(pkg="sntc_tpu_torch", cols=SINK_COLS,
                           device=', device="cpu"'),
}

KILL_AFTER = {"ingress.recv": 1, "ingress.spool": 1}


def _spawn(d, site="", pkg="port"):
    env = dict(os.environ, PYTHONPATH=REPO, SNTC_FAULTS="",
               JAX_PLATFORMS="cpu")
    env.pop("SNTC_RESILIENCE_LOG", None)
    return subprocess.Popen(
        [sys.executable, "-c", WORKERS[pkg], d, site,
         str(KILL_AFTER.get(site, 0))],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)


def _committed(ckpt):
    out = {}
    for p in sorted(glob.glob(os.path.join(ckpt, "commits", "*.json"))):
        rec = json.load(open(p))
        out[int(os.path.basename(p)[:-5])] = (rec["start"], rec["end"])
    return out


def _sink(d):
    return {os.path.basename(p): open(p, "rb").read()
            for p in sorted(glob.glob(os.path.join(d, "batch_*.csv")))}


def _drive(d, payloads, site="", timeout=120.0, pkg="port"):
    """Send each payload as one datagram to ``pkg``'s worker and resend
    it only after a worker death, so the sealed file is the ack; a
    killed worker (137) restarts without the fault.  SIGTERM drains once
    every payload is sealed and committed."""
    spool = os.path.join(d, "spool")

    def port_of(proc):
        assert _wait(lambda: (IngressSpool.read_stats(spool) or {}).get(
            "port") or proc.poll() is not None, timeout=90.0)
        assert proc.poll() is None, proc.communicate()
        return IngressSpool.read_stats(spool)["port"]

    def sealed():
        return len(glob.glob(os.path.join(spool, "capture_*.nf5")))

    proc = _spawn(d, site, pkg)
    kills, sent = [], 0
    sock = _udp()
    deadline = time.monotonic() + timeout
    try:
        port = port_of(proc)
        k, pending = 0, False
        while k < len(payloads):
            assert time.monotonic() < deadline, (k, kills)
            if proc.poll() is not None:
                assert proc.returncode == 137, proc.communicate()
                proc.communicate()
                kills.append(proc.returncode)
                os.unlink(os.path.join(spool, "ingress_stats.json"))
                proc = _spawn(d, pkg=pkg)
                port, pending = port_of(proc), False
            if not pending:
                sock.sendto(payloads[k], ("127.0.0.1", port))
                sent, pending = sent + 1, True
            if sealed() > k:
                k, pending = sealed(), False
                continue
            time.sleep(0.02)
        assert _wait(lambda: len(_committed(os.path.join(d, "ckpt")))
                     >= len(payloads), timeout=60.0)
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=60)
    finally:
        sock.close()
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err[-2000:]
    return {"kills": kills, "sent": sent, "sealed": sealed(),
            "stats": IngressSpool.read_stats(spool),
            "commits": _committed(os.path.join(d, "ckpt")),
            "sink": _sink(os.path.join(d, "out")),
            "spool": {k: v for k, v in _spool_files(spool).items()
                      if k.startswith("capture_")}}


@pytest.fixture(scope="module")
def ingress_payloads(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("payloads"))
    info = write_capture_stream(d, n_files=6, flows_per_file=3,
                                packets_per_flow=4, seed=23,
                                format="netflow", flush=False)
    return [open(p, "rb").read() for p in info["files"]]


@pytest.fixture(scope="module")
def ingress_reference(ingress_payloads, tmp_path_factory):
    """The JAX package's unkilled socket-fed run over the payloads."""
    return _drive(str(tmp_path_factory.mktemp("ref")), ingress_payloads,
                  pkg="jax")


def test_ingress_unkilled_run_equals_the_jax_run(tmp_path, ingress_payloads,
                                                 ingress_reference):
    ref = ingress_reference
    assert not ref["kills"] and len(ref["sink"]) == len(ingress_payloads)
    got = _drive(str(tmp_path), ingress_payloads)
    assert not got["kills"] and got["sent"] == ref["sent"]
    assert got["stats"] == dict(ref["stats"], port=got["stats"]["port"])
    for key in ("sealed", "commits", "sink", "spool"):
        assert got[key] == ref[key], key


@pytest.mark.parametrize("site", ["ingress.recv", "ingress.spool"])
def test_ingress_kill_converges_bitwise(tmp_path, site, ingress_payloads,
                                        ingress_reference):
    ref = ingress_reference
    assert not ref["kills"] and len(ref["sink"]) == len(ingress_payloads)
    got = _drive(str(tmp_path), ingress_payloads, site=site)
    stats = got["stats"]
    dropped = sum(stats["dropped"].values())
    assert got["kills"] == [137]
    assert got["sealed"] == len(ingress_payloads)
    assert len(ingress_payloads) == len(got["commits"]) + dropped
    assert stats["received"] == stats["spooled"] + dropped
    assert stats["drained"] is True
    assert got["commits"] == ref["commits"]
    assert got["sink"] == ref["sink"]
    assert got["spool"] == ref["spool"]


@pytest.mark.cuda
def test_spool_served_on_the_card_equals_the_cpu(tmp_path):
    import torch

    from sntc_tpu_torch.app import serving_form
    from sntc_tpu_torch.mlio import load_model
    from sntc_tpu_torch.serve import BatchPredictor, CsvDirSink, StreamingQuery

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    model_dir = _lr_model(tmp_path)
    info = write_capture_stream(str(tmp_path / "gen"), n_files=4,
                                flows_per_file=40, packets_per_flow=4,
                                seed=5, format="netflow", flush=False)
    spool_dir = str(tmp_path / "spool")
    spool = IngressSpool(spool_dir)
    for p in info["files"]:
        assert spool.seal(open(p, "rb").read(), units=1)
    preds = {}
    for dev in ("cpu", "cuda"):
        model, _labels, cols = serving_form(
            load_model(model_dir, device=dev), "label", True)
        q = StreamingQuery(
            BatchPredictor(model, bucket_rows=64, device=dev),
            NetFlowSpoolSource(spool_dir),
            CsvDirSink(str(tmp_path / dev), columns=["prediction"]),
            str(tmp_path / f"ck_{dev}"), max_batch_offsets=1, device=dev)
        assert q.process_available() == 4
        q.stop()
        import pyarrow.csv as pacsv

        preds[dev] = [pacsv.read_csv(p).column("prediction").to_pylist()
                      for p in sorted(glob.glob(str(tmp_path / dev /
                                                    "batch_*.csv")))]
    assert preds["cuda"] == preds["cpu"] and sum(map(len, preds["cpu"])) > 0


# ---------------------------------------------------------------------------
# ingress tenants on the serve daemon (tests/test_ingress.py:403, :427)
# ---------------------------------------------------------------------------


def test_tenant_spec_ingress_validation():
    """The ingress block's checks give the JAX package's messages."""
    from sntc_tpu.serve import TenantSpec as JSpec
    from sntc_tpu_torch.serve import TenantSpec as PSpec

    def errors(spec_cls):
        out = []
        for kw in ({"watch": "w/", "ingress": {"listen_udp": 0,
                                                "listen_tcp": 0}},
                   {"watch": "w/", "ingress": {"spool_mb": 8}},
                   {"watch": "w/", "ingress": {"listen_udp": 0,
                                                "bogus_knob": 1}},
                   {"ingress": {"listen_udp": 0}},
                   {"watch": "w/", "from_capture": "pcap",
                    "ingress": {"listen_udp": 0}}):
            with pytest.raises(ValueError) as exc:
                spec_cls("t", model=object(), out="o/", **kw)
            out.append(str(exc.value))
        return out

    port = errors(PSpec)
    assert port == errors(JSpec)
    assert "exactly one" in port[0] and "watch" in port[3] \
        and "pcap" in port[4]


def _tcp_daemon(pkg, d):
    """One daemon tenant behind a framed-TCP listener: rows sent over a
    real socket come out of its sink; the spool and its stats carry the
    tenant."""
    if pkg == "jax":
        import sntc_tpu.resilience as res
        from sntc_tpu.core.base import Transformer as T
        from sntc_tpu.serve import ServeDaemon, TenantSpec

        dev = {}
    else:
        import sntc_tpu_torch.resilience as res
        from sntc_tpu_torch.core.base import Transformer as T
        from sntc_tpu_torch.serve import ServeDaemon, TenantSpec

        dev = {"device": "cpu"}

    class Identity(T):
        def transform(self, frame):
            return frame

    res.clear_events()
    spool_dir = os.path.join(d, "spool")
    out_dir = os.path.join(d, "out")
    spec = TenantSpec("net", model=Identity(), watch=spool_dir, out=out_dir,
                      out_columns=["x"],
                      ingress={"listen_tcp": 0, "columns": ["x"],
                               "seal_every": 2})
    daemon = ServeDaemon([spec], os.path.join(d, "root"), **dev)
    try:
        assert _wait(lambda: (IngressSpool.read_stats(spool_dir) or {}).get(
            "tcp_port"), timeout=15.0)
        port = IngressSpool.read_stats(spool_dir)["tcp_port"]
        c = socket.create_connection(("127.0.0.1", port), timeout=5.0)
        c.sendall(frame_rows(["5", "7"]))
        c.close()
        assert _wait(lambda: glob.glob(os.path.join(spool_dir,
                                                    "rows_*.csv")),
                     timeout=15.0)
        assert _wait(lambda: daemon.process_available() >= 1,
                     timeout=15.0)
    finally:
        daemon.close()
    stats = IngressSpool.read_stats(spool_dir)
    rows = []
    for b in sorted(glob.glob(os.path.join(out_dir, "*.csv"))):
        with open(b) as f:
            rows.extend(ln.strip() for ln in f.readlines()[1:] if ln.strip())
    drained = [r.get("tenant") for r in res.recent_events(
        event="ingress_drained")]
    return ({k: stats[k] for k in ("drained", "received", "spooled",
                                   "dropped")}, rows, drained)


def test_daemon_tcp_ingress_end_to_end(tmp_path):
    """Per-tenant TCP ingress end to end, in both packages: received ==
    spooled == 2, the listener drained before the engine settled, the
    rows in the tenant's sink, the drain event tagged."""
    got = _both(_tcp_daemon, tmp_path)
    stats, rows, drained = got
    assert stats == {"drained": True, "received": 2, "spooled": 2,
                     "dropped": {}}
    assert [float(r) for r in rows] == [5.0, 7.0]
    assert drained == ["net"]
