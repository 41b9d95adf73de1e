"""The port's row admission against the JAX package's, on the CPU.

Counterpart of ``tests/test_admission.py``: the same numpy-seeded inputs
go through both packages, and every comparison is bitwise unless it says
otherwise.

* ``SchemaContract.admit``: ``valid``, ``rejects``, ``coerced`` and the
  sanitized frame, in every mode, on hand-made frames and on generated
  CICIDS2017 flows under ``CICIDS2017_CONTRACT``; ``Frame.
  fill_invalid_rows``'s donor rows; ``clean_flows`` drop/zero against
  the contract's salvage/permissive.
* The CSV parser: errors naming file and line, per-line salvage rejects
  (file, line, raw, reason); the ``source.parse`` DATA kinds mutate the
  same bytes as the JAX package's for the same spec and payload.
* The engine: salvage dead letters (records equal apart from ``ts``),
  strict quarantine, parse salvage with file and line, the file-scoped
  reject drain, the merged row journal.
* The masked dispatch: a batch with an excised row goes through
  ``pad_assemble`` (here its plain version) even when it fills its
  bucket, and the OOM split's halves carry their masks.  The port of
  ``tests/test_admission.py:499``: a scaler → LR/NB pipeline (the port
  has no MinMaxScaler: a StandardScaler without centering) served with
  shape buckets and fusion, salvage output bitwise equal to serving the
  pre-cleaned stream, ``compile_events`` flat; against the JAX engine
  (``SNTC_SERVE_HOST_ROWS=0``) predictions equal and probabilities
  within 1e-6 (f32 products in another order).
* The ``serve`` command of both packages with ``--row-policy salvage``
  and ``permissive`` over uncleaned CSVs with ragged lines: the same
  batch files as serving the pre-cleaned rows, the same row dead
  letters.
"""

import glob
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import sntc_tpu.resilience as J
import sntc_tpu_torch.resilience as R
from sntc_tpu.core.base import Pipeline as JPipeline
from sntc_tpu.core.base import Transformer as JTransformer
from sntc_tpu.core.frame import Frame as JFrame
from sntc_tpu.data import clean_flows as jax_clean_flows
from sntc_tpu.data.ingest import load_csv as jax_load_csv
from sntc_tpu.data.ingest import load_csv_dir as jax_load_csv_dir
from sntc_tpu.data.schema import CICIDS2017_CONTRACT as J_CONTRACT
from sntc_tpu.data.schema import ColumnSpec as JColumnSpec
from sntc_tpu.data.schema import SchemaContract as JSchemaContract
from sntc_tpu.data.schema import SchemaViolation as JSchemaViolation
from sntc_tpu.data.synth import generate_frame as jax_generate_frame
from sntc_tpu.feature import StandardScaler as JStandardScaler
from sntc_tpu.feature import StringIndexer as JStringIndexer
from sntc_tpu.feature import VectorAssembler as JVectorAssembler
from sntc_tpu.fuse import compile_pipeline as jax_compile_pipeline
from sntc_tpu.mlio import save_model as jax_save_model
from sntc_tpu.models import LogisticRegression as JLR
from sntc_tpu.models import NaiveBayes as JNaiveBayes
from sntc_tpu.models import RandomForestClassifier as JRandomForest
from sntc_tpu.serve import FileStreamSource as JFileStreamSource
from sntc_tpu.serve import MemorySink as JMemorySink
from sntc_tpu.serve import MemorySource as JMemorySource
from sntc_tpu.serve import StreamingQuery as JStreamingQuery
from sntc_tpu_torch.core.base import Transformer
from sntc_tpu_torch.core.frame import Frame, to_host
from sntc_tpu_torch.data import (
    CICIDS2017_CONTRACT,
    CICIDS2017_FEATURES,
    ColumnSpec,
    SchemaContract,
    SchemaViolation,
    clean_flows,
    load_csv,
    load_csv_dir,
    write_raw_csv,
)
from sntc_tpu_torch.fuse import compile_pipeline, fusion_stats
from sntc_tpu_torch.mlio import load_model
from sntc_tpu_torch.serve import (
    BatchPredictor,
    FileStreamSource,
    MemorySink,
    MemorySource,
    StreamingQuery,
)
from jax_metrics_guard import own_jax_registry  # noqa: F401

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean_state(monkeypatch):
    monkeypatch.delenv("SNTC_FAULTS", raising=False)
    monkeypatch.setenv("SNTC_SERVE_HOST_ROWS", "0")
    for pkg in (J, R):
        pkg.clear()
        pkg.clear_events()
    yield
    for pkg in (J, R):
        pkg.clear()
        pkg.clear_events()


class _Identity(Transformer):
    def transform(self, frame):
        return frame


class _JIdentity(JTransformer):
    def transform(self, frame):
        return frame


def _same_frame(port, jax):
    assert port.columns == jax.columns
    for c in port.columns:
        a, b = to_host(port[c]), np.asarray(jax[c])
        assert a.dtype == b.dtype, c
        np.testing.assert_array_equal(a, b, err_msg=c)


def _same_admission(port_res, jax_res):
    np.testing.assert_array_equal(port_res.valid, jax_res.valid)
    assert port_res.rejects == jax_res.rejects
    assert port_res.coerced == jax_res.coerced
    assert port_res.num_rejected == jax_res.num_rejected
    _same_frame(port_res.frame, jax_res.frame)


def _xy(pkg, **kw):
    spec, contract = ((ColumnSpec, SchemaContract) if pkg == "port"
                      else (JColumnSpec, JSchemaContract))
    return contract({"x": spec(fill=0.0), "y": spec(fill=0.0)}, **kw)


# ---------------------------------------------------------------------------
# SchemaContract
# ---------------------------------------------------------------------------


def test_strict_raises_with_reasons():
    x = {"x": np.array([1.0, np.nan]), "y": np.array([1.0, 2.0])}
    with pytest.raises(SchemaViolation) as pe:
        _xy("port").admit(Frame(x), mode="strict")
    with pytest.raises(JSchemaViolation) as je:
        _xy("jax").admit(JFrame(x), mode="strict")
    assert pe.value.reasons == je.value.reasons == [
        {"column": "x", "reason": "non_finite", "count": 1}]
    assert str(pe.value) == str(je.value)


SALVAGE_CASES = {
    "nan_inf": {"x": np.array([1.0, np.nan, 3.0, np.inf]),
                "y": np.array([1.0, 2.0, 3.0, 4.0])},
    "leading_run": {"x": np.array([np.nan, -np.inf, 3.0, 4.0, np.nan]),
                    "y": np.array([1.0, 2.0, np.nan, 4.0, 5.0])},
    "all_bad": {"x": np.array([np.nan, np.inf]),
                "y": np.array([1.0, 2.0])},
    "ints": {"x": np.array([1, 2, 3], dtype=np.int64),
             "y": np.array([0.5, np.nan, 1.5], dtype=np.float32)},
    "text": {"x": np.array(["1.5", "junk", "inf", "2"], dtype=object),
             "y": np.array([np.nan, 2.0, -1.0, 4.0])},
}


@pytest.mark.parametrize("mode", ["salvage", "permissive"])
@pytest.mark.parametrize("case", sorted(SALVAGE_CASES))
def test_admit_matches_jax(case, mode):
    x = SALVAGE_CASES[case]
    _same_admission(_xy("port").admit(Frame(x), mode=mode),
                    _xy("jax").admit(JFrame(x), mode=mode))


def test_salvage_masks_and_sanitizes():
    f = Frame(SALVAGE_CASES["nan_inf"])
    res = _xy("port").admit(f, mode="salvage")
    np.testing.assert_array_equal(res.valid, [True, False, True, False])
    assert res.frame.num_rows == 4
    assert np.isfinite(res.frame["x"]).all()
    assert res.frame["x"].dtype == np.float32
    assert [r["row"] for r in res.rejects] == [1, 3]


def test_range_domain_and_missing_column():
    def contract(pkg):
        spec, c = ((ColumnSpec, SchemaContract) if pkg == "port"
                   else (JColumnSpec, JSchemaContract))
        return c({"x": spec(min_value=0.0, max_value=10.0),
                  "tag": spec(dtype="str", domain=("a", "b"))})

    x = {"x": np.array([5.0, 11.0, 2.0]),
         "tag": np.array(["a", "b", "z"], dtype=object)}
    res = contract("port").admit(Frame(x), mode="salvage")
    _same_admission(res, contract("jax").admit(JFrame(x), mode="salvage"))
    assert {r["reason"] for r in res.rejects} == {"out_of_range",
                                                 "out_of_domain"}
    with pytest.raises(SchemaViolation) as pe:
        contract("port").admit(Frame({"x": np.array([1.0])}),
                               mode="salvage")
    with pytest.raises(JSchemaViolation) as je:
        contract("jax").admit(JFrame({"x": np.array([1.0])}),
                              mode="salvage")
    assert pe.value.reasons == je.value.reasons
    assert pe.value.reasons[0]["reason"] == "missing_column"


def test_with_mode_and_validation():
    c = _xy("port", mode="salvage")
    assert c.with_mode("salvage") is c
    assert c.with_mode("strict").mode == "strict"
    assert c.columns is c.with_mode("strict").columns
    with pytest.raises(ValueError):
        SchemaContract({"x": ColumnSpec()}, mode="wat")


def test_coerced_counts_only_permissive_repairs():
    x = {"x": np.array(["1.5", "2.5"], dtype=object),
         "y": np.array([1.0, 2.0])}
    for mode, want in (("salvage", 0), ("permissive", 2)):
        got = _xy("port").admit(Frame(x), mode=mode).coerced
        assert got == _xy("jax").admit(JFrame(x), mode=mode).coerced == want


def test_admit_shares_clean_columns():
    x = np.array([1.0, 2.0], np.float32)
    res = _xy("port").admit(
        Frame({"x": x, "y": np.array([3.0, 4.0], np.float32)}),
        mode="salvage")
    assert res.valid.all() and res.frame["x"] is x


@pytest.mark.parametrize("mode", ["salvage", "permissive"])
@pytest.mark.parametrize("seed", [4, 5, 12])
def test_contract_on_generated_flows_matches_jax(seed, mode):
    rows = jax_generate_frame(1500, seed=seed, dirty=True)
    cols = {c: np.asarray(rows[c]) for c in rows.columns}
    res = CICIDS2017_CONTRACT.admit(Frame(cols), mode=mode)
    _same_admission(res, J_CONTRACT.admit(JFrame(cols), mode=mode))
    if mode == "salvage":
        assert 0 < res.num_rejected < 1500


@pytest.mark.parametrize("valid", [
    [False, True, False, True],
    [True, False, False, True],
    [False, False, False, True],
    [True, True, True, False],
    [False, False, False, False],
])
def test_fill_invalid_rows_matches_jax(valid):
    cols = {"x": np.array([9.0, 1.0, 2.0, 3.0]),
            "v": np.arange(8.0).reshape(4, 2),
            "i": np.array([4, 5, 6, 7], dtype=np.int32),
            "s": np.array(["a", "b", "c", "d"], dtype=object)}
    mask = np.array(valid)
    got = Frame(cols).fill_invalid_rows(mask)
    want = JFrame(cols).fill_invalid_rows(mask)
    for c in cols:
        a, b = to_host(got[c]), np.asarray(want[c])
        assert a.dtype == b.dtype
        assert a.tolist() == b.tolist(), c
    with pytest.raises(ValueError):
        Frame(cols).fill_invalid_rows(np.ones(3, bool))


def test_fill_invalid_rows_donor_semantics():
    f = Frame({"x": np.array([9.0, 1.0, 2.0, 3.0]),
               "s": np.array(["a", "b", "c", "d"], dtype=object)})
    out = f.fill_invalid_rows(np.array([False, True, False, True]))
    np.testing.assert_array_equal(out["x"], [1.0, 1.0, 1.0, 3.0])
    assert list(out["s"]) == ["b", "b", "b", "d"]
    assert f.fill_invalid_rows(np.ones(4, bool)) is f


@pytest.mark.parametrize("seed", [4, 7])
def test_clean_flows_drop_equals_contract_salvage(seed):
    rows = jax_generate_frame(1500, seed=seed, dirty=True)
    cols = {c: np.asarray(rows[c]) for c in rows.columns}
    dropped = clean_flows(Frame(cols))
    _same_frame(dropped, jax_clean_flows(JFrame(cols)))
    res = CICIDS2017_CONTRACT.admit(Frame(cols), mode="salvage")
    salvaged = res.frame.filter(res.valid)
    assert salvaged.num_rows == dropped.num_rows < 1500
    for c in CICIDS2017_FEATURES:
        np.testing.assert_array_equal(salvaged[c], dropped[c], err_msg=c)


@pytest.mark.parametrize("seed", [5, 8])
def test_clean_flows_zero_equals_contract_permissive(seed):
    rows = jax_generate_frame(1500, seed=seed, dirty=True)
    cols = {c: np.asarray(rows[c]) for c in rows.columns}
    zeroed = clean_flows(Frame(cols), handle_invalid="zero")
    _same_frame(zeroed, jax_clean_flows(JFrame(cols), handle_invalid="zero"))
    res = CICIDS2017_CONTRACT.admit(Frame(cols), mode="permissive")
    assert res.valid.all() and res.coerced > 0
    for c in CICIDS2017_FEATURES:
        np.testing.assert_array_equal(res.frame[c], zeroed[c], err_msg=c)


# ---------------------------------------------------------------------------
# the CSV parser
# ---------------------------------------------------------------------------


def _ragged_fixture(tmp_path, name="day.csv"):
    p = tmp_path / name
    p.write_text("x,y\n1.0,2.0\n3.0,4.0,5.0\n6.0,7.0\n")
    return str(p)


def test_load_csv_error_names_file_and_line(tmp_path):
    p = _ragged_fixture(tmp_path)
    with pytest.raises(ValueError) as pe:
        load_csv(p)
    with pytest.raises(ValueError) as je:
        jax_load_csv(p)
    assert str(pe.value) == str(je.value)
    assert p in str(pe.value) and "line 3" in str(pe.value)


def test_load_csv_dir_error_names_offending_file(tmp_path):
    d = tmp_path / "days"
    d.mkdir()
    (d / "a.csv").write_text("x,y\n1.0,2.0\n")
    bad = _ragged_fixture(d, name="b.csv")
    with pytest.raises(ValueError) as pe:
        load_csv_dir(str(d))
    with pytest.raises(ValueError) as je:
        jax_load_csv_dir(str(d))
    assert str(pe.value) == str(je.value)
    assert bad in str(pe.value) and "line 3" in str(pe.value)


@pytest.mark.parametrize("text", [
    "x,y\n1.0,2.0\n3.0,4.0,5.0\n6.0,7.0\n",
    "x,y\n1.0\n3.0,4.0\n6.0,7.0,8.0,9.0\n10.0,11.0\n",
    "x,y\n1.0,2.0\n3.0,4.0\n",
])
def test_load_csv_salvage_matches_jax(tmp_path, text):
    p = tmp_path / "day.csv"
    p.write_text(text)
    prej, jrej = [], []
    got = load_csv(str(p), salvage=True, rejects=prej)
    want = jax_load_csv(str(p), salvage=True, rejects=jrej)
    _same_frame(got, want)
    assert prej == jrej


def test_load_csv_salvage_excises_with_location(tmp_path):
    p = _ragged_fixture(tmp_path)
    rejects = []
    f = load_csv(p, salvage=True, rejects=rejects)
    np.testing.assert_array_equal(f["x"], [1.0, 6.0])
    assert rejects == [{"file": p, "line": 3, "raw": "3.0,4.0,5.0",
                        "reason": "ragged_row",
                        "detail": "3 fields, expected 2"}]


def test_load_csv_dir_salvage_matches_jax(tmp_path):
    d = tmp_path / "days"
    d.mkdir()
    (d / "a.csv").write_text("x,y\n1.0,2.0\n9,9,9\n")
    _ragged_fixture(d, name="b.csv")
    prej, jrej = [], []
    _same_frame(load_csv_dir(str(d), salvage=True, rejects=prej),
                jax_load_csv_dir(str(d), salvage=True, rejects=jrej))
    key = lambda r: (r["file"], r["line"])  # noqa: E731 (pool order)
    assert sorted(prej, key=key) == sorted(jrej, key=key)
    assert len(prej) == 2


# ---------------------------------------------------------------------------
# the DATA kinds
# ---------------------------------------------------------------------------


def test_grammar_accepts_data_and_io_kinds():
    raw = ("source.parse:ragged:0.5:7,source.parse:corrupt_bytes,"
           "storage.wal:enospc,storage.marker:torn_write:0.2:3")
    assert R.parse_faults_env(raw) == J.parse_faults_env(raw)
    for bad in ("source.parse:shred", "storage.wal:disk_full"):
        with pytest.raises(ValueError, match="unknown kind"):
            R.parse_faults_env(bad)
    assert R.DATA_KINDS == ("corrupt_bytes", "truncate", "ragged")
    assert R.IO_KINDS == ("enospc", "io_error", "torn_write")
    assert set(R.ALL_KINDS) <= set(J.ALL_KINDS)


def _payloads():
    rng = np.random.default_rng(0)
    rows = jax_generate_frame(40, seed=3, dirty=True).drop("Label")
    lines = [",".join(rows.columns)] + [
        ",".join(str(rows[c][i]) for c in rows.columns) for i in range(40)]
    return {"csv": "\n".join(lines).encode() + b"\n",
            "small": b"x,y\n1,2\n3,4\n5,6\n",
            "two_lines": b"x,y\n1,2",
            "binary": rng.integers(0, 256, 3000, dtype=np.uint8).tobytes(),
            "empty": b""}


@pytest.mark.parametrize("prob,seed", [(1.0, 0), (0.6, 7), (0.3, 2)])
@pytest.mark.parametrize("kind", ["corrupt_bytes", "truncate", "ragged"])
def test_fault_data_bytes_match_jax(kind, prob, seed):
    """Three passes over every payload under the same spec: the same
    fire decisions and the same mutated bytes as the JAX package."""
    R.arm("source.parse", kind=kind, prob=prob, seed=seed, times=None)
    J.arm("source.parse", kind=kind, prob=prob, seed=seed, times=None)
    fired = 0
    for _ in range(3):
        for name, data in sorted(_payloads().items()):
            got = R.fault_data("source.parse", data)
            assert got == J.fault_data("source.parse", data), name
            fired += got != data
    assert R.call_count("source.parse") == J.call_count("source.parse")
    assert fired > 0
    assert len(R.recent_events(event="fault_injected")) == len(
        J.recent_events(event="fault_injected"))


def test_fault_data_deterministic_and_kind_scoped():
    payload = b"x,y\n1,2\n3,4\n5,6\n"
    R.arm("source.parse", kind="ragged", times=None)
    a = R.fault_data("source.parse", payload)
    assert b"__sntc_ragged__" in a and a.split(b"\n")[0] == b"x,y"
    R.arm("source.parse", kind="ragged", times=None)
    assert R.fault_data("source.parse", payload) == a
    R.arm("source.parse", kind="truncate", times=None)
    assert len(R.fault_data("source.parse", payload)) < len(payload)
    R.arm("source.parse", kind="ragged", times=None)
    R.fault_point("source.parse")  # a DATA kind is inert here
    assert R.data_fault_armed("source.parse")
    R.arm("source.parse", kind="exc", times=None)
    assert R.fault_data("source.parse", payload) == payload
    assert not R.data_fault_armed("source.parse")


def test_source_parse_fault_reaches_load_csv(tmp_path):
    """An armed ``source.parse:ragged`` mutates what ``load_csv`` parses
    in both packages alike: under salvage the spliced line is a reject
    with the same line number and text."""
    p = tmp_path / "day.csv"
    p.write_text("x,y\n" + "".join(f"{i}.0,{i}.5\n" for i in range(12)))
    prej, jrej = [], []
    R.arm("source.parse", kind="ragged", seed=3, times=None)
    J.arm("source.parse", kind="ragged", seed=3, times=None)
    _same_frame(load_csv(str(p), salvage=True, rejects=prej),
                jax_load_csv(str(p), salvage=True, rejects=jrej))
    assert prej == jrej and len(prej) == 1
    assert "__sntc_ragged__" in prej[0]["raw"]


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


def _poison_frames():
    return [{"x": np.array([1.0, 2.0, np.nan, 4.0])},
            {"x": np.array([5.0, np.inf, 7.0, 8.0])}]


def _row_records(ckpt):
    rows = []
    for p in sorted(glob.glob(os.path.join(ckpt, "dead_letter_rows",
                                           "*.jsonl"))):
        with open(p) as f:
            rows += [{k: v for k, v in json.loads(line).items() if k != "ts"}
                     for line in f]
    return rows


def _engines(tmp_path, frames, **kw):
    """The same MemorySource stream through both engines; (port query,
    port sink, jax query, jax sink)."""
    pc = SchemaContract({"x": ColumnSpec()}, mode="salvage")
    jc = JSchemaContract({"x": JColumnSpec()}, mode="salvage")
    ps, js = MemorySink(), JMemorySink()
    pq = StreamingQuery(_Identity(), MemorySource([Frame(f) for f in frames]),
                        ps, str(tmp_path / "p"), max_batch_offsets=1,
                        device="cpu", schema_contract=pc, **kw)
    jq = JStreamingQuery(_JIdentity(),
                         JMemorySource([JFrame(f) for f in frames]), js,
                         str(tmp_path / "j"), max_batch_offsets=1,
                         schema_contract=jc, **kw)
    return pq, ps, jq, js


def test_engine_salvage_dead_letters_rows(tmp_path):
    monitor = R.HealthMonitor().attach()
    try:
        pq, ps, jq, js = _engines(tmp_path, _poison_frames())
        assert pq.process_available() == jq.process_available() == 2
    finally:
        monitor.detach()
    for (pb, pf), (jb, jf) in zip(ps.batches, js.batches):
        assert pb == jb
        _same_frame(pf, jf)
    np.testing.assert_array_equal(ps.frames[0]["x"], [1.0, 2.0, 4.0])
    rows = _row_records(str(tmp_path / "p"))
    assert rows == _row_records(str(tmp_path / "j"))
    assert [(r["batch_id"], r["row"], r["reason"]) for r in rows] == [
        (0, 2, "non_finite"), (1, 1, "non_finite")]
    assert pq.admission_stats() == dict(
        jq.admission_stats(), row_dead_letter_dir=str(
            tmp_path / "p" / "dead_letter_rows"))
    assert pq.admission_stats()["rows_rejected"] == 2
    assert [e["count"] for e in R.recent_events(event="rows_rejected")] \
        == [e["count"] for e in J.recent_events(event="rows_rejected")] \
        == [1, 1]
    assert monitor.state_of("source.parse") == R.HealthState.DEGRADED
    assert pq.pipeline_stats()["admission"]["batches_salvaged"] == 2
    pq.stop()
    jq.stop()


def test_rows_rejected_counted_into_metrics(tmp_path):
    from sntc_tpu.obs import metrics as jax_metrics
    from sntc_tpu_torch.obs import metrics as port_metrics

    preg, jreg = port_metrics.reset_registry(), jax_metrics.reset_registry()
    pq, _, jq, _ = _engines(tmp_path, _poison_frames())
    assert pq.process_available() == jq.process_available() == 2
    assert preg.get("sntc_rows_rejected_total", reason="non_finite") \
        == jreg.get("sntc_rows_rejected_total", reason="non_finite") == 2
    pq.stop()
    jq.stop()


def test_engine_strict_mode_quarantines_batch(tmp_path):
    pq, _, jq, _ = _engines(tmp_path, _poison_frames(), row_policy="strict",
                            max_batch_failures=1)
    assert pq.process_available() == jq.process_available() == 2
    assert [p.get("quarantined") for p in pq.recentProgress] == [
        p.get("quarantined") for p in jq.recentProgress] == [True, True]
    for root in ("p", "j"):
        assert os.path.isdir(tmp_path / root / "dead_letter")
        assert not os.path.isdir(tmp_path / root / "dead_letter_rows")
    pq.stop()
    jq.stop()


def test_row_policy_requires_contract(tmp_path):
    with pytest.raises(ValueError, match="schema_contract"):
        StreamingQuery(_Identity(), MemorySource([]), MemorySink(),
                       str(tmp_path / "ckpt"), row_policy="salvage",
                       device="cpu")


def test_file_source_parse_salvage_attributes_file_and_line(tmp_path):
    watch = tmp_path / "in"
    watch.mkdir()
    (watch / "a.csv").write_text("x\n1.0\nbad,row\n3.0\n")
    (watch / "b.csv").write_text("x\n4.0\nnan\n6.0,7\n")
    runs = {}
    for pkg in ("port", "jax"):
        if pkg == "port":
            src = FileStreamSource(str(watch), parse_salvage=True)
            q = StreamingQuery(_Identity(), src, MemorySink(),
                               str(tmp_path / pkg), max_batch_offsets=1,
                               device="cpu", schema_contract=SchemaContract(
                                   {"x": ColumnSpec()}, mode="salvage"))
        else:
            src = JFileStreamSource(str(watch), parse_salvage=True)
            q = JStreamingQuery(_JIdentity(), src, JMemorySink(),
                                str(tmp_path / pkg), max_batch_offsets=1,
                                schema_contract=JSchemaContract(
                                    {"x": JColumnSpec()}, mode="salvage"))
        assert q.process_available() == 2
        runs[pkg] = ([np.asarray(to_host(f["x"])) for f in q.sink.frames],
                     _row_records(str(tmp_path / pkg)))
        q.stop()
        src.close()
    (pframes, prows), (jframes, jrows) = runs["port"], runs["jax"]
    for a, b in zip(pframes, jframes):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(pframes[0], [1.0, 3.0])
    np.testing.assert_array_equal(pframes[1], [4.0])
    assert prows == jrows
    ragged = [r for r in prows if r["reason"] == "ragged_row"]
    assert [(os.path.basename(r["file"]), r["line"], r["raw"])
            for r in ragged] == [("a.csv", 3, "bad,row"),
                                 ("b.csv", 4, "6.0,7")]
    assert [r["reason"] for r in prows if r["batch_id"] == 1] == [
        "ragged_row", "non_finite"]


def test_take_rejects_is_file_scoped(tmp_path):
    watch = tmp_path / "in"
    watch.mkdir()
    (watch / "a.csv").write_text("x\n1.0\nbad,a\n")
    (watch / "b.csv").write_text("x\n2.0\nbad,b\n")
    src = FileStreamSource(str(watch), parse_salvage=True)
    src.latest_offset()
    src.get_batch(0, 2)  # parses both files, collects both rejects
    a, b = str(watch / "a.csv"), str(watch / "b.csv")
    assert src.files_for_range(0, 2) == [a, b]
    assert [r["file"] for r in src.take_rejects([a])] == [a]
    assert [r["file"] for r in src.take_rejects([b])] == [b]
    assert src.take_rejects() == []
    src.close()


def test_dead_letter_journal_merges_never_shrinks(tmp_path):
    pq, _, jq, _ = _engines(tmp_path, _poison_frames())
    stray = {"file": "elsewhere.csv", "line": 9, "raw": "bad",
             "reason": "ragged_row"}
    row = {"row": 2, "column": "x", "reason": "non_finite", "value": "nan",
           "raw": "nan"}
    for q in (pq, jq):
        q._journal_rejected_rows(0, {"start": 0, "end": 1}, [stray], [])
        q._journal_rejected_rows(0, {"start": 0, "end": 1}, [row], [])
    recs = _row_records(str(tmp_path / "p"))
    assert recs == _row_records(str(tmp_path / "j"))
    assert {r["reason"] for r in recs} == {"ragged_row", "non_finite"}
    # journaled twice, counted once
    assert pq.admission_stats()["rows_rejected"] == \
        jq.admission_stats()["rows_rejected"] == 1
    pq.stop()
    jq.stop()


# ---------------------------------------------------------------------------
# the masked dispatch
# ---------------------------------------------------------------------------


class _Echo(Transformer):
    """Adds a column that depends on the row's value only."""

    def transform(self, frame):
        x = to_host(frame["x"])
        return frame.with_column("y", np.asarray(x) * 2.0 + 1.0)


@pytest.fixture
def pad_calls(monkeypatch):
    """Counts the plain ``pad_rows`` calls ``pad_assemble`` makes (on the
    CPU it takes the kernel's plain version) and the targets."""
    from sntc_tpu_torch.kernels import assemble

    calls = []
    original = assemble.pad_rows

    def counting(a, target):
        calls.append((tuple(a.shape), target, a.dtype))
        return original(a, target)

    monkeypatch.setattr(assemble, "pad_rows", counting)
    return calls


def test_full_bucket_with_excised_rows_goes_through_pad_assemble(pad_calls):
    x = np.arange(64, dtype=np.float32)
    valid = np.ones(64, bool)
    valid[[3, 40]] = False
    pred = BatchPredictor(_Echo(), bucket_rows=64, device="cpu")
    out = pred.predict_frame(Frame({"x": x}), row_valid=valid)
    assert pad_calls == [((64, 1), 64, torch.float32)]  # a zero-row pad
    np.testing.assert_array_equal(to_host(out["x"]), x[valid])
    np.testing.assert_array_equal(to_host(out["y"]), x[valid] * 2 + 1)
    assert pred.compile_events == 1 and pred.padded_rows_total == 0
    # every row admitted: the plain dispatch, no pad, the same shape
    pred.predict_frame(Frame({"x": x}), row_valid=np.ones(64, bool))
    assert len(pad_calls) == 1
    assert pred.compile_events == 1 and pred.bucket_hits == 1


def test_masked_dispatch_matches_jax(pad_calls):
    rng = np.random.default_rng(3)
    from sntc_tpu.serve import BatchPredictor as JBatchPredictor

    class JEcho(JTransformer):
        def transform(self, frame):
            return frame.with_column("y", np.asarray(frame["x"]) * 2.0 + 1.0)

    pred = BatchPredictor(_Echo(), bucket_rows=32, device="cpu")
    jpred = JBatchPredictor(JEcho(), bucket_rows=32)
    for n in (32, 50, 64, 7):
        x = rng.normal(size=n).astype(np.float32)
        valid = rng.uniform(size=n) > 0.2
        got = pred.predict_frame(Frame({"x": x}), row_valid=valid)
        want = jpred.predict_frame(JFrame({"x": x}), row_valid=valid)
        np.testing.assert_array_equal(to_host(got["y"]),
                                      np.asarray(want["y"]))
    assert pred.compile_events == jpred.compile_events
    assert pred.padded_rows_total == jpred.padded_rows_total
    with pytest.raises(ValueError, match="row_valid"):
        pred.predict_frame(Frame({"x": x}), row_valid=np.ones(3, bool))


def test_oom_split_halves_carry_their_masks(pad_calls):
    x = np.arange(200, dtype=np.float64)
    valid = np.ones(200, bool)
    valid[[0, 99, 100, 150]] = False
    clean = BatchPredictor(_Echo(), bucket_rows=64, device="cpu")
    want = to_host(clean.predict_frame(Frame({"x": x}),
                                       row_valid=valid)["y"])
    dom = R.DeviceFaultDomain()
    pred = BatchPredictor(_Echo(), bucket_rows=64, device="cpu",
                          device_domain=dom)
    R.arm("device.dispatch", "device_oom", times=1)
    got = to_host(pred.predict_frame(Frame({"x": x}), row_valid=valid)["y"])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, x[valid] * 2 + 1)
    assert dom.stats()["oom_splits"] == 1


def test_chunked_frame_carries_per_chunk_masks():
    x = np.arange(330, dtype=np.float64)
    valid = np.random.default_rng(1).uniform(size=330) > 0.3
    pred = BatchPredictor(_Echo(), chunk_rows=100, bucket_rows=64,
                          device="cpu")
    out = pred.predict_frame(Frame({"x": x}), row_valid=valid)
    np.testing.assert_array_equal(to_host(out["x"]), x[valid])


D = 4


def _serve_pipeline(head_name):
    head = {
        "lr": JLR(featuresCol="scaled", maxIter=25),
        "nb": JNaiveBayes(featuresCol="scaled", modelType="multinomial"),
    }[head_name]
    rng = np.random.default_rng(0)
    X = np.abs(rng.normal(3.0, 2.0, size=(400, D))).astype(np.float32)
    train = JFrame({f"c{i}": X[:, i].copy() for i in range(D)}
                   | {"label": (X[:, 0] > 3.0).astype(np.float64)})
    return JPipeline(stages=[
        # "keep": an assembler that may drop rows or raise is not fused
        JVectorAssembler(inputCols=[f"c{i}" for i in range(D)],
                         outputCol="features", handleInvalid="keep"),
        JStandardScaler(inputCol="features", outputCol="scaled",
                        withMean=False),
        head,
    ]).fit(train)


def _stream_frames(n_batches=3, rows=8, seed=9):
    """Per batch: (poisoned columns, valid mask); poison = NaN in c1."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_batches):
        X = np.abs(rng.normal(3.0, 2.0, size=(rows, D))).astype(np.float32)
        cols = {f"c{i}": X[:, i].copy() for i in range(D)}
        valid = np.ones(rows, bool)
        for r in rng.choice(rows, size=2, replace=False):
            cols["c1"][r] = np.nan
            valid[r] = False
        out.append((cols, valid))
    return out


@pytest.mark.parametrize("head_name", ["lr", "nb"])
def test_salvage_buckets_fusion_bitwise_flat_compiles(tmp_path, head_name,
                                                      pad_calls):
    jpm = _serve_pipeline(head_name)
    jax_save_model(jpm, str(tmp_path / "m"))
    model = compile_pipeline(load_model(str(tmp_path / "m"), device="cpu"))
    # nb: the scaler and the head form one segment; lr: the scaler folds
    # into the head and the leading assembler runs eagerly (the planner's
    # single-upload rule), so nothing is left to fuse
    assert (fusion_stats(model) is None) == (head_name == "lr")
    batches = _stream_frames()
    contract = SchemaContract({f"c{i}": ColumnSpec() for i in range(D)},
                              mode="salvage")

    def run(frames, ckpt, with_contract):
        sink = MemorySink()
        q = StreamingQuery(model, MemorySource(frames), sink,
                           str(tmp_path / ckpt), max_batch_offsets=1,
                           shape_buckets=8, device="cpu",
                           schema_contract=contract if with_contract
                           else None)
        assert q.process_available() == len(frames)
        return q, sink

    _, sink_ref = run([Frame({c: a[v] for c, a in f.items()})
                       for f, v in batches], "ref", False)
    fused_after_ref = (fusion_stats(model) or {}).get("compile_events")
    pad_calls.clear()
    q_sal, sink_sal = run([Frame(f) for f, _ in batches], "salvage", True)
    for (_, ref), (_, got) in zip(sink_ref.batches, sink_sal.batches):
        assert got.num_rows == ref.num_rows
        for c in ("rawPrediction", "probability", "prediction"):
            np.testing.assert_array_equal(to_host(got[c]), to_host(ref[c]),
                                          err_msg=c)
    # every batch fills its 8-row bucket: each goes through pad_assemble
    # (a zero-row pad of the contract's float32 block), one shape
    assert len(pad_calls) == len(batches)
    assert all(t == 8 and shape == (8, D) and dtype == torch.float32
               for shape, t, dtype in pad_calls)
    assert q_sal.predictor.compile_events == 1
    assert q_sal.pipeline_stats()["compile_events"] == 1
    assert (fusion_stats(model) or {}).get("compile_events") \
        == fused_after_ref
    assert q_sal.admission_stats()["rows_rejected"] == 6

    # the JAX engine on the same stream: predictions equal, probability
    # within 1e-6 (f32 products summed in another order)
    jcontract = JSchemaContract({f"c{i}": JColumnSpec() for i in range(D)},
                                mode="salvage")
    jsink = JMemorySink()
    jq = JStreamingQuery(jax_compile_pipeline(jpm),
                         JMemorySource([JFrame(f) for f, _ in batches]),
                         jsink, str(tmp_path / "j"), max_batch_offsets=1,
                         shape_buckets=8, schema_contract=jcontract)
    assert jq.process_available() == len(batches)
    assert jq.predictor.compile_events == 1
    for (_, got), (_, want) in zip(sink_sal.batches, jsink.batches):
        np.testing.assert_array_equal(to_host(got["prediction"]),
                                      np.asarray(want["prediction"]))
        np.testing.assert_allclose(to_host(got["probability"]),
                                   np.asarray(want["probability"]),
                                   rtol=0, atol=1e-6)
    assert _row_records(str(tmp_path / "salvage")) == _row_records(
        str(tmp_path / "j"))


# ---------------------------------------------------------------------------
# the serve command, both packages
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def rf_model_dir(tmp_path_factory):
    train = jax_clean_flows(jax_generate_frame(2000, seed=1))
    pm = JPipeline(stages=[
        JStringIndexer(inputCol="Label", outputCol="label",
                       handleInvalid="skip"),
        JVectorAssembler(inputCols=CICIDS2017_FEATURES,
                         outputCol="features", handleInvalid="skip"),
        JRandomForest(numTrees=2, maxDepth=4, seed=0),
    ]).fit(train)
    path = str(tmp_path_factory.mktemp("adm_model") / "model")
    jax_save_model(pm, path)
    return path


RAGGED_AT = {1: 5, 3: 17}  # file -> data line index of a ragged line


def _write_streams(root):
    """Uncleaned flows (Inf/NaN rows) in 4 files, two of them with one
    ragged line; beside them the same rows pre-cleaned (``clean_flows``
    drop, ragged lines removed).  ``(raw dir, clean dir, expected
    dead-letter (file name, line) pairs of the ragged lines)``."""
    rows = jax_generate_frame(640, seed=12, dirty=True).drop("Label")
    cols = {c: np.asarray(rows[c]) for c in rows.columns}
    raw, clean = os.path.join(root, "raw"), os.path.join(root, "clean")
    os.makedirs(raw)
    os.makedirs(clean)
    ragged = []
    for i in range(4):
        part = Frame({c: a[160 * i:160 * (i + 1)] for c, a in cols.items()})
        name = f"part_{i:04d}.csv"
        path = os.path.join(raw, name)
        write_raw_csv(part, path)
        write_raw_csv(clean_flows(part), os.path.join(clean, name))
        if i in RAGGED_AT:
            lines = open(path).read().splitlines(True)
            at = 1 + RAGGED_AT[i]
            lines.insert(at, "1," * len(cols) + "1\n")
            open(path, "w").writelines(lines)
            ragged.append((name, at + 1))
    return raw, clean, ragged


def _serve(pkg, model_dir, watch, out, ckpt, policy):
    module = "sntc_tpu" if pkg == "jax" else "sntc_tpu_torch"
    cmd = [sys.executable, "-m", module, "serve", "--model", model_dir,
           "--watch", watch, "--out", out, "--checkpoint", ckpt,
           "--max-files-per-batch", "2", "--shape-buckets", "64",
           "--row-policy", policy, "--once"]
    cmd += ["--platform", "cpu"] if pkg == "jax" else ["--device", "cpu"]
    env = dict(os.environ, JAX_PLATFORMS="cpu", SNTC_FAULTS="",
               SNTC_SERVE_HOST_ROWS="0")
    proc = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    files = {f: open(os.path.join(out, f), "rb").read()
             for f in sorted(os.listdir(out))}
    return json.loads(proc.stdout.strip().splitlines()[-1]), files


def test_serve_command_salvage_and_permissive_as_jax(tmp_path, rf_model_dir):
    raw, clean, ragged = _write_streams(str(tmp_path))
    _, ref = _serve("port", rf_model_dir, clean, str(tmp_path / "o_ref"),
                    str(tmp_path / "c_ref"), "strict")
    runs = {}
    for pkg in ("port", "jax"):
        ckpt = str(tmp_path / f"c_{pkg}")
        summary, files = _serve(pkg, rf_model_dir, raw,
                                str(tmp_path / f"o_{pkg}"), ckpt, "salvage")
        runs[pkg] = (summary, files, _row_records(ckpt))
    (ps, pfiles, prows), (js, jfiles, jrows) = runs["port"], runs["jax"]
    assert pfiles == ref == jfiles  # byte-identical batch files
    assert ps["batches"] == 2 and ps["quarantined"] == []
    for r in prows:
        r["file"] = r["file"] and os.path.basename(r["file"])
    for r in jrows:
        r["file"] = r["file"] and os.path.basename(r["file"])
    assert prows == jrows
    assert sorted((r["file"], r["line"]) for r in prows
                  if r["reason"] == "ragged_row") == sorted(ragged)
    assert ps["pipeline_stats"]["admission"]["rows_rejected"] == len(prows)
    assert ps["pipeline_stats"]["admission"]["batches_salvaged"] == len(
        {r["batch_id"] for r in prows if r["reason"] == "non_finite"})

    # permissive equals serving clean_flows(handle_invalid="zero")
    zero = str(tmp_path / "zero")
    os.makedirs(zero)
    for name in sorted(os.listdir(raw)):
        rows = load_csv(os.path.join(raw, name), salvage=True)
        write_raw_csv(clean_flows(rows, handle_invalid="zero"),
                      os.path.join(zero, name))
    _, zref = _serve("port", rf_model_dir, zero, str(tmp_path / "o_zref"),
                     str(tmp_path / "c_zref"), "strict")
    ps, pfiles = _serve("port", rf_model_dir, raw, str(tmp_path / "o_perm"),
                        str(tmp_path / "c_perm"), "permissive")
    js, jfiles = _serve("jax", rf_model_dir, raw, str(tmp_path / "o_jperm"),
                        str(tmp_path / "c_jperm"), "permissive")
    assert pfiles == zref == jfiles
    assert ps["pipeline_stats"]["admission"]["rows_coerced"] > 0
    assert [(r["reason"]) for r in _row_records(str(tmp_path / "c_perm"))] \
        == ["ragged_row"] * len(ragged)
