"""The mesh substrate on the card: virtual shards of ``cuda:0`` against
the same meshes of CPU shards.

Every test here needs a CUDA device (``-m cuda``) and skips without one;
the file imports no JAX.  What each holds:

* ``make_tree_aggregate`` over ``[cuda:0] * 4`` on integer-valued rows:
  bitwise the CPU mesh's; a ``device_lost`` resize 8 → 4 on the card:
  bitwise the unfaulted result;
* the reduced RF fit at ``[cuda:0] * 4``: one ``tree_hist`` launch a
  shard (4 times mesh 1's), the forest equal node for node to mesh 1's
  (whole-count histograms);
* LogisticRegression and KMeans over card shards against CPU shards:
  within 1e-4 and 1e-5 relative (the card's products round apart from
  the CPU's);
* the device quantile edges on the card: bitwise the host path's;
* a fused scaler → LR segment at serve mesh ``[cuda:0] * 4`` and at
  ``[cuda:0, cpu]`` (the head's replica runs the CPU block): the batch
  split once, predictions equal to direct dispatch, probabilities within
  1e-5.
"""

import numpy as np
import pytest
import torch

import sntc_tpu_torch.resilience as R
from sntc_tpu_torch.core.frame import Frame
from sntc_tpu_torch.parallel import (
    default_mesh,
    make_mesh,
    make_tree_aggregate,
    set_collective_domain,
    shard_batch,
)
from sntc_tpu_torch.parallel.mesh import DATA_AXIS


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    R.clear()
    set_collective_domain(None)
    yield torch.device("cuda:0")
    R.clear()
    set_collective_domain(None)


def _moments(xs, w):
    xw = xs * w[:, None]
    return {"sum": xw.sum(0), "gram": xw.t() @ xs}


def _ints(n, d=6, seed=5):
    return np.random.default_rng(seed).integers(
        -20, 20, size=(n, d)).astype(np.float32)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _frames():
    rng = np.random.default_rng(0)
    X = rng.normal(3.0, 2.0, size=(1024, 6)).astype(np.float32)
    y3 = (((X[:, 0] + rng.normal(size=1024)) > 3).astype(int)
          + (X[:, 1] > 3).astype(int)).astype(np.float64)
    Xi = rng.integers(-20, 20, size=(1024, 6)).astype(np.float32)
    return Frame({"features": X, "label": y3}), Frame(
        {"features": Xi, "label": y3})


@pytest.mark.cuda
def test_aggregate_on_virtual_card_shards_matches_the_cpu(card):
    x = _ints(4096)
    m4 = make_mesh(devices=[card] * 4)
    out = make_tree_aggregate(_moments, m4)(*shard_batch(m4, x))
    assert out["gram"].device.type == "cuda"
    c4 = default_mesh(4, device="cpu")
    ref = make_tree_aggregate(_moments, c4)(*shard_batch(c4, x))
    for k in ref:
        np.testing.assert_array_equal(out[k].cpu().numpy(), ref[k].numpy())


@pytest.mark.cuda
def test_resize_on_the_card_is_bitwise(card):
    m8 = make_mesh(devices=[card] * 8)
    x = _ints(1024, seed=9)
    base = make_tree_aggregate(_moments, m8)(*shard_batch(m8, x))
    agg = make_tree_aggregate(_moments, m8)
    R.arm("collective.dispatch", kind="device_lost", times=1)
    out = agg(*shard_batch(m8, x))
    assert agg.mesh().shape[DATA_AXIS] == 4
    for k in base:
        assert torch.equal(out[k], base[k])


@pytest.mark.cuda
def test_rf_on_virtual_card_shards_launches_tree_hist_per_shard(card):
    from sntc_tpu_torch.kernels import LAUNCHES, reset_launches
    from sntc_tpu_torch.models import RandomForestClassifier

    _f, fi = _frames()
    kw = dict(numTrees=3, maxDepth=4)
    forests, launches = {}, {}
    for s in (1, 4):
        reset_launches()
        m = RandomForestClassifier(
            mesh=make_mesh(devices=[card] * s), **kw).fit(fi)
        launches[s] = LAUNCHES["tree_hist"]
        f = m.forest
        forests[s] = (f.feature, f.threshold, f.leaf_stats, f.gain, f.count)
    assert launches[4] == 4 * launches[1] > 0
    for a, b in zip(forests[4], forests[1]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
def test_lr_and_kmeans_on_card_shards_match_cpu_shards(card):
    from sntc_tpu_torch.models import KMeans, LogisticRegression

    f, _fi = _frames()
    cpu4 = default_mesh(4, device="cpu")
    lr_c = LogisticRegression(mesh=make_mesh(devices=[card] * 4),
                              maxIter=30).fit(f)
    lr_h = LogisticRegression(device="cpu", mesh=cpu4, maxIter=30).fit(f)
    assert _rel(lr_c.coefficientMatrix, lr_h.coefficientMatrix) <= 1e-4
    km_c = KMeans(mesh=make_mesh(devices=[card] * 4), k=3, seed=1).fit(f)
    km_h = KMeans(device="cpu", mesh=cpu4, k=3, seed=1).fit(f)
    assert _rel(km_c.clusterCenters, km_h.clusterCenters) <= 1e-5


@pytest.mark.cuda
def test_device_edges_on_the_card_equal_the_host(card):
    from sntc_tpu_torch.ops.binning import quantile_bin_edges

    x = np.random.default_rng(3).normal(size=(20_000, 8)).astype(np.float32)
    host = quantile_bin_edges(x, 32, sample_rows=10_000, seed=1)
    dev = quantile_bin_edges(torch.from_numpy(x).to(card), 32,
                             sample_rows=10_000, seed=1)
    np.testing.assert_array_equal(dev.cpu().numpy(), host)


def _fused_minmax_lr(dev, n):
    """A fitted MinMaxScaler → LR pipeline compiled into one fused
    segment (a StandardScaler would fold into the head), its frame, the
    segment and the fitted pipeline."""
    from sntc_tpu_torch.core.base import Pipeline
    from sntc_tpu_torch.feature import MinMaxScaler
    from sntc_tpu_torch.fuse import compile_pipeline, fused_segments
    from sntc_tpu_torch.models import LogisticRegression

    rng = np.random.default_rng(0)
    X = rng.normal(3.0, 2.0, size=(n, 6)).astype(np.float32)
    f = Frame({"features": X, "label": (X[:, 0] > 3.0).astype(np.float64)})
    pm = Pipeline(stages=[
        MinMaxScaler(device=dev, inputCol="features", outputCol="scaled"),
        LogisticRegression(device=dev, featuresCol="scaled", maxIter=30),
    ]).fit(f)
    fused = compile_pipeline(pm)
    seg, = fused_segments(fused)
    return fused, f, seg, pm


def _serve_direct_and_split(fused, f, mesh):
    from sntc_tpu_torch.parallel.context import reset_serve_mesh, set_serve_mesh

    try:
        set_serve_mesh(None)
        direct = fused.transform(f)
        set_serve_mesh(mesh)
        split = fused.transform(f)
    finally:
        reset_serve_mesh()
    return direct, split


@pytest.mark.cuda
def test_fused_lr_segment_at_card_serve_mesh_4(card, monkeypatch):
    """A fused scaler → LR segment at serve mesh ``[cuda:0] * 4`` against
    direct dispatch on the card: the batch split once, predictions
    equal, probabilities within 1e-5 (``tests/test_mesh.py``'s
    tolerance).  cuBLAS may take another kernel for a quarter of the
    rows, so the rows need not be bitwise (phase 23 (a) of
    ``chip_smoke.py`` counts them: ROADMAP queue C)."""
    monkeypatch.setenv("SNTC_SERVE_HOST_ROWS", "0")
    fused, f, seg, _ = _fused_minmax_lr(card, 4096)
    direct, split = _serve_direct_and_split(
        fused, f, make_mesh(devices=[card] * 4))
    assert seg.mesh_splits == 1
    np.testing.assert_array_equal(split["prediction"], direct["prediction"])
    np.testing.assert_allclose(split["probability"], direct["probability"],
                               rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_serve_mesh_of_distinct_devices_runs_the_head_on_each(
        card, monkeypatch, tmp_path):
    """A serve mesh of two distinct devices, ``[cuda:0, cpu]``: the
    second row block runs the whole segment on the CPU, the head through
    its CPU replica, not on the card.  Predictions equal direct
    dispatch.  The first half's probabilities lie within 1e-5 of direct
    dispatch on the card, the second half's within 1e-5 of the same
    pipeline served on the CPU (the card's and the CPU's products round
    apart by more than that on this separable data's large margins)."""
    from sntc_tpu_torch.fuse import compile_pipeline
    from sntc_tpu_torch.mlio.save_load import load_model, save_model

    monkeypatch.setenv("SNTC_SERVE_HOST_ROWS", "0")
    fused, f, seg, pm = _fused_minmax_lr(card, 4096)
    on_cpu = compile_pipeline(load_model(save_model(pm, str(tmp_path / "m")),
                                         device="cpu"))
    head = seg._head
    ran_on = []
    dev_prog = type(head)._predict_all_dev

    def spy(self, X):
        out = dev_prog(self, X)
        ran_on.append((self is head, out.device.type))
        return out

    monkeypatch.setattr(type(head), "_predict_all_dev", spy)
    direct, split = _serve_direct_and_split(
        fused, f, make_mesh(devices=[card, torch.device("cpu")]))
    assert seg.mesh_splits == 1
    # the head ran only on the card, its replica only on the CPU, once
    assert set(ran_on) == {(True, "cuda"), (False, "cpu")}
    assert ran_on.count((False, "cpu")) == 1
    assert head.replica_on("cpu").device == torch.device("cpu")
    np.testing.assert_array_equal(split["prediction"], direct["prediction"])
    half = f.num_rows // 2
    want = np.concatenate([np.asarray(direct["probability"])[:half],
                           np.asarray(on_cpu.transform(f)["probability"])[half:]])
    np.testing.assert_allclose(split["probability"], want,
                               rtol=1e-5, atol=1e-6)
