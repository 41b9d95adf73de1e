"""``mesh=`` on the port's estimators of bench configs 1–4 and 17, the
serve mesh and the device quantile edges, against the JAX package.

The port's meshes are virtual CPU shards; the JAX side runs on tier-1's
8 virtual CPU devices (``mesh8``).  What each test holds:

* ``mesh=None`` and a one-shard mesh take the single-device path: equal,
  bitwise (the fit pads nothing and keeps its reduction order);
* across mesh sizes 1, 2, 4, 8: the forests (RF with its bootstrap, DT)
  and ChiSq's selection equal, node for node; MinMaxScaler bitwise;
  StandardScaler, PCA, KMeans, ALS within ``rtol = atol = 1e-5``
  (``tests/test_mesh.py``'s float32 aggregate tolerance; KMeans'
  predictions equal); the multinomial LogisticRegression's
  coefficients within 1e-4 relative (its near-flat directions carry a
  summation order's rounding: 2.5e-5 measured with one thread, 6.7e-6
  with eight); the MLP's objective history and weights within 1e-3
  relative (30 LBFGS iterations carry a summation order's float32
  rounding into the path: 9.2e-5 and 7.1e-4 measured); GBT's raw
  scores within 1e-5 relative;
* at mesh 8 against the JAX estimator on ``mesh8`` (both sum per shard):
  trees equal; selection equal; MinMaxScaler bitwise; the rest within
  the tolerance each test states, beside the gap measured when it was
  written;
* the serve mesh: a fused scaler → LR segment at serve mesh 1 and 4
  against direct dispatch, predictions equal and probabilities within
  1e-5 (``tests/test_mesh.py``'s tolerance; on the CPU they are equal),
  the batch split only at mesh 4; each fusible head's replica for
  another device serving bitwise as the head, on its params;
* the device quantile edges: bitwise the host path on the same sample,
  and within one float32 rounding (2⁻²³ relative) of the JAX
  ``_edges_device`` with every row in the sample.
"""

import inspect

import numpy as np
import pytest
import torch

import sntc_tpu_torch.resilience as R
from sntc_tpu_torch.core.frame import Frame
from sntc_tpu_torch.obs.metrics import registry
from sntc_tpu_torch.parallel import default_mesh, make_mesh, set_collective_domain
from sntc_tpu_torch.parallel.mesh import DATA_AXIS
from jax_metrics_guard import own_jax_registry  # noqa: F401

SIZES = (1, 2, 4, 8)
TOL = 1e-5


def _mesh(n):
    return default_mesh(n, device="cpu")


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.fixture(autouse=True)
def _clean():
    R.clear()
    set_collective_domain(None)
    yield
    R.clear()
    set_collective_domain(None)


def _data(seed=0, n=1024, d=6):
    rng = np.random.default_rng(seed)
    X = rng.normal(3.0, 2.0, size=(n, d)).astype(np.float32)
    y = (X[:, 0] + rng.normal(size=n) > 3.0).astype(np.float64)
    y3 = (((X[:, 0] + rng.normal(size=n)) > 3).astype(int)
          + (X[:, 1] > 3).astype(int)).astype(np.float64)
    Xi = rng.integers(-20, 20, size=(n, d)).astype(np.float32)
    return X, y, y3, Xi


def _ratings(seed=0):
    rng = np.random.default_rng(seed)
    n_u, n_i, rank = 40, 30, 3
    U = rng.normal(size=(n_u, rank)) / np.sqrt(rank)
    V = rng.normal(size=(n_i, rank)) / np.sqrt(rank)
    full = U @ V.T + 2.0
    mask = rng.random((n_u, n_i)) < 0.6
    uu, ii = np.nonzero(mask)
    cols = {"user": uu.astype(np.int64), "item": ii.astype(np.int64),
            "rating": full[uu, ii].astype(np.float32)}
    return cols, full[uu, ii]


def _forest(m):
    f = m.forest
    return np.concatenate([f.feature.ravel().astype(np.float64),
                           f.threshold.ravel(), f.leaf_stats.ravel()])


# (name, port class path, kwargs, data key, result getter, tolerance
#  across mesh sizes: None = equal)
X, Y, Y3, XI = _data()
FRAMES = {
    "x": {"features": X},
    "bin": {"features": X, "label": Y},
    "multi": {"features": X, "label": Y3},
    "int": {"features": XI, "label": Y3},
    "reg": {"features": X, "label": (X[:, 0] * 2.0).astype(np.float64)},
}
CASES = [
    ("StandardScaler", "feature", dict(withMean=True), "x",
     lambda m: np.concatenate([m.mean, m.std]), TOL),
    ("MinMaxScaler", "feature", {}, "x",
     lambda m: np.concatenate([m.originalMin, m.originalMax]), None),
    ("PCA", "feature", dict(k=3), "x", lambda m: np.abs(m.pc), TOL),
    ("ChiSqSelector", "feature", dict(numTopFeatures=3), "int",
     lambda m: np.asarray(m.selected_features, np.float64), None),
    ("KMeans", "models", dict(k=3, seed=1, maxIter=15), "x",
     lambda m: m.clusterCenters, TOL),
    ("LogisticRegression", "models", dict(maxIter=30), "multi",
     lambda m: m.coefficientMatrix, 1e-4),
    ("MultilayerPerceptronClassifier", "models",
     dict(layers=[6, 5, 3], maxIter=30), "multi",
     lambda m: m.summary.objectiveHistory, 1e-3),
    ("RandomForestClassifier", "models", dict(numTrees=5, maxDepth=5),
     "int", _forest, None),
    ("DecisionTreeClassifier", "models", dict(maxDepth=5), "int", _forest,
     None),
    ("GBTClassifier", "models", dict(maxIter=5, maxDepth=3), "bin",
     lambda m: m.transform(Frame(FRAMES["bin"]))["rawPrediction"], TOL),
    ("RandomForestRegressor", "models", dict(numTrees=3, maxDepth=4), "reg",
     lambda m: m.transform(Frame(FRAMES["reg"]))["prediction"], TOL),
    ("DecisionTreeRegressor", "models", dict(maxDepth=4), "reg",
     lambda m: m.transform(Frame(FRAMES["reg"]))["prediction"], TOL),
    ("GBTRegressor", "models", dict(maxIter=3, maxDepth=3), "reg",
     lambda m: m.transform(Frame(FRAMES["reg"]))["prediction"], TOL),
]


def _cls(pkg, name):
    import importlib

    return getattr(importlib.import_module(f"sntc_tpu_torch.{pkg}"), name)


def _fit(case, mesh):
    name, pkg, kw, key, get, _tol = case
    return get(_cls(pkg, name)(device="cpu", mesh=mesh, **kw).fit(
        Frame(FRAMES[key])))


def test_every_slice_estimator_takes_mesh_as_the_jax_one_does():
    import importlib

    names = [c[0] for c in CASES] + ["ALS"]
    for name in names:
        pkg = "feature" if name in ("StandardScaler", "MinMaxScaler", "PCA",
                                    "ChiSqSelector") else "models"
        port = getattr(importlib.import_module(f"sntc_tpu_torch.{pkg}"), name)
        ref = getattr(importlib.import_module(f"sntc_tpu.{pkg}"), name)
        assert "mesh" in inspect.signature(port.__init__).parameters, name
        assert "mesh" in inspect.signature(ref.__init__).parameters, name
        est = port(mesh=_mesh(2))
        assert est.mesh.shape == {"data": 2}
        assert est.device == torch.device("cpu")


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_no_mesh_and_one_shard_are_the_single_device_fit_bitwise(case):
    a = np.asarray(_fit(case, None), np.float64)
    b = np.asarray(_fit(case, _mesh(1)), np.float64)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_mesh_sizes_agree(case):
    outs = {s: np.asarray(_fit(case, _mesh(s)), np.float64) for s in SIZES}
    tol = case[-1]
    for s in SIZES[1:]:
        if tol is None:
            np.testing.assert_array_equal(outs[s], outs[1], err_msg=str(s))
        else:
            assert _rel(outs[s], outs[1]) <= tol, (s, _rel(outs[s], outs[1]))


def test_mlp_weights_across_mesh_sizes_within_1e_3():
    from sntc_tpu_torch.models import MultilayerPerceptronClassifier

    w = {s: MultilayerPerceptronClassifier(
        device="cpu", mesh=_mesh(s), layers=[6, 5, 3], maxIter=30).fit(
            Frame(FRAMES["multi"])).weights for s in SIZES}
    for s in SIZES[1:]:
        assert _rel(w[s], w[1]) <= 1e-3, (s, _rel(w[s], w[1]))


def test_kmeans_predictions_equal_and_one_lloyd_dispatch_an_iteration():
    from sntc_tpu_torch.models import KMeans

    f = Frame(FRAMES["x"])
    base = KMeans(device="cpu", mesh=_mesh(1), k=3, seed=1).fit(f)
    for s in SIZES[1:]:
        d0 = registry().get("sntc_collective_dispatches_total",
                            op="kmeans.lloyd", axis=DATA_AXIS) or 0
        m = KMeans(device="cpu", mesh=_mesh(s), k=3, seed=1).fit(f)
        d1 = registry().get("sntc_collective_dispatches_total",
                            op="kmeans.lloyd", axis=DATA_AXIS)
        assert d1 - d0 == m.fit_stats["iterations"]
        np.testing.assert_array_equal(m.transform(f)["prediction"],
                                      base.transform(f)["prediction"])


# -- mesh 8 against the JAX estimators on mesh8 -----------------------------


def _jax(pkg, name, mesh8, kw, key):
    import importlib

    from sntc_tpu.core.frame import Frame as JFrame

    cls = getattr(importlib.import_module(f"sntc_tpu.{pkg}"), name)
    return cls(mesh=mesh8, **kw).fit(JFrame(FRAMES[key]))


def _port8(pkg, name, kw, key):
    return _cls(pkg, name)(device="cpu", mesh=_mesh(8), **kw).fit(
        Frame(FRAMES[key]))


@pytest.mark.parametrize("name,pkg,kw,key,get,tol,measured", [
    # measured: the gap when this test was written (relative to the
    # largest value)
    ("StandardScaler", "feature", dict(withMean=True), "x",
     lambda m: np.concatenate([m.mean, m.std]), 1e-6, 1.2e-7),
    ("MinMaxScaler", "feature", {}, "x",
     lambda m: np.concatenate([m.originalMin, m.originalMax]), 0.0, 0.0),
    ("PCA", "feature", dict(k=3), "x", lambda m: np.abs(np.asarray(m.pc)),
     1e-5, 7.5e-7),
    ("KMeans", "models", dict(k=3, seed=1, maxIter=15), "x",
     lambda m: np.asarray(m.clusterCenters), 1e-5, 0.0),
    ("LogisticRegression", "models", dict(maxIter=30), "bin",
     lambda m: np.asarray(m.coefficientMatrix), 1e-5, 1.5e-7),
    ("LogisticRegression", "models", dict(maxIter=30), "multi",
     lambda m: np.asarray(m.coefficientMatrix), 1e-4, 3.9e-6),
    ("MultilayerPerceptronClassifier", "models",
     dict(layers=[6, 5, 3], maxIter=30, seed=0), "multi",
     lambda m: np.asarray(m.weights), 1e-3, 5.1e-5),
], ids=["scaler", "minmax", "pca", "kmeans", "lr", "lr_multi", "mlp"])
def test_mesh8_against_the_jax_estimator(mesh8, name, pkg, kw, key, get,
                                         tol, measured):
    j = get(_jax(pkg, name, mesh8, kw, key))
    p = get(_port8(pkg, name, kw, key))
    gap = _rel(p, j)
    assert gap <= tol, (name, gap, measured)


def test_mesh8_selection_and_trees_equal_the_jax_ones(mesh8):
    chi_j = _jax("feature", "ChiSqSelector", mesh8, dict(numTopFeatures=3),
                 "int")
    chi_p = _port8("feature", "ChiSqSelector", dict(numTopFeatures=3), "int")
    assert list(chi_p.selected_features) == list(chi_j.selected_features)
    for name, kw in [
        ("RandomForestClassifier", dict(numTrees=3, maxDepth=4,
                                        bootstrap=False,
                                        featureSubsetStrategy="all")),
        ("DecisionTreeClassifier", dict(maxDepth=4)),
    ]:
        j = _jax("models", name, mesh8, kw, "int")
        p = _port8("models", name, kw, "int")
        jf = getattr(j, "forest", None) or j.trees
        np.testing.assert_array_equal(p.forest.feature,
                                      np.asarray(jf.feature))
        np.testing.assert_array_equal(p.forest.threshold,
                                      np.asarray(jf.threshold))
        np.testing.assert_array_equal(p.forest.leaf_stats,
                                      np.asarray(jf.leaf_stats))


def test_als_mesh8_against_jax_and_across_sizes(mesh8):
    from sntc_tpu.core.frame import Frame as JFrame
    from sntc_tpu.models import ALS as JALS
    from sntc_tpu_torch.models import ALS

    cols, _ = _ratings()
    kw = dict(rank=4, maxIter=10, regParam=0.02, seed=2)
    j = JALS(mesh=mesh8, **kw).fit(JFrame(cols))
    outs = {s: ALS(device="cpu", mesh=_mesh(s), **kw).fit(Frame(cols))
            for s in SIZES}
    # measured 1.8e-6 against JAX, 2.3e-6 across sizes
    assert _rel(outs[8]._uf, np.asarray(j._uf)) <= 1e-4
    for s in SIZES[1:]:
        assert _rel(outs[s]._uf, outs[1]._uf) <= 1e-4
        assert _rel(outs[s]._if, outs[1]._if) <= 1e-4


# -- the chaos leg: a participant lost mid-fit ------------------------------


def test_als_resize_mid_fit_converges_on_the_survivors():
    from sntc_tpu_torch.models import ALS
    from sntc_tpu_torch.resilience.device import DeviceFaultDomain

    cols, truth = _ratings()
    dom = DeviceFaultDomain()
    set_collective_domain(dom)
    R.arm("collective.dispatch", kind="device_lost", after=3, times=1)
    m = ALS(device="cpu", mesh=_mesh(8), rank=4, maxIter=10, regParam=0.02,
            seed=2).fit(Frame(cols))
    pred = m.transform(Frame({"user": cols["user"],
                              "item": cols["item"]}))["prediction"]
    rmse = float(np.sqrt(np.mean((pred - truth) ** 2)))
    assert rmse < 0.1, rmse
    resizes = [r for r in dom.journal if r.get("decision") == "mesh_resize"]
    assert [(r["from"], r["to"]) for r in resizes] == [(8, 4)]
    assert registry().get("sntc_collective_mesh_devices",
                          axis=DATA_AXIS) == 4
    assert not dom.failed


def test_chisq_contingency_survives_a_resize_bitwise():
    """ChiSq's contingency is an aggregate of one ``tree_hist`` launch a
    shard: a lost device mid-dispatch resizes 8 → 4 and the whole-count
    table, hence the statistics, come out bitwise."""
    from sntc_tpu_torch.feature.chisq_selector import chi2_scores
    from sntc_tpu_torch.resilience.device import DeviceFaultDomain

    cpu = torch.device("cpu")
    base = chi2_scores(XI, Y3, 16, cpu, _mesh(8))
    dom = DeviceFaultDomain()
    set_collective_domain(dom)
    R.arm("collective.dispatch", kind="device_lost", times=1)
    again = chi2_scores(XI, Y3, 16, cpu, _mesh(8))
    for a, b in zip(base, again):
        np.testing.assert_array_equal(a, b)
    one = chi2_scores(XI, Y3, 16, cpu, None)
    np.testing.assert_array_equal(base[0], one[0])
    assert [r["to"] for r in dom.journal
            if r.get("decision") == "mesh_resize"] == [4]


# -- the serve mesh -----------------------------------------------------------


def test_fused_lr_segment_at_serve_mesh_1_and_4_equals_direct(monkeypatch):
    from sntc_tpu_torch.core.base import Pipeline
    from sntc_tpu_torch.feature import MinMaxScaler
    from sntc_tpu_torch.fuse import compile_pipeline, fused_segments
    from sntc_tpu_torch.models import LogisticRegression
    from sntc_tpu_torch.parallel.context import reset_serve_mesh, set_serve_mesh

    monkeypatch.setenv("SNTC_SERVE_HOST_ROWS", "0")
    rng = np.random.default_rng(0)
    Xs = rng.normal(3.0, 2.0, size=(1024, 6)).astype(np.float32)
    ys = (Xs[:, 0] > 3.0).astype(np.float64)
    f = Frame({"features": Xs, "label": ys})
    # a MinMaxScaler stays a stage of the segment (a StandardScaler
    # would fold into the head, leaving nothing to fuse)
    pm = Pipeline(stages=[
        MinMaxScaler(device="cpu", mesh=_mesh(8), inputCol="features",
                     outputCol="scaled"),
        LogisticRegression(device="cpu", mesh=_mesh(8), featuresCol="scaled",
                           maxIter=30),
    ]).fit(f)
    fused = compile_pipeline(pm)
    seg, = fused_segments(fused)
    splits = {}
    try:
        set_serve_mesh(None)
        direct = fused.transform(f)
        splits["direct"] = seg.mesh_splits
        outs = {}
        for s in (1, 4):
            set_serve_mesh(_mesh(s))
            outs[s] = fused.transform(f)
            splits[s] = seg.mesh_splits
    finally:
        reset_serve_mesh()
    # only the mesh of 4 split the batch, once
    assert splits == {"direct": 0, 1: 0, 4: 1}
    for s, out in outs.items():
        np.testing.assert_array_equal(out["prediction"], direct["prediction"])
        np.testing.assert_allclose(out["probability"], direct["probability"],
                                   rtol=1e-5, atol=1e-6)
    # rows that do not divide the mesh dispatch unsplit
    set_serve_mesh(_mesh(3))
    try:
        odd = fused.transform(f)
    finally:
        reset_serve_mesh()
    assert seg.mesh_splits == 1
    np.testing.assert_array_equal(odd["prediction"], direct["prediction"])


@pytest.mark.parametrize("head", ["lr", "mlp", "nb", "rf", "dt", "gbt"])
def test_head_replica_serves_bitwise_and_shares_params(head):
    """``replica_on``: the copy a serve-mesh block on another device
    runs.  On the CPU both live on one device, so its packed program
    must equal the head's bitwise; it is built once a device, and a
    threshold set on the head holds on the replica."""
    from sntc_tpu_torch.models import (
        DecisionTreeClassifier,
        GBTClassifier,
        LogisticRegression,
        MultilayerPerceptronClassifier,
        NaiveBayes,
        RandomForestClassifier,
    )

    rng = np.random.default_rng(3)
    X = rng.normal(3.0, 2.0, size=(400, 5)).astype(np.float32)
    y = (X[:, 0] > 3.0).astype(np.float64)
    est = {
        "lr": LogisticRegression(device="cpu", maxIter=10),
        "mlp": MultilayerPerceptronClassifier(device="cpu", layers=[5, 4, 2],
                                              maxIter=10),
        "nb": NaiveBayes(device="cpu", modelType="gaussian"),
        "rf": RandomForestClassifier(device="cpu", numTrees=3, maxDepth=3),
        "dt": DecisionTreeClassifier(device="cpu", maxDepth=3),
        "gbt": GBTClassifier(device="cpu", maxIter=3, maxDepth=2),
    }[head]
    model = est.fit(Frame({"features": X, "label": y}))
    rep = model.replica_on(torch.device("cpu"))
    assert rep is not model and model.replica_on("cpu") is rep
    xt = torch.from_numpy(X)
    np.testing.assert_array_equal(rep._predict_all_dev(xt).numpy(),
                                  model._predict_all_dev(xt).numpy())
    model.setThreshold(0.9)
    np.testing.assert_array_equal(rep._predict_all_dev(xt).numpy(),
                                  model._predict_all_dev(xt).numpy())


def test_serve_mesh_env_knob_and_default_mesh(monkeypatch):
    from sntc_tpu_torch.parallel import context as ctx

    ctx.reset_serve_mesh()
    monkeypatch.setenv("SNTC_SERVE_MESH_DEVICES", "1")
    assert ctx.get_serve_mesh() is None
    ctx.set_serve_mesh(None)
    monkeypatch.setenv("SNTC_SERVE_MESH_DEVICES", "4")
    assert ctx.get_serve_mesh() is None  # pinned off
    ctx.reset_serve_mesh()
    assert ctx.get_default_mesh("cpu").shape == {"data": 1}
    m = make_mesh(devices=["cpu"] * 2)
    ctx.set_default_mesh(m)
    try:
        assert ctx.get_default_mesh("cpu") is m
    finally:
        ctx.set_default_mesh(None)


# -- the device quantile edges ------------------------------------------------


@pytest.mark.parametrize("n,sample_rows", [(500, 1000), (3000, 3000),
                                           (5000, 1000)])
def test_device_edges_equal_the_host_path(n, sample_rows):
    from sntc_tpu_torch.ops.binning import quantile_bin_edges

    rng = np.random.default_rng(n)
    x = rng.lognormal(size=(n, 5)).astype(np.float32)
    x[:, 4] = np.round(x[:, 4])  # ties
    host = quantile_bin_edges(x, 32, sample_rows=sample_rows, seed=7)
    dev = quantile_bin_edges(torch.from_numpy(x), 32,
                             sample_rows=sample_rows, seed=7)
    assert isinstance(dev, torch.Tensor) and dev.dtype == torch.float32
    np.testing.assert_array_equal(dev.numpy(), host)


def test_device_edges_against_the_jax_device_path():
    import jax.numpy as jnp

    from sntc_tpu.ops.binning import quantile_bin_edges as jax_edges
    from sntc_tpu_torch.ops.binning import quantile_bin_edges

    rng = np.random.default_rng(1)
    x = rng.normal(3.0, 2.0, size=(2000, 6)).astype(np.float32)
    j = np.asarray(jax_edges(jnp.asarray(x), 16, sample_rows=4000, seed=3))
    p = quantile_bin_edges(torch.from_numpy(x), 16, sample_rows=4000,
                           seed=3).numpy()
    ulp = np.spacing(np.abs(j).astype(np.float32))
    assert np.all(np.abs(p - j) <= ulp), np.abs(p - j).max()
