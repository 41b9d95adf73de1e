"""The port's KMeans, BisectingKMeans, GaussianMixture, PIC and
ClusteringEvaluator against the JAX package's, on the CPU.

Inputs are numpy-seeded blobs, rays and block graphs (the JAX tests'
own generators); the JAX side runs on tier-1's ``mesh8`` (8 virtual CPU
devices: its sums are per shard, the port's once).

Tolerances, each with what it measured here when set:

* ``ClusteringEvaluator``: bitwise (the same float64 numpy operations);
* KMeans: centers and cost within 1e-5 relative (2.0e-7 / 2.2e-6),
  predictions and iteration counts equal (the init is the same numpy
  draw in both packages);
* BisectingKMeans: leaf centers within 1e-5 relative (1.8e-7), the same
  tree and predictions;
* GaussianMixture: means, covariances, weights, posteriors and the mean
  log-likelihood within 1e-4 (9.5e-7 at most), assignments equal, the
  same iteration count;
* PIC: the power-iteration embedding ``v`` within 1e-4 relative of its
  largest entry (3.3e-7), the same number of steps, and the same
  partition of the vertices (the cluster ids may be numbered apart).
"""

from itertools import permutations

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from sntc_tpu.core.frame import Frame as JFrame
from sntc_tpu.evaluation import ClusteringEvaluator as JClusteringEvaluator
from sntc_tpu.evaluation.clustering import _silhouette as jax_silhouette
from sntc_tpu.mlio import load_model as jax_load_model
from sntc_tpu.mlio import save_model as jax_save_model
from sntc_tpu.models import BisectingKMeans as JBisectingKMeans
from sntc_tpu.models import GaussianMixture as JGaussianMixture
from sntc_tpu.models import KMeans as JKMeans
from sntc_tpu.models import PowerIterationClustering as JPIC
from sntc_tpu.models.pic import _power_iterate_sharded
from sntc_tpu.parallel.collectives import shard_batch
from sntc_tpu_torch.core.frame import Frame
from sntc_tpu_torch.evaluation import ClusteringEvaluator
from sntc_tpu_torch.evaluation.clustering import _silhouette
from sntc_tpu_torch.mlio import load_model, save_model
from sntc_tpu_torch.models import (
    BisectingKMeans,
    BisectingKMeansModel,
    GaussianMixture,
    GaussianMixtureModel,
    KMeans,
    KMeansModel,
    PowerIterationClustering,
)
from sntc_tpu_torch.models.pic import power_iterate
from jax_metrics_guard import own_jax_registry  # noqa: F401

torch.set_num_threads(1)

KM_RTOL = 1e-5
GMM_TOL = 1e-4
PIC_TOL = 1e-4


def _blobs(seed=0, n=3000, k=3, d=5, scale=6.0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(k, d)) * scale
    y = rng.integers(0, k, size=n)
    X = (centers[y] + rng.normal(size=(n, d))).astype(np.float32)
    return X, y


def _rays(seed=4, n=1000):
    rng = np.random.default_rng(seed)
    base = np.array([[1.0, 0.0], [0.0, 1.0]], np.float32)
    y = rng.integers(0, 2, size=n)
    X = base[y] * rng.uniform(0.5, 5.0, size=(n, 1)).astype(np.float32)
    return (X + 0.05 * rng.normal(size=X.shape).astype(np.float32)), y


def _cluster_match(pred, truth, k):
    best = 0.0
    for perm in permutations(range(k)):
        best = max(best, (np.asarray(perm)[pred.astype(int)] == truth).mean())
    return best


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _fit_kmeans_both(mesh8, X, **params):
    jm = JKMeans(mesh=mesh8, **params).fit(JFrame({"features": X}))
    pm = KMeans(device="cpu", **params).fit(Frame({"features": X}))
    return jm, pm


# -- ClusteringEvaluator -------------------------------------------------------


@pytest.mark.parametrize("measure", ["squaredEuclidean", "cosine"])
def test_silhouette_bitwise(measure):
    X, y = _blobs(seed=6, n=1500)
    f = {"features": X, "prediction": y.astype(np.float64)}
    ours = ClusteringEvaluator(distanceMeasure=measure).evaluate(Frame(f))
    theirs = JClusteringEvaluator(distanceMeasure=measure).evaluate(JFrame(f))
    assert ours == theirs
    # a tensor column is read from the host, the same value
    ft = dict(f, features=torch.from_numpy(X))
    assert ClusteringEvaluator(distanceMeasure=measure).evaluate(
        Frame(ft)) == theirs
    assert ClusteringEvaluator().isLargerBetter()


def test_silhouette_ignores_empty_cluster_ids():
    X = np.array([[0.0, 0.0], [0.1, 0.0], [10.0, 0.0], [10.1, 0.0]])
    sparse = _silhouette(X, np.array([0, 0, 2, 2]), 3, cosine=False)
    assert sparse == jax_silhouette(X, np.array([0, 0, 2, 2]), 3, False)
    assert sparse == pytest.approx(
        _silhouette(X, np.array([0, 0, 1, 1]), 2, cosine=False))
    with pytest.raises(ValueError, match="at least 2 clusters"):
        _silhouette(X, np.zeros(4, np.int64), 1, cosine=False)


# -- KMeans --------------------------------------------------------------------


@pytest.mark.parametrize("case", [
    dict(data="blobs", k=3, seed=1, maxIter=30),
    dict(data="blobs3", k=3, seed=5, maxIter=50, initMode="random"),
    dict(data="blobs3", k=3, seed=5, maxIter=50),
    dict(data="rays", k=2, seed=0, distanceMeasure="cosine"),
    dict(data="blobs", k=4, seed=2, maxIter=3),  # stops on maxIter
], ids=["kmeans||", "random", "kmeans||-seed5", "cosine", "max-iter"])
def test_kmeans_matches_jax(mesh8, case):
    case = dict(case)
    data = case.pop("data")
    X, y = {"blobs": lambda: _blobs(),
            "blobs3": lambda: _blobs(seed=3),
            "rays": lambda: _rays()}[data]()
    jm, pm = _fit_kmeans_both(mesh8, X, **case)
    assert _rel(pm.clusterCenters, jm.clusterCenters) <= KM_RTOL
    assert pm.summary.trainingCost == pytest.approx(
        jm.summary.trainingCost, rel=KM_RTOL)
    assert pm.summary.totalIterations == jm.summary.totalIterations
    np.testing.assert_array_equal(pm.predict(X), jm.predict(X))
    out = pm.transform(Frame({"features": X}))["prediction"]
    np.testing.assert_array_equal(out, jm.predict(X))
    if case.get("initMode") != "random" and case.get("maxIter", 20) >= 20:
        # random init (no restarts, as in Spark) may end in a local
        # optimum, as it does in the JAX package on "blobs3"
        assert _cluster_match(out, y, case["k"]) > 0.98
    # one host read an iteration, and one for the centers and the cost
    assert pm.fit_stats["host_reads"] == pm.summary.totalIterations + 1


def test_kmeans_predict_on_a_tensor_runs_on_its_device(mesh8):
    X, _ = _blobs(seed=2, n=600)
    _, pm = _fit_kmeans_both(mesh8, X, k=3, seed=0)
    got = pm.predict(torch.from_numpy(X))
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float64
    np.testing.assert_array_equal(got.numpy(), pm.predict(X))
    cos = pm.copy({"distanceMeasure": "cosine"})
    np.testing.assert_array_equal(cos.predict(torch.from_numpy(X)).numpy(),
                                  cos.predict(X))


def test_kmeans_validation():
    with pytest.raises(ValueError, match="exceeds the row count"):
        KMeans(device="cpu", k=50).fit(
            Frame({"features": np.zeros((10, 2), np.float32)}))
    with pytest.raises(ValueError, match="vector column"):
        KMeans(device="cpu").fit(Frame({"features": np.zeros(10)}))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            KMeans()


def test_kmeans_subsamples_its_init_like_jax(mesh8):
    """Above 100 000 rows the init draws a host sample: the same draw."""
    rng = np.random.default_rng(11)
    X = rng.lognormal(0.5, 1.2, size=(100_500, 4)).astype(np.float32)
    jm, pm = _fit_kmeans_both(mesh8, X, k=3, seed=7, maxIter=2)
    assert _rel(pm.clusterCenters, jm.clusterCenters) <= KM_RTOL
    assert pm.summary.trainingCost == pytest.approx(
        jm.summary.trainingCost, rel=KM_RTOL)


# -- BisectingKMeans -----------------------------------------------------------


def _bk_blobs(n_per=400, seed=0, spread=0.3):
    rng = np.random.default_rng(seed)
    centers = np.array([[0.0, 0.0], [8.0, 0.0], [0.0, 8.0], [8.0, 8.0]])
    X = np.concatenate(
        [c + spread * rng.normal(size=(n_per, 2)) for c in centers]
    ).astype(np.float32)
    return X, np.repeat(np.arange(4), n_per)


def _bk_tiny_blob():
    rng = np.random.default_rng(2)
    return np.concatenate([
        rng.normal(size=(900, 2)),
        np.array([[50.0, 50.0]]) + 0.01 * rng.normal(size=(60, 2)),
    ]).astype(np.float32)


def _bk_rays():
    rng = np.random.default_rng(5)
    rows = []
    for d in np.array([[1.0, 0.0], [0.0, 1.0]]):
        scale = rng.uniform(0.5, 20.0, size=200)[:, None]
        rows.append(scale * (d + 0.02 * rng.normal(size=(200, 2))))
    return np.concatenate(rows).astype(np.float32)


@pytest.mark.parametrize("case", [
    ("blobs", dict(k=4, seed=1)),
    ("tiny", dict(k=6, minDivisibleClusterSize=100, seed=0)),
    ("tiny", dict(k=6, minDivisibleClusterSize=0.5, seed=0)),
    ("ones", dict(k=4)),
    ("rays", dict(k=2, distanceMeasure="cosine", seed=0)),
], ids=["blobs", "min-size", "min-fraction", "degenerate", "cosine"])
def test_bisecting_kmeans_matches_jax(mesh8, case):
    data, params = case
    X = {"blobs": lambda: _bk_blobs()[0], "tiny": _bk_tiny_blob,
         "ones": lambda: np.ones((64, 3), np.float32),
         "rays": _bk_rays}[data]()
    jm = JBisectingKMeans(mesh=mesh8, **params).fit(JFrame({"features": X}))
    pm = BisectingKMeans(device="cpu", **params).fit(Frame({"features": X}))
    np.testing.assert_array_equal(pm._left, jm._left)
    np.testing.assert_array_equal(pm._right, jm._right)
    assert pm.clusterCenters.shape == jm.clusterCenters.shape
    assert _rel(pm.clusterCenters, jm.clusterCenters) <= KM_RTOL
    np.testing.assert_array_equal(pm.predict(X), jm.predict(X))
    assert pm.summary.totalIterations == jm.summary.totalIterations
    assert pm.summary.trainingCost == pytest.approx(
        jm.summary.trainingCost, rel=KM_RTOL)
    f = Frame({"features": X})
    assert pm.computeCost(f) == pytest.approx(pm.summary.trainingCost,
                                              rel=1e-9)


def test_bisecting_kmeans_recovers_blobs():
    X, y = _bk_blobs()
    m = BisectingKMeans(device="cpu", k=4, seed=1).fit(Frame({"features": X}))
    pred = m.transform(Frame({"features": X}))["prediction"].astype(int)
    for c in range(4):
        assert len(np.unique(pred[y == c])) == 1
    assert len(np.unique(pred)) == 4


# -- GaussianMixture -----------------------------------------------------------


def _gmm_blobs(n=3000, seed=0):
    rng = np.random.default_rng(seed)
    centers = np.array([[-4.0, 0.0, 2.0], [3.0, 3.0, -1.0], [0.0, -4.0, -3.0]])
    y = rng.integers(0, 3, size=n)
    return (centers[y] + rng.normal(size=(n, 3))).astype(np.float32), y


def _anisotropic():
    rng = np.random.default_rng(3)
    A = np.array([[2.0, 1.8], [1.8, 2.0]])
    X1 = rng.multivariate_normal([0, 0], A, size=2000)
    X2 = rng.multivariate_normal([8, -8], np.eye(2) * 0.5, size=2000)
    return np.concatenate([X1, X2]).astype(np.float32)


@pytest.mark.parametrize("case", [
    ("blobs", dict(k=3, seed=1)),
    ("blobs2", dict(k=3, seed=0, tol=1e-4, maxIter=200)),
    ("aniso", dict(k=2, seed=0, tol=1e-4)),
    ("blobs", dict(k=3, seed=4, maxIter=3)),
], ids=["default", "tight", "anisotropic", "max-iter"])
def test_gaussian_mixture_matches_jax(mesh8, case):
    data, params = case
    X = {"blobs": lambda: _gmm_blobs()[0],
         "blobs2": lambda: _gmm_blobs(seed=2)[0],
         "aniso": _anisotropic}[data]()
    jm = JGaussianMixture(mesh=mesh8, **params).fit(JFrame({"features": X}))
    pm = GaussianMixture(device="cpu", **params).fit(Frame({"features": X}))
    assert pm.summary.totalIterations == jm.summary.totalIterations
    assert pm.summary.logLikelihood == pytest.approx(
        jm.summary.logLikelihood, abs=GMM_TOL)
    np.testing.assert_allclose(pm.means, jm.means, atol=GMM_TOL)
    np.testing.assert_allclose(pm.covs, jm.covs, atol=GMM_TOL)
    np.testing.assert_allclose(pm.weights, jm.weights, atol=GMM_TOL)
    out = pm.transform(Frame({"features": X}))
    np.testing.assert_array_equal(out["prediction"], jm.predict(X))
    np.testing.assert_allclose(out["probability"], jm.predictProbability(X),
                               atol=GMM_TOL)
    np.testing.assert_allclose(out["probability"].sum(axis=1), 1.0,
                               rtol=1e-5)
    assert len(pm.gaussians) == params["k"]
    assert pm.fit_stats["iterations"] == pm.summary.totalIterations


def test_gaussian_mixture_validation_and_tensor_input():
    X, _ = _gmm_blobs(n=900, seed=4)
    with pytest.raises(ValueError, match="at least k"):
        GaussianMixture(device="cpu", k=5).fit(Frame({"features": X[:3]}))
    m = GaussianMixture(device="cpu", k=3, seed=0).fit(Frame({"features": X}))
    np.testing.assert_array_equal(
        m.predictProbability(torch.from_numpy(X)), m.predictProbability(X))


# -- PowerIterationClustering --------------------------------------------------


def _two_block_graph(n_per=30, seed=0, id_offset=0):
    rng = np.random.default_rng(seed)
    n = 2 * n_per
    src, dst, w = [], [], []
    for i in range(n):
        for j in range(i + 1, n):
            same = (i < n_per) == (j < n_per)
            if rng.random() < (0.9 if same else 0.02):
                src.append(i + id_offset)
                dst.append(j + id_offset)
                w.append(1.0 if same else 0.1)
    return (np.array(src, np.int64), np.array(dst, np.int64),
            np.array(w, np.float64))


def _same_partition(a, b) -> bool:
    pairs = set(zip(a.tolist(), b.tolist()))
    return len(pairs) == len(set(a.tolist())) == len(set(b.tolist()))


@pytest.mark.parametrize("case", [
    dict(seed=0, id_offset=100, params=dict(k=2, maxIter=30, seed=1)),
    dict(seed=3, id_offset=0,
         params=dict(k=2, maxIter=30, initMode="degree", seed=0)),
    dict(seed=5, id_offset=7, params=dict(k=2, maxIter=5, seed=2)),
], ids=["random", "degree", "short"])
def test_pic_matches_jax(mesh8, case):
    src, dst, w = _two_block_graph(seed=case["seed"],
                                   id_offset=case["id_offset"])
    cols = {"src": src, "dst": dst, "weight": w}
    params = dict(case["params"], weightCol="weight")
    jout = JPIC(**params).assignClusters(JFrame(cols))
    pic = PowerIterationClustering(device="cpu", **params)
    out = pic.assignClusters(Frame(cols))
    np.testing.assert_array_equal(out["id"], jout["id"])
    assert _same_partition(np.asarray(out["cluster"]),
                           np.asarray(jout["cluster"]))
    # the embedding against the JAX power iteration on the same edges
    ids = np.asarray(jout["id"])
    lut = {int(v): i for i, v in enumerate(ids)}
    s = np.array([lut[int(v)] for v in src], np.int32)
    d = np.array([lut[int(v)] for v in dst], np.int32)
    s2, d2 = np.concatenate([s, d]), np.concatenate([d, s])
    w2 = np.concatenate([w, w]).astype(np.float32)
    n = len(ids)
    rng = np.random.default_rng(params["seed"])
    if params.get("initMode") == "degree":
        deg = np.bincount(s2, weights=w2, minlength=n)
        v0 = (deg / deg.sum()).astype(np.float32)
    else:
        v0 = rng.random(n).astype(np.float32)
    ss, dd, ww, wm = shard_batch(mesh8, s2, d2, w2)
    jv, jit = _power_iterate_sharded(mesh8, n, params["maxIter"])(
        ss, dd, ww, wm, jnp.asarray(v0))
    v = pic.fit_stats["embedding"]
    assert _rel(v, np.asarray(jv)) <= PIC_TOL
    assert pic.fit_stats["power_steps"] == int(jit)
    pv, steps, _ = power_iterate(
        torch.from_numpy(s2.astype(np.int64)),
        torch.from_numpy(d2.astype(np.int64)), torch.from_numpy(w2),
        torch.from_numpy(v0), n, params["maxIter"])
    np.testing.assert_array_equal(pv.numpy().astype(np.float64), v)


def test_pic_validation_and_default_weight():
    out = PowerIterationClustering(device="cpu", k=2, maxIter=10).assignClusters(
        Frame({"src": np.array([0, 1, 3, 4]), "dst": np.array([1, 2, 4, 5])}))
    assert out.num_rows == 6
    with pytest.raises(ValueError, match="non-negative"):
        PowerIterationClustering(device="cpu", weightCol="weight").assignClusters(
            Frame({"src": np.array([0]), "dst": np.array([1]),
                   "weight": np.array([-1.0])}))
    with pytest.raises(ValueError, match="self-loop"):
        PowerIterationClustering(device="cpu").assignClusters(
            Frame({"src": np.array([2]), "dst": np.array([2])}))


# -- persistence across the packages ------------------------------------------


def test_kmeans_family_saved_by_either_package_loads_in_the_other(
        mesh8, tmp_path):
    X, _ = _blobs(seed=3, n=900)
    jf, pf = JFrame({"features": X}), Frame({"features": X})
    pairs = [
        (JKMeans(mesh=mesh8, k=3, seed=5).fit(jf),
         KMeans(device="cpu", k=3, seed=5).fit(pf), KMeansModel),
        (JBisectingKMeans(mesh=mesh8, k=3, seed=4).fit(jf),
         BisectingKMeans(device="cpu", k=3, seed=4).fit(pf),
         BisectingKMeansModel),
        (JGaussianMixture(mesh=mesh8, k=3, seed=0).fit(jf),
         GaussianMixture(device="cpu", k=3, seed=0).fit(pf),
         GaussianMixtureModel),
    ]
    for i, (jm, pm, cls) in enumerate(pairs):
        jax_save_model(jm, str(tmp_path / f"j{i}"))
        save_model(pm, str(tmp_path / f"p{i}"))
        loaded = load_model(str(tmp_path / f"j{i}"), device="cpu")
        back = jax_load_model(str(tmp_path / f"p{i}"))
        assert isinstance(loaded, cls)
        assert type(back) is type(jm)
        np.testing.assert_array_equal(
            loaded.transform(pf)["prediction"], jm.transform(jf)["prediction"])
        np.testing.assert_array_equal(
            back.transform(jf)["prediction"], pm.transform(pf)["prediction"])
        if cls is GaussianMixtureModel:
            np.testing.assert_allclose(
                loaded.transform(pf)["probability"],
                jm.transform(jf)["probability"], atol=1e-6)
            np.testing.assert_allclose(
                back.transform(jf)["probability"],
                pm.transform(pf)["probability"], atol=1e-6)
