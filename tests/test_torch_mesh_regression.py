"""``mesh=`` on the port's regression fits (LinearRegression, the GLMs,
AFT, the factorization machines, IsotonicRegression) and on the families
(GaussianMixture, BisectingKMeans, LDA, PowerIterationClustering),
against the JAX package.

The port's meshes are virtual CPU shards (``default_mesh(n,
device="cpu")``); the JAX side runs on tier-1's 8 virtual CPU devices
(``mesh8``).  The inputs are a few hundred numpy-seeded rows.  What each
test holds, relative to the largest value, each limit beside what it
measured when it was set:

* ``mesh=None`` and a one-shard mesh take the single-device path: equal,
  bitwise, for every entry point;
* across mesh sizes 1, 2, 4, 8 (``TOL``): the normal solve, the GLMs'
  coefficients and deviances, GMM's parameters, BisectingKMeans' tree
  and centers (on four blobs), the LDA fits' λ and PIC's embedding
  within ``MOMENT_TOL`` = 1e-5 (the float32 sums in other orders: at
  most 6.3e-7, LDA's em fit; the normal solve 4.5e-7); the
  fixed-length LBFGS fits (the elastic-net LR, AFT; ``maxIter`` short
  of their stop, so every size runs the same iterations) within
  ``LBFGS_TOL`` = 2e-4 (2.2e-5, AFT; the LR 1.5e-7); the FMs' factors
  after 30 adamW steps within ``FM_TOL`` = 1e-4 (6.1e-6);
  IsotonicRegression bitwise (host work); the GMM's iteration count and
  every prediction equal;
* mesh 8 against the JAX package on ``mesh8`` (``JAX_CASES``): each gap
  beside its limit; LDA's E-step fed the JAX γ₀ (the JAX draws keyed by
  each document's global index), and PIC's power iteration against the
  JAX sharded program on the same edges;
* the plumbing: every entry point takes ``mesh=`` where the JAX one
  does, a ``device`` that is not the mesh's first local device is
  refused, the collective op names (``lda.e_step``, ``pic.power``,
  ``kmeans.lloyd``) are recorded, a failing dispatch raises and a lost
  device resizes the GLM's mesh; two gloo ranks fit the GLM, the GMM and
  LDA's E-step as the one-process mesh of 2 does.
"""

import inspect
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import sntc_tpu_torch.resilience as R
from sntc_tpu_torch.core.frame import Frame
from sntc_tpu_torch.obs.metrics import registry
from sntc_tpu_torch.parallel import default_mesh, set_collective_domain
from sntc_tpu_torch.parallel.mesh import DATA_AXIS

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZES = (1, 2, 4, 8)
MOMENT_TOL = 1e-5
LBFGS_TOL = 2e-4
FM_TOL = 1e-4
TIMEOUT_S = 60

NAMES = ("LinearRegression", "GeneralizedLinearRegression",
         "AFTSurvivalRegression", "FMRegressor", "FMClassifier",
         "IsotonicRegression", "GaussianMixture", "BisectingKMeans", "LDA",
         "PowerIterationClustering")


def _mesh(n):
    return None if n is None else default_mesh(n, device="cpu")


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


# -- the inputs ----------------------------------------------------------------


def _inputs(seed=0, n=600, d=5):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    eta = X @ (0.3 * rng.normal(size=d))
    Xo = (X * 2.0 + 3.0).astype(np.float32)  # offset: the pilot rows work
    targets = {
        "gaussian": eta + 0.5 * rng.normal(size=n),
        "poisson": rng.poisson(np.exp(eta)).astype(np.float64),
        "gamma": rng.gamma(2.0, np.exp(eta) / 2.0),
        "binomial": (rng.random(n) < 1.0 / (1.0 + np.exp(-eta))).astype(
            np.float64),
        "tweedie": rng.poisson(np.exp(eta)).astype(np.float64),
    }
    t = np.exp(1.0 + eta + 0.3 * rng.normal(size=n))
    centers = np.array([[-4.0, 0.0, 2.0], [3.0, 3.0, -1.0],
                        [0.0, -4.0, -3.0]])
    blobs = (centers[rng.integers(0, 3, n)]
             + rng.normal(size=(n, 3))).astype(np.float32)
    quads = np.array([[0.0, 0.0], [8.0, 0.0], [0.0, 8.0], [8.0, 8.0]])
    squares = (quads[rng.integers(0, 4, n)]
               + 0.3 * rng.normal(size=(n, 2))).astype(np.float32)
    docs = rng.poisson(1.0, size=(200, 20)).astype(np.float32)
    return {
        "reg": {"features": Xo, "label": targets["gaussian"] + Xo[:, 0]},
        **{f"glm_{k}": {"features": X, "label": v}
           for k, v in targets.items()},
        "aft": {"features": X, "label": t,
                "censor": (rng.random(n) < 0.8).astype(np.float64)},
        "iso": {"features": X[:, 0].astype(np.float64),
                "label": eta + 0.3 * rng.normal(size=n)},
        "blobs": {"features": blobs},
        "squares": {"features": squares},
        "docs": {"features": docs},
        "graph": _two_block_graph(),
    }


def _two_block_graph(n_per=30, seed=0):
    rng = np.random.default_rng(seed)
    src, dst, w = [], [], []
    for i in range(2 * n_per):
        for j in range(i + 1, 2 * n_per):
            same = (i < n_per) == (j < n_per)
            if rng.random() < (0.9 if same else 0.02):
                src.append(i + 100)
                dst.append(j + 100)
                w.append(1.0 if same else 0.1)
    return {"src": np.array(src, np.int64), "dst": np.array(dst, np.int64),
            "weight": np.array(w, np.float64)}


COLS = _inputs()
GLMS = {"gaussian": {}, "poisson": {}, "gamma": {"link": "log"},
        "binomial": {}, "tweedie": {"variancePower": 1.5}}


def _port(name):
    import sntc_tpu_torch.models as m

    return getattr(m, name)


def _jax(name):
    import sntc_tpu.models as m

    return getattr(m, name)


def JFrame(cols):
    """A JAX package frame (imported here: the rank processes import
    this module and nothing of the JAX package)."""
    from sntc_tpu.core.frame import Frame as JF

    return JF(cols)


# -- each entry point's result, by mesh (None = no mesh) ----------------------

# (estimator, its parameters, the input, what is compared)
FITS = {
    "lr_normal": ("LinearRegression", dict(solver="normal"), "reg",
                  lambda m: np.append(m.coefficients, m.intercept)),
    "lr_elastic": ("LinearRegression", dict(
        solver="l-bfgs", regParam=0.1, elasticNetParam=0.5, maxIter=8),
        "reg", lambda m: np.append(m.coefficients, m.intercept)),
    **{f"glm_{fam}": ("GeneralizedLinearRegression",
                      dict(family=fam, **kw), f"glm_{fam}",
                      lambda m: np.append(m.coefficients, [
                          m.intercept, m.summary.deviance,
                          m.summary.nullDeviance]))
       for fam, kw in GLMS.items()},
    "aft": ("AFTSurvivalRegression", dict(maxIter=6), "aft",
            lambda m: np.append(m.coefficients, [m.intercept, m.scale])),
    "fm_regressor": ("FMRegressor", dict(maxIter=30, stepSize=0.05, tol=0.0),
                     "glm_gaussian", lambda m: np.concatenate([
                         m.factors.ravel(), m.linear, [m.intercept]])),
    "fm_classifier": ("FMClassifier", dict(
        maxIter=30, stepSize=0.05, tol=0.0, regParam=0.01), "glm_binomial",
        lambda m: np.concatenate([m.factors.ravel(), m.linear,
                                  [m.intercept]])),
    "isotonic": ("IsotonicRegression", {}, "iso",
                 lambda m: np.concatenate([m.boundaries, m.predictions])),
    "gaussian_mixture": ("GaussianMixture", dict(k=3, seed=1), "blobs",
                         lambda m: np.concatenate([
                             m.means.ravel(), m.covs.ravel(), m.weights,
                             [m.summary.logLikelihood]])),
    "bisecting_kmeans": ("BisectingKMeans", dict(k=4, seed=1), "squares",
                         lambda m: np.concatenate([
                             m._centers.ravel(), m._left, m._right])),
    "lda_online": ("LDA", dict(k=3, maxIter=5, subsamplingRate=0.2),
                   "docs", lambda m: m.lam),
    "lda_em": ("LDA", dict(k=3, maxIter=3, optimizer="em"), "docs",
               lambda m: m.lam),
}
TOL = {"lr_normal": MOMENT_TOL, "lr_elastic": LBFGS_TOL,
       **{f"glm_{fam}": MOMENT_TOL for fam in GLMS}, "aft": LBFGS_TOL,
       "fm_regressor": FM_TOL, "fm_classifier": FM_TOL, "isotonic": 0.0,
       "gaussian_mixture": MOMENT_TOL, "bisecting_kmeans": MOMENT_TOL,
       "lda_online": MOMENT_TOL, "lda_em": MOMENT_TOL, "pic": MOMENT_TOL}


def _fit(key, mesh):
    if key == "pic":
        return _pic(mesh)[1]
    name, kw, data, get = FITS[key]
    return get(_port(name)(device="cpu", mesh=mesh, **kw).fit(
        Frame(COLS[data])))


def _pic(mesh):
    pic = _port("PowerIterationClustering")(
        device="cpu", mesh=mesh, k=2, maxIter=30, weightCol="weight",
        seed=1)
    out = pic.assignClusters(Frame(COLS["graph"]))
    return np.asarray(out["cluster"]), pic.fit_stats["embedding"]


KEYS = list(FITS) + ["pic"]


@pytest.mark.parametrize("key", KEYS)
def test_no_mesh_and_one_shard_are_the_single_device_path_bitwise(key):
    np.testing.assert_array_equal(np.asarray(_fit(key, None), np.float64),
                                  np.asarray(_fit(key, _mesh(1)),
                                             np.float64))


@pytest.mark.parametrize("key", KEYS)
def test_mesh_sizes_agree(key):
    outs = {s: np.asarray(_fit(key, _mesh(s)), np.float64) for s in SIZES}
    for s in SIZES[1:]:
        if TOL[key] == 0.0:
            np.testing.assert_array_equal(outs[s], outs[1], err_msg=str(s))
        else:
            assert _rel(outs[s], outs[1]) <= TOL[key], (
                key, s, _rel(outs[s], outs[1]))


def test_trees_and_partitions_equal_across_mesh_sizes():
    """BisectingKMeans' tree and predictions, PIC's clusters and the GMM's
    predictions are the same at every mesh size."""
    f, fb = Frame(COLS["squares"]), Frame(COLS["blobs"])
    BK, GM = _port("BisectingKMeans"), _port("GaussianMixture")
    base = BK(device="cpu", k=4, seed=1).fit(f)
    gbase = GM(device="cpu", k=3, seed=1).fit(fb)
    cl1, _ = _pic(None)
    for s in SIZES[1:]:
        m = BK(device="cpu", mesh=_mesh(s), k=4, seed=1).fit(f)
        np.testing.assert_array_equal(m._left, base._left)
        np.testing.assert_array_equal(m.transform(f)["prediction"],
                                      base.transform(f)["prediction"])
        g = GM(device="cpu", mesh=_mesh(s), k=3, seed=1).fit(fb)
        assert g.summary.totalIterations == gbase.summary.totalIterations
        np.testing.assert_array_equal(g.transform(fb)["prediction"],
                                      gbase.transform(fb)["prediction"])
        np.testing.assert_array_equal(_pic(_mesh(s))[0], cl1)


def test_every_entry_point_takes_mesh_as_the_jax_one_does():
    for name in NAMES:
        for cls in (_port(name), _jax(name)):
            assert "mesh" in inspect.signature(cls.__init__).parameters, name
        est = _port(name)(mesh=_mesh(2))
        assert est.mesh.shape == {"data": 2}
        assert est.device == torch.device("cpu")


@pytest.mark.parametrize("name", NAMES)
def test_a_device_that_is_not_the_mesh_s_is_refused(name):
    with pytest.raises(ValueError, match="first local device"):
        _port(name)(device="cuda", mesh=_mesh(2))


def test_collective_op_names_are_the_jax_package_s():
    def dispatches(op):
        return registry().get("sntc_collective_dispatches_total", op=op,
                              axis=DATA_AXIS) or 0

    before = {op: dispatches(op) for op in ("lda.e_step", "pic.power",
                                            "kmeans.lloyd")}
    m = _port("LDA")(device="cpu", mesh=_mesh(4), k=3, maxIter=3,
                     subsamplingRate=0.2).fit(Frame(COLS["docs"]))
    assert m.fit_stats["iterations"] == 3
    assert dispatches("lda.e_step") - before["lda.e_step"] == 3
    _pic(_mesh(4))
    assert dispatches("pic.power") - before["pic.power"] == 1
    # the PIC's KMeans on the embedding ran over the mesh
    assert dispatches("kmeans.lloyd") > before["kmeans.lloyd"]


def test_a_failing_dispatch_raises_and_a_lost_device_resizes():
    """No fallback: a mesh fit whose dispatch fails raises.  A lost device
    shrinks the GLM's mesh 8 → 4 and the fit goes on to the same
    coefficients."""
    from sntc_tpu_torch.resilience.device import DeviceFaultDomain

    GLM = _port("GeneralizedLinearRegression")
    f = Frame(COLS["glm_poisson"])
    R.arm("collective.dispatch", kind="exc", after=2, times=1)
    with pytest.raises(Exception):
        GLM(device="cpu", mesh=_mesh(8), family="poisson").fit(f)
    R.clear()
    base = GLM(device="cpu", mesh=_mesh(8), family="poisson").fit(f)
    dom = DeviceFaultDomain()
    set_collective_domain(dom)
    R.arm("collective.dispatch", kind="device_lost", after=3, times=1)
    m = GLM(device="cpu", mesh=_mesh(8), family="poisson").fit(f)
    assert [(r["from"], r["to"]) for r in dom.journal
            if r.get("decision") == "mesh_resize"] == [(8, 4)]
    assert _rel(np.append(m.coefficients, m.intercept),
                np.append(base.coefficients, base.intercept)) <= MOMENT_TOL


# -- mesh 8 against the JAX package on mesh8 ----------------------------------

# (the key of FITS, the JAX side's result as FITS compares it, limit,
# measured when set)
JAX_CASES = [
    ("lr_normal", 1e-5, 1.3e-7),
    ("lr_elastic", 1e-4, 8.6e-8),
    ("glm_gaussian", 1e-5, 1.1e-7),
    ("glm_poisson", 1e-5, 7.5e-8),
    ("glm_gamma", 1e-5, 1.3e-7),
    ("glm_binomial", 1e-5, 2.9e-7),
    ("glm_tweedie", 1e-5, 2.1e-7),
    ("aft", 1e-4, 9.9e-6),
    ("fm_regressor", 1e-4, 2.6e-6),
    ("fm_classifier", 1e-4, 1.0e-6),
    ("isotonic", 0.0, 0.0),
    ("gaussian_mixture", 1e-5, 0.0),
    ("bisecting_kmeans", 1e-5, 0.0),
]


def _jax_fit(key, mesh8):
    name, kw, data, get = FITS[key]
    return get(_jax(name)(mesh=mesh8, **kw).fit(JFrame(COLS[data])))


@pytest.mark.parametrize("key,tol,measured", JAX_CASES,
                         ids=[c[0] for c in JAX_CASES])
def test_mesh8_against_the_jax_package(mesh8, key, tol, measured):
    j = np.asarray(_jax_fit(key, mesh8), np.float64)
    p = np.asarray(_fit(key, _mesh(8)), np.float64)
    if tol == 0.0:
        np.testing.assert_array_equal(p, j)
    else:
        assert _rel(p, j) <= tol, (key, _rel(p, j), measured)


def _jax_gamma0(key, n, k):
    """The JAX E-step's γ₀: Gamma(100)/100 keyed by each document's
    global index in the (padded) batch."""
    import jax
    import jax.numpy as jnp

    keys = jax.vmap(lambda i: jax.random.fold_in(key, i))(jnp.arange(n))
    return np.array(jax.vmap(
        lambda kk: jax.random.gamma(kk, 100.0, (k,)))(keys) / 100.0)


@pytest.mark.parametrize("rows", [200, 37], ids=["batch", "odd-batch"])
def test_lda_e_step_at_mesh8_fed_the_jax_gamma0(mesh8, rows):
    """γ and the ``[k, V]`` statistic within 1e-4 of the JAX sharded
    E-step's (measured 3.7e-6 / 1.9e-7 at 200 documents, 4.5e-6 / 6.2e-7
    at 37; a random λ: all 100 updates run), the same number of updates
    at every mesh size."""
    import jax
    from scipy.special import psi

    from sntc_tpu.models.lda import _run_e_step as jax_run_e_step
    from sntc_tpu_torch.models.lda import e_step
    from sntc_tpu_torch.parallel import shard_batch

    X = COLS["docs"]["features"][:rows]
    k = 3
    lam = np.random.default_rng(3).gamma(100.0, 0.01, size=(k, X.shape[1]))
    eeb = np.exp(psi(lam) - psi(lam.sum(axis=1, keepdims=True)))
    key = jax.random.PRNGKey(5)
    jg, jstat = jax_run_e_step(mesh8, X, eeb, 1.0 / k, key, 100)
    g0 = _jax_gamma0(key, rows, k)
    eeb_t = torch.from_numpy(eeb.astype(np.float32))
    updates = {}
    for s in SIZES:
        xs, gs, wm = shard_batch(_mesh(s), X, g0)
        gamma, stat, updates[s], reads = e_step(xs, eeb_t, 1.0 / k, gs,
                                                wm=wm)
        assert reads == updates[s]
        if s == 8:
            assert _rel(gamma.numpy()[:rows], jg) <= 1e-4
            assert _rel(stat.numpy(), np.asarray(jstat)) <= 1e-4
    assert len(set(updates.values())) == 1, updates


def test_pic_at_mesh8_against_the_jax_power_iteration(mesh8):
    """The embedding within 1e-5 of the JAX sharded program's on the same
    mirrored edges (measured 3.3e-7), the same steps (8), the same
    partition as the JAX ``assignClusters``."""
    import jax.numpy as jnp

    from sntc_tpu.models.pic import _power_iterate_sharded
    from sntc_tpu.parallel.collectives import shard_batch as jshard

    g = COLS["graph"]
    jout = _jax("PowerIterationClustering")(
        mesh=mesh8, k=2, maxIter=30, weightCol="weight", seed=1
    ).assignClusters(JFrame(g))
    pic = _port("PowerIterationClustering")(
        device="cpu", mesh=_mesh(8), k=2, maxIter=30, weightCol="weight",
        seed=1)
    out = pic.assignClusters(Frame(g))
    np.testing.assert_array_equal(out["id"], jout["id"])
    a, b = np.asarray(out["cluster"]), np.asarray(jout["cluster"])
    assert len(set(zip(a.tolist(), b.tolist()))) == len(set(a.tolist()))
    ids = np.asarray(jout["id"])
    s = np.searchsorted(ids, g["src"]).astype(np.int32)
    d = np.searchsorted(ids, g["dst"]).astype(np.int32)
    s2, d2 = np.concatenate([s, d]), np.concatenate([d, s])
    w2 = np.concatenate([g["weight"], g["weight"]]).astype(np.float32)
    v0 = np.random.default_rng(1).random(len(ids)).astype(np.float32)
    jv, jit = _power_iterate_sharded(mesh8, len(ids), 30)(
        *jshard(mesh8, s2, d2, w2), jnp.asarray(v0))
    assert _rel(pic.fit_stats["embedding"], np.asarray(jv)) <= 1e-5
    assert pic.fit_stats["power_steps"] == int(jit)


# -- two gloo ranks -------------------------------------------------------------

RANK_CODE = r"""
import sys
import numpy as np
import torch
sys.path.insert(0, sys.argv[3])
from test_torch_mesh_regression import rank_results
from sntc_tpu_torch.parallel import global_mesh, initialize

url, out = sys.argv[1], sys.argv[2]
torch.set_num_threads(1)
assert initialize(url, device="cpu")
np.savez(out, **rank_results(global_mesh()))
torch.distributed.destroy_process_group()
"""


def rank_results(mesh) -> dict:
    """What a rank process and the one-process mesh of 2 compute: the
    poisson GLM, the GMM and one LDA E-step."""
    from sntc_tpu_torch.models.lda import e_step
    from sntc_tpu_torch.parallel import shard_batch

    glm = _port("GeneralizedLinearRegression")(
        device="cpu", mesh=mesh, family="poisson").fit(
            Frame(COLS["glm_poisson"]))
    gmm = _port("GaussianMixture")(device="cpu", mesh=mesh, k=3,
                                   seed=1).fit(Frame(COLS["blobs"]))
    X = COLS["docs"]["features"]
    g0 = np.random.default_rng(9).gamma(100.0, 0.01, size=(len(X), 3))
    eeb = np.random.default_rng(8).dirichlet(np.ones(X.shape[1]), 3)
    xs, gs, wm = shard_batch(mesh, X, g0.astype(np.float32))
    _, stat, updates, _ = e_step(
        xs, torch.from_numpy(eeb.astype(np.float32)), 1.0 / 3, gs, wm=wm)
    return {"glm": np.append(glm.coefficients, glm.summary.deviance),
            "gmm": np.concatenate([gmm.means.ravel(), gmm.covs.ravel()]),
            "lda": stat.numpy(), "updates": np.array(updates),
            "shards": np.array(mesh.shape["data"])}


def test_two_gloo_ranks_equal_the_one_process_mesh_of_2(tmp_path):
    """Each rank holds one shard; the partials' all-reduce is the
    one-process sum of two (bitwise: a two-term sum has one order)."""
    env = dict(os.environ, PYTHONPATH=REPO, WORLD_SIZE="2",
               OMP_NUM_THREADS="1", MASTER_ADDR="", MASTER_PORT="")
    url = f"file://{tmp_path}/rendezvous"
    procs = []
    try:
        for r in range(2):
            procs.append(subprocess.Popen(
                [sys.executable, "-c", RANK_CODE, url,
                 str(tmp_path / f"rank{r}.npz"),
                 os.path.dirname(os.path.abspath(__file__))],
                env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, cwd=REPO))
        for p in procs:
            _out, err = p.communicate(timeout=TIMEOUT_S)
            assert p.returncode == 0, err.decode()[-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    ref = rank_results(_mesh(2))
    for r in range(2):
        got = dict(np.load(tmp_path / f"rank{r}.npz"))
        assert int(got["shards"]) == 2
        for k in ("glm", "gmm", "lda", "updates"):
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
