"""The port's LDA and ALS against the JAX package's, on the CPU.

Inputs: the JAX tests' planted three-topic corpus (300 documents of 80
words over a 30-word vocabulary, numpy seed 0) and their low-rank rating
matrices (numpy seeds 0, 4); the JAX side runs on tier-1's ``mesh8``.

Tolerances, each with what it measured here when set:

* LDA's E-step: fed the JAX package's own γ₀ (``jax.random.gamma``
  keyed by each document's index, computed here), γ and the ``[k, V]``
  statistic within 1e-4 relative of the JAX E-step's (2.6e-6 / 5.8e-7);
  a stop one update apart would part γ by ~1e-3.  The port's whole
  fits draw γ₀ with numpy (the JAX draws cannot be made without JAX),
  so they are held to what a fit must do: recover the planted topics by the JAX
  tests' criteria, and reach a log perplexity within 1 % of the JAX
  fit's (0.007 % online, 6e-7 % EM);
* ALS: factors within 1e-4 of the largest (explicit 2.9e-5, implicit
  8.0e-6, nonnegative 3.3e-6), predictions of ``transform`` within 1e-4
  and the same top-k recommendations.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.special import psi

from sntc_tpu.core.frame import Frame as JFrame
from sntc_tpu.mlio import load_model as jax_load_model
from sntc_tpu.mlio import save_model as jax_save_model
from sntc_tpu.models import ALS as JALS
from sntc_tpu.models import LDA as JLDA
from sntc_tpu.models.lda import _run_e_step as jax_run_e_step
from sntc_tpu_torch.core.frame import Frame
from sntc_tpu_torch.mlio import load_model, save_model
from sntc_tpu_torch.models import ALS, LDA, ALSModel, LDAModel
from sntc_tpu_torch.models.als import solve_all, solve_all_nnls
from sntc_tpu_torch.models.lda import e_step, gamma0
from jax_metrics_guard import own_jax_registry  # noqa: F401

torch.set_num_threads(1)

V, K = 30, 3
E_STEP_RTOL = 1e-4
PERPLEXITY_RTOL = 0.01
ALS_TOL = 1e-4


def _planted_corpus(n_docs=300, doc_len=80, seed=0):
    rng = np.random.default_rng(seed)
    beta = np.zeros((K, V))
    for t in range(K):
        beta[t, t * 10:(t + 1) * 10] = 1.0 / 10
    X = np.zeros((n_docs, V), np.float32)
    dominant = np.zeros(n_docs, np.int64)
    for d in range(n_docs):
        theta = rng.dirichlet([0.2] * K)
        dominant[d] = theta.argmax()
        words = rng.choice(V, size=doc_len, p=theta @ beta)
        X[d] = np.bincount(words, minlength=V)
    return X, beta, dominant


@pytest.fixture(scope="module")
def corpus():
    return _planted_corpus()


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _jax_gamma0(key, n, k):
    """The JAX E-step's γ₀: Gamma(100)/100 keyed by each document's
    index in the (padded) batch."""
    keys = jax.vmap(lambda i: jax.random.fold_in(key, i))(jnp.arange(n))
    return np.array(jax.vmap(
        lambda kk: jax.random.gamma(kk, 100.0, (k,)))(keys) / 100.0)


def _assert_recovers_planted(model, beta):
    topics = model.topicsMatrix().T
    used = set()
    for t in range(K):
        mass = topics[:, beta[t] > 0].sum(axis=1)
        best = int(np.argmax(mass))
        assert mass[best] > 0.85
        used.add(best)
    assert len(used) == K


# -- LDA -----------------------------------------------------------------------


@pytest.mark.parametrize("rows,alpha,planted", [
    (300, 1.0 / K, True), (37, 50.0 / K + 1, True), (300, 1.0 / K, False),
], ids=["corpus", "odd-batch-em-alpha", "unconverged"])
def test_lda_e_step_fed_the_jax_gamma0_matches_jax(mesh8, corpus, rows,
                                                   alpha, planted):
    """λ near the planted topics (the E-step stops on its tolerance; a
    stop one update apart would part γ by ~1e-3), or a random λ, where
    both run all 100 updates."""
    X, beta, _ = corpus
    X = X[:rows]
    rng = np.random.default_rng(3)
    lam = rng.gamma(100.0, 1.0 / 100.0, size=(K, V))
    if planted:
        lam = lam + 100.0 * beta
    elog_beta = psi(lam) - psi(lam.sum(axis=1, keepdims=True))
    key = jax.random.PRNGKey(5)
    jg, jstat = jax_run_e_step(mesh8, X, np.exp(elog_beta), alpha, key, 100)
    g0 = _jax_gamma0(key, rows, K)
    eeb = torch.from_numpy(np.exp(elog_beta).astype(np.float32))
    gamma, stat, updates, reads = e_step(
        torch.from_numpy(X.copy()), eeb, alpha, torch.from_numpy(g0))
    assert _rel(gamma.numpy(), jg) <= E_STEP_RTOL
    assert _rel(stat.numpy(), np.asarray(jstat)) <= E_STEP_RTOL
    assert reads == updates
    assert (updates < 100) if planted else (updates == 100)


def test_gamma0_is_deterministic_per_document():
    a = gamma0(7, (1, 3), 10, K)
    assert a.dtype == np.float32 and a.shape == (10, K)
    np.testing.assert_array_equal(a, gamma0(7, (1, 3), 10, K))
    # a longer batch extends the same stream: row i is the i-th document
    np.testing.assert_array_equal(gamma0(7, (1, 3), 12, K)[:10].ravel(),
                                  a.ravel())
    assert not np.array_equal(a, gamma0(7, (1, 4), 10, K))


@pytest.fixture(scope="module")
def lda_fits(corpus, mesh8):
    X = corpus[0]
    params = dict(k=K, maxIter=60, subsamplingRate=0.2, seed=1)
    em = dict(k=K, maxIter=15, optimizer="em", seed=1)
    return {
        "online": (JLDA(mesh=mesh8, **params).fit(JFrame({"features": X})),
                   LDA(device="cpu", **params).fit(Frame({"features": X}))),
        "em": (JLDA(mesh=mesh8, **em).fit(JFrame({"features": X})),
               LDA(device="cpu", **em).fit(Frame({"features": X}))),
    }


@pytest.mark.parametrize("kind", ["online", "em"])
def test_lda_fit_recovers_topics_and_matches_jax_perplexity(
        corpus, lda_fits, kind):
    X, beta, dominant = corpus
    jm, pm = lda_fits[kind]
    _assert_recovers_planted(pm, beta)
    assert (pm.alpha, pm.eta) == (jm.alpha, jm.eta)
    f, jf = Frame({"features": X}), JFrame({"features": X})
    ours, theirs = pm.logPerplexity(f), jm.logPerplexity(jf)
    assert ours == pytest.approx(theirs, rel=PERPLEXITY_RTOL)
    assert pm.logLikelihood(f) < 0
    theta = pm.transform(f)["topicDistribution"]
    np.testing.assert_allclose(theta.sum(axis=1), 1.0, atol=1e-6)
    topics = pm.topicsMatrix().T
    t_map = [int(np.argmax(topics[:, beta[t] > 0].sum(axis=1)))
             for t in range(K)]
    assert (theta.argmax(axis=1) == np.array(t_map)[dominant]).mean() > 0.8
    d = pm.describeTopics(5)
    assert d["termIndices"].shape == (K, 5)
    assert (np.diff(d["termWeights"], axis=1) <= 1e-12).all()


def test_lda_em_is_deterministic_and_validates(corpus):
    X = corpus[0]
    a = LDA(device="cpu", k=K, maxIter=3, optimizer="em", seed=1).fit(
        Frame({"features": X}))
    b = LDA(device="cpu", k=K, maxIter=3, optimizer="em", seed=1).fit(
        Frame({"features": X}))
    np.testing.assert_array_equal(a.lam, b.lam)
    with pytest.raises(ValueError, match="non-negative"):
        LDA(device="cpu", k=2).fit(
            Frame({"features": -np.ones((4, 5), np.float32)}))


def test_lda_saved_by_either_package_loads_in_the_other(corpus, lda_fits,
                                                        tmp_path):
    X = corpus[0][:20]
    jm, pm = lda_fits["online"]
    jax_save_model(jm, str(tmp_path / "j"))
    save_model(pm, str(tmp_path / "p"))
    loaded = load_model(str(tmp_path / "j"), device="cpu")
    back = jax_load_model(str(tmp_path / "p"))
    assert isinstance(loaded, LDAModel)
    np.testing.assert_array_equal(loaded.lam, jm.lam)
    np.testing.assert_array_equal(back.lam, pm.lam)
    assert (back.alpha, back.eta, back.numDocs) == (pm.alpha, pm.eta,
                                                    pm.numDocs)
    # the same λ infers the same topic mixtures up to the γ₀ draws
    np.testing.assert_allclose(
        loaded.transform(Frame({"features": X}))["topicDistribution"],
        jm.transform(JFrame({"features": X}))["topicDistribution"],
        atol=1e-3)


# -- ALS -----------------------------------------------------------------------


def _low_rank_ratings(n_u=60, n_i=40, rank=4, frac=0.5, seed=0, noise=0.05):
    rng = np.random.default_rng(seed)
    U = rng.normal(size=(n_u, rank)) / np.sqrt(rank)
    Vf = rng.normal(size=(n_i, rank)) / np.sqrt(rank)
    R = U @ Vf.T + 2.0
    mask = rng.random((n_u, n_i)) < frac
    uu, ii = np.nonzero(mask)
    r = R[uu, ii] + noise * rng.normal(size=len(uu))
    return 10 * uu + 3, 7 * ii + 1, r.astype(np.float32)


def _implicit_groups():
    rng = np.random.default_rng(4)
    users, items, counts = [], [], []
    for u in range(40):
        for _ in range(15):
            users.append(u)
            items.append(rng.integers(0, 20) + 20 * (u % 2))
            counts.append(float(rng.integers(1, 5)))
    return (np.array(users), np.array(items),
            np.array(counts, np.float32))


def _nonneg_ratings():
    rng = np.random.default_rng(4)
    U = np.abs(rng.normal(size=(50, 3))) / np.sqrt(3)
    Vf = np.abs(rng.normal(size=(35, 3))) / np.sqrt(3)
    mask = rng.random((50, 35)) < 0.6
    uu, ii = np.nonzero(mask)
    r = ((U @ Vf.T)[uu, ii] + 0.02 * rng.normal(size=len(uu)))
    return uu, ii, r.astype(np.float32)


ALS_CASES = {
    "explicit": (_low_rank_ratings, dict(rank=6, maxIter=15, regParam=0.01,
                                         seed=2)),
    "implicit": (_implicit_groups, dict(rank=4, maxIter=10, regParam=0.05,
                                        implicitPrefs=True, alpha=10.0,
                                        seed=0)),
    "nonnegative": (_nonneg_ratings, dict(rank=4, maxIter=10, regParam=0.02,
                                          nonnegative=True, seed=3)),
}


@pytest.fixture(scope="module")
def als_fits(mesh8):
    out = {}
    for name, (make, params) in ALS_CASES.items():
        u, i, r = make()
        cols = {"user": u, "item": i, "rating": r}
        out[name] = (JALS(mesh=mesh8, **params).fit(JFrame(cols)),
                     ALS(device="cpu", **params).fit(Frame(cols)), cols)
    return out


@pytest.mark.parametrize("name", list(ALS_CASES))
def test_als_matches_jax(als_fits, name):
    jm, pm, cols = als_fits[name]
    np.testing.assert_array_equal(pm.userIds, jm.userIds)
    np.testing.assert_array_equal(pm.itemIds, jm.itemIds)
    for side in ("userFactors", "itemFactors"):
        assert _rel(getattr(pm, side)["features"],
                    getattr(jm, side)["features"]) <= ALS_TOL
    pairs = {"user": cols["user"], "item": cols["item"]}
    np.testing.assert_allclose(pm.transform(Frame(pairs))["prediction"],
                               jm.transform(JFrame(pairs))["prediction"],
                               atol=ALS_TOL)
    rec, jrec = pm.recommendForAllUsers(3), jm.recommendForAllUsers(3)
    np.testing.assert_array_equal(rec["id"], jrec["id"])
    np.testing.assert_array_equal(rec["recommendations"],
                                  jrec["recommendations"])
    np.testing.assert_allclose(rec["ratings"], jrec["ratings"], atol=ALS_TOL)
    assert pm.recommendForAllItems(2)["recommendations"].shape == (
        len(pm.itemIds), 2)
    if name == "nonnegative":
        assert (pm.userFactors["features"] >= 0).all()
        assert (pm.itemFactors["features"] >= 0).all()


def test_als_cold_start_and_validation(als_fits):
    m = als_fits["explicit"][1]
    f = Frame({"user": np.array([3, 99999]), "item": np.array([1, 1])})
    assert np.isnan(m.transform(f)["prediction"][1])
    assert m.copy({"coldStartStrategy": "drop"}).transform(f).num_rows == 1
    with pytest.raises(ValueError, match="non-negative"):
        ALS(device="cpu", implicitPrefs=True).fit(Frame({
            "user": np.array([0]), "item": np.array([0]),
            "rating": np.array([-1.0], np.float32)}))


def test_als_solvers_against_float64():
    """The batched Cholesky solve against numpy; the NNLS solve at its
    KKT point (free coordinates zero gradient, bound ones non-negative),
    each row stopping on its own test."""
    rng = np.random.default_rng(0)
    n, r = 64, 5
    M = rng.normal(size=(n, r, r))
    A = (M @ M.transpose(0, 2, 1)).astype(np.float32)
    b = rng.normal(size=(n, r)).astype(np.float32)
    reg = rng.uniform(0.1, 1.0, n).astype(np.float32)
    A64 = A.astype(np.float64) + reg[:, None, None] * np.eye(r)
    x, reads = solve_all(torch.from_numpy(A), torch.from_numpy(b),
                         torch.from_numpy(reg))
    assert reads == 0
    np.testing.assert_allclose(
        x.numpy(), np.linalg.solve(A64, b.astype(np.float64)[..., None])[
            ..., 0], rtol=1e-3, atol=1e-4)
    xn, reads = solve_all_nnls(torch.from_numpy(A), torch.from_numpy(b),
                               torch.from_numpy(reg))
    xn = xn.numpy().astype(np.float64)
    assert (xn >= 0).all() and reads >= 1
    g = np.einsum("nij,nj->ni", A64, xn) - b
    assert np.abs(g[xn > 1e-8]).max() < 1e-3
    assert g[xn <= 1e-8].min() > -1e-3


def test_als_saved_by_either_package_loads_in_the_other(als_fits, tmp_path):
    jm, pm, cols = als_fits["explicit"]
    jax_save_model(jm, str(tmp_path / "j"))
    save_model(pm, str(tmp_path / "p"))
    loaded = load_model(str(tmp_path / "j"), device="cpu")
    back = jax_load_model(str(tmp_path / "p"))
    assert isinstance(loaded, ALSModel)
    pairs = {"user": cols["user"][:50], "item": cols["item"][:50]}
    np.testing.assert_array_equal(
        loaded.transform(Frame(pairs))["prediction"],
        jm.transform(JFrame(pairs))["prediction"])
    np.testing.assert_array_equal(
        back.transform(JFrame(pairs))["prediction"],
        pm.transform(Frame(pairs))["prediction"])
