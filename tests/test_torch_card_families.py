"""The families' estimators and the chi-square test on the card against
the port on the CPU.

Every test here needs a CUDA device (``-m cuda``) and skips without one;
the file imports no JAX.  The inputs are numpy-seeded, as in
``test_torch_clustering.py``, ``test_torch_lda_als.py`` and
``test_torch_stat.py``, whose tolerances these hold:

* KMeans: centers within 1e-5 relative, the same iteration count and
  predictions;
* GaussianMixture: means and covariances within 1e-4, the same iteration
  count and predictions;
* LDA's E-step from one γ₀: γ and the statistic within 1e-4 relative,
  the same number of updates;
* ALS (explicit, implicit, nonnegative): factors within 1e-4 of the
  largest;
* ``ChiSquareTest``: one ``tree_hist`` launch a test, its contingency
  bitwise the plain version's, the narrow and the wide (rows-regime)
  shape alike, and the result bitwise the CPU's.
"""

import numpy as np
import pytest
import torch
from scipy.special import psi

from sntc_tpu_torch.core.frame import Frame
from sntc_tpu_torch.kernels import LAUNCHES, reset_launches
from sntc_tpu_torch.kernels.histogram import tree_hist_reference
from sntc_tpu_torch.models import ALS, GaussianMixture, KMeans
from sntc_tpu_torch.models.lda import e_step, gamma0
from sntc_tpu_torch.stat import ChiSquareTest, contingency, factorize

KM_RTOL = 1e-5
GMM_TOL = 1e-4
E_STEP_RTOL = 1e-4
ALS_TOL = 1e-4


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _blobs(seed, n, k, d, scale=6.0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(k, d)) * scale
    y = rng.integers(0, k, size=n)
    return (centers[y] + rng.normal(size=(n, d))).astype(np.float32)


@pytest.mark.cuda
def test_kmeans_and_gmm_on_the_card_match_the_cpu(card):
    X = _blobs(9, 20_000, 5, 12)
    f = Frame({"features": X})
    kc = KMeans(device=card, k=5, seed=3).fit(f)
    kh = KMeans(device="cpu", k=5, seed=3).fit(f)
    assert _rel(kc.clusterCenters, kh.clusterCenters) <= KM_RTOL
    assert kc.summary.totalIterations == kh.summary.totalIterations
    np.testing.assert_array_equal(kc.predict(X), kh.predict(X))
    np.testing.assert_array_equal(
        kc.predict(torch.from_numpy(X).to(card)).cpu().numpy(), kh.predict(X))
    gc = GaussianMixture(device=card, k=5, seed=3, tol=1e-4).fit(f)
    gh = GaussianMixture(device="cpu", k=5, seed=3, tol=1e-4).fit(f)
    assert gc.summary.totalIterations == gh.summary.totalIterations
    np.testing.assert_allclose(gc.means, gh.means, atol=GMM_TOL)
    np.testing.assert_allclose(gc.covs, gh.covs, atol=GMM_TOL)
    np.testing.assert_array_equal(gc.predict(X), gh.predict(X))


@pytest.mark.cuda
def test_lda_e_step_on_the_card_matches_the_cpu(card):
    rng = np.random.default_rng(0)
    k, v = 10, 1_000
    beta = rng.dirichlet([0.05] * v, size=k)
    theta = rng.dirichlet([0.3] * k, size=2_000)
    X = np.stack([rng.multinomial(120, p) for p in theta @ beta]).astype(
        np.float32)
    lam = rng.gamma(100.0, 1.0 / 100.0, size=(k, v)) + 50.0 * beta
    eeb = np.exp(psi(lam) - psi(lam.sum(axis=1, keepdims=True))).astype(
        np.float32)
    g0 = gamma0(1, (0,), X.shape[0], k)
    got = {}
    for dev in ("cpu", card):
        g, s, it, _ = e_step(torch.from_numpy(X).to(dev),
                             torch.from_numpy(eeb).to(dev), 1.0 / k,
                             torch.from_numpy(g0).to(dev))
        got[str(dev)] = (g.cpu().numpy(), s.cpu().numpy(), it)
    c, h = got[str(card)], got["cpu"]
    assert c[2] == h[2]
    assert _rel(c[0], h[0]) <= E_STEP_RTOL
    assert _rel(c[1], h[1]) <= E_STEP_RTOL


def _ratings(kind: str):
    rng = np.random.default_rng(4)
    n_u, n_i, rank = 300, 120, 4
    U = np.abs(rng.normal(size=(n_u, rank)))
    V = np.abs(rng.normal(size=(n_i, rank)))
    mask = rng.random((n_u, n_i)) < 0.3
    uu, ii = np.nonzero(mask)
    r = (U @ V.T)[uu, ii] / rank + 0.05 * rng.normal(size=len(uu))
    if kind == "implicit":
        r = np.round(np.abs(r) * 3)
    return Frame({"user": uu, "item": ii, "rating": r.astype(np.float32)})


@pytest.mark.cuda
@pytest.mark.parametrize("kind,params", [
    ("explicit", dict(rank=6, maxIter=10, regParam=0.05)),
    ("implicit", dict(rank=8, maxIter=5, regParam=0.05, implicitPrefs=True,
                      alpha=5.0)),
    ("explicit", dict(rank=4, maxIter=5, regParam=0.02, nonnegative=True)),
], ids=["explicit", "implicit", "nonnegative"])
def test_als_on_the_card_matches_the_cpu(card, kind, params):
    f = _ratings(kind)
    mc = ALS(device=card, seed=3, **params).fit(f)
    mh = ALS(device="cpu", seed=3, **params).fit(f)
    for side in ("userFactors", "itemFactors"):
        assert _rel(getattr(mc, side)["features"],
                    getattr(mh, side)["features"]) <= ALS_TOL
    rec, rech = mc.recommendForAllUsers(3), mh.recommendForAllUsers(3)
    np.testing.assert_allclose(rec["ratings"], rech["ratings"], atol=ALS_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("values", [4, 4_000], ids=["narrow", "wide"])
def test_chisquare_launches_tree_hist_once_on_the_card(card, values):
    rng = np.random.default_rng(12)
    n = 50_000
    y = rng.integers(0, 5, size=n)
    X = np.stack([rng.integers(0, values, size=n) + y,
                  rng.integers(0, 7, size=n)], axis=1).astype(np.float32)
    f = Frame({"f": X, "label": y})
    reset_launches()
    out = ChiSquareTest.test(f, "f", "label", device=card)
    assert LAUNCHES["tree_hist"] == 1
    ref = ChiSquareTest.test(f, "f", "label", device="cpu")
    for c in ref.columns:
        np.testing.assert_array_equal(out[c], ref[c], err_msg=c)
    binned, n_bins, y_idx, n_classes = factorize(X, y, 10_000)
    table = contingency(binned, y_idx, n_bins, n_classes, card)
    bt = torch.from_numpy(np.ascontiguousarray(binned.T)).to(card)
    yoh = torch.nn.functional.one_hot(
        torch.from_numpy(y_idx).to(card), n_classes).float()
    plain = tree_hist_reference(
        bt, torch.zeros((1, n), dtype=torch.int32, device=card), yoh,
        n_nodes=1, n_bins=n_bins)[0]
    assert torch.equal(table, plain)
