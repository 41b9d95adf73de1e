"""``mesh=`` on the classification path, the selectors, MaxAbsScaler,
IDF and ``stat`` on the card: virtual shards ``[cuda:0] * 4`` against
the same mesh of CPU shards and against mesh 1 on the card.

Every test here needs a CUDA device (``-m cuda``) and skips without one;
the file imports no JAX.  What each holds:

* whole counts bitwise the CPU mesh's: the evaluator's confusion
  matrix, IDF's ``docFreq``, the χ² statistics of ChiSquareTest and
  UnivariateFeatureSelector's selection, with ``tree_hist`` launched
  once a shard (4 times mesh 1's launches); MaxAbsScaler's maxima
  bitwise;
* moments within 1e-5 relative of the CPU mesh's (the card's products
  round apart from the CPU's): NaiveBayes' fit and ``partial_fit``,
  ANOVA, F-regression, Correlation, the Summarizer;
* the LBFGS fits: OneVsRest's LR lanes at ``[cuda:0] * 4`` within 5e-4
  relative of mesh 1 on the card (``tests/test_torch_mesh_classification.py``'s
  lane tolerance) with predictions equal on 99.9 % of rows; LinearSVC
  within 1e-3 of the CPU mesh's and its predictions equal on 99.9 %.
"""

import numpy as np
import pytest
import torch

import sntc_tpu_torch.resilience as R
from sntc_tpu_torch.core.frame import Frame
from sntc_tpu_torch.parallel import default_mesh, make_mesh, set_collective_domain


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    R.clear()
    set_collective_domain(None)
    yield torch.device("cuda:0")
    R.clear()
    set_collective_domain(None)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _data(n=2000, d=6, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(3.0, 2.0, size=(n, d)).astype(np.float32)
    y = (X[:, 0] + rng.normal(size=n) > 3.0).astype(np.float64)
    y3 = (((X[:, 0] + rng.normal(size=n)) > 3).astype(int)
          + (X[:, 1] > 3).astype(int)).astype(np.float64)
    counts = rng.poisson(0.7, size=(n, 16)).astype(np.float32)
    return X, y, y3, counts


X, Y, Y3, COUNTS = _data()


def _meshes(card):
    return make_mesh(devices=[card] * 4), default_mesh(4, device="cpu")


@pytest.mark.cuda
def test_counts_on_card_shards_equal_the_cpu_mesh(card):
    from sntc_tpu_torch.evaluation.multiclass import MulticlassMetrics
    from sntc_tpu_torch.feature import IDF, MaxAbsScaler
    from sntc_tpu_torch.stat import ChiSquareTest

    c4, h4 = _meshes(card)
    rng = np.random.default_rng(5)
    y, p = rng.integers(0, 15, 50_001), rng.integers(0, 15, 50_001)
    np.testing.assert_array_equal(MulticlassMetrics(y, p, mesh=c4).confusion,
                                  MulticlassMetrics(y, p).confusion)
    fc = Frame({"features": COUNTS})
    np.testing.assert_array_equal(
        IDF(mesh=c4, inputCol="features").fit(fc).docFreq,
        IDF(device="cpu", mesh=h4, inputCol="features").fit(fc).docFreq)
    fb = Frame({"features": X})
    np.testing.assert_array_equal(
        MaxAbsScaler(mesh=c4, inputCol="features").fit(fb).maxAbs,
        MaxAbsScaler(device="cpu", inputCol="features").fit(fb).maxAbs)
    fi = Frame({"features": np.round(X).astype(np.float32), "label": Y3})
    np.testing.assert_array_equal(
        ChiSquareTest.test(fi, "features", "label", mesh=c4)["statistics"],
        ChiSquareTest.test(fi, "features", "label", device="cpu",
                           mesh=h4)["statistics"])


@pytest.mark.cuda
def test_chi2_selection_launches_tree_hist_once_a_card_shard(card):
    from sntc_tpu_torch.feature import UnivariateFeatureSelector
    from sntc_tpu_torch.kernels import LAUNCHES, reset_launches

    f = Frame({"features": X, "label": Y3})
    kw = dict(featureType="categorical", labelType="categorical",
              selectionThreshold=3)
    launches, selected = {}, {}
    for s in (1, 4):
        reset_launches()
        selected[s] = UnivariateFeatureSelector(
            mesh=make_mesh(devices=[card] * s), **kw).fit(f).selected_features
        launches[s] = LAUNCHES["tree_hist"]
    assert launches[4] == 4 * launches[1] == 4
    cpu = UnivariateFeatureSelector(device="cpu", **kw).fit(f)
    assert selected[1] == selected[4] == cpu.selected_features


@pytest.mark.cuda
def test_moments_on_card_shards_match_the_cpu_mesh(card):
    from sntc_tpu_torch import stat
    from sntc_tpu_torch.models import NaiveBayes

    c4, h4 = _meshes(card)
    f3 = Frame({"features": X, "label": Y3})
    fr = Frame({"features": X, "label": X[:, 0] * 2.0 + Y})

    def nb(mesh, dev=None):
        m = NaiveBayes(device=dev, mesh=mesh, modelType="gaussian").fit(f3)
        return np.concatenate([m.gaussian_mu.ravel(), m.gaussian_var.ravel()])

    def nb_partial(mesh, dev=None):
        est, state = NaiveBayes(device=dev, mesh=mesh,
                                modelType="gaussian"), None
        for i in range(4):
            m, state = est.partial_fit(f3.slice(i * 500, (i + 1) * 500),
                                       state, n_classes=3)
        return np.concatenate([m.gaussian_mu.ravel(), m.gaussian_var.ravel()])

    assert _rel(nb(c4), nb(h4, "cpu")) <= 1e-5
    assert _rel(nb_partial(c4), nb_partial(h4, "cpu")) <= 1e-5
    for name, frame in (("ANOVATest", f3), ("FValueTest", fr)):
        test = getattr(stat, name).test
        assert _rel(test(frame, "features", "label", mesh=c4)["statistics"],
                    test(frame, "features", "label", device="cpu",
                         mesh=h4)["statistics"]) <= 1e-5, name
    assert _rel(stat.Correlation.corr(f3, "features", mesh=c4)["pearson"],
                stat.Correlation.corr(f3, "features", device="cpu",
                                      mesh=h4)["pearson"]) <= 1e-5
    names = ("mean", "variance", "min", "max", "count")
    sb = stat.Summarizer.metrics(*names)
    a = sb.summary(f3, "features", mesh=c4)
    b = sb.summary(f3, "features", device="cpu", mesh=h4)
    for c in names:
        assert _rel(a[c], b[c]) <= 1e-5, c
    for c in ("min", "max", "count"):
        np.testing.assert_array_equal(a[c], b[c])


@pytest.mark.cuda
def test_lbfgs_fits_on_card_shards(card):
    from sntc_tpu_torch.models import LinearSVC, LogisticRegression, OneVsRest

    c4, h4 = _meshes(card)
    f3 = Frame({"features": X, "label": Y3})
    lr = LogisticRegression(maxIter=50, regParam=1e-2)
    one = OneVsRest(classifier=lr, mesh=make_mesh(devices=[card])).fit(f3)
    four = OneVsRest(classifier=lr, mesh=c4).fit(f3)

    def coefs(m):
        return np.concatenate([np.concatenate([s.coefficientMatrix.ravel(),
                                               s.interceptVector])
                               for s in m.models])

    assert _rel(coefs(four), coefs(one)) <= 5e-4
    agree = np.mean(np.asarray(four.transform(f3)["prediction"])
                    == np.asarray(one.transform(f3)["prediction"]))
    assert agree >= 0.999
    fb = Frame({"features": X, "label": Y})
    svc_c = LinearSVC(mesh=c4, maxIter=50).fit(fb)
    svc_h = LinearSVC(device="cpu", mesh=h4, maxIter=50).fit(fb)
    assert _rel(np.append(svc_c.coefficients, svc_c.intercept),
                np.append(svc_h.coefficients, svc_h.intercept)) <= 1e-3
    agree = np.mean(np.asarray(svc_c.transform(fb)["prediction"])
                    == np.asarray(svc_h.transform(fb)["prediction"]))
    assert agree >= 0.999
