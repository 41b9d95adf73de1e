"""``mesh=`` on the regression fits and the families on the card:
virtual shards ``[cuda:0] * 4`` against ``cuda:0`` alone.

Every test here needs a CUDA device (``-m cuda``) and skips without one;
the file imports no JAX.  The limits are those of
``tests/test_torch_mesh_regression.py`` across mesh sizes, relative to
the largest value: the normal solve, the GLMs, the GMM, the LDA fits'
λ, PIC's embedding and BisectingKMeans' centers within 1e-5 (the same
tree, the same partitions and predictions); the FMs after 30 adamW steps
within 1e-4.  The LBFGS fits (the elastic-net LR, AFT) run to their
stop: the same iterations, the objective histories within 5e-5 of the
start and the last within 1e-6 (on the CPU at these 4 000 rows 9.0e-6
and 2.2e-8), the coefficients within 1e-3 (the elastic net's L1 term
leaves them 5.2e-4 apart on the CPU, its objective 1.8e-8).  A model
fitted at ``[cuda:0] * 4`` is served through a bucketed
``BatchPredictor``: one ``pad_assemble`` launch a padded batch,
predictions within 1e-5 of the single-device model's.
"""

import numpy as np
import pytest
import torch

import sntc_tpu_torch.resilience as R
from sntc_tpu_torch.core.frame import Frame, to_host
from sntc_tpu_torch.parallel import make_mesh, set_collective_domain


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


def _data(n=4000, d=8, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    eta = X @ (0.3 * rng.normal(size=d))
    centers = rng.normal(size=(3, 4)) * 5.0
    blobs = (centers[rng.integers(0, 3, n)]
             + rng.normal(size=(n, 4))).astype(np.float32)
    return {
        "X": X, "Xo": (X * 2.0 + 3.0).astype(np.float32),
        "gaussian": eta + 0.5 * rng.normal(size=n),
        "poisson": rng.poisson(np.exp(eta)).astype(np.float64),
        "binary": (rng.random(n) < 1.0 / (1.0 + np.exp(-eta))).astype(
            np.float64),
        "t": np.exp(1.0 + eta + 0.3 * rng.normal(size=n)),
        "censor": (rng.random(n) < 0.8).astype(np.float64),
        "blobs": blobs,
        "docs": rng.poisson(1.0, size=(400, 30)).astype(np.float32),
    }


D = _data()


def _graph(n_per=40, seed=0):
    rng = np.random.default_rng(seed)
    iu, ju = np.triu_indices(2 * n_per, 1)
    same = (iu < n_per) == (ju < n_per)
    keep = rng.random(len(iu)) < np.where(same, 0.5, 0.01)
    return {"src": iu[keep].astype(np.int64), "dst": ju[keep].astype(np.int64),
            "weight": np.where(same[keep], 1.0, 0.1)}


def _both(card, fit):
    """``fit(mesh)`` at ``cuda:0`` alone and at ``[cuda:0] * 4``."""
    return fit(None), fit(make_mesh(devices=[card] * 4))


@pytest.mark.cuda
@pytest.mark.parametrize("name,tol", [
    ("lr_normal", 1e-5), ("lr_elastic", 1e-3), ("glm_poisson", 1e-5),
    ("glm_binomial", 1e-5), ("aft", 1e-3), ("fm_regressor", 1e-4),
    ("fm_classifier", 1e-4)])
def test_regression_fits_on_card_shards(card, name, tol):
    from sntc_tpu_torch import models as M

    fr = Frame({"features": D["Xo"], "label": D["gaussian"] + D["Xo"][:, 0]})
    fb = Frame({"features": D["X"], "label": D["binary"]})
    est, frame = {
        "lr_normal": (lambda m: M.LinearRegression(
            device=card if m is None else None, mesh=m, solver="normal"),
            fr),
        "lr_elastic": (lambda m: M.LinearRegression(
            device=card if m is None else None, mesh=m, solver="l-bfgs",
            regParam=0.1, elasticNetParam=0.5), fr),
        "glm_poisson": (lambda m: M.GeneralizedLinearRegression(
            device=card if m is None else None, mesh=m, family="poisson"),
            Frame({"features": D["X"], "label": D["poisson"]})),
        "glm_binomial": (lambda m: M.GeneralizedLinearRegression(
            device=card if m is None else None, mesh=m, family="binomial"),
            fb),
        "aft": (lambda m: M.AFTSurvivalRegression(
            device=card if m is None else None, mesh=m),
            Frame({"features": D["X"], "label": D["t"],
                   "censor": D["censor"]})),
        "fm_regressor": (lambda m: M.FMRegressor(
            device=card if m is None else None, mesh=m, maxIter=30,
            stepSize=0.05, tol=0.0),
            Frame({"features": D["X"], "label": D["gaussian"]})),
        "fm_classifier": (lambda m: M.FMClassifier(
            device=card if m is None else None, mesh=m, maxIter=30,
            stepSize=0.05, tol=0.0), fb),
    }[name]

    def params(m):
        if hasattr(m, "factors"):
            return np.concatenate([m.factors.ravel(), m.linear,
                                   [m.intercept]])
        return np.append(m.coefficients, m.intercept)

    one, four = _both(card, lambda m: est(m).fit(frame))
    assert _rel(params(four), params(one)) <= tol, _rel(params(four),
                                                        params(one))
    if name.startswith("glm"):
        assert abs(four.summary.deviance / one.summary.deviance - 1) <= 1e-5
    if name in ("lr_elastic", "aft"):
        h1 = np.asarray(one.summary.objectiveHistory)
        h4 = np.asarray(four.summary.objectiveHistory)
        assert len(h4) == len(h1)
        assert np.abs(h4 - h1).max() <= 5e-5 * abs(h1[0])
        assert abs(h4[-1] - h1[-1]) <= 1e-6 * abs(h1[0])


@pytest.mark.cuda
def test_families_on_card_shards(card):
    from sntc_tpu_torch.models import (BisectingKMeans, GaussianMixture, LDA,
                                       PowerIterationClustering)

    fb = Frame({"features": D["blobs"]})

    def dev(m):
        return card if m is None else None

    g1, g4 = _both(card, lambda m: GaussianMixture(
        device=dev(m), mesh=m, k=3, seed=1).fit(fb))
    assert g4.summary.totalIterations == g1.summary.totalIterations
    assert _rel(np.concatenate([g4.means.ravel(), g4.covs.ravel()]),
                np.concatenate([g1.means.ravel(), g1.covs.ravel()])) <= 1e-5
    np.testing.assert_array_equal(g4.predict(D["blobs"]),
                                  g1.predict(D["blobs"]))
    b1, b4 = _both(card, lambda m: BisectingKMeans(
        device=dev(m), mesh=m, k=3, seed=1).fit(fb))
    np.testing.assert_array_equal(b4._left, b1._left)
    assert _rel(b4.clusterCenters, b1.clusterCenters) <= 1e-5
    fd = Frame({"features": D["docs"]})
    for kw in (dict(subsamplingRate=0.2, maxIter=5),
               dict(optimizer="em", maxIter=3)):
        l1, l4 = _both(card, lambda m: LDA(device=dev(m), mesh=m, k=3,
                                           **kw).fit(fd))
        assert _rel(l4.lam, l1.lam) <= 1e-5, kw
    p1, p4 = _both(card, lambda m: PowerIterationClustering(
        device=dev(m), mesh=m, k=2, maxIter=30, weightCol="weight", seed=1))
    c1 = np.asarray(p1.assignClusters(Frame(_graph()))["cluster"])
    c4 = np.asarray(p4.assignClusters(Frame(_graph()))["cluster"])
    assert len(set(zip(c1.tolist(), c4.tolist()))) == len(set(c1.tolist()))
    assert _rel(p4.fit_stats["embedding"], p1.fit_stats["embedding"]) <= 1e-5
    assert p4.fit_stats["power_steps"] == p1.fit_stats["power_steps"]


@pytest.mark.cuda
def test_mesh_fitted_models_served_through_pad_assemble(card):
    from sntc_tpu_torch.kernels import LAUNCHES, reset_launches
    from sntc_tpu_torch.models import GaussianMixture, LinearRegression
    from sntc_tpu_torch.serve.transform import BatchPredictor

    fr = Frame({"features": D["Xo"], "label": D["gaussian"]})
    lr1, lr4 = _both(card, lambda m: LinearRegression(
        device=card if m is None else None, mesh=m, solver="normal").fit(fr))
    fb = Frame({"features": D["blobs"]})
    g1, g4 = _both(card, lambda m: GaussianMixture(
        device=card if m is None else None, mesh=m, k=3, seed=1).fit(fb))
    reset_launches()
    preds = {}
    for key, models, x in (("lr", (lr1, lr4), D["Xo"]),
                           ("gmm", (g1, g4), D["blobs"])):
        for tag, m in zip((1, 4), models):
            out = BatchPredictor(m, bucket_rows=256, device=card
                                 ).predict_frame(Frame({"features": x[:1000]}))
            preds[(key, tag)] = np.asarray(to_host(out["prediction"]),
                                           np.float64)
    torch.cuda.synchronize()
    assert LAUNCHES["pad_assemble"] == 4
    assert _rel(preds[("lr", 4)], preds[("lr", 1)]) <= 1e-5
    np.testing.assert_array_equal(preds[("gmm", 4)], preds[("gmm", 1)])
