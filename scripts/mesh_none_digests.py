"""Digests of the single-device fits of every estimator that takes
``mesh=``: each fitted on the CPU without a mesh, from numpy-seeded
inputs, with 4 torch threads, and one SHA-256 prefix a result printed as
one JSON line.  Run it from two checkouts (``PYTHONPATH=<checkout>
python3 scripts/mesh_none_digests.py``) to show that a change leaves the
``mesh=None`` path's results bitwise as they were.  The classification
path's fits and scores (NaiveBayes, LinearSVC, OneVsRest's LR lanes, the
grid and fold lanes, LR's partial_fit, the evaluator, the selectors,
MaxAbsScaler, IDF, ``stat``), the regression fits (LinearRegression,
the GLMs, AFT, the FMs, IsotonicRegression) and the families
(GaussianMixture, BisectingKMeans, LDA, PowerIterationClustering) are
digested at ``mesh=None``; where the checkout's entry point takes
``mesh=``, the same call at a one-shard mesh is digested too, and
``one_shard_differs`` lists those that differ."""
import hashlib, json, sys
import numpy as np, torch
torch.set_num_threads(4)
from sntc_tpu_torch.core.frame import Frame
from sntc_tpu_torch.feature import StandardScaler, MinMaxScaler, PCA, ChiSqSelector
from sntc_tpu_torch.models import (KMeans, ALS, LogisticRegression, MultilayerPerceptronClassifier,
    RandomForestClassifier, DecisionTreeClassifier, GBTClassifier, RandomForestRegressor,
    DecisionTreeRegressor, GBTRegressor, OneVsRest)
rng = np.random.default_rng(0)
X = rng.normal(3, 2, size=(3000, 8)).astype(np.float32)
y = ((X[:, 0] + rng.normal(size=3000)) > 3).astype(np.float64)
y3 = ((X[:, 0] + rng.normal(size=3000)) > 3).astype(int) + (X[:, 1] > 3).astype(int)
yr = (X[:, 0] * 2 + rng.normal(size=3000)).astype(np.float64)
f = Frame({"features": X, "label": y})
f3 = Frame({"features": X, "label": y3.astype(np.float64)})
fr = Frame({"features": X, "label": yr})
def h(*arrs):
    m = hashlib.sha256()
    for a in arrs: m.update(np.ascontiguousarray(np.asarray(a)).tobytes())
    return m.hexdigest()[:16]
out = {}
out["ss"] = h(*(lambda m: (m.mean, m.std))(StandardScaler(device="cpu", withMean=True).fit(f)))
out["mm"] = h(*(lambda m: (m.originalMin, m.originalMax))(MinMaxScaler(device="cpu").fit(f)))
out["pca"] = h(PCA(device="cpu", k=4).fit(f).pc)
out["chisq"] = h(ChiSqSelector(device="cpu", numTopFeatures=4).fit(f3).selected_features)
km = KMeans(device="cpu", k=4, seed=1).fit(f); out["km"] = h(km.clusterCenters, km.summary.trainingCost)
lr = LogisticRegression(device="cpu", maxIter=30).fit(f3); out["lr"] = h(lr.coefficientMatrix, lr.interceptVector, lr.summary.objectiveHistory)
mlp = MultilayerPerceptronClassifier(device="cpu", layers=[8, 6, 3], maxIter=30).fit(f3); out["mlp"] = h(mlp.weights)
for name, est, fr_ in [("rf", RandomForestClassifier(device="cpu", numTrees=4, maxDepth=5), f3),
                       ("dt", DecisionTreeClassifier(device="cpu", maxDepth=5), f3),
                       ("gbt", GBTClassifier(device="cpu", maxIter=4, maxDepth=3), f),
                       ("ovr_gbt", OneVsRest(classifier=GBTClassifier(device="cpu", maxIter=3, maxDepth=3)), f3),
                       ("rfr", RandomForestRegressor(device="cpu", numTrees=3, maxDepth=4), fr),
                       ("dtr", DecisionTreeRegressor(device="cpu", maxDepth=4), fr),
                       ("gbtr", GBTRegressor(device="cpu", maxIter=3, maxDepth=3), fr)]:
    m = est.fit(fr_)
    out[name] = h(m.transform(fr_)["prediction"], *( (m.forest.feature, m.forest.threshold, m.forest.leaf_stats) if hasattr(m, "forest") else ()))
rng2 = np.random.default_rng(1)
uu = rng2.integers(0, 40, 600); ii = rng2.integers(0, 30, 600)
fa = Frame({"user": uu, "item": ii, "rating": rng2.normal(3, 1, 600).astype(np.float32)})
out["als"] = h(ALS(device="cpu", rank=4, maxIter=5, seed=2).fit(fa)._uf)
out["als_imp"] = h(ALS(device="cpu", rank=4, maxIter=5, seed=2, implicitPrefs=True).fit(Frame({"user": uu, "item": ii, "rating": np.abs(fa["rating"])}))._uf)
from sntc_tpu_torch.ops.binning import quantile_bin_edges
out["edges"] = h(quantile_bin_edges(X, 32, sample_rows=1000))

from sntc_tpu_torch import stat
from sntc_tpu_torch.evaluation import MulticlassClassificationEvaluator
from sntc_tpu_torch.feature import (IDF, MaxAbsScaler, UnivariateFeatureSelector,
    VarianceThresholdSelector)
from sntc_tpu_torch.models import LinearSVC, NaiveBayes
from sntc_tpu_torch.parallel import default_mesh
Xi = np.round(X).astype(np.float32)
fi = Frame({"features": Xi, "label": y3.astype(np.float64)})
fc = Frame({"features": np.maximum(X - 3, 0).astype(np.float32)})
fold_of = np.arange(3000) % 3
GRID = [{"regParam": 1e-4}, {"regParam": 1e-2}]
def lrs(models): return [a for m in models for a in (m.coefficientMatrix, m.interceptVector, m.summary.objectiveHistory)]
def pf(kw):
    est, state = LogisticRegression(device="cpu", maxIter=20, **kw), None
    for i in range(3):
        m, state = est.partial_fit(f3.slice(i * 1000, (i + 1) * 1000), state, n_classes=3)
    return [m.coefficientMatrix, m.interceptVector]
def nb_pf(kw):
    est, state = NaiveBayes(device="cpu", modelType="gaussian", **kw), None
    for i in range(3):
        m, state = est.partial_fit(f3.slice(i * 1000, (i + 1) * 1000), state, n_classes=3)
    return [m.gaussian_mu, m.gaussian_var, m.pi]
def ev(kw):
    p = LogisticRegression(device="cpu", maxIter=10).fit(f3).transform(f3)
    return [MulticlassClassificationEvaluator(metricName=n, **kw).evaluate(p) for n in ("f1", "macroF1", "accuracy")]
def summ(kw):
    sb = stat.Summarizer.metrics("mean", "variance", "min", "max", "count", "numNonZeros", "normL2")
    r = sb.summary(f, "features", device="cpu", **kw)
    return [r[c] for c in ("mean", "variance", "min", "max", "count", "numNonZeros", "normL2")]
CLASSIFICATION = {
    "nb": lambda kw: (lambda m: [m.gaussian_mu, m.gaussian_var, m.pi])(NaiveBayes(device="cpu", modelType="gaussian", **kw).fit(f3)),
    "nb_multinomial": lambda kw: [NaiveBayes(device="cpu", **kw).fit(Frame({"features": np.abs(X), "label": y3.astype(np.float64)})).theta],
    "nb_partial": nb_pf,
    "svc": lambda kw: (lambda m: [m.coefficients, m.intercept, m.summary.objectiveHistory, m.summary.accuracy])(LinearSVC(device="cpu", maxIter=20, **kw).fit(f)),
    "ovr_lr": lambda kw: lrs(OneVsRest(classifier=LogisticRegression(device="cpu", maxIter=20), **kw).fit(f3).models),
    "ovr_svc": lambda kw: [m.coefficients for m in OneVsRest(classifier=LinearSVC(device="cpu", maxIter=10), **kw).fit(f3).models],
    "lr_grid": lambda kw: lrs(LogisticRegression(device="cpu", maxIter=20, **kw)._fit_grid(f3, GRID)),
    "lr_folds": lambda kw: lrs([m for r in LogisticRegression(device="cpu", maxIter=20, **kw)._fit_grid_folds(f3, GRID, fold_of, 3) for m in r]),
    "lr_partial": pf,
    "lr_summary": lambda kw: [LogisticRegression(device="cpu", maxIter=10, **kw).fit(f3).summary.weightedFMeasure()],
    "evaluator": ev,
    "ufs_chi2": lambda kw: [UnivariateFeatureSelector(device="cpu", featureType="categorical", labelType="categorical", selectionThreshold=3, **kw).fit(f3).selected_features],
    "ufs_anova": lambda kw: [UnivariateFeatureSelector(device="cpu", featureType="continuous", labelType="categorical", selectionThreshold=3, **kw).fit(f3).selected_features],
    "ufs_fregression": lambda kw: [UnivariateFeatureSelector(device="cpu", featureType="continuous", labelType="continuous", selectionThreshold=3, **kw).fit(fr).selected_features],
    "variance_selector": lambda kw: [VarianceThresholdSelector(device="cpu", varianceThreshold=3.9, **kw).fit(f).selectedFeatures],
    "maxabs": lambda kw: [MaxAbsScaler(device="cpu", inputCol="features", **kw).fit(f).maxAbs],
    "idf": lambda kw: (lambda m: [m.idf, m.docFreq])(IDF(device="cpu", inputCol="features", **kw).fit(fc)),
    "correlation": lambda kw: [stat.Correlation.corr(f, "features", device="cpu", **kw)["pearson"], stat.Correlation.corr(f, "features", "spearman", device="cpu", **kw)["spearman"]],
    "chisq_test": lambda kw: [stat.ChiSquareTest.test(fi, "features", "label", device="cpu", **kw)["statistics"]],
    "anova_test": lambda kw: [stat.ANOVATest.test(f3, "features", "label", device="cpu", **kw)["statistics"]],
    "fvalue_test": lambda kw: [stat.FValueTest.test(fr, "features", "label", device="cpu", **kw)["statistics"]],
    "summarizer": summ,
}
from sntc_tpu_torch.models import (AFTSurvivalRegression, BisectingKMeans, FMClassifier,
    FMRegressor, GaussianMixture, GeneralizedLinearRegression, IsotonicRegression, LDA,
    LinearRegression, PowerIterationClustering)
eta = X[:, :4] @ np.array([0.2, -0.1, 0.15, 0.05], np.float32) - 0.6
fz = lambda lab: Frame({"features": X, "label": lab})
GLM_LABELS = {"gaussian": yr, "poisson": rng2.poisson(np.exp(eta)).astype(np.float64),
              "gamma": rng2.gamma(2.0, np.exp(eta) / 2.0), "binomial": y,
              "tweedie": rng2.poisson(np.exp(eta)).astype(np.float64)}
GLM_KW = {"gamma": {"link": "log"}, "tweedie": {"variancePower": 1.5}}
fa = Frame({"features": X, "label": np.exp(eta + 0.3 * rng2.normal(size=3000)),
            "censor": (rng2.random(3000) < 0.8).astype(np.float64)})
docs = Frame({"features": rng2.poisson(1.0, size=(500, 40)).astype(np.float32)})
iu, ju = np.triu_indices(80, 1)
keep = rng2.random(len(iu)) < np.where((iu < 40) == (ju < 40), 0.5, 0.01)
graph = Frame({"src": iu[keep], "dst": ju[keep], "weight": np.where((iu[keep] < 40) == (ju[keep] < 40), 1.0, 0.1)})
def coef(m): return [m.coefficients, m.intercept]
def pic(kw):
    p = PowerIterationClustering(device="cpu", k=2, maxIter=30, weightCol="weight", seed=1, **kw)
    return [p.assignClusters(graph)["cluster"], p.fit_stats["embedding"]]
REGRESSION_AND_FAMILIES = {
    "lr_normal": lambda kw: coef(LinearRegression(device="cpu", solver="normal", **kw).fit(fr)),
    "lr_lbfgs": lambda kw: (lambda m: coef(m) + [m.summary.objectiveHistory])(LinearRegression(device="cpu", solver="l-bfgs", regParam=0.1, elasticNetParam=0.5, **kw).fit(fr)),
    **{f"glm_{fam}": (lambda fam, lab: lambda kw: (lambda m: coef(m) + [m.summary.deviance, m.summary.nullDeviance, m.summary.dispersion])(
        GeneralizedLinearRegression(device="cpu", family=fam, **GLM_KW.get(fam, {}), **kw).fit(fz(lab))))(fam, lab)
       for fam, lab in GLM_LABELS.items()},
    "aft": lambda kw: (lambda m: coef(m) + [m.scale, m.summary.objectiveHistory])(AFTSurvivalRegression(device="cpu", **kw).fit(fa)),
    "fm_regressor": lambda kw: (lambda m: [m.factors, m.linear, m.intercept, m.summary.objectiveHistory])(FMRegressor(device="cpu", maxIter=20, stepSize=0.05, **kw).fit(fr)),
    "fm_classifier": lambda kw: (lambda m: [m.factors, m.linear, m.intercept, m.summary.objectiveHistory])(FMClassifier(device="cpu", maxIter=20, stepSize=0.05, **kw).fit(f)),
    "isotonic": lambda kw: (lambda m: [m.boundaries, m.predictions])(IsotonicRegression(device="cpu", **kw).fit(Frame({"features": X[:, 0].astype(np.float64), "label": yr}))),
    "gmm": lambda kw: (lambda m: [m.means, m.covs, m.weights, m.summary.logLikelihood])(GaussianMixture(device="cpu", k=3, seed=1, **kw).fit(f)),
    "bisecting_kmeans": lambda kw: (lambda m: [m._centers, m._left, m.summary.trainingCost])(BisectingKMeans(device="cpu", k=4, seed=1, **kw).fit(f)),
    "lda_online": lambda kw: [LDA(device="cpu", k=4, maxIter=5, subsamplingRate=0.2, **kw).fit(docs).lam],
    "lda_em": lambda kw: [LDA(device="cpu", k=4, maxIter=3, optimizer="em", **kw).fit(docs).lam],
    "pic": pic,
}
differs = []
for name, fn in {**CLASSIFICATION, **REGRESSION_AND_FAMILIES}.items():
    out[name] = h(*fn({}))
    try:
        one = h(*fn({"mesh": default_mesh(1, device="cpu")}))
    except (TypeError, AttributeError):  # this checkout's entry point takes no mesh
        continue
    if one != out[name]:
        differs.append(name)
out["one_shard_differs"] = differs
print(json.dumps(out))
