"""Digests of the single-device fits of every estimator that takes
``mesh=``: each fitted on the CPU without a mesh, from numpy-seeded
inputs, with 4 torch threads, and one SHA-256 prefix a result printed as
one JSON line.  Run it from two checkouts (``PYTHONPATH=<checkout>
python3 scripts/mesh_none_digests.py``) to show that a change leaves the
``mesh=None`` path's results bitwise as they were."""
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
print(json.dumps(out))
