"""The port's FPGrowth, RFormula, SQLTransformer, RankingEvaluator and
MultilabelClassificationEvaluator against the JAX package's, on the CPU;
every fitted model of this slice saved by the JAX package and loaded by
the port's ``load_model``; and the names and ``get*`` defaults of the
two packages' ``feature``, ``models`` and ``evaluation``.

Inputs are seeded numpy draws: baskets of items from a skewed
vocabulary (strings and integers), flow-like frames with string and
numeric columns, ranked id lists and label sets.

Tolerances: FPGrowth's itemsets, rules (confidence, lift, support) and
predictions, RFormula's features and labels, SQLTransformer's columns,
both evaluators' values: equal (the same host arithmetic); a loaded
JAX model's transform: equal (host numpy, or for the LSH models the
hashes away from bucket edges, as ``test_torch_lsh_w2v.py`` holds them;
none lies on an edge here).
"""

import inspect

import numpy as np
import pytest
import torch

import sntc_tpu.evaluation as jevaluation
import sntc_tpu.feature as jfeature
import sntc_tpu.models as jmodels
from sntc_tpu.core.frame import Frame as JFrame
from sntc_tpu.core.frame import object_column as jobject_column
from sntc_tpu.mlio import save_model as jax_save_model
import sntc_tpu_torch.evaluation as evaluation
import sntc_tpu_torch.feature as feature
import sntc_tpu_torch.models as models
from sntc_tpu_torch.core.frame import Frame, object_column
from sntc_tpu_torch.mlio import load_model
from jax_metrics_guard import own_jax_registry  # noqa: F401

#: JAX names with no counterpart in the port, never to be ported
NEVER_PORTED: set = set()
#: the classes of this slice, whose defaults are compared
SLICE_CLASSES = (
    "Tokenizer", "RegexTokenizer", "StopWordsRemover", "NGram", "HashingTF",
    "CountVectorizer", "IDF", "FeatureHasher", "Word2Vec", "RFormula",
    "SQLTransformer", "BucketedRandomProjectionLSH", "MinHashLSH",
    "FPGrowth", "RankingEvaluator", "MultilabelClassificationEvaluator",
)


def _baskets(n: int, seed: int, ints: bool = False) -> list:
    rng = np.random.default_rng(seed)
    items = [i if ints else f"i{i}" for i in range(12)]
    p = 1.0 / np.arange(1, 13) ** 0.7
    p /= p.sum()
    out = []
    for _ in range(n):
        k = int(rng.integers(1, 7))
        pick = rng.choice(12, size=k, replace=False, p=p)
        out.append([items[int(j)] for j in pick])
    return out


def _fp_pair(baskets, **params):
    m = models.FPGrowth(itemsCol="items", **params).fit(
        Frame({"items": object_column(baskets)}))
    jm = jmodels.FPGrowth(itemsCol="items", **params).fit(
        JFrame({"items": jobject_column(baskets)}))
    return m, jm


def _frames_equal(got, want, cols=None):
    for c in cols or want.columns:
        g, w = got[c], want[c]
        if w.dtype == object:
            assert [list(x) if isinstance(x, (list, np.ndarray)) else x
                    for x in g] == \
                [list(x) if isinstance(x, (list, np.ndarray)) else x
                 for x in w], c
        else:
            assert g.dtype == w.dtype, c
            np.testing.assert_array_equal(g, w, err_msg=c)


@pytest.mark.parametrize("ints", [False, True])
@pytest.mark.parametrize("support,confidence", [(0.1, 0.5), (0.3, 0.8),
                                                (0.05, 0.2)])
def test_fpgrowth_equal_jax(support, confidence, ints):
    baskets = _baskets(200, 3, ints)
    m, jm = _fp_pair(baskets, minSupport=support, minConfidence=confidence)
    assert m._itemsets == jm._itemsets
    _frames_equal(m.freqItemsets, jm.freqItemsets)
    _frames_equal(m.associationRules, jm.associationRules)
    probe = _baskets(40, 4, ints)
    _frames_equal(m.transform(Frame({"items": object_column(probe)})),
                  jm.transform(JFrame({"items": jobject_column(probe)})),
                  ["prediction"])
    m.setMinConfidence(0.9)
    jm.setMinConfidence(0.9)
    _frames_equal(m.associationRules, jm.associationRules)


def test_fpgrowth_refuses_duplicate_items():
    with pytest.raises(ValueError, match="duplicate"):
        models.FPGrowth().fit(Frame({"items": object_column([["a", "a"]])}))


def _rf_frames(n: int, seed: int):
    rng = np.random.default_rng(seed)
    cols = {
        "y": rng.normal(size=n),
        "label_s": rng.choice(np.array(["attack", "benign"], object), size=n,
                              p=[0.3, 0.7]),
        "proto": rng.choice(np.array(["tcp", "udp", "icmp"], object),
                            size=n, p=[0.5, 0.3, 0.2]),
        "flag": rng.choice(np.array(["S", "A", "F", "R"], object), size=n),
        "dur": rng.exponential(5.0, size=n),
        "pkts": rng.integers(1, 100, size=n).astype(np.int64),
    }
    return Frame(dict(cols)), JFrame(dict(cols))


@pytest.mark.parametrize("formula", [
    "y ~ .",
    "y ~ . - label_s - flag",
    "label_s ~ proto + dur + proto:dur",
    "label_s ~ proto:flag + pkts",
    "y ~ dur + dur + pkts:dur",
    "missing ~ proto + dur",
])
def test_rformula_equal_jax(formula):
    f, jf = _rf_frames(120, 5)
    m = feature.RFormula(formula=formula).fit(f)
    jm = jfeature.RFormula(formula=formula).fit(jf)
    assert (m.label, m.terms, m.encodings, m.labelLevels) == \
        (jm.label, jm.terms, jm.encodings, jm.labelLevels)
    got, want = m.transform(f), jm.transform(jf)
    _frames_equal(got, want, [c for c in ("features", "label")
                              if c in want])
    assert ("label" in got) == ("label" in want)


@pytest.mark.parametrize("formula,match", [
    ("y ~ nope", "unknown column"), ("y + x", "~"), ("y ~ dur - 1", "- 1"),
    ("y ~ dur - pkts", "not among"), ("y ~ . - dur - pkts - proto - "
                                      "flag - label_s", "no feature"),
])
def test_rformula_refuses_like_jax(formula, match):
    f, jf = _rf_frames(10, 1)
    for cls, frame in ((feature.RFormula, f), (jfeature.RFormula, jf)):
        with pytest.raises(ValueError, match=match):
            cls(formula=formula).fit(frame)


STATEMENTS = [
    "SELECT *, (v1 + v2) AS v3, (v1 * v2) AS v4 FROM __THIS__ WHERE v1 > 2",
    "SELECT v2, (v1 > 2) AS big FROM __THIS__",
    "SELECT v1, 1 AS one FROM __THIS__ WHERE v1 = 3 OR (NOT v2 <> 30 AND "
    "v1 > 4)",
    "SELECT x, (`Destination Port` + 1) AS dp FROM __THIS__ WHERE "
    "`Destination Port` > 0",
    "SELECT `Destination Port` FROM __THIS__",
    "SELECT `Fwd AND Bwd` FROM __THIS__ WHERE name = 'a=b'",
    "SELECT (name == 'a,b') AS m, x FROM __THIS__",
    "SELECT x FROM __THIS__ WHERE name = 'it''s'",
    "SELECT limit, (limit * 2) AS d FROM __THIS__;",
]


def _sql_frames():
    rng = np.random.default_rng(2)
    n = 30
    cols = {
        "v1": rng.integers(0, 7, size=n).astype(np.float64),
        "v2": rng.choice([10.0, 20.0, 30.0], size=n),
        "vec": rng.normal(size=(n, 3)).astype(np.float32),
        "Destination Port": rng.choice([0.0, 80.0, 443.0], size=n),
        "x": rng.normal(size=n),
        "name": rng.choice(np.array(["a=b", "a,b", "it's", "z"], object),
                           size=n),
        "Fwd AND Bwd": rng.normal(size=n),
        "limit": rng.normal(size=n),
    }
    return Frame(dict(cols)), JFrame(dict(cols))


@pytest.mark.parametrize("statement", STATEMENTS)
def test_sql_transformer_equal_jax(statement):
    f, jf = _sql_frames()
    got = feature.SQLTransformer(statement=statement).transform(f)
    want = jfeature.SQLTransformer(statement=statement).transform(jf)
    assert got.columns == want.columns and got.num_rows == want.num_rows
    _frames_equal(got, want)


@pytest.mark.parametrize("bad", [
    "SELECT * FROM other", "SELECT a FROM __THIS__ JOIN b",
    "SELECT v1 + v2 FROM __THIS__", "SELECT nope FROM __THIS__",
    "SELECT COUNT(v1) AS c FROM __THIS__",
])
def test_sql_transformer_refuses_like_jax(bad):
    f, jf = _sql_frames()
    for cls, frame in ((feature.SQLTransformer, f),
                       (jfeature.SQLTransformer, jf)):
        with pytest.raises(ValueError):
            cls(statement=bad).transform(frame)


def _ranking_frames(seed: int):
    rng = np.random.default_rng(seed)
    preds, labels = [], []
    for i in range(60):
        preds.append(list(rng.permutation(30)[:int(rng.integers(0, 15))]))
        labels.append(list(rng.choice(30, size=int(rng.integers(0, 8)),
                                      replace=False)))
    preds[3], labels[4] = [], []
    return (Frame({"prediction": object_column(preds),
                   "label": object_column(labels)}),
            JFrame({"prediction": jobject_column(preds),
                    "label": jobject_column(labels)}))


@pytest.mark.parametrize("metric", evaluation.RankingEvaluator._METRICS)
@pytest.mark.parametrize("k", [1, 5, 20])
def test_ranking_evaluator_equal_jax(metric, k):
    f, jf = _ranking_frames(3)
    got = evaluation.RankingEvaluator(metricName=metric, k=k).evaluate(f)
    want = jevaluation.RankingEvaluator(metricName=metric,
                                        k=k).evaluate(jf)
    assert got == want


@pytest.mark.parametrize(
    "metric", evaluation.MultilabelClassificationEvaluator._METRICS)
@pytest.mark.parametrize("both_empty", [False, True])
def test_multilabel_evaluator_equal_jax(metric, both_empty):
    f, jf = _ranking_frames(8)
    if both_empty:
        p = list(f["prediction"])
        p[4] = []
        f = f.with_column("prediction", object_column(p))
        jf = jf.with_column("prediction", jobject_column(p))
    ev = evaluation.MultilabelClassificationEvaluator(metricName=metric)
    jev = jevaluation.MultilabelClassificationEvaluator(metricName=metric)
    got, want = ev.evaluate(f), jev.evaluate(jf)
    assert got == want or (np.isnan(got) and np.isnan(want))
    assert ev.isLargerBetter() == jev.isLargerBetter()


def _corpus():
    rng = np.random.default_rng(12)
    words = [f"w{i}" for i in range(25)]
    return [list(rng.choice(words, size=int(rng.integers(2, 15))))
            for _ in range(120)]


def test_jax_saved_models_load_and_transform_equally(tmp_path):
    docs = _corpus()
    jdocs = JFrame({"tokens": jobject_column(docs)})
    pdocs = Frame({"tokens": object_column(docs)})
    rng = np.random.default_rng(0)
    X = rng.normal(size=(300, 6)).astype(np.float32)
    B = (rng.random((300, 20)) < 0.3).astype(np.float32)
    B[np.arange(300), rng.integers(0, 20, size=300)] = 1.0
    rf, jrf = _rf_frames(80, 9)
    cv = jfeature.CountVectorizer(inputCol="tokens", outputCol="cv",
                                  minDF=2.0).fit(jdocs)
    tf = jfeature.HashingTF(inputCol="tokens", outputCol="tf",
                            numFeatures=64).transform(jdocs)
    cases = {
        "cv": (cv, jdocs, pdocs),
        "idf": (jfeature.IDF(inputCol="tf", outputCol="idf",
                             minDocFreq=2).fit(tf), tf,
                Frame({"tf": tf["tf"]})),
        "w2v": (jfeature.Word2Vec(inputCol="tokens", vectorSize=8,
                                  minCount=2, seed=1).fit(jdocs), jdocs,
                pdocs),
        "fpm": (jmodels.FPGrowth(itemsCol="tokens", minSupport=0.1,
                                 minConfidence=0.3).fit(
            JFrame({"tokens": jobject_column(
                [sorted(set(d)) for d in docs])})),
            JFrame({"tokens": jobject_column([sorted(set(d))
                                              for d in docs])}),
            Frame({"tokens": object_column([sorted(set(d))
                                            for d in docs])})),
        "rformula": (jfeature.RFormula(
            formula="label_s ~ proto + dur + proto:flag").fit(jrf), jrf, rf),
        "brp": (jfeature.BucketedRandomProjectionLSH(
            inputCol="x", numHashTables=3, bucketLength=2.0, seed=4).fit(
            JFrame({"x": X})), JFrame({"x": X}), Frame({"x": X})),
        "minhash": (jfeature.MinHashLSH(inputCol="b", numHashTables=4,
                                        seed=2).fit(JFrame({"b": B})),
                    JFrame({"b": B}), Frame({"b": B})),
    }
    for name, (jm, jframe, pframe) in cases.items():
        path = str(tmp_path / name)
        jax_save_model(jm, path)
        m = load_model(path, device="cpu")
        assert type(m).__name__ == type(jm).__name__, name
        assert m.paramValues() == jm.paramValues(), name
        got, want = m.transform(pframe), jm.transform(jframe)
        new = [c for c in want.columns if c not in jframe.columns]
        assert new, name
        _frames_equal(got, want, new)
    w2v = load_model(str(tmp_path / "w2v"), device="cpu")
    _frames_equal(w2v.findSynonyms("w3", 4),
                  cases["w2v"][0].findSynonyms("w3", 4))
    fpm = load_model(str(tmp_path / "fpm"), device="cpu")
    _frames_equal(fpm.associationRules, cases["fpm"][0].associationRules)
    brp = load_model(str(tmp_path / "brp"), device="cpu")
    assert brp.device == torch.device("cpu")
    _frames_equal(
        brp.approxSimilarityJoin(Frame({"x": X[:100]}),
                                 Frame({"x": X[100:]}), 1.0),
        cases["brp"][0].approxSimilarityJoin(JFrame({"x": X[:100]}),
                                             JFrame({"x": X[100:]}), 1.0),
        ["idA", "idB"])


def test_every_jax_name_has_a_port_counterpart():
    for jmod, pmod in ((jfeature, feature), (jmodels, models),
                       (jevaluation, evaluation)):
        missing = set(jmod.__all__) - set(pmod.__all__) - NEVER_PORTED
        assert not missing, (jmod.__name__, sorted(missing))
        for name in jmod.__all__:
            if name not in NEVER_PORTED:
                assert hasattr(pmod, name), name


@pytest.mark.parametrize("name", SLICE_CLASSES)
def test_slice_classes_defaults_equal_jax(name):
    jcls = next(getattr(m, name) for m in (jfeature, jmodels, jevaluation)
                if hasattr(m, name))
    pcls = next(getattr(m, name) for m in (feature, models, evaluation)
                if hasattr(m, name))
    kw = {"device": "cpu"} if "device" in inspect.signature(
        pcls).parameters else {}
    port, ref = pcls(**kw), jcls()
    assert sorted(pcls.params()) == sorted(jcls.params())
    for p in jcls.params():
        getter = "get" + p[0].upper() + p[1:]
        assert getattr(port, getter)() == getattr(ref, getter)(), (name, p)
