"""The port's LSH models (BucketedRandomProjectionLSH, MinHashLSH) and
Word2Vec against the JAX package's, on the CPU.

Inputs are seeded numpy draws: Gaussian rows of several scales for BRP,
0/1 rows (every row with at least one 1) for MinHash, and documents of
Zipf-drawn words for Word2Vec.

Tolerances, each with what it measured here when set:

* the fits' draws (BRP's unit vectors, MinHash's coefficients): equal;
* BRP hashes: equal wherever the pre-floor value lies more than 1e-4
  from an integer (two libraries' float32 products round apart there:
  1 cell of 2 000 in these inputs), and within one bucket there;
* MinHash hashes: bitwise (int32 minima);
* ``approxNearestNeighbors`` and ``approxSimilarityJoin``: the same rows
  and pairs in the same order, distances within 1e-6 relative (float32
  sums in two libraries; 6e-8 measured);
* Word2Vec: the vocabulary, the shuffled pairs, the unigram table and
  ``w_in0`` bitwise; fed the uniforms of the JAX fit's own key chain
  (``split`` a step, then ``uniform(k_neg, (B, 5))``), the negatives
  equal and the vectors within 2e-6 of the JAX fit's (the hand-written
  gradient against autodiff's, float32: 1.5e-7 measured over 80 steps
  with vectors up to 0.89, 0 over 22 small steps), and the port's move
  from ``w_in0`` within 1e-5 of the JAX fit's, relative to its largest
  move (MOVE measured here);
* every JAX-saved model of this slice loads with the port's
  ``load_model`` and transforms equally (``test_torch_longtail.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sntc_tpu.feature.word2vec as jw2v
from sntc_tpu.core.frame import Frame as JFrame
from sntc_tpu.core.frame import object_column as jobject_column
from sntc_tpu.feature import (
    BucketedRandomProjectionLSH as JBRP,
    MinHashLSH as JMinHash,
    Word2Vec as JWord2Vec,
)
from sntc_tpu_torch.core.frame import Frame, object_column
from sntc_tpu_torch.feature import (
    BucketedRandomProjectionLSH,
    MinHashLSH,
    Word2Vec,
)
import sntc_tpu_torch.feature.word2vec as port_w2v
from sntc_tpu_torch.feature.word2vec import (
    NEG,
    UNIFORM_CHUNK,
    skipgram_inputs,
    train_epochs,
)

W2V_TOL = 2e-6
W2V_MOVE_RTOL = 1e-5


def _dense(n: int, f: int, seed: int, scale: float) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, f)) * scale).astype(np.float32)


def _binary(n: int, f: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    X = (rng.random((n, f)) < 0.3).astype(np.float32)
    X[np.arange(n), rng.integers(0, f, size=n)] = 1.0
    return X


def _brp_pair(X, **kw):
    port = BucketedRandomProjectionLSH(device="cpu", inputCol="features",
                                       **kw).fit(Frame({"features": X}))
    jax_model = JBRP(inputCol="features", **kw).fit(JFrame({"features": X}))
    return port, jax_model


def _edges(X, R, bucket):
    v = X.astype(np.float64) @ R.astype(np.float64).T / bucket
    return np.abs(v - np.rint(v)) < 1e-4


@pytest.mark.parametrize("n,f,scale,bucket,tables", [
    (500, 8, 1.0, 2.0, 4), (300, 78, 3.0, 4.0, 3), (200, 1, 10.0, 0.5, 2),
])
def test_brp_hashes_equal_jax_away_from_edges(n, f, scale, bucket, tables):
    X = _dense(n, f, 11, scale)
    X = X[:, 0] if f == 1 else X
    m, jm = _brp_pair(X, numHashTables=tables, bucketLength=bucket, seed=5)
    np.testing.assert_array_equal(m.randUnitVectors, jm.randUnitVectors)
    got = m.transform(Frame({"features": X}))["hashes"]
    want = jm.transform(JFrame({"features": X}))["hashes"]
    assert got.dtype == want.dtype == np.float32
    X2 = X[:, None] if X.ndim == 1 else X
    far = ~_edges(X2, m.randUnitVectors, bucket)
    np.testing.assert_array_equal(got[far], want[far])
    # the edge cells are few, and a floor there moves by one bucket at most
    assert (~far).mean() <= 1e-3
    assert np.abs(got - want).max() <= 1.0


def _rel(a, b):
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30))) \
        if len(b) else 0.0


@pytest.mark.parametrize("bucket", [1.0, 3.0])
def test_brp_ann_and_join_equal_jax(bucket):
    X = _dense(400, 6, 3, 1.0)
    Y = _dense(300, 6, 4, 1.0)
    m, jm = _brp_pair(X, numHashTables=3, bucketLength=bucket, seed=1)
    f, jf = Frame({"features": X}), JFrame({"features": X})
    g, jg = Frame({"features": Y}), JFrame({"features": Y})
    for key in (X[7], Y[0], np.zeros(6, np.float32)):
        got = m.approxNearestNeighbors(f, key, 10)
        want = jm.approxNearestNeighbors(jf, key, 10)
        np.testing.assert_array_equal(got["features"], want["features"])
        assert _rel(got["distCol"], want["distCol"]) <= 1e-6
    for thr in (0.8, 1.5):
        got = m.approxSimilarityJoin(f, g, thr)
        want = jm.approxSimilarityJoin(jf, jg, thr)
        assert len(want["idA"]) > 0
        np.testing.assert_array_equal(got["idA"], want["idA"])
        np.testing.assert_array_equal(got["idB"], want["idB"])
        assert _rel(got["distCol"], want["distCol"]) <= 1e-6
    assert m.approxNearestNeighbors(
        f, np.full(6, 1e6, np.float32), 3).num_rows == \
        jm.approxNearestNeighbors(jf, np.full(6, 1e6, np.float32), 3).num_rows


def test_brp_join_exact_under_one_bucket_with_large_rows():
    # one huge bucket: every pair is a candidate, the prefilter's slack
    # (scaled by the rows' magnitude) must keep every true pair
    X = _dense(150, 10, 8, 200.0)
    Y = X[:120] + _dense(120, 10, 9, 0.01)
    m, jm = _brp_pair(X, numHashTables=1, bucketLength=1e9, seed=2)
    got = m.approxSimilarityJoin(Frame({"features": X}),
                                 Frame({"features": Y}), 0.5)
    want = jm.approxSimilarityJoin(JFrame({"features": X}),
                                   JFrame({"features": Y}), 0.5)
    np.testing.assert_array_equal(got["idA"], want["idA"])
    np.testing.assert_array_equal(got["idB"], want["idB"])
    assert len(got["idA"]) >= 120
    assert _rel(got["distCol"], want["distCol"]) <= 1e-6


@pytest.mark.parametrize("tables", [1, 5])
def test_minhash_bitwise_and_queries_equal_jax(tables):
    X = _binary(300, 40, 2)
    Y = _binary(200, 40, 3)
    m = MinHashLSH(device="cpu", numHashTables=tables, seed=4,
                   inputCol="features").fit(Frame({"features": X}))
    jm = JMinHash(numHashTables=tables, seed=4,
                  inputCol="features").fit(JFrame({"features": X}))
    np.testing.assert_array_equal(m.randCoefficients, jm.randCoefficients)
    got = m.transform(Frame({"features": X}))["hashes"]
    want = jm.transform(JFrame({"features": X}))["hashes"]
    assert got.dtype == want.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    f, jf = Frame({"features": X}), JFrame({"features": X})
    g, jg = Frame({"features": Y}), JFrame({"features": Y})
    got = m.approxNearestNeighbors(f, Y[0], 7)
    want = jm.approxNearestNeighbors(jf, Y[0], 7)
    np.testing.assert_array_equal(got["features"], want["features"])
    np.testing.assert_array_equal(got["distCol"], want["distCol"])
    got = m.approxSimilarityJoin(f, g, 0.6)
    want = jm.approxSimilarityJoin(jf, jg, 0.6)
    for col in ("idA", "idB", "distCol"):
        np.testing.assert_array_equal(got[col], want[col])
    with pytest.raises(ValueError, match="binary"):
        m.transform(Frame({"features": X * 2}))
    with pytest.raises(ValueError, match="nonzero"):
        m.transform(Frame({"features": np.zeros((2, 40), np.float32)}))


def _corpus(n_docs: int, seed: int) -> list:
    rng = np.random.default_rng(seed)
    vocab = [f"w{i}" for i in range(40)]
    p = 1.0 / np.arange(1, 41)
    p /= p.sum()
    return [list(rng.choice(vocab, size=int(rng.integers(3, 25)), p=p))
            for _ in range(n_docs)]


def _jax_fit_capture(monkeypatch, docs, **params):
    """The JAX fit and the arguments it handed its training scan."""
    seen = {}
    real = jw2v._train_epochs

    def spy(pairs, probs_cum, w_in0, w_out0, key, lr0, *, batch, n_steps):
        seen.update(pairs=np.asarray(pairs), probs_cum=np.asarray(probs_cum),
                    w_in0=np.asarray(w_in0), key=key, lr0=lr0, batch=batch,
                    n_steps=n_steps)
        return real(pairs, probs_cum, w_in0, w_out0, key, lr0, batch=batch,
                    n_steps=n_steps)

    monkeypatch.setattr(jw2v, "_train_epochs", spy)
    model = JWord2Vec(inputCol="tokens", **params).fit(
        JFrame({"tokens": jobject_column(docs)}))
    return model, seen


def _jax_uniforms(key, batch: int, n_steps: int) -> np.ndarray:
    """The JAX scan's uniforms: its key split once a step, the negatives'
    half drawn as ``uniform(k_neg, (batch, 5))``."""
    out = np.empty((n_steps, batch, NEG), np.float32)
    k = key
    for t in range(n_steps):
        k, k_neg = jax.random.split(k)
        out[t] = np.asarray(jax.random.uniform(k_neg, (batch, NEG)))
    return out


@pytest.mark.parametrize("params", [
    {"vectorSize": 16, "windowSize": 2, "minCount": 2, "maxIter": 8,
     "stepSize": 1.0, "seed": 3},
    {"vectorSize": 8, "windowSize": 5, "minCount": 5, "maxIter": 1,
     "seed": 0},
])
def test_word2vec_equal_jax_on_its_uniforms(monkeypatch, params):
    docs = _corpus(220, 7)
    jm, seen = _jax_fit_capture(monkeypatch, docs, **params)
    inp = skipgram_inputs(docs, params["minCount"], params["windowSize"],
                          params["vectorSize"], params["seed"])
    assert inp["vocab"] == jm.vocabulary
    np.testing.assert_array_equal(inp["pairs"], seen["pairs"])
    np.testing.assert_array_equal(inp["probs_cum"], seen["probs_cum"])
    np.testing.assert_array_equal(inp["w_in0"], seen["w_in0"])
    batch, n_steps = seen["batch"], seen["n_steps"]
    uniforms = _jax_uniforms(seen["key"], batch, n_steps)
    # the negatives the JAX step searches for equal the port's
    np.testing.assert_array_equal(
        torch.searchsorted(torch.from_numpy(inp["probs_cum"]),
                           torch.from_numpy(uniforms[0])).numpy(),
        np.asarray(jnp.searchsorted(jnp.asarray(inp["probs_cum"]),
                                    jnp.asarray(uniforms[0]))))
    # uniform chunks that end inside the run
    monkeypatch.setattr(port_w2v, "UNIFORM_CHUNK", 7)
    w_in, _ = train_epochs(
        torch.from_numpy(inp["pairs"].astype(np.int64)),
        torch.from_numpy(inp["probs_cum"]), torch.from_numpy(inp["w_in0"]),
        torch.zeros(inp["w_in0"].shape), float(seen["lr0"]), batch=batch,
        n_steps=n_steps, uniforms=uniforms)
    monkeypatch.setattr(port_w2v, "UNIFORM_CHUNK", UNIFORM_CHUNK)
    gap = float(np.abs(w_in.numpy() - jm.vectors).max())
    w0 = inp["w_in0"].astype(np.float64)
    move = float(np.abs(jm.vectors - w0).max())
    move_gap = float(np.abs((w_in.numpy() - w0) - (jm.vectors - w0)).max()
                     / move)
    print(f"word2vec gap {gap:.3g} over {n_steps} steps, vectors up to "
          f"{np.abs(jm.vectors).max():.3g}; moves {move:.3g}, "
          f"{move_gap:.3g} apart")
    assert gap <= W2V_TOL, gap
    assert move_gap <= W2V_MOVE_RTOL, move_gap
    # the estimator fed the same uniforms fits the same vectors
    est = Word2Vec(device="cpu", inputCol="tokens", uniforms=uniforms,
                   **params)
    port = est.fit(Frame({"tokens": object_column(docs)}))
    np.testing.assert_array_equal(port.vectors, w_in.numpy())
    assert est.fit_stats["steps"] == n_steps
    assert port.vocabulary == jm.vocabulary


def test_word2vec_model_surface_equal_jax(monkeypatch):
    docs = _corpus(150, 2)
    params = {"vectorSize": 12, "windowSize": 3, "minCount": 3, "seed": 1}
    jm, _ = _jax_fit_capture(monkeypatch, docs, **params)
    from sntc_tpu_torch.feature.word2vec import Word2VecModel

    m = Word2VecModel(vocabulary=jm.vocabulary, vectors=jm.vectors)
    m.setParams(**jm.paramValues())
    vec, jvec = m.getVectors(), jm.getVectors()
    assert list(vec["word"]) == list(jvec["word"])
    np.testing.assert_array_equal(vec["vector"], jvec["vector"])
    for w in ("w0", "w5"):
        got, want = m.findSynonyms(w, 5), jm.findSynonyms(w, 5)
        assert list(got["word"]) == list(want["word"])
        np.testing.assert_array_equal(got["similarity"], want["similarity"])
    docs2 = docs[:20] + [[], ["unseen"]]
    np.testing.assert_array_equal(
        m.transform(Frame({"tokens": object_column(docs2)}))["wordVectors"],
        jm.transform(JFrame({"tokens": jobject_column(docs2)}))[
            "wordVectors"])
    with pytest.raises(KeyError):
        m.findSynonyms("unseen", 2)


def test_word2vec_default_uniforms_are_numpy_draws_of_the_seed():
    docs = _corpus(80, 4)
    f = Frame({"tokens": object_column(docs)})
    a = Word2Vec(device="cpu", inputCol="tokens", vectorSize=6,
                 minCount=2, seed=9).fit(f)
    b = Word2Vec(device="cpu", inputCol="tokens", vectorSize=6,
                 minCount=2, seed=9).fit(f)
    np.testing.assert_array_equal(a.vectors, b.vectors)
    with pytest.raises(ValueError, match="empty vocabulary"):
        Word2Vec(device="cpu", inputCol="tokens", minCount=10**6).fit(f)
