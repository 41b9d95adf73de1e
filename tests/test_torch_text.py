"""The port's ``object_column`` Frame, text stages (Tokenizer,
RegexTokenizer, StopWordsRemover, NGram, HashingTF, CountVectorizer,
IDF) and FeatureHasher against the JAX package's, on the CPU.

Inputs are seeded numpy draws: documents of words from a small
vocabulary (with case, empty documents, unicode and punctuation), and
flow-like numeric, string and boolean columns for FeatureHasher.

Tolerances, each exact where stated:

* ``object_column`` frames (take, filter, slice, concat_all,
  with_column, the Arrow round trip): equal lists, rank 1 kept;
* the tokenizers, NGram, murmur3 and Spark's buckets, HashingTF,
  CountVectorizer (model and transform) and FeatureHasher: equal (host
  string work; whole counts, exact in float32);
* IDF: ``docFreq`` bitwise (integer-valued float32 sums), the idf
  equal (the same float64 formula on the same counts), IDFModel's
  transform bitwise.
"""

import numpy as np
import pyarrow as pa
import pytest
import torch

from sntc_tpu.core.frame import Frame as JFrame
from sntc_tpu.core.frame import object_column as jobject_column
from sntc_tpu.feature import (
    CountVectorizer as JCountVectorizer,
    FeatureHasher as JFeatureHasher,
    HashingTF as JHashingTF,
    IDF as JIDF,
    NGram as JNGram,
    RegexTokenizer as JRegexTokenizer,
    StopWordsRemover as JStopWordsRemover,
    Tokenizer as JTokenizer,
)
from sntc_tpu.feature.text import _spark_bucket as j_bucket
from sntc_tpu.feature.text import murmur3_32 as j_murmur3
from sntc_tpu_torch.core.frame import Frame, object_column, to_host
from sntc_tpu_torch.feature import (
    IDF,
    CountVectorizer,
    FeatureHasher,
    HashingTF,
    NGram,
    RegexTokenizer,
    StopWordsRemover,
    Tokenizer,
)
from sntc_tpu_torch.feature.text import _spark_bucket, doc_freq, murmur3_32
from jax_metrics_guard import own_jax_registry  # noqa: F401

WORDS = ("The", "flow", "SYN", "syn", "from", "host", "a", "to", "scan",
         "benign", "ATTACK", "port", "22", "443", "udp", "is", "an", "of",
         "синтаксис", "長い語", "x-y", "dns.query", "NOT", "and")


def _docs(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    docs = []
    for i in range(n):
        k = int(rng.integers(0, 14)) if i % 9 else 0  # some empty
        words = rng.choice(WORDS, size=k)
        sep = "  " if i % 5 == 0 else " "
        docs.append(sep.join(words) + ("\t" if i % 7 == 0 else ""))
    return np.array(docs, dtype=object)


def _both(docs: np.ndarray):
    return JFrame({"text": docs}), Frame({"text": docs})


def _lists(col) -> list:
    return [list(v) for v in col]


def test_object_column_stays_rank_one_through_frame_ops():
    same = [["a", "b"], ["c", "d"], ["e", "f"]]  # equal lengths
    ragged = [["a"], [], ["b", "c", "d"]]
    for vals in (same, ragged):
        col, jcol = object_column(vals), jobject_column(vals)
        assert col.shape == jcol.shape == (3,)
        assert col.dtype == jcol.dtype == object
        f = Frame({"t": col, "x": np.arange(3.0)})
        jf = JFrame({"t": jcol, "x": np.arange(3.0)})
        for op in (lambda g: g.take(np.array([2, 0])),
                   lambda g: g.filter(np.array([True, False, True])),
                   lambda g: g.slice(1, 3),
                   lambda g: type(g).concat_all([g, g]),
                   lambda g: g.with_column("u", g["t"])):
            got, want = op(f), op(jf)
            assert got["t"].ndim == 1 and got["t"].dtype == object
            assert _lists(got["t"]) == _lists(want["t"])
            assert _lists(got["u"] if "u" in got else got["t"]) == \
                _lists(want["u"] if "u" in want else want["t"])
        back = Frame.from_arrow(f.to_arrow())
        jback = JFrame.from_arrow(jf.to_arrow())
        assert isinstance(f.to_arrow().column("t").type, pa.ListType)
        assert [list(v) for v in back["t"]] == [list(v) for v in jback["t"]]
        assert [list(v) for v in back["t"]] == vals


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tokenizers_stopwords_ngram_equal_jax(seed):
    docs = _docs(60, seed)
    jf, f = _both(docs)
    stages = [
        (Tokenizer(inputCol="text", outputCol="tokens"),
         JTokenizer(inputCol="text", outputCol="tokens")),
        (RegexTokenizer(inputCol="text", outputCol="rx", pattern=r"\W+",
                        minTokenLength=2),
         JRegexTokenizer(inputCol="text", outputCol="rx", pattern=r"\W+",
                         minTokenLength=2)),
        (RegexTokenizer(inputCol="text", outputCol="rx2", pattern=r"[a-z]+",
                        gaps=False, toLowercase=False),
         JRegexTokenizer(inputCol="text", outputCol="rx2",
                         pattern=r"[a-z]+", gaps=False, toLowercase=False)),
        (StopWordsRemover(inputCol="tokens", outputCol="filtered"),
         JStopWordsRemover(inputCol="tokens", outputCol="filtered")),
        (StopWordsRemover(inputCol="rx2", outputCol="cs",
                          stopWords=("syn", "a", "NOT"), caseSensitive=True),
         JStopWordsRemover(inputCol="rx2", outputCol="cs",
                           stopWords=("syn", "a", "NOT"),
                           caseSensitive=True)),
        (NGram(inputCol="filtered", outputCol="bigrams"),
         JNGram(inputCol="filtered", outputCol="bigrams")),
        (NGram(inputCol="tokens", outputCol="trigrams", n=3),
         JNGram(inputCol="tokens", outputCol="trigrams", n=3)),
    ]
    for port, jax_stage in stages:
        f, jf = port.transform(f), jax_stage.transform(jf)
        col = port.getOutputCol()
        assert f[col].ndim == 1 and f[col].dtype == object
        assert _lists(f[col]) == _lists(jf[col]), col


def test_murmur3_and_spark_buckets_equal_jax():
    rng = np.random.default_rng(5)
    terms = list(WORDS) + ["", "x" * 257] + [
        "".join(rng.choice(list("abcXYZ019 ?é語"), size=int(k)))
        for k in rng.integers(0, 40, size=300)]
    for t in terms:
        b = t.encode("utf-8")
        for seed in (0, 42, 2**31 + 5):
            assert murmur3_32(b, seed) == j_murmur3(b, seed)
        for width in (1, 7, 64, 4096, 1 << 18):
            assert _spark_bucket(t, width) == j_bucket(t, width)


@pytest.mark.parametrize("width,binary", [(16, False), (64, True),
                                          (4096, False)])
def test_hashing_tf_equal_jax(width, binary):
    jf, f = _both(_docs(80, 3))
    f = Tokenizer(inputCol="text", outputCol="tokens").transform(f)
    jf = JTokenizer(inputCol="text", outputCol="tokens").transform(jf)
    f = NGram(inputCol="tokens", outputCol="ngrams").transform(f)
    jf = JNGram(inputCol="tokens", outputCol="ngrams").transform(jf)
    for col in ("tokens", "ngrams"):
        got = HashingTF(inputCol=col, outputCol="tf", numFeatures=width,
                        binary=binary).transform(f)["tf"]
        want = JHashingTF(inputCol=col, outputCol="tf", numFeatures=width,
                          binary=binary).transform(jf)["tf"]
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    assert HashingTF(numFeatures=width).indexOf("flow") == \
        JHashingTF(numFeatures=width).indexOf("flow")
    with pytest.raises(ValueError, match="dense output"):
        HashingTF(inputCol="tokens", numFeatures=1 << 30).transform(f)


@pytest.mark.parametrize("params", [
    {},
    {"minDF": 2.0, "vocabSize": 10},
    {"minDF": 0.05, "maxDF": 0.5, "minTF": 2.0},
    {"minTF": 0.2, "binary": True},
    {"maxDF": 3.0},
])
def test_count_vectorizer_equal_jax(params):
    jf, f = _both(_docs(90, 4))
    f = Tokenizer(inputCol="text", outputCol="tokens").transform(f)
    jf = JTokenizer(inputCol="text", outputCol="tokens").transform(jf)
    m = CountVectorizer(inputCol="tokens", outputCol="cv", **params).fit(f)
    jm = JCountVectorizer(inputCol="tokens", outputCol="cv",
                          **params).fit(jf)
    assert m.vocabulary == jm.vocabulary
    got, want = m.transform(f)["cv"], jm.transform(jf)["cv"]
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert m.paramValues() == jm.paramValues()


def test_count_vectorizer_refuses_max_below_min():
    f = Tokenizer(inputCol="text", outputCol="tokens").transform(
        Frame({"text": _docs(10, 0)}))
    with pytest.raises(ValueError, match="maxDF"):
        CountVectorizer(inputCol="tokens", minDF=5.0, maxDF=2.0).fit(f)


@pytest.mark.parametrize("min_doc_freq", [0, 3])
def test_idf_doc_freq_bitwise_and_idf_equal(mesh8, min_doc_freq):
    jf, f = _both(_docs(120, 6))
    f = Tokenizer(inputCol="text", outputCol="tokens").transform(f)
    jf = JTokenizer(inputCol="text", outputCol="tokens").transform(jf)
    f = HashingTF(inputCol="tokens", outputCol="tf",
                  numFeatures=128).transform(f)
    jf = JHashingTF(inputCol="tokens", outputCol="tf",
                    numFeatures=128).transform(jf)
    m = IDF(device="cpu", inputCol="tf", outputCol="idf",
            minDocFreq=min_doc_freq).fit(f)
    jm = JIDF(mesh=mesh8, inputCol="tf", outputCol="idf",
              minDocFreq=min_doc_freq).fit(jf)
    np.testing.assert_array_equal(m.docFreq, jm.docFreq)
    np.testing.assert_array_equal(m.idf, jm.idf)
    assert m.numDocs == jm.numDocs == 120
    np.testing.assert_array_equal(m.transform(f)["idf"],
                                  jm.transform(jf)["idf"])
    # a tensor column fits the same
    t = IDF(device="cpu", inputCol="tf", minDocFreq=min_doc_freq).fit(
        f.with_column("tf", torch.from_numpy(f["tf"])))
    np.testing.assert_array_equal(t.docFreq, jm.docFreq)


def test_doc_freq_weights_rows():
    x = torch.tensor([[0.0, 2.0, 1.0], [3.0, 0.0, 0.5], [0.0, 0.0, -1.0]])
    w = torch.tensor([1.0, 2.0, 4.0])
    assert doc_freq(x, w).tolist() == [2.0, 1.0, 3.0]


def _hasher_frames():
    rng = np.random.default_rng(9)
    n = 50
    cols = {
        "Destination Port": rng.integers(0, 65536, size=n).astype(np.int64),
        "Flow Duration": rng.exponential(1e5, size=n),
        "Protocol": rng.choice(np.array(["tcp", "udp", "icmp"], object),
                               size=n),
        "syn": rng.random(n) < 0.4,
        "Bytes": rng.normal(size=n).astype(np.float32),
    }
    return JFrame(dict(cols)), Frame(dict(cols))


@pytest.mark.parametrize("width,forced", [(32, ()), (4096, ()),
                                          (64, ("Destination Port",))])
def test_feature_hasher_equal_jax(width, forced):
    jf, f = _hasher_frames()
    cols = list(f.columns)
    got = FeatureHasher(inputCols=cols, outputCol="h", numFeatures=width,
                        categoricalCols=forced).transform(f)["h"]
    want = JFeatureHasher(inputCols=cols, outputCol="h", numFeatures=width,
                          categoricalCols=forced).transform(jf)["h"]
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    # a tensor column hashes as its host values do
    t = f.with_column("Bytes", torch.from_numpy(to_host(f["Bytes"])))
    np.testing.assert_array_equal(
        FeatureHasher(inputCols=cols, outputCol="h", numFeatures=width,
                      categoricalCols=forced).transform(t)["h"], want)
    with pytest.raises(ValueError, match="inputCols"):
        FeatureHasher().transform(f)
