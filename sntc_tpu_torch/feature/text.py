"""Text pipeline stages: Tokenizer / RegexTokenizer / StopWordsRemover /
NGram / HashingTF / CountVectorizer / IDF.

Counterpart of ``sntc_tpu/feature/text.py`` (Spark's stages of the same
names):

  * Tokenizer: lowercase, then split on whitespace.
  * RegexTokenizer: ``pattern`` as splitter (``gaps=True``) or token
    matcher (``gaps=False``); ``minTokenLength``; ``toLowercase``.
  * StopWordsRemover: drop a stop-word list (default English), case
    sensitive or not.
  * NGram: sliding windows of ``n`` tokens joined by single spaces.
  * HashingTF: term-frequency vectors by murmur3_32 (seed 42) of the
    term's UTF-8 bytes, ``nonNegativeMod`` into ``numFeatures``: Spark's
    buckets at any width (default 4096: the vectors are dense);
    optional ``binary``.
  * CountVectorizer: the vocabulary by corpus term frequency
    (``vocabSize``, ``minDF``/``maxDF``, ``minTF`` per document,
    ``binary``), ties broken by the term.
  * IDF: ``log((m + 1) / (df + 1))``, zero below ``minDocFreq``.

Tokenizing, counting and the vocabulary are host string work, as in the
JAX package; token columns are 1-D object columns of lists
(:func:`~sntc_tpu_torch.core.frame.object_column`).  IDF's document
frequency is one float32 reduction on the estimator's ``device``
(default ``cuda``): ``((X > 0) * w[:, None]).sum(0)`` over every row at
once; the counts are integers, so any order sums them exactly.  With a
``mesh=`` of more than one shard it is one ``make_tree_aggregate`` over
``shard_batch``'s rows (the padding weighted 0), equal at every mesh
size.  The idf is taken in float64 on the host, and IDFModel's
transform is host numpy.
"""

from __future__ import annotations

import re
from collections import Counter
from itertools import chain, repeat
from typing import List, Sequence

import numpy as np
import torch

from sntc_tpu_torch.core.base import Estimator, Model, Transformer
from sntc_tpu_torch.core.frame import Frame, object_column, to_host
from sntc_tpu_torch.core.params import Param, validators
from sntc_tpu_torch.parallel.collectives import (
    fit_device,
    fit_mesh,
    make_tree_aggregate,
    shard_batch,
)
from sntc_tpu_torch.utils.profiling import record_movement, upload

__all__ = [
    "CountVectorizer",
    "CountVectorizerModel",
    "HashingTF",
    "IDF",
    "IDFModel",
    "NGram",
    "RegexTokenizer",
    "StopWordsRemover",
    "Tokenizer",
]

#: Spark's default English stop words (the snowball list of
#: ``StopWordsRemover.loadDefaultStopWords("english")``).
ENGLISH_STOP_WORDS = (
    "i me my myself we our ours ourselves you your yours yourself "
    "yourselves he him his himself she her hers herself it its itself "
    "they them their theirs themselves what which who whom this that "
    "these those am is are was were be been being have has had having "
    "do does did doing a an the and but if or because as until while "
    "of at by for with about against between into through during "
    "before after above below to from up down in out on off over under "
    "again further then once here there when where why how all any "
    "both each few more most other some such no nor not only own same "
    "so than too very s t can will just don should now"
).split()


def _tokens_column(frame: Frame, col: str) -> List[list]:
    """The token lists of ``col`` (lists as they are, other sequences
    as lists; the stages read them and make new ones)."""
    return [v if type(v) is list else list(v) for v in frame[col]]


def _as_str(docs: List[list]) -> List[list]:
    """``docs`` with every token as ``str`` (a pass over the types when
    they already are)."""
    if set(map(type, chain.from_iterable(docs))) <= {str}:
        return docs
    return [list(map(str, d)) for d in docs]


class Tokenizer(Transformer):
    """Lowercase, then split on whitespace."""

    inputCol = Param("input string column", default="text")
    outputCol = Param("output token column", default="tokens")

    def transform(self, frame: Frame) -> Frame:
        toks = [str(s).lower().split() for s in frame[self.getInputCol()]]
        return frame.with_column(self.getOutputCol(), object_column(toks))


class RegexTokenizer(Transformer):
    inputCol = Param("input string column", default="text")
    outputCol = Param("output token column", default="tokens")
    pattern = Param("split/match regex", default=r"\s+")
    gaps = Param(
        "True: pattern splits; False: pattern matches tokens",
        default=True, validator=validators.is_bool(),
    )
    minTokenLength = Param(
        "drop tokens shorter than this", default=1,
        validator=validators.gteq(0),
    )
    toLowercase = Param("lowercase before tokenizing", default=True,
                        validator=validators.is_bool())

    def transform(self, frame: Frame) -> Frame:
        rx = re.compile(self.getPattern())
        gaps = self.getGaps()
        lo = self.getToLowercase()
        mtl = int(self.getMinTokenLength())
        out = []
        for s in frame[self.getInputCol()]:
            s = str(s).lower() if lo else str(s)
            toks = rx.split(s) if gaps else rx.findall(s)
            out.append([t for t in toks if len(t) >= mtl])
        return frame.with_column(self.getOutputCol(), object_column(out))


class StopWordsRemover(Transformer):
    inputCol = Param("input token column", default="tokens")
    outputCol = Param("output token column", default="filtered")
    stopWords = Param("stop word list", default=tuple(ENGLISH_STOP_WORDS))
    caseSensitive = Param("case-sensitive matching", default=False,
                          validator=validators.is_bool())

    def transform(self, frame: Frame) -> Frame:
        docs = _tokens_column(frame, self.getInputCol())
        if self.getCaseSensitive():
            stop = set(self.getStopWords())
        else:
            # each distinct token's verdict once
            low = {w.lower() for w in self.getStopWords()}
            stop = {t for t in set(chain.from_iterable(docs))
                    if t.lower() in low}
        out = [[t for t in doc if t not in stop] for doc in docs]
        return frame.with_column(self.getOutputCol(), object_column(out))


class NGram(Transformer):
    inputCol = Param("input token column", default="tokens")
    outputCol = Param("output n-gram column", default="ngrams")
    n = Param("tokens per n-gram", default=2, validator=validators.gteq(1))

    def transform(self, frame: Frame) -> Frame:
        n = int(self.getN())
        out = [list(map(" ".join, zip(*(doc[k:] for k in range(n)))))
               for doc in _tokens_column(frame, self.getInputCol())]
        return frame.with_column(self.getOutputCol(), object_column(out))


# ---------------------------------------------------------------------------
# murmur3_32: Spark's HashingTF term hash (seed 42)
# ---------------------------------------------------------------------------


def murmur3_32(data: bytes, seed: int = 42) -> int:
    """Murmur3_x86_32 (the hash behind Spark's HashingTF buckets), as an
    UNSIGNED 32-bit integer."""
    c1, c2 = 0xCC9E2D51, 0x1B873593
    h = seed & 0xFFFFFFFF
    n4 = len(data) // 4
    for i in range(n4):
        k = int.from_bytes(data[4 * i:4 * i + 4], "little")
        k = (k * c1) & 0xFFFFFFFF
        k = ((k << 15) | (k >> 17)) & 0xFFFFFFFF
        k = (k * c2) & 0xFFFFFFFF
        h ^= k
        h = ((h << 13) | (h >> 19)) & 0xFFFFFFFF
        h = (h * 5 + 0xE6546B64) & 0xFFFFFFFF
    tail = data[4 * n4:]
    k = 0
    if len(tail) >= 3:
        k ^= tail[2] << 16
    if len(tail) >= 2:
        k ^= tail[1] << 8
    if len(tail) >= 1:
        k ^= tail[0]
        k = (k * c1) & 0xFFFFFFFF
        k = ((k << 15) | (k >> 17)) & 0xFFFFFFFF
        k = (k * c2) & 0xFFFFFFFF
        h ^= k
    h ^= len(data)
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & 0xFFFFFFFF
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & 0xFFFFFFFF
    h ^= h >> 16
    return h


def _spark_bucket(term: str, num_features: int) -> int:
    """Spark's ``HashingTF.indexOf``: signed-int32 murmur3, then
    ``nonNegativeMod``."""
    h = murmur3_32(term.encode("utf-8"))
    signed = h - (1 << 32) if h >= (1 << 31) else h
    return ((signed % num_features) + num_features) % num_features


def _dense_guard(width: int, rows: int) -> None:
    if width * max(rows, 1) > 1 << 30:
        raise ValueError(
            f"dense output would hold {width}×{rows} floats; this "
            "frame is dense-columnar (no sparse vectors) — lower "
            "numFeatures (e.g. 4096) for corpora of this size"
        )


def _flat_indices(docs: List[list], index: dict) -> tuple:
    """(row, column) of every token of ``docs`` that ``index`` maps to
    a column (a token it does not hold is skipped)."""
    lens = np.fromiter(map(len, docs), np.int64, count=len(docs))
    rows = np.repeat(np.arange(len(docs), dtype=np.int64), lens)
    cols = np.fromiter(map(index.get, chain.from_iterable(docs),
                           repeat(-1)), np.int64, count=int(lens.sum()))
    keep = cols >= 0
    return rows[keep], cols[keep]


def _count_matrix(rows: np.ndarray, cols: np.ndarray, n: int, width: int,
                  binary: bool) -> np.ndarray:
    """``[n, width]`` float32 counts of the (row, column) pairs, or 1.0
    where a pair occurs when ``binary``: the JAX package's per-token
    ``out[i, j] += 1.0`` in one pass (whole counts, exact in float32)."""
    flat = rows * width + cols
    out = np.zeros(n * width, np.float32)
    if binary:
        out[flat] = 1.0
    else:
        cells, counts = np.unique(flat, return_counts=True)
        out[cells] = counts
    return out.reshape(n, width)


class HashingTF(Transformer):
    """Term-frequency vectors in Spark's buckets (murmur3 seed 42 and
    ``nonNegativeMod``)."""

    inputCol = Param("input token column", default="tokens")
    outputCol = Param("output vector column", default="rawFeatures")
    #: Spark defaults to 2^18 for SPARSE vectors; these are dense, so the
    #: default is 4096 (the buckets still match Spark's at equal widths)
    numFeatures = Param("vector width", default=4096,
                        validator=validators.gt(0))
    binary = Param("presence (1.0) instead of counts", default=False,
                   validator=validators.is_bool())

    def indexOf(self, term: str) -> int:
        return _spark_bucket(str(term), int(self.getNumFeatures()))

    def transform(self, frame: Frame) -> Frame:
        nf = int(self.getNumFeatures())
        docs = _tokens_column(frame, self.getInputCol())
        _dense_guard(nf, len(docs))
        # each distinct term hashed once
        bucket = {t: _spark_bucket(str(t), nf)
                  for t in set(chain.from_iterable(docs))}
        rows, cols = _flat_indices(docs, bucket)
        out = _count_matrix(rows, cols, len(docs), nf, self.getBinary())
        return frame.with_column(self.getOutputCol(), out)


class _CvParams:
    inputCol = Param("input token column", default="tokens")
    outputCol = Param("output vector column", default="features")
    vocabSize = Param("max vocabulary size", default=1 << 18,
                      validator=validators.gt(0))
    minDF = Param(
        "min documents a term must appear in (>=1: count, <1: fraction)",
        default=1.0, validator=validators.gteq(0),
    )
    maxDF = Param(
        "max documents a term may appear in (>=1: count, <1: fraction)",
        default=2**63, validator=validators.gt(0),
    )
    minTF = Param(
        "per-document min term count (>=1: count, <1: fraction of doc)",
        default=1.0, validator=validators.gteq(0),
    )
    binary = Param("presence instead of counts", default=False,
                   validator=validators.is_bool())


class CountVectorizer(_CvParams, Estimator):
    def _fit(self, frame: Frame) -> "CountVectorizerModel":
        docs = _as_str(_tokens_column(frame, self.getInputCol()))
        m = len(docs)
        tf = Counter(chain.from_iterable(docs))
        df = Counter(chain.from_iterable(map(set, docs)))
        lo = self.getMinDF()
        hi = self.getMaxDF()
        lo = lo if lo >= 1 else lo * m
        hi = hi if hi >= 1 else hi * m
        if hi < lo:
            # Spark fails fast: require(maxDF >= minDF)
            raise ValueError(
                f"maxDF (resolves to {hi}) must be >= minDF (resolves "
                f"to {lo})"
            )
        kept = [t for t, c in df.items() if lo <= c <= hi]
        # corpus frequency descending, then the term ascending
        kept.sort(key=lambda t: (-tf[t], t))
        vocab = kept[: int(self.getVocabSize())]
        model = CountVectorizerModel(vocabulary=vocab)
        model.setParams(**self.paramValues())
        return model


class CountVectorizerModel(_CvParams, Model):
    def __init__(self, vocabulary: Sequence[str] = (), **kwargs):
        super().__init__(**kwargs)
        self.vocabulary = list(vocabulary)
        self._index = {t: i for i, t in enumerate(self.vocabulary)}

    def _save_extra(self):
        return {"vocabulary": self.vocabulary}, {}

    @classmethod
    def _load_from(cls, params, extra, arrays, device):
        m = cls(vocabulary=extra["vocabulary"])
        m.setParams(**params)
        return m

    def transform(self, frame: Frame) -> Frame:
        docs = _as_str(_tokens_column(frame, self.getInputCol()))
        v = len(self.vocabulary)
        _dense_guard(v, len(docs))
        rows, cols = _flat_indices(docs, self._index)
        out = _count_matrix(rows, cols, len(docs), v, False)
        lens = np.fromiter(map(len, docs), np.float64, count=len(docs))
        min_tf = float(self.getMinTF())
        # each row's threshold, compared in float32 as the JAX package's
        # row-by-row Python-float comparison is
        thr = (np.full(len(docs), min_tf) if min_tf >= 1
               else min_tf * lens).astype(np.float32)
        out[out < thr[:, None]] = 0.0
        if self.getBinary():
            out[out > 0] = 1.0
        return frame.with_column(self.getOutputCol(), out)


def doc_freq(xs: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Every column's document frequency, ``((X > 0) * w[:, None])
    .sum(0)``, one float32 reduction over all rows."""
    return ((xs > 0) * w[:, None]).sum(0)


class IDF(Estimator):
    """``log((m + 1) / (df + 1))``; fits on ``device`` (default
    ``cuda``): the document frequency is one reduction there, or one a
    shard over ``mesh`` (whose first local device is then the device)."""

    inputCol = Param("input count-vector column", default="rawFeatures")
    outputCol = Param("output vector column", default="features")
    minDocFreq = Param("terms below this df get idf 0", default=0,
                       validator=validators.gteq(0))

    def __init__(self, device=None, mesh=None, **kwargs):
        super().__init__(**kwargs)
        self.mesh = mesh
        self.device = fit_device(device, mesh)

    def _fit(self, frame: Frame) -> "IDFModel":
        X = frame[self.getInputCol()]
        mesh = fit_mesh(self.mesh)
        if mesh is not None:
            X = (X.to(torch.float32) if isinstance(X, torch.Tensor)
                 else np.ascontiguousarray(X, np.float32))
            m = X.shape[0]
            df = make_tree_aggregate(doc_freq, mesh, op="idf.doc_freq")(
                *shard_batch(mesh, X))
        else:
            if isinstance(X, torch.Tensor):
                xs = X.to(self.device, torch.float32)
            else:
                xs = upload(np.ascontiguousarray(X, np.float32), self.device)
            m = xs.shape[0]
            w = torch.ones(m, dtype=torch.float32, device=self.device)
            df = doc_freq(xs, w)
        df = df.cpu().numpy().astype(np.float64)
        record_movement(downloads=1, download_bytes=df.nbytes // 2)
        idf = np.log((m + 1.0) / (df + 1.0))
        idf[df < float(self.getMinDocFreq())] = 0.0
        model = IDFModel(idf=idf, docFreq=df, numDocs=m)
        model.setParams(**self.paramValues())
        return model


class IDFModel(Model):
    inputCol = IDF.inputCol
    outputCol = IDF.outputCol
    minDocFreq = IDF.minDocFreq

    def __init__(self, idf, docFreq=None, numDocs: int = 0, **kwargs):
        super().__init__(**kwargs)
        self.idf = np.asarray(idf, np.float64)
        self.docFreq = (
            np.asarray(docFreq, np.float64)
            if docFreq is not None else np.zeros_like(self.idf)
        )
        self.numDocs = int(numDocs)

    def _save_extra(self):
        return {"numDocs": self.numDocs}, {
            "idf": self.idf, "docFreq": self.docFreq,
        }

    @classmethod
    def _load_from(cls, params, extra, arrays, device):
        m = cls(
            idf=arrays["idf"], docFreq=arrays["docFreq"],
            numDocs=int(extra["numDocs"]),
        )
        m.setParams(**params)
        return m

    def transform(self, frame: Frame) -> Frame:
        X = to_host(frame[self.getInputCol()]).astype(np.float32, copy=False)
        out = X * self.idf[None, :].astype(np.float32)
        return frame.with_column(self.getOutputCol(), out)
