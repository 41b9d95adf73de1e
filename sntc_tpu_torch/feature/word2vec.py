"""Word2Vec: skip-gram word embeddings.

Counterpart of ``sntc_tpu/feature/word2vec.py`` (Spark's ``Word2Vec``):
token-array input, ``vectorSize`` (100), ``windowSize`` (5), the
``minCount`` (5) vocabulary floor, ``stepSize`` (0.025) with linear
decay, ``maxIter`` epochs, ``seed``; the model's ``getVectors`` (word →
vector frame), ``findSynonyms`` (cosine nearest words) and
``transform`` (the average of a document's word vectors).  As in the
JAX package the skip-gram objective trains with negative sampling
(Spark uses hierarchical softmax).

The fit draws the vocabulary's order, the shuffled (center, context)
pairs and the initial input vectors from one numpy generator seeded
with ``seed``, in the JAX fit's order, so they are the JAX fit's bit for
bit.  :func:`train_epochs` runs the steps on the estimator's ``device``
(default ``cuda``): step ``t`` trains on the rolling slice ``[t·B,
(t+1)·B)`` mod P of the pairs, draws its negatives by
``searchsorted(probs_cum, u)`` on ``[B, 5]`` uniforms, takes the
negative-sampling loss's gradient by hand (scatter-adds by
``index_add_``) and steps with the linearly decayed rate.  The uniforms
are an argument: the fit draws them with numpy from ``seed`` (the JAX
fit draws them with ``jax.random`` inside its scan, which a torch
program cannot reproduce), uploads them and searches them on the
device, so a card and a CPU fit see the same negatives.  The model is
host numpy.
"""

from __future__ import annotations

from collections import Counter
from itertools import chain
from typing import Callable, List, Union

import numpy as np
import torch

from sntc_tpu_torch.core.base import Estimator, Model
from sntc_tpu_torch.core.frame import Frame, object_column, to_host
from sntc_tpu_torch.core.params import Param, validators
from sntc_tpu_torch.device import resolve_device
from sntc_tpu_torch.utils.profiling import upload

NEG = 5  # negatives a positive (Mikolov's small-corpus default)
#: steps whose uniforms the fit draws, uploads and searches at once
UNIFORM_CHUNK = 256

#: a source of the negatives' uniforms: ``[n_steps, B, NEG]`` values, or
#: a callable ``(t0, t1) -> [t1 - t0, B, NEG]`` for steps ``t0 .. t1 - 1``
Uniforms = Union[np.ndarray, torch.Tensor, Callable]


def _uniform_chunk(uniforms: Uniforms, t0: int, t1: int,
                   device: torch.device) -> torch.Tensor:
    u = uniforms(t0, t1) if callable(uniforms) else uniforms[t0:t1]
    if isinstance(u, torch.Tensor):
        return u.to(device, torch.float32)
    return upload(np.ascontiguousarray(u, np.float32), device)


def learning_rate(lr0: float, t: int, n_steps: int) -> float:
    """Step ``t``'s rate, ``lr0 · max(1 − t / n_steps, 1e-4)``, in
    float32 as the JAX step takes it."""
    f = np.float32
    frac = f(t) / f(n_steps)
    return float(f(lr0) * np.maximum(f(1.0) - frac, f(1e-4)))


def sgns_step(w_in: torch.Tensor, w_out: torch.Tensor,
              centers: torch.Tensor, contexts: torch.Tensor,
              negs: torch.Tensor, lr: float) -> None:
    """One step of skip-gram negative sampling in place: the gradient
    of ``−mean(log σ(v_c·u_o) + Σ_k log σ(−v_c·u_k))`` over the batch,
    scattered by ``index_add_`` and applied with rate ``lr``."""
    b = centers.shape[0]
    vc = w_in.index_select(0, centers)  # [B, E]
    uo = w_out.index_select(0, contexts)  # [B, E]
    un = w_out.index_select(0, negs.reshape(-1)).reshape(b, NEG, -1)
    s_pos = (vc * uo).sum(-1)
    s_neg = (vc[:, None, :] * un).sum(-1)
    # d loss / d score: −σ(−s)/B for the positive, σ(s)/B a negative
    d_pos = -torch.sigmoid(-s_pos) / b
    d_neg = torch.sigmoid(s_neg) / b
    g_vc = d_pos[:, None] * uo + (d_neg[:, :, None] * un).sum(1)
    g_in = torch.zeros_like(w_in).index_add_(0, centers, g_vc)
    g_out = torch.zeros_like(w_out).index_add_(
        0, contexts, d_pos[:, None] * vc)
    g_out.index_add_(0, negs.reshape(-1),
                     (d_neg[:, :, None] * vc[:, None, :]).reshape(b * NEG, -1))
    w_in.sub_(lr * g_in)
    w_out.sub_(lr * g_out)


def train_epochs(pairs: torch.Tensor, probs_cum: torch.Tensor,
                 w_in0: torch.Tensor, w_out0: torch.Tensor, lr0: float, *,
                 batch: int, n_steps: int, uniforms: Uniforms):
    """Every step of every epoch on the device of ``pairs``: ``pairs
    [P, 2]`` (center, context), pre-shuffled; step ``t`` trains on the
    rows ``[t·B, (t+1)·B)`` mod P with negatives
    ``searchsorted(probs_cum, u_t)`` (clamped to the vocabulary, as a
    gather clamps; ``UNIFORM_CHUNK`` steps' uniforms at a time) and rate
    :func:`learning_rate`.  Returns ``(w_in, w_out)``."""
    dev = pairs.device
    p = pairs.shape[0]
    v = w_in0.shape[0]
    w_in = w_in0.to(dev, torch.float32).clone()
    w_out = w_out0.to(dev, torch.float32).clone()
    ar = torch.arange(batch, device=dev)
    for t0 in range(0, n_steps, UNIFORM_CHUNK):
        t1 = min(n_steps, t0 + UNIFORM_CHUNK)
        u = _uniform_chunk(uniforms, t0, t1, dev)
        negs_all = torch.searchsorted(probs_cum, u).clamp_(max=v - 1)
        for t in range(t0, t1):
            idx = ((t * batch) % p + ar) % p
            rows = pairs.index_select(0, idx)
            sgns_step(w_in, w_out, rows[:, 0], rows[:, 1], negs_all[t - t0],
                      learning_rate(lr0, t, n_steps))
    return w_in, w_out


class _W2vParams:
    inputCol = Param("token-array column", default="tokens")
    outputCol = Param("output document-vector column", default="wordVectors")
    vectorSize = Param("embedding dimension", default=100,
                       validator=validators.gt(0))
    windowSize = Param("context window radius", default=5,
                       validator=validators.gt(0))
    minCount = Param("min corpus occurrences for the vocabulary", default=5,
                     validator=validators.gteq(0))
    maxIter = Param("training epochs", default=1, validator=validators.gt(0))
    stepSize = Param("initial learning rate (linear decay)", default=0.025,
                     validator=validators.gt(0))
    seed = Param("random seed", default=0)


def skipgram_inputs(docs: List[List[str]], min_count: int, window: int,
                    vector_size: int, seed: int) -> dict:
    """The fit's host inputs, drawn as the JAX fit draws them: the
    vocabulary (count descending, then the token), the (center,
    context) pairs shuffled by ``default_rng(seed)``, the unigram^0.75
    cumulative table, and ``w_in0`` from the same generator after the
    shuffle."""
    counts = Counter(chain.from_iterable(docs))
    vocab = sorted((t for t, c in counts.items() if c >= min_count),
                   key=lambda t: (-counts[t], t))
    if not vocab:
        raise ValueError(
            f"empty vocabulary: no token reaches minCount={min_count}"
        )
    index = {t: i for i, t in enumerate(vocab)}
    # every (center, context) within the window, center by center and
    # each center's contexts in order: the JAX fit's nested loops
    offsets = np.concatenate([np.arange(-window, 0), np.arange(1, window + 1)])
    parts = []
    for d in docs:
        ids = np.array([index[t] for t in d if t in index], np.int32)
        i = np.repeat(np.arange(len(ids)), len(offsets))
        j = i + np.tile(offsets, len(ids))
        ok = (j >= 0) & (j < len(ids))
        parts.append(np.stack([ids[i[ok]], ids[j[ok]]], axis=1))
    pairs_arr = (np.concatenate(parts) if parts
                 else np.zeros((0, 2), np.int32))
    if not len(pairs_arr):
        raise ValueError(
            "no skip-gram pairs: documents are too short for the "
            "window after minCount filtering"
        )
    rng = np.random.default_rng(seed)
    # the JAX fit's ``rng.shuffle(pairs_arr)``: a 1-D shuffle takes the
    # same draws as a row shuffle and is a tenth of its time
    order = np.arange(len(pairs_arr))
    rng.shuffle(order)
    pairs_arr = pairs_arr[order]
    freq = np.asarray([counts[t] for t in vocab], np.float64) ** 0.75
    probs_cum = np.cumsum(freq / freq.sum()).astype(np.float32)
    v, e = len(vocab), int(vector_size)
    w_in0 = ((rng.random((v, e), np.float32) - 0.5) / e).astype(np.float32)
    return {"vocab": vocab, "pairs": pairs_arr, "probs_cum": probs_cum,
            "w_in0": w_in0}


def numpy_uniforms(seed: int, batch: int) -> Callable:
    """The fit's uniforms: ``default_rng(seed)`` drawn in step order,
    ``[t1 - t0, batch, NEG]`` float32 a call (calls in step order)."""
    rng = np.random.default_rng(seed)

    def draw(t0: int, t1: int) -> np.ndarray:
        return rng.random((t1 - t0, batch, NEG), np.float32)

    return draw


class Word2Vec(_W2vParams, Estimator):
    """Fits on ``device`` (default ``cuda``); ``uniforms`` (default: the
    numpy stream :func:`numpy_uniforms` of ``seed``) feeds the
    negatives."""

    def __init__(self, device="cuda", uniforms: Uniforms = None, **kwargs):
        super().__init__(**kwargs)
        self.device = resolve_device(device)
        self.uniforms = uniforms
        #: the last fit's steps, batch and pairs
        self.fit_stats: dict = {}

    def _fit(self, frame: Frame) -> "Word2VecModel":
        docs = [list(map(str, d)) for d in frame[self.getInputCol()]]
        inp = skipgram_inputs(docs, int(self.getMinCount()),
                              int(self.getWindowSize()),
                              int(self.getVectorSize()), self.getSeed())
        p = len(inp["pairs"])
        batch = int(min(1024, p))
        n_steps = max(1, p // batch) * int(self.getMaxIter())
        dev = self.device
        uniforms = self.uniforms
        if uniforms is None:
            uniforms = numpy_uniforms(self.getSeed(), batch)
        w_in, _ = train_epochs(
            upload(inp["pairs"].astype(np.int64), dev),
            upload(inp["probs_cum"], dev), torch.from_numpy(inp["w_in0"]),
            torch.zeros(inp["w_in0"].shape, dtype=torch.float32),
            float(np.float32(self.getStepSize())), batch=batch,
            n_steps=n_steps, uniforms=uniforms,
        )
        self.fit_stats = {"steps": n_steps, "batch": batch, "pairs": p,
                          "vocabulary": len(inp["vocab"])}
        model = Word2VecModel(vocabulary=inp["vocab"],
                              vectors=to_host(w_in).astype(np.float32))
        model.setParams(**self.paramValues())
        return model


class Word2VecModel(_W2vParams, Model):
    def __init__(self, vocabulary: List[str], vectors, **kwargs):
        super().__init__(**kwargs)
        self.vocabulary = list(vocabulary)
        self.vectors = np.asarray(vectors, np.float32)
        self._index = {t: i for i, t in enumerate(self.vocabulary)}

    def getVectors(self) -> Frame:
        return Frame({
            "word": object_column(self.vocabulary),
            "vector": self.vectors,
        })

    def findSynonyms(self, word: str, num: int) -> Frame:
        j = self._index.get(str(word))
        if j is None:
            raise KeyError(f"{word!r} is not in the vocabulary")
        q = self.vectors[j]
        w = self.vectors
        sim = (w @ q) / (
            np.linalg.norm(w, axis=1) * max(np.linalg.norm(q), 1e-12) + 1e-12
        )
        sim[j] = -np.inf  # Spark leaves out the query word
        order = np.argsort(-sim)[:num]
        return Frame({
            "word": object_column([self.vocabulary[o] for o in order]),
            "similarity": sim[order].astype(np.float64),
        })

    def transform(self, frame: Frame) -> Frame:
        e = self.vectors.shape[1]
        out = np.zeros((frame.num_rows, e), np.float32)
        for r, doc in enumerate(frame[self.getInputCol()]):
            ids = [self._index[str(t)] for t in doc if str(t) in self._index]
            if ids:
                out[r] = self.vectors[ids].mean(axis=0)
        return frame.with_column(self.getOutputCol(), out)

    def _save_extra(self):
        return {"vocabulary": self.vocabulary}, {"vectors": self.vectors}

    @classmethod
    def _load_from(cls, params, extra, arrays, device):
        m = cls(vocabulary=extra["vocabulary"], vectors=arrays["vectors"])
        m.setParams(**params)
        return m
