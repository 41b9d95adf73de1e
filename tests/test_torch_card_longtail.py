"""The device parts of the object-column and long-tail slice on the card
against the port on the CPU: IDF's document frequency, the LSH hashes,
distances and join, and Word2Vec's steps.

Every test here needs a CUDA device (``-m cuda``) and skips without one;
the file imports no JAX.  Inputs are numpy-seeded.  Tolerances:

* IDF: ``docFreq`` bitwise (integer-valued float32 sums), the idf equal;
* BRP hashes: equal wherever the pre-floor value lies more than 1e-4
  from an integer, with the caller's matmul precision at ``"high"``
  (TF32 allowed) and restored after each call; MinHash hashes bitwise;
* distances within 1e-6 relative (float32 in two libraries); the join's
  pairs equal;
* Word2Vec, one step and 50 steps from a nonzero ``w_out0`` at a rate
  large enough that the steps move every vector far above its float32
  rounding: each of ``w_in`` and ``w_out`` moved from its start within
  ``W2V_MOVE_RTOL`` of the CPU's move, relative to the CPU's largest
  move (``index_add_``'s atomics sum a row's contributions in any
  order; the CPU's own steps with each batch's rows permuted moved them
  1.5e-7 / 7.1e-6 apart for the step, 1.1e-7 / 7.6e-7 for 50 steps; an
  H100 80GB HBM3 at 700 W 1.6e-7 / 6.0e-6 and 2.1e-7 / 7.6e-7).
"""

import numpy as np
import pytest
import torch

from sntc_tpu_torch.core.frame import Frame
from sntc_tpu_torch.feature import (
    IDF,
    BucketedRandomProjectionLSH,
    MinHashLSH,
)
from sntc_tpu_torch.feature.lsh import sq_dists, sq_dists_paired
from sntc_tpu_torch.feature.word2vec import NEG, sgns_step, train_epochs


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture
def tf32_caller():
    """The caller allows TF32; each LSH call must restore that."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    yield
    torch.set_float32_matmul_precision(prev)


def _counts(n: int, width: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.poisson(0.05, size=(n, width)).astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("n,width", [(1000, 64), (49950, 4096)])
def test_idf_doc_freq_on_card_equals_cpu(card, n, width):
    f = Frame({"tf": _counts(n, width, 1)})
    got = IDF(device=card, inputCol="tf", minDocFreq=2).fit(f)
    want = IDF(device="cpu", inputCol="tf", minDocFreq=2).fit(f)
    np.testing.assert_array_equal(got.docFreq, want.docFreq)
    np.testing.assert_array_equal(got.idf, want.idf)


def _near_edges(X, R, bucket):
    v = X.astype(np.float64) @ R.astype(np.float64).T / bucket
    return np.abs(v - np.rint(v)) < 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("n,f,bucket", [(5000, 78, 2.0), (1000, 8, 0.5)])
def test_brp_hashes_on_card_equal_cpu_with_tf32_off(card, tf32_caller, n, f,
                                                    bucket):
    rng = np.random.default_rng(3)
    X = (rng.normal(size=(n, f)) * 3.0).astype(np.float32)
    frame = Frame({"features": X})
    m = BucketedRandomProjectionLSH(device=card, numHashTables=3,
                                    bucketLength=bucket, seed=1).fit(frame)
    got = m.transform(frame)["hashes"]
    assert torch.get_float32_matmul_precision() == "high"
    m.device = torch.device("cpu")
    want = m.transform(frame)["hashes"]
    far = ~_near_edges(X, m.randUnitVectors, bucket)
    np.testing.assert_array_equal(got[far], want[far])
    assert (~far).mean() <= 1e-3


@pytest.mark.cuda
def test_minhash_on_card_bitwise_and_join_equal_cpu(card, tf32_caller):
    rng = np.random.default_rng(4)
    X = (rng.random((3000, 78)) < 0.2).astype(np.float32)
    X[np.arange(3000), rng.integers(0, 78, size=3000)] = 1.0
    m = MinHashLSH(device=card, numHashTables=5, seed=2).fit(
        Frame({"features": X}))
    a, b = Frame({"features": X[:1500]}), Frame({"features": X[1500:]})
    got_h = m.transform(a)["hashes"]
    got_j = m.approxSimilarityJoin(a, b, 0.6)
    assert torch.get_float32_matmul_precision() == "high"
    m.device = torch.device("cpu")
    np.testing.assert_array_equal(got_h, m.transform(a)["hashes"])
    want_j = m.approxSimilarityJoin(a, b, 0.6)
    for col in ("idA", "idB", "distCol"):
        np.testing.assert_array_equal(got_j[col], want_j[col])


@pytest.mark.cuda
def test_distances_and_brp_join_on_card_equal_cpu(card, tf32_caller):
    rng = np.random.default_rng(5)
    A = rng.normal(size=(700, 78)).astype(np.float32)
    B = rng.normal(size=(900, 78)).astype(np.float32)
    d = sq_dists(torch.from_numpy(A).to(card),
                 torch.from_numpy(B).to(card)).cpu().numpy()
    d0 = sq_dists(torch.from_numpy(A), torch.from_numpy(B)).numpy()
    np.testing.assert_allclose(d, d0, rtol=1e-6, atol=1e-4)
    p = sq_dists_paired(torch.from_numpy(A).to(card),
                        torch.from_numpy(B[:700]).to(card)).cpu().numpy()
    p0 = sq_dists_paired(torch.from_numpy(A),
                         torch.from_numpy(B[:700])).numpy()
    np.testing.assert_allclose(p, p0, rtol=1e-6)
    m = BucketedRandomProjectionLSH(device=card, numHashTables=3,
                                    bucketLength=8.0, seed=0).fit(
        Frame({"features": A}))
    fa, fb = Frame({"features": A}), Frame({"features": B})
    got = m.approxSimilarityJoin(fa, fb, 11.0)
    m.device = torch.device("cpu")
    want = m.approxSimilarityJoin(fa, fb, 11.0)
    assert len(want["idA"]) > 0
    np.testing.assert_array_equal(got["idA"], want["idA"])
    np.testing.assert_array_equal(got["idB"], want["idB"])
    np.testing.assert_allclose(got["distCol"], want["distCol"], rtol=1e-6)


def _w2v_inputs(seed: int, v: int = 600, e: int = 100, p: int = 20000):
    rng = np.random.default_rng(seed)
    pairs = rng.integers(0, v, size=(p, 2)).astype(np.int64)
    freq = (1.0 / np.arange(1, v + 1)) ** 0.75
    probs_cum = np.cumsum(freq / freq.sum()).astype(np.float32)
    w_in0 = ((rng.random((v, e), np.float32) - 0.5) / e).astype(np.float32)
    return pairs, probs_cum, w_in0


#: card against CPU: max |Δcard − Δcpu| / max |Δcpu|, Δ = w − w0
W2V_MOVE_RTOL = 1e-4
#: the CPU's moves must be this large, far above float32's rounding of
#: the vectors (~5e-3 and ~0.3 at most: half an ulp is 2.3e-10, 1.5e-8)
W2V_MIN_MOVE = 1e-3


def _move_gap(card, cpu, start) -> float:
    d_cpu = cpu.astype(np.float64) - start
    d_card = card.astype(np.float64) - start
    scale = np.abs(d_cpu).max()
    assert scale >= W2V_MIN_MOVE, scale
    return float(np.abs(d_card - d_cpu).max() / scale)


@pytest.mark.cuda
def test_word2vec_step_on_card_equals_cpu(card):
    pairs, probs_cum, w_in0 = _w2v_inputs(0)
    rng = np.random.default_rng(1)
    w_out0 = (rng.normal(size=w_in0.shape) * 0.1).astype(np.float32)
    u = torch.from_numpy(rng.random((1024, NEG), np.float32))
    negs = torch.searchsorted(torch.from_numpy(probs_cum), u)
    out = {}
    for dev in (card, torch.device("cpu")):
        w_in = torch.from_numpy(w_in0).to(dev).clone()
        w_out = torch.from_numpy(w_out0).to(dev).clone()
        rows = torch.from_numpy(pairs[:1024]).to(dev)
        sgns_step(w_in, w_out, rows[:, 0], rows[:, 1], negs.to(dev), 25.0)
        out[dev.type] = (w_in.cpu().numpy(), w_out.cpu().numpy())
    gaps = [_move_gap(a, b, w0) for a, b, w0 in
            zip(out["cuda"], out["cpu"], (w_in0, w_out0))]
    print(f"one step: moves apart {gaps}")
    assert max(gaps) <= W2V_MOVE_RTOL, gaps
    uniforms = np.random.default_rng(2).random((50, 1024, NEG), np.float32)
    fits = {}
    for dev in (card, torch.device("cpu")):
        w_in, w_out = train_epochs(
            torch.from_numpy(pairs).to(dev),
            torch.from_numpy(probs_cum).to(dev), torch.from_numpy(w_in0),
            torch.from_numpy(w_out0), 2.5, batch=1024, n_steps=50,
            uniforms=uniforms)
        fits[dev.type] = (w_in.cpu().numpy(), w_out.cpu().numpy())
    gaps = [_move_gap(a, b, w0) for a, b, w0 in
            zip(fits["cuda"], fits["cpu"], (w_in0, w_out0))]
    print(f"50 steps: moves apart {gaps}")
    assert max(gaps) <= W2V_MOVE_RTOL, gaps
