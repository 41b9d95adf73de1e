"""Locality-sensitive hashing: ``BucketedRandomProjectionLSH`` (Euclidean)
and ``MinHashLSH`` (Jaccard).

Counterpart of ``sntc_tpu/feature/lsh.py`` (Spark's stages of the same
names):

* fit draws ``numHashTables`` random hash functions with numpy from
  ``seed``, as the JAX fit draws them;
* ``transform`` appends one hash value a table;
* ``approxNearestNeighbors(dataset, key, k)``: the rows sharing a bucket
  with the key in ANY table, ranked by the exact ``keyDistance``, the
  first k (fewer where the buckets are sparse, as in Spark);
* ``approxSimilarityJoin(A, B, threshold)``: pairs sharing a bucket in
  at least one table, kept where ``keyDistance < threshold``.

The hashes and the candidates' distances run on the model's ``device``
(default ``cuda``): BRP is one ``[N, F] @ [F, L]`` product and a floor;
MinHash a loop over the F features of masked int32 minima over the
host's ``((1 + j)·a + b) mod p`` table (no ``[N, F, L]`` block);
Euclidean distances use ``‖a‖² + ‖b‖² − 2a·b``.  Every product runs in
full float32 (TF32 off, the caller's setting restored after): the slack
bound and the floor's bucket edges assume float32 error, and TF32 would
move points across buckets and drop true pairs before the exact
recheck.  The join's bucket group-by (integer key matching) and its
chunking are host work, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from sntc_tpu_torch.core.base import Estimator, Model
from sntc_tpu_torch.core.frame import Frame, to_host
from sntc_tpu_torch.core.params import Param, validators
from sntc_tpu_torch.device import resolve_device
from sntc_tpu_torch.ops.lbfgs import full_f32
from sntc_tpu_torch.utils.profiling import record_movement, upload

#: Spark's MinHash prime (``MinHashLSH.HASH_PRIME``).
HASH_PRIME = 2038074743


class _LSHParams:
    inputCol = Param("input vector column", default="features")
    outputCol = Param("output hashes column", default="hashes")
    numHashTables = Param(
        "number of hash tables", default=1, validator=validators.gteq(1)
    )
    seed = Param("random seed", default=0)


_NP = {torch.float32: np.float32, torch.int32: np.int32,
       torch.bool: np.bool_}


def _on(x, device: torch.device, dtype=torch.float32) -> torch.Tensor:
    """``x`` as a ``dtype`` tensor on ``device`` (an upload, recorded,
    for host values)."""
    if isinstance(x, torch.Tensor):
        return x.to(device, dtype)
    return upload(np.ascontiguousarray(x, _NP[dtype]), device)


def _down(t: torch.Tensor) -> np.ndarray:
    out = t.cpu().numpy()
    record_movement(downloads=1, download_bytes=out.nbytes)
    return out


def brp_hash(X: torch.Tensor, R: torch.Tensor,
             inv_bucket: float) -> torch.Tensor:
    """``floor(X @ R.T · inv_bucket)``, ``[N, L]`` float32, in full
    float32."""
    with full_f32():
        return torch.floor(torch.matmul(X, R.t()) * inv_bucket)


def minhash(active: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """``active [N, F]`` bool, ``vals [L, F]`` int32 (each index's hash)
    → ``[N, L]`` int32: each row's minimum over its active indices, one
    feature at a time.  int32 throughout: the hashes reach ~2e9, past
    float32's 24-bit mantissa."""
    n, f = active.shape
    big = torch.tensor(HASH_PRIME, dtype=torch.int32, device=active.device)
    acc = torch.full((n, vals.shape[0]), HASH_PRIME, dtype=torch.int32,
                     device=active.device)
    for j in range(f):
        acc = torch.minimum(acc, torch.where(active[:, j, None],
                                             vals[None, :, j], big))
    return acc


def sq_dists(Xa: torch.Tensor, Xb: torch.Tensor) -> torch.Tensor:
    """Pairwise squared Euclidean distances ``[Na, Nb]`` by
    ``‖a‖² + ‖b‖² − 2a·b``, clamped at 0, in full float32."""
    aa = (Xa * Xa).sum(dim=1)[:, None]
    bb = (Xb * Xb).sum(dim=1)[None, :]
    with full_f32():
        cross = torch.matmul(Xa, Xb.t())
    return torch.clamp(aa + bb - 2.0 * cross, min=0.0)


def sq_dists_paired(Xa: torch.Tensor, Xb: torch.Tensor) -> torch.Tensor:
    """Row-by-row squared distances ``[N]`` of two ``[N, F]`` blocks."""
    d = Xa - Xb
    return torch.clamp((d * d).sum(dim=1), min=0.0)


def _matrix(col) -> np.ndarray:
    """A 1-D column as ``[N, 1]`` (fit takes either rank; every hash and
    distance works on matrices)."""
    col = to_host(col)
    return col[:, None] if col.ndim == 1 else col


class _LSHModel(Model):
    """What both LSH models share: transform and the two queries."""

    def __init__(self, device="cuda", **kwargs):
        super().__init__(**kwargs)
        self.device = resolve_device(device)

    def _hash(self, X: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def keyDistance(self, a: np.ndarray, b: np.ndarray,
                    paired: bool = False) -> np.ndarray:
        raise NotImplementedError

    def transform(self, frame: Frame) -> Frame:
        X = _matrix(frame[self.getInputCol()]).astype(np.float32, copy=False)
        return frame.with_column(self.getOutputCol(), self._hash(X))

    def approxNearestNeighbors(
        self,
        frame: Frame,
        key: np.ndarray,
        numNearestNeighbors: int,
        distCol: str = "distCol",
    ) -> Frame:
        X = _matrix(frame[self.getInputCol()]).astype(np.float32, copy=False)
        key = np.asarray(key, np.float32).reshape(1, -1)
        h_data = self._hash(X)
        h_key = self._hash(key)[0]
        cand = np.nonzero((h_data == h_key[None, :]).any(axis=1))[0]
        if cand.size == 0:
            return frame.slice(0, 0).with_column(
                distCol, np.zeros(0, np.float64)
            )
        # the paired (broadcast) form: exact differences; the
        # a²+b²−2ab identity loses ~1e-3 on near-zero distances in f32,
        # enough to misrank close neighbours
        d = self.keyDistance(X[cand], key, paired=True).ravel()
        order = np.argsort(d, kind="stable")[:numNearestNeighbors]
        out = frame.take(cand[order])
        return out.with_column(distCol, d[order].astype(np.float64))

    #: rows of A a distance chunk takes inside one bucket: bounds the
    #: memory when skewed data falls into one giant bucket
    _JOIN_CHUNK_A = 4096

    def _prefilter_slack(self, Xa, Xb) -> float:
        """Upper bound on the pairwise distance error of
        ``keyDistance``'s fast path, in distance units; 0 where that path
        is exact (MinHash: float32 products of 0/1 counts)."""
        return 0.0

    def _candidates(self, Xa, Xb, threshold: float) -> tuple:
        """(rows of ``Xa``, rows of ``Xb``) of the pairs the join's
        prefilter keeps: the fast pairwise distance under ``threshold``
        plus the slack."""
        d = self.keyDistance(Xa, Xb)
        return np.nonzero(d < threshold + self._prefilter_slack(Xa, Xb))

    def approxSimilarityJoin(
        self,
        frameA: Frame,
        frameB: Frame,
        threshold: float,
        distCol: str = "distCol",
    ) -> Frame:
        Xa = _matrix(frameA[self.getInputCol()]).astype(np.float32, copy=False)
        Xb = _matrix(frameB[self.getInputCol()]).astype(np.float32, copy=False)
        ha, hb = self._hash(Xa), self._hash(Xb)
        # the bucket group-by of each table (Spark's shuffle stage):
        # shared unique-value codes, then the cartesian pairs of each
        # shared bucket, thresholded chunk by chunk, so only surviving
        # pairs are materialized
        ia_parts, ib_parts, d_parts = [], [], []
        for t in range(ha.shape[1]):
            uniq, codes = np.unique(
                np.concatenate([ha[:, t], hb[:, t]]), return_inverse=True
            )
            ca, cb = codes[: len(ha)], codes[len(ha):]
            order_a = np.argsort(ca, kind="stable")
            order_b = np.argsort(cb, kind="stable")
            sca, scb = ca[order_a], cb[order_b]
            vals = np.arange(len(uniq))
            a_lo = np.searchsorted(sca, vals, "left")
            a_hi = np.searchsorted(sca, vals, "right")
            b_lo = np.searchsorted(scb, vals, "left")
            b_hi = np.searchsorted(scb, vals, "right")
            shared = np.nonzero((a_hi > a_lo) & (b_hi > b_lo))[0]
            for v in shared:
                jb = order_b[b_lo[v]:b_hi[v]]
                ja = order_a[a_lo[v]:a_hi[v]]
                for s in range(0, ja.size, self._JOIN_CHUNK_A):
                    chunk = ja[s:s + self._JOIN_CHUNK_A]
                    # the pairwise prefilter with a margin scaled by the
                    # rows' magnitude (the identity's f32 error grows
                    # with ‖x‖²), then the exact paired recheck
                    ii, jj = self._candidates(Xa[chunk], Xb[jb], threshold)
                    if ii.size == 0:
                        continue
                    d_ex = self.keyDistance(
                        Xa[chunk[ii]], Xb[jb[jj]], paired=True
                    )
                    keep = d_ex < threshold
                    if keep.any():
                        ia_parts.append(chunk[ii[keep]])
                        ib_parts.append(jb[jj[keep]])
                        d_parts.append(d_ex[keep])
        if not ia_parts:
            ia = np.zeros(0, np.int64)
            ib = np.zeros(0, np.int64)
            d = np.zeros(0, np.float64)
        else:
            ia = np.concatenate(ia_parts).astype(np.int64)
            ib = np.concatenate(ib_parts).astype(np.int64)
            d = np.concatenate(d_parts).astype(np.float64)
            # a pair sharing buckets in several tables appears once a
            # table: keep its first
            packed = ia * len(Xb) + ib
            _, first = np.unique(packed, return_index=True)
            first.sort()
            ia, ib, d = ia[first], ib[first], d[first]
        return Frame({"idA": ia, "idB": ib, distCol: d.astype(np.float64)})


class BucketedRandomProjectionLSH(_LSHParams, Estimator):
    """Euclidean LSH: ``h(x) = floor(x·r / bucketLength)`` with unit-norm
    Gaussian projections ``r``; the model runs on ``device`` (default
    ``cuda``)."""

    bucketLength = Param(
        "bucket width of each hash", default=None,
        validator=lambda v: v is None or v > 0,
    )

    def __init__(self, device="cuda", **kwargs):
        super().__init__(**kwargs)
        self.device = resolve_device(device)

    def _fit(self, frame: Frame) -> "BucketedRandomProjectionLSHModel":
        if self.getBucketLength() is None:
            raise ValueError("bucketLength must be set")
        X = frame[self.getInputCol()]
        f = X.shape[1] if X.ndim == 2 else 1
        rng = np.random.default_rng(self.getSeed())
        R = rng.normal(size=(int(self.getNumHashTables()), f))
        R /= np.linalg.norm(R, axis=1, keepdims=True)
        model = BucketedRandomProjectionLSHModel(randUnitVectors=R,
                                                 device=self.device)
        model.setParams(**self.paramValues())
        return model


class BucketedRandomProjectionLSHModel(_LSHParams, _LSHModel):
    bucketLength = BucketedRandomProjectionLSH.bucketLength

    def __init__(self, randUnitVectors, device="cuda", **kwargs):
        super().__init__(device=device, **kwargs)
        self.randUnitVectors = np.asarray(randUnitVectors, np.float32)

    def _save_extra(self):
        return {}, {"randUnitVectors": self.randUnitVectors}

    @classmethod
    def _load_from(cls, params, extra, arrays, device):
        m = cls(randUnitVectors=arrays["randUnitVectors"], device=device)
        m.setParams(**params)
        return m

    def _hash(self, X: np.ndarray) -> np.ndarray:
        inv = float(np.float32(1.0 / float(self.getBucketLength())))
        return _down(brp_hash(_on(X, self.device),
                              _on(self.randUnitVectors, self.device), inv))

    def keyDistance(self, a, b, paired: bool = False) -> np.ndarray:
        fn = sq_dists_paired if paired else sq_dists
        return np.sqrt(_down(fn(_on(a, self.device),
                                _on(b, self.device))).astype(np.float64))

    def _candidates(self, Xa, Xb, threshold: float) -> tuple:
        """The prefilter on the device: the same float64 square roots of
        the float32 squared distances the host would take, compared
        there; only the kept pairs' indices come back."""
        r = threshold + self._prefilter_slack(Xa, Xb)
        d2 = sq_dists(_on(Xa, self.device), _on(Xb, self.device))
        keep = torch.nonzero(torch.sqrt(d2.to(torch.float64)) < r)
        ij = _down(keep)
        return ij[:, 0], ij[:, 1]

    def _prefilter_slack(self, Xa, Xb) -> float:
        """The identity's float32 error is at most ~F·eps·(‖a‖²+‖b‖²) in
        squared distance; its square root in distance units
        (conservative near zero: over-inclusion only costs the exact
        recheck)."""
        eps = float(np.finfo(np.float32).eps)
        aa = float((Xa.astype(np.float64) ** 2).sum(axis=1).max())
        bb = float((Xb.astype(np.float64) ** 2).sum(axis=1).max())
        return float(np.sqrt(4.0 * Xa.shape[1] * eps * (aa + bb)))


class MinHashLSH(_LSHParams, Estimator):
    """Jaccard LSH over binary vectors: ``h(x) = min over the active
    indices j of ((1 + j)·a + b) mod HASH_PRIME``; the model runs on
    ``device`` (default ``cuda``)."""

    def __init__(self, device="cuda", **kwargs):
        super().__init__(**kwargs)
        self.device = resolve_device(device)

    def _fit(self, frame: Frame) -> "MinHashLSHModel":
        X = frame[self.getInputCol()]
        f = X.shape[1] if X.ndim == 2 else 1
        if f > HASH_PRIME:
            raise ValueError("input dimension must be < HASH_PRIME")
        rng = np.random.default_rng(self.getSeed())
        L = int(self.getNumHashTables())
        coeffs = np.stack(
            [
                rng.integers(1, HASH_PRIME, size=L),
                rng.integers(0, HASH_PRIME, size=L),
            ],
            axis=1,
        )
        model = MinHashLSHModel(randCoefficients=coeffs, device=self.device)
        model.setParams(**self.paramValues())
        return model


class MinHashLSHModel(_LSHParams, _LSHModel):
    def __init__(self, randCoefficients, device="cuda", **kwargs):
        super().__init__(device=device, **kwargs)
        self.randCoefficients = np.asarray(randCoefficients, np.int64)

    def _save_extra(self):
        return {}, {"randCoefficients": self.randCoefficients}

    @classmethod
    def _load_from(cls, params, extra, arrays, device):
        m = cls(randCoefficients=arrays["randCoefficients"], device=device)
        m.setParams(**params)
        return m

    def _hash_table(self, f: int) -> np.ndarray:
        """``[L, F]`` hash of every index: int64 products on the host
        (``a·j`` overflows int32), reduced mod HASH_PRIME into int32."""
        j = np.arange(1, f + 1, dtype=np.int64)[None, :]
        a = self.randCoefficients[:, 0][:, None]
        b = self.randCoefficients[:, 1][:, None]
        return ((j * a + b) % HASH_PRIME).astype(np.int32)

    def _hash(self, X: np.ndarray) -> np.ndarray:
        if np.any((X != 0) & (X != 1)):
            raise ValueError("MinHashLSH requires binary (0/1) vectors")
        if not np.asarray(X != 0).any(axis=1).all():
            raise ValueError(
                "MinHashLSH: every vector needs at least one nonzero "
                "entry (Spark raises on empty sets too)"
            )
        vals = self._hash_table(X.shape[1])
        active = _on(np.asarray(X != 0), self.device, torch.bool)
        return _down(minhash(active, _on(vals, self.device, torch.int32))
                     ).astype(np.int64)

    def keyDistance(self, a, b, paired: bool = False) -> np.ndarray:
        """Jaccard distance ``1 − |A∩B| / |A∪B|``."""
        a = np.asarray(a, bool)
        b = np.asarray(b, bool)
        if paired:
            inter = (a & b).sum(axis=1).astype(np.float64)
            union = (a | b).sum(axis=1).astype(np.float64)
        else:
            with full_f32():
                inter = _down(torch.matmul(
                    _on(a, self.device), _on(b, self.device).t()
                )).astype(np.float64)
            union = (
                a.sum(axis=1)[:, None] + b.sum(axis=1)[None, :] - inter
            ).astype(np.float64)
        with np.errstate(divide="ignore", invalid="ignore"):
            d = 1.0 - inter / union
        return np.where(union > 0, d, 0.0)
