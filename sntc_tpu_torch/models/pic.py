"""PowerIterationClustering — Lin & Cohen PIC over a similarity graph.

Counterpart of ``sntc_tpu/models/pic.py`` (Spark's
``PowerIterationClustering``): the input is an edge list (``srcCol``,
``dstCol``, optional ``weightCol``, similarities ≥ 0, undirected),
``k``, ``maxIter``, ``initMode`` random | degree; ``assignClusters``
returns an (id, cluster) frame.  Power-iterate ``v ← D⁻¹ A v``
(L1-normalised each step, stopping on the acceleration criterion), then
k-means the 1-D embedding.

The ids are compacted and the edges mirrored on the host; the degree and
random inits are numpy draws from the seed, as in the JAX package.  The
power iteration runs on the estimator's device, each step one
``index_add_`` mat-vec over the mirrored edges; the host reads the
acceleration once a step and stops below 1e-5 / n (the JAX package
runs the loop as one XLA ``while_loop``).  The embedding is clustered by
the port's KMeans on the same device.
"""

from __future__ import annotations

import numpy as np
import torch

from sntc_tpu_torch.core.base import Params
from sntc_tpu_torch.core.frame import Frame, to_host
from sntc_tpu_torch.core.params import Param, validators
from sntc_tpu_torch.device import resolve_device
from sntc_tpu_torch.models.kmeans import KMeans


def power_iterate(src: torch.Tensor, dst: torch.Tensor, w: torch.Tensor,
                  v0: torch.Tensor, n: int, max_iter: int):
    """``v ← normalize₁(D⁻¹ A v)`` over the edges ``(src, dst, w)`` from
    ``v0``, with mllib's stop: the acceleration ‖(v_t − v_{t−1}) −
    (v_{t−1} − v_{t−2})‖∞, taken as the change of the largest update,
    below 1e-5 / n.  Returns ``(v, steps, host_reads)``."""
    # compared in float32, as the JAX loop compares it
    tol = float(np.float32(1e-5 / max(n, 1)))
    deg = torch.zeros(n, dtype=w.dtype, device=w.device).index_add_(
        0, src, w)
    inv_deg = torch.where(deg > 0, 1.0 / deg.clamp_min(1e-30),
                          torch.zeros_like(deg))
    v = v0 / v0.abs().sum().clamp_min(1e-30)
    prev_delta = torch.tensor(float("inf"), dtype=w.dtype, device=w.device)
    it, reads = 0, 0
    while it < max_iter:
        av = torch.zeros_like(v).index_add_(0, src, w * v[dst])
        nv = inv_deg * av
        nv = nv / nv.abs().sum().clamp_min(1e-30)
        delta = (nv - v).abs().max()
        accel = (delta - prev_delta).abs()
        v, prev_delta, it = nv, delta, it + 1
        reads += 1
        if not float(accel) > tol:
            break
    return v, it, reads


class PowerIterationClustering(Params):
    """Not an Estimator/Model pair — like Spark, PIC is a one-shot
    ``assignClusters`` over an edge frame.  Runs on ``device`` (default
    ``cuda``)."""

    srcCol = Param("source vertex id column", default="src")
    dstCol = Param("destination vertex id column", default="dst")
    weightCol = Param("optional similarity column (default 1.0)",
                      default=None)
    k = Param("number of clusters", default=2, validator=validators.gt(1))
    maxIter = Param("max power iterations", default=20,
                    validator=validators.gt(0))
    initMode = Param(
        "random | degree", default="random",
        validator=validators.one_of("random", "degree"),
    )
    seed = Param("random seed", default=0)

    def __init__(self, device="cuda", **kwargs):
        super().__init__(**kwargs)
        self.device = resolve_device(device)
        self.fit_stats = None

    def assignClusters(self, frame: Frame) -> Frame:
        src = np.asarray(to_host(frame[self.getSrcCol()])).astype(np.int64)
        dst = np.asarray(to_host(frame[self.getDstCol()])).astype(np.int64)
        wcol = self.getWeightCol()
        w = (
            np.asarray(to_host(frame[wcol]), np.float64)
            if wcol else np.ones(len(src), np.float64)
        )
        if np.any(w < 0):
            raise ValueError("similarities must be non-negative (Spark)")
        if np.any(src == dst):
            # mllib rejects self-similarity edges (the diagonal is 0)
            raise ValueError("self-loop edges (src == dst) are not allowed")
        # compact ids -> [0, n); the result reports the ORIGINAL ids
        ids, inv = np.unique(np.concatenate([src, dst]), return_inverse=True)
        s, d = inv[:len(src)], inv[len(src):]
        n = len(ids)
        # undirected: mirror every edge (Spark's graph construction)
        s2 = np.concatenate([s, d])
        d2 = np.concatenate([d, s])
        w2 = np.concatenate([w, w]).astype(np.float32)

        rng = np.random.default_rng(self.getSeed())
        if self.getInitMode() == "degree":
            deg = np.bincount(s2, weights=w2, minlength=n)
            v0 = (deg / max(deg.sum(), 1e-30)).astype(np.float32)
        else:
            # mllib random init: uniform in [0, 1), L1-normalised in the
            # loop
            v0 = rng.random(n).astype(np.float32)

        dev = self.device

        def on(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        v, steps, reads = power_iterate(
            on(s2.astype(np.int64)), on(d2.astype(np.int64)), on(w2), on(v0),
            n, int(self.getMaxIter()))
        v = v.cpu().numpy().astype(np.float64)

        km = KMeans(
            device=dev, k=int(self.getK()), seed=int(self.getSeed()),
            maxIter=40,
        ).fit(Frame({"features": v[:, None].astype(np.float32)}))
        assign = km.predict(v[:, None])
        self.fit_stats = {"power_steps": steps, "embedding": v,
                          "host_reads": reads + 1
                          + km.fit_stats["host_reads"]}
        return Frame({
            "id": ids.astype(np.int64),
            "cluster": assign.astype(np.int64),
        })
