"""ALS — collaborative filtering by alternating least squares.

Counterpart of ``sntc_tpu/models/als.py`` (Spark's ``ALS``):
``userCol``/``itemCol``/``ratingCol``, ``rank`` (10), ``maxIter`` (10),
``regParam`` (0.1) scaled per least-squares problem by that row's rating
count (ALS-WR), ``implicitPrefs`` with ``alpha`` confidence (Hu-Koren:
c = 1 + α·r, preference 1 at observed cells), ``coldStartStrategy`` nan
| drop, ``nonnegative`` (each row's regularised normal system solved
under x ≥ 0), ``seed``; the model has ``userFactors``/``itemFactors``,
``transform`` over (user, item) pairs, ``recommendForAllUsers`` and
``recommendForAllItems``.

The init is numpy from the seed, as in the JAX package.  One half-step
(all users, or all items) runs on the estimator's device: the normal
equations' statistics (:func:`normal_stats`) are ``index_add_`` of the
per-rating outer products in chunks of ``_CHUNK`` ratings, accumulated
on the device (the JAX package brings each chunk's partials to the
host); implicit mode adds the shared Gram ``YᵀY``, computed there too.
With a ``mesh=`` of more than one shard the ratings are sharded once per
fit (both sides' row and factor ids) and each half-step's statistics are
one ``make_tree_aggregate``: every shard gathers the replicated factors
of the other side for its ratings, masked by the padding weights, and
the shards' partials are summed.
Every row then solves at once: a batched Cholesky solve
(:func:`solve_all`), or under ``nonnegative`` a batched projected
cyclic coordinate descent (:func:`solve_all_nnls`) in which each row
stops on its own test, as the JAX package's ``vmap`` of a ``while_loop``
does — the rows' active mask lives on the device and the host reads
whether any row is left once a sweep.  Products run in full float32.
"""

from __future__ import annotations

import numpy as np
import torch

from sntc_tpu_torch.core.base import Estimator, Model
from sntc_tpu_torch.core.frame import Frame, to_host
from sntc_tpu_torch.core.params import Param, validators
from sntc_tpu_torch.device import resolve_device
from sntc_tpu_torch.parallel.collectives import (
    fit_device,
    fit_mesh,
    make_tree_aggregate,
    shard_batch,
)
from sntc_tpu_torch.ops.lbfgs import full_f32

_CHUNK = 250_000  # ratings per outer-product chunk (memory: _CHUNK·r² f32)
_NNLS_TOL = 1e-6
_NNLS_MAX_SWEEPS = 500


def normal_stats(rows: torch.Tensor, other_idx: torch.Tensor,
                 other: torch.Tensor, ratings: torch.Tensor, n_rows: int,
                 implicit: bool, alpha: float, wm=None, gram: bool = True):
    """One side's normal equations on the device: ``(A [n, r, r], b [n,
    r], cnt [n])`` with, per rating of row ``u`` against factor ``v``,

    explicit:  ``A += v vᵀ``,        ``b += r·v``;
    implicit:  ``A += (c−1) v vᵀ``,  ``b += c·v``   (c = 1 + α·r),

    plus ``YᵀY`` on every row in implicit mode (unless ``gram`` is off:
    a shard's partial leaves it to the reduced sum).  ``wm`` weighs each
    rating (a shard's padding mask)."""
    r = other.shape[1]
    dev = other.device
    A = torch.zeros((n_rows, r, r), dtype=torch.float32, device=dev)
    b = torch.zeros((n_rows, r), dtype=torch.float32, device=dev)
    cnt = torch.zeros(n_rows, dtype=torch.float32, device=dev)
    for s in range(0, rows.shape[0], _CHUNK):
        rs = rows[s:s + _CHUNK]
        fo = other.index_select(0, other_idx[s:s + _CHUNK])
        rr = ratings[s:s + _CHUNK]
        if implicit:
            scale = alpha * rr  # c − 1
            rhs_w = 1.0 + alpha * rr
        else:
            scale, rhs_w = None, rr
        one = torch.ones_like(rr)
        if wm is not None:
            m = wm[s:s + _CHUNK]
            scale = m if scale is None else m * scale
            rhs_w, one = m * rhs_w, m
        outer = fo[:, :, None] * fo[:, None, :]
        if scale is not None:
            outer = scale[:, None, None] * outer
        A.index_add_(0, rs, outer)
        b.index_add_(0, rs, rhs_w[:, None] * fo)
        cnt.index_add_(0, rs, one)
    if implicit and gram:
        # Hu-Koren: every row shares the full Gram YᵀY
        with full_f32():
            A += (other.t() @ other)[None, :, :]
    return A, b, cnt


def _regularised(A: torch.Tensor, reg: torch.Tensor) -> torch.Tensor:
    r = A.shape[1]
    eye = torch.eye(r, dtype=A.dtype, device=A.device)
    return A + reg[:, None, None] * eye


def solve_all(A: torch.Tensor, b: torch.Tensor, reg: torch.Tensor):
    """``(A + diag(reg)) x = b`` for every row, by batched Cholesky."""
    L = torch.linalg.cholesky(_regularised(A, reg))
    return torch.cholesky_solve(b[:, :, None], L).squeeze(2), 0


def solve_all_nnls(A: torch.Tensor, b: torch.Tensor, reg: torch.Tensor):
    """``argmin_{x≥0} ½xᵀ(A+diag(reg))x − bᵀx`` per row by projected
    cyclic coordinate descent: each coordinate's exact minimiser clipped
    at 0, swept until the row's largest update stalls below
    ``_NNLS_TOL``·(1 + max|x|) or ``_NNLS_MAX_SWEEPS`` sweeps.  A row
    that has stopped keeps its x.  Returns ``(x, host_reads)``."""
    m = _regularised(A, reg)
    n, r = b.shape
    diag = torch.diagonal(m, dim1=1, dim2=2).clamp_min(1e-12)
    x = torch.zeros_like(b)
    active = torch.ones(n, dtype=torch.bool, device=b.device)
    sweeps = torch.zeros(n, dtype=torch.int32, device=b.device)
    reads = 0
    with full_f32():
        for _ in range(_NNLS_MAX_SWEEPS):
            x_new = x.clone()
            for j in range(r):
                g = (m[:, j, :] * x_new).sum(dim=1) - b[:, j]
                x_new[:, j] = (x_new[:, j] - g / diag[:, j]).clamp_min(0.0)
            delta = (x_new - x).abs().max(dim=1).values
            x = torch.where(active[:, None], x_new, x)
            sweeps += active.to(torch.int32)
            active &= (delta > _NNLS_TOL * (1.0 + x.abs().max(dim=1).values)
                       ) & (sweeps < _NNLS_MAX_SWEEPS)
            reads += 1
            if not bool(active.any()):
                break
    return x, reads


class _AlsParams:
    userCol = Param("user id column", default="user")
    itemCol = Param("item id column", default="item")
    ratingCol = Param("rating column", default="rating")
    predictionCol = Param("output prediction column", default="prediction")
    rank = Param("factor dimension", default=10, validator=validators.gt(0))
    maxIter = Param("alternation rounds", default=10,
                    validator=validators.gt(0))
    regParam = Param("λ, ALS-WR scaled by each row's rating count",
                     default=0.1, validator=validators.gteq(0))
    implicitPrefs = Param("Hu-Koren implicit feedback", default=False,
                          validator=validators.is_bool())
    alpha = Param("implicit confidence slope", default=1.0,
                  validator=validators.gteq(0))
    coldStartStrategy = Param(
        "nan | drop for unseen ids at transform", default="nan",
        validator=validators.one_of("nan", "drop"),
    )
    nonnegative = Param(
        "constrain factors to be non-negative (NNLS solves)",
        default=False, validator=validators.is_bool(),
    )
    seed = Param("random seed", default=0)


class ALS(_AlsParams, Estimator):
    """Fits on ``device`` (default ``cuda``); the model recommends
    there."""

    def __init__(self, device=None, mesh=None, **kwargs):
        super().__init__(**kwargs)
        self.mesh = mesh
        self.device = fit_device(device, mesh)

    def _fit(self, frame: Frame) -> "ALSModel":
        users = np.asarray(to_host(frame[self.getUserCol()])).astype(np.int64)
        items = np.asarray(to_host(frame[self.getItemCol()])).astype(np.int64)
        ratings = np.asarray(to_host(frame[self.getRatingCol()]), np.float32)
        implicit = bool(self.getImplicitPrefs())
        if implicit and np.any(ratings < 0):
            raise ValueError(
                "implicitPrefs requires non-negative ratings (they enter "
                "the confidence c = 1 + alpha*r)"
            )
        # dense ids in sorted-id order (the JAX package's lookup tables)
        uids, u = np.unique(users, return_inverse=True)
        iids, i = np.unique(items, return_inverse=True)
        n_u, n_i = len(uids), len(iids)
        rank = int(self.getRank())
        lam = float(self.getRegParam())
        alpha = float(self.getAlpha())

        rng = np.random.default_rng(self.getSeed())
        # Spark init: abs(normal)/sqrt(rank)-style small positive factors
        U = (np.abs(rng.normal(size=(n_u, rank))) / np.sqrt(rank)).astype(
            np.float32
        )
        V = (np.abs(rng.normal(size=(n_i, rank))) / np.sqrt(rank)).astype(
            np.float32
        )

        dev = self.device
        u_d = torch.from_numpy(u.astype(np.int64)).to(dev)
        i_d = torch.from_numpy(i.astype(np.int64)).to(dev)
        r_d = torch.from_numpy(ratings).to(dev)
        U_d, V_d = torch.from_numpy(U).to(dev), torch.from_numpy(V).to(dev)
        solver = solve_all_nnls if self.getNonnegative() else solve_all
        reads = 0

        mesh = fit_mesh(self.mesh)
        if mesh is not None:
            # the ratings sharded once; each side's aggregate built once
            sharded = shard_batch(mesh, u.astype(np.int64),
                                  i.astype(np.int64), ratings)
            aggs = {}
            for n_side in (n_u, n_i):
                if n_side in aggs:
                    continue

                def part(rows, oidx, rr, wm, other, _n=n_side):
                    return normal_stats(rows, oidx, other, rr, _n, implicit,
                                        alpha, wm=wm, gram=False)

                aggs[n_side] = make_tree_aggregate(
                    part, mesh, replicated_args=(4,), op="als.normal")

        def half_step(rows, other_idx, other, n_rows):
            if mesh is None:
                A, b, cnt = normal_stats(rows, other_idx, other, r_d,
                                         n_rows, implicit, alpha)
            else:
                su, si, sr, sw = sharded
                rs, oi = (su, si) if rows is u_d else (si, su)
                A, b, cnt = aggs[n_rows](rs, oi, sr, sw, other)
                if implicit:
                    with full_f32():
                        A = A + (other.t() @ other)[None, :, :]
            # ALS-WR: λ scaled by the row's rating count; rows with no
            # ratings keep a bare λ ridge (and solve to 0)
            x, r = solver(A, b, lam * cnt.clamp_min(1.0))
            return x, r

        for _ in range(int(self.getMaxIter())):
            U_d, r1 = half_step(u_d, i_d, V_d, n_u)
            V_d, r2 = half_step(i_d, u_d, U_d, n_i)
            reads += r1 + r2

        model = ALSModel(
            userIds=uids, itemIds=iids, userFactors=U_d.cpu().numpy(),
            itemFactors=V_d.cpu().numpy(), device=dev,
        )
        model.setParams(**self.paramValues())
        model.fit_stats = {"host_reads": reads + 2}
        return model


class ALSModel(_AlsParams, Model):
    def __init__(self, userIds, itemIds, userFactors, itemFactors,
                 device="cuda", **kwargs):
        super().__init__(**kwargs)
        self.userIds = np.asarray(userIds, np.int64)
        self.itemIds = np.asarray(itemIds, np.int64)
        self._uf = np.asarray(userFactors, np.float32)
        self._if = np.asarray(itemFactors, np.float32)
        self._u_lut = {int(v): j for j, v in enumerate(self.userIds)}
        self._i_lut = {int(v): j for j, v in enumerate(self.itemIds)}
        self.device = resolve_device(device)
        self.fit_stats = None

    @property
    def rank(self) -> int:
        return self._uf.shape[1]

    @property
    def userFactors(self) -> Frame:
        return Frame({"id": self.userIds, "features": self._uf})

    @property
    def itemFactors(self) -> Frame:
        return Frame({"id": self.itemIds, "features": self._if})

    def _save_extra(self):
        return {}, {
            "userIds": self.userIds, "itemIds": self.itemIds,
            "userFactors": self._uf, "itemFactors": self._if,
        }

    @classmethod
    def _load_from(cls, params, extra, arrays, device="cuda"):
        m = cls(
            userIds=arrays["userIds"], itemIds=arrays["itemIds"],
            userFactors=arrays["userFactors"],
            itemFactors=arrays["itemFactors"], device=device,
        )
        m.setParams(**params)
        return m

    def transform(self, frame: Frame) -> Frame:
        users = np.asarray(to_host(frame[self.getUserCol()])).astype(np.int64)
        items = np.asarray(to_host(frame[self.getItemCol()])).astype(np.int64)
        ui = np.array([self._u_lut.get(int(x), -1) for x in users])
        ii = np.array([self._i_lut.get(int(x), -1) for x in items])
        known = (ui >= 0) & (ii >= 0)
        pred = np.full(len(users), np.nan, np.float64)
        if known.any():
            pred[known] = np.einsum(
                "nr,nr->n",
                self._uf[ui[known]].astype(np.float64),
                self._if[ii[known]].astype(np.float64),
            )
        out = frame.with_column(self.getPredictionCol(), pred)
        if self.getColdStartStrategy() == "drop":
            out = out.filter(~np.isnan(pred))
        return out

    def _recommend(self, left, right, left_ids, right_ids, k):
        """Top-``k`` scores of every left factor against all right
        factors: one float32 product and ``topk`` on the model's
        device."""
        dev = self.device
        with full_f32():
            scores = (torch.from_numpy(left).to(dev)
                      @ torch.from_numpy(right).to(dev).t())
            vals, idx = torch.topk(scores, min(k, right.shape[0]), dim=1)
        return Frame({
            "id": left_ids,
            "recommendations": np.asarray(right_ids)[idx.cpu().numpy()],
            "ratings": vals.cpu().numpy().astype(np.float64),
        })

    def recommendForAllUsers(self, numItems: int) -> Frame:
        return self._recommend(
            self._uf, self._if, self.userIds, self.itemIds, numItems
        )

    def recommendForAllItems(self, numUsers: int) -> Frame:
        return self._recommend(
            self._if, self._uf, self.itemIds, self.userIds, numUsers
        )
