"""PolynomialExpansion / Interaction — monomial feature construction.

Counterpart of ``sntc_tpu/feature/expansion.py`` (Spark's stages of the
same names):

  * PolynomialExpansion(degree): every monomial of the input vector up
    to ``degree`` (no constant term), in Spark's ``expandDense`` order
    (:func:`_expansion_plan`): ``[x1, x1², x2, x1x2, x2², x3, ...]`` for
    degree 2; width C(n + d, d) − 1, float64.
  * Interaction: the full outer product of two or more columns (a
    numeric scalar counts as a width-1 vector), float64, laid out with
    the LAST input varying fastest (Spark's foldRight).

A numpy column is expanded on the host, as in the JAX package: a loop
over the plan, each monomial's factors multiplied left to right.  A
tensor column is expanded on its device (:func:`expand_tensor`): the
plan's monomials are grouped by degree and each group is one gather of
its first factors, then one gather and one product per further factor,
in the host loop's order.  An f64 product is exact IEEE, so the device
block equals the host one bitwise.  The fused segment
(``fuse.registry``) runs the same functions.
"""

from __future__ import annotations

from functools import lru_cache
from typing import List, Tuple

import numpy as np
import torch

from sntc_tpu_torch.core.base import Transformer
from sntc_tpu_torch.core.frame import Frame
from sntc_tpu_torch.core.params import Param, validators
from sntc_tpu_torch.utils.profiling import upload


@lru_cache(maxsize=None)
def _expansion_plan(n: int, degree: int) -> Tuple[Tuple[int, ...], ...]:
    """Spark-ordered monomial index tuples for n features up to degree.

    For each feature i, emit ``x_i``, then scan the WHOLE emitted list in
    order (entries appended during the scan included), multiplying each
    monomial below the degree cap by ``x_i``."""
    terms: List[Tuple[int, ...]] = []
    for i in range(n):
        terms.append((i,))
        j = 0
        while j < len(terms):
            m = terms[j]
            if len(m) < degree:
                terms.append(m + (i,))
            j += 1
    return tuple(terms)


@lru_cache(maxsize=None)
def _degree_groups(n: int, degree: int):
    """The plan grouped by monomial degree: ``[(positions [G],
    factors [G, L])]``, one entry a degree L, as numpy int64."""
    plan = _expansion_plan(n, degree)
    groups = []
    for length in range(1, degree + 1):
        pos = [j for j, t in enumerate(plan) if len(t) == length]
        if pos:
            groups.append((np.asarray(pos, np.int64),
                           np.asarray([plan[j] for j in pos], np.int64)))
    return tuple(groups)


@lru_cache(maxsize=64)
def _groups_on(n: int, degree: int, device: torch.device) -> tuple:
    """:func:`_degree_groups` as index tensors on ``device``: per degree,
    the output positions and one index vector per factor."""
    return tuple(
        (torch.from_numpy(pos).to(device),
         [torch.from_numpy(np.ascontiguousarray(f[:, k])).to(device)
          for k in range(f.shape[1])])
        for pos, f in _degree_groups(n, degree))


def expand_tensor(x: torch.Tensor, degree: int) -> torch.Tensor:
    """PolynomialExpansion of ``x [N, n]`` on its device, float64,
    bitwise the host loop's block."""
    x = x.to(torch.float64)
    n = x.shape[1]
    out = torch.empty((x.shape[0], len(_expansion_plan(n, degree))),
                      dtype=torch.float64, device=x.device)
    for pos, factors in _groups_on(n, degree, x.device):
        col = x.index_select(1, factors[0])
        for f in factors[1:]:  # the host loop's multiply order
            col = col * x.index_select(1, f)
        out.index_copy_(1, pos, col)
    return out


def interact_tensors(cols) -> torch.Tensor:
    """Interaction of the tensors ``cols`` (1-D or 2-D) on their device,
    float64, the LAST varying fastest."""
    mats = []
    for c in cols:
        c = c.to(torch.float64)
        mats.append(c[:, None] if c.ndim == 1 else c)
    acc = mats[0]
    for m in mats[1:]:
        acc = (acc[:, :, None] * m[:, None, :]).reshape(acc.shape[0], -1)
    return acc


class PolynomialExpansion(Transformer):
    inputCol = Param("input vector column")
    outputCol = Param("output expanded column", default="polyFeatures")
    degree = Param("max monomial degree", default=2,
                   validator=validators.gteq(1))

    def transform(self, frame: Frame) -> Frame:
        X = frame[self.getInputCol()]
        if X.ndim != 2:
            raise ValueError(
                f"inputCol {self.getInputCol()!r} must be a vector column"
            )
        degree = int(self.getDegree())
        if isinstance(X, torch.Tensor):
            return frame.with_column(self.getOutputCol(),
                                     expand_tensor(X, degree))
        X = np.asarray(X, np.float64)
        plan = _expansion_plan(X.shape[1], degree)
        out = np.empty((X.shape[0], len(plan)), np.float64)
        for j, idxs in enumerate(plan):
            col = X[:, idxs[0]].copy()
            for i in idxs[1:]:
                col *= X[:, i]
            out[:, j] = col
        return frame.with_column(self.getOutputCol(), out)


class Interaction(Transformer):
    inputCols = Param("columns to interact (vectors or numeric scalars)")
    outputCol = Param("output interaction column", default="interaction")

    def transform(self, frame: Frame) -> Frame:
        names = self.getInputCols()
        if not names or len(names) < 2:
            raise ValueError("Interaction needs at least two inputCols")
        cols = [frame[name] for name in names]
        device = next((c.device for c in cols
                       if isinstance(c, torch.Tensor)), None)
        if device is not None:
            # a host column among device ones is copied to their device
            return frame.with_column(self.getOutputCol(), interact_tensors([
                c.to(device) if isinstance(c, torch.Tensor)
                else upload(np.ascontiguousarray(c, np.float64), device)
                for c in cols]))
        mats = []
        for c in cols:
            c = np.asarray(c, np.float64)
            mats.append(c[:, None] if c.ndim == 1 else c)
        # Spark foldRight layout: LAST column varies fastest
        out = mats[0]
        for m in mats[1:]:
            out = (out[:, :, None] * m[:, None, :]).reshape(
                out.shape[0], -1
            )
        return frame.with_column(self.getOutputCol(), out)
