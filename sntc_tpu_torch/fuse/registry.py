"""Capability registry — which fitted feature stages export a device fn.

Counterpart of ``sntc_tpu/fuse/registry.py``.  The fusion planner
(``sntc_tpu_torch.fuse.planner``) fuses a stage only when it can run it
as a PURE function of device tensors, ``apply(cols_in) -> cols_out``,
with the fitted stage's parameters (taken when the plan is built, or
read from the stage as its staged transform reads them).  Each such stage
registers a plan function ``(fitted stage) -> DevicePlan | None`` keyed
on its EXACT class (a subclass is not fused unless it is registered
here too).  It returns None when this instance must run eagerly
(``VectorAssembler`` in ``skip`` or ``error`` mode: row dropping and a
data-dependent raise are host decisions).

Bitwise contract: every ``apply`` does its stage's ``transform``
arithmetic operation for operation (same casts, same order), so a fused
segment's output equals the staged path's; the scalers', DCT's and
PCA's plans call the very functions their staged transforms call.

Registered: ``StandardScalerModel``, ``MinMaxScalerModel``,
``MaxAbsScalerModel``, ``RobustScalerModel``, ``PCAModel`` and ``DCT``
(the three scalers' elementwise float32 maps and the two full-f32
products run the same code as their staged transforms: the models'
``scale_tensor``, ``pca_project`` and ``dct_apply``),
``ChiSqSelectorModel``, ``UnivariateFeatureSelectorModel``,
``VarianceThresholdSelectorModel`` and ``VectorSlicer`` (column
gathers), ``ElementwiseProduct`` (float32 inputs only, as its host map
keeps the dtype), ``PolynomialExpansion``, ``Interaction`` and
``Bucketizer`` (float64 math; the Bucketizer in scalar mode with
``handleInvalid='keep'`` and open ends only, where no value can raise)
and ``VectorAssembler`` in ``keep`` mode: every stage the JAX registry
holds.  The JAX package builds its three float64 plans only under
``jax_enable_x64``; the port has float64 on every device and always
builds them.

A plan may carry ``flops(env)``: the FLOPs of its products on the bound
tensors, which the segment's roofline counts (``obs.cost``).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch

# read-binding policies: how a segment binds an EXTERNAL column a plan
# reads (columns made inside the segment arrive as device tensors)
F32_CAST = "f32cast"  # cast to float32 first (the stage's own cast)
F32_ONLY = "f32only"  # dtype-preserving op: float32 only, else eager
F64 = "f64"  # float64 math: bound as float64, whatever the column holds


class DevicePlan:
    """One fused stage: ``apply`` maps a dict of device tensors to the
    stage's written columns, doing exactly the host transform's math."""

    __slots__ = ("reads", "writes", "apply", "read_policy", "flops")

    def __init__(
        self,
        reads: List[str],
        writes: List[str],
        apply: Callable[[dict], dict],
        read_policy: str = F32_CAST,
        flops: Optional[Callable[[dict], float]] = None,
    ):
        self.reads = list(reads)
        self.writes = list(writes)
        self.apply = apply
        self.read_policy = read_policy
        self.flops = flops


_REGISTRY: Dict[type, Callable] = {}


def _register(cls: type):
    """``@_register(StageType)`` marks ``plan_fn(stage) -> DevicePlan |
    None`` as StageType's exporter."""

    def deco(plan_fn):
        _REGISTRY[cls] = plan_fn
        return plan_fn

    return deco


def device_plan_for(stage) -> Optional[DevicePlan]:
    """The stage's device plan, or None when it (or this configuration
    of it) runs eagerly.  Exact-type lookup, never MRO."""
    plan_fn = _REGISTRY.get(type(stage))
    if plan_fn is None:
        return None
    return plan_fn(stage)


def _on(cache: dict, a: np.ndarray, device) -> torch.Tensor:
    """``a`` as a tensor on ``device``, uploaded once per device."""
    t = cache.get(device)
    if t is None:
        t = cache[device] = torch.from_numpy(a).to(device)
    return t


def _register_builtin() -> None:
    from sntc_tpu_torch.feature.chisq_selector import ChiSqSelectorModel
    from sntc_tpu_torch.feature.dct import DCT, dct_apply
    from sntc_tpu_torch.feature.discretizers import (
        Bucketizer,
        bucketize_tensor,
    )
    from sntc_tpu_torch.feature.encoders import (
        ElementwiseProduct,
        VectorSlicer,
        scale_tensor,
    )
    from sntc_tpu_torch.feature.expansion import (
        Interaction,
        PolynomialExpansion,
        expand_tensor,
        interact_tensors,
    )
    from sntc_tpu_torch.feature.pca import PCAModel, pca_project
    from sntc_tpu_torch.feature.scalers import (
        MaxAbsScalerModel,
        MinMaxScalerModel,
        RobustScalerModel,
    )
    from sntc_tpu_torch.feature.standard_scaler import StandardScalerModel
    from sntc_tpu_torch.feature.univariate_selector import (
        UnivariateFeatureSelectorModel,
    )
    from sntc_tpu_torch.feature.variance_selector import (
        VarianceThresholdSelectorModel,
    )
    from sntc_tpu_torch.feature.vector_assembler import VectorAssembler
    from sntc_tpu_torch.obs.cost import matmul_flops

    @_register(StandardScalerModel)
    def _standard_scaler(m):
        mu, f = m.affine()  # float64, the one source of both paths
        mu32, f32 = mu.astype(np.float32), f.astype(np.float32)
        with_mean, with_std = m.getWithMean(), m.getWithStd()
        inp, out = m.getInputCol(), m.getOutputCol()
        mu_on, f_on = {}, {}

        def apply(cols):
            x = cols[inp].to(torch.float32)
            if with_mean:
                x = x - _on(mu_on, mu32, x.device)
            if with_std:
                x = x * _on(f_on, f32, x.device)
            return {out: x}

        return DevicePlan([inp], [out], apply)

    def _scaler_plan(m):
        # the model's own tensor map: the staged transform's operations
        inp, out = m.getInputCol(), m.getOutputCol()
        return DevicePlan([inp], [out],
                          lambda cols: {out: m.scale_tensor(cols[inp])})

    for cls in (MinMaxScalerModel, MaxAbsScalerModel, RobustScalerModel):
        _register(cls)(_scaler_plan)

    @_register(PCAModel)
    def _pca(m):
        inp, out = m.getInputCol(), m.getOutputCol()
        d, k = m.pc.shape

        def apply(cols):
            x = cols[inp]
            return {out: pca_project(x, m.pc_on(x.device))}

        return DevicePlan([inp], [out], apply, flops=lambda env: matmul_flops(
            env[inp].shape[0], d, k))

    @_register(DCT)
    def _dct(m):
        inp, out = m.getInputCol(), m.getOutputCol()

        def apply(cols):
            x = cols[inp]
            if x.ndim != 2:  # the staged transform's ValueError
                raise ValueError("inputCol must be a vector column")
            return {out: dct_apply(x, m.basis_on(x.shape[1], x.device))}

        def flops(env):
            n, f = env[inp].shape
            return matmul_flops(n, f, f)

        return DevicePlan([inp], [out], apply, flops=flops)

    def _gather_plan(inp, out, idx):
        idx = np.asarray(idx, np.int64)
        idx_on = {}

        def apply(cols):
            x = cols[inp]
            if len(idx) and (idx.min() < 0 or idx.max() >= x.shape[1]):
                raise ValueError(
                    f"indices out of range for vector width {x.shape[1]}"
                )
            return {out: x.index_select(1, _on(idx_on, idx, x.device))}

        # dtype-preserving on the host (f64 in -> f64 out): fuse f32 only
        return DevicePlan([inp], [out], apply, read_policy=F32_ONLY)

    @_register(VectorSlicer)
    def _vector_slicer(m):
        idx = m.getIndices()
        if not idx:
            return None  # unset: the eager path raises the right error
        return _gather_plan(m.getInputCol(), m.getOutputCol(), idx)

    @_register(ElementwiseProduct)
    def _elementwise_product(m):
        w = m.getScalingVec()
        if w is None:
            return None
        w32 = np.asarray(w, np.float32)
        inp, out = m.getInputCol(), m.getOutputCol()
        w_on = {}

        def apply(cols):
            x = cols[inp]
            if w32.shape != (x.shape[1],):
                raise ValueError(
                    f"scalingVec length {w32.shape[0]} != vector width "
                    f"{x.shape[1]}"
                )
            return {out: scale_tensor(x, _on(w_on, w32, x.device))}

        # dtype-preserving on the host (f64 in -> f64 out): fuse f32 only
        return DevicePlan([inp], [out], apply, read_policy=F32_ONLY)

    @_register(PolynomialExpansion)
    def _poly_expansion(m):
        degree = int(m.getDegree())
        inp, out = m.getInputCol(), m.getOutputCol()

        def apply(cols):
            x = cols[inp]
            if x.ndim != 2:
                raise ValueError(
                    f"inputCol {inp!r} must be a vector column"
                )
            return {out: expand_tensor(x, degree)}

        return DevicePlan([inp], [out], apply, read_policy=F64)

    @_register(Interaction)
    def _interaction(m):
        names = m.getInputCols()
        if not names or len(names) < 2:
            return None
        out = m.getOutputCol()
        return DevicePlan(
            list(names), [out],
            lambda cols: {out: interact_tensors([cols[n] for n in names])},
            read_policy=F64)

    @_register(Bucketizer)
    def _bucketizer(m):
        if m.getInputCols():
            return None  # multi-column mode: eager (scope: scalar mode)
        if m.getHandleInvalid() != "keep":
            return None  # 'error' raises on NaN, 'skip' drops rows
        try:
            splits = m._splits()
        except ValueError:
            return None  # malformed splits: the eager path raises
        if not (np.isneginf(splits[0]) and np.isposinf(splits[-1])):
            # closed ends ALWAYS raise on out-of-range values (Spark):
            # a data-dependent check only the host can make
            return None
        inp, out = m.getInputCol(), m.getOutputCol()
        last = float(splits[-1])

        def apply(cols):
            v = cols[inp]
            return {out: bucketize_tensor(v, m.splits_on(splits, v.device),
                                          last)}

        return DevicePlan([inp], [out], apply, read_policy=F64)

    @_register(ChiSqSelectorModel)
    def _chisq_selector(m):
        return _gather_plan(
            m.getFeaturesCol(), m.getOutputCol(), m.selected_features
        )

    @_register(UnivariateFeatureSelectorModel)
    def _univariate_selector(m):
        return _gather_plan(
            m.getFeaturesCol(), m.getOutputCol(), m.selected_features
        )

    @_register(VarianceThresholdSelectorModel)
    def _variance_selector(m):
        return _gather_plan(
            m.getFeaturesCol(), m.getOutputCol(), m.selectedFeatures
        )

    @_register(VectorAssembler)
    def _vector_assembler(m):
        # 'error' raises on NaN rows and 'skip' drops them: both are
        # data-dependent host decisions a pure device fn cannot make
        if m.getHandleInvalid() != "keep":
            return None
        ins = m.getInputCols()
        if not ins:
            return None
        out = m.getOutputCol()

        def apply(cols):
            parts = []
            for name in ins:
                c = cols[name].to(torch.float32)
                parts.append(c[:, None] if c.ndim == 1 else c)
            return {out: torch.cat(parts, dim=1)}

        return DevicePlan(list(ins), [out], apply)


_register_builtin()
