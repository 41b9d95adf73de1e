"""Whole-pipeline fusion compiler — one device program per fusible run.

Counterpart of ``sntc_tpu/fuse/planner.py``.  ``compile_pipeline``
turns a fitted ``PipelineModel`` into its serving form:

1. **rewrite** — algebraic folds first (``fuse.rules``: scaler → LR/MLP
   weights);
2. **partition** — the stage list splits into MAXIMAL runs of stages
   whose fitted instances export a device fn (``fuse.registry``); a
   classifier head with a packed device program (``has_device_serve``)
   ends its run;
3. **segment** — each run becomes one :class:`FusedSegment`: its input
   columns are bound once (uploaded when still on the host, taken as
   they are when already on the device), every plan's ``apply`` runs on
   device tensors, the head's ``_predict_all_dev`` packs raw | prob |
   prediction, and finalize copies the outputs to the host once.

Stages that cannot fuse (row-dropping ``handleInvalid='skip'``, host
string columns) stay eager between segments.  The ``VALID_COL`` mask is
never a plan read or write: outputs are layered onto the segment's
INPUT frame, so the mask rides through untouched and the predictor's
finalize strips the pad tail as in the staged form.

There is no jit here: a "program" is the plans' tensor code, launched
eagerly, and ``compile_events`` counts the distinct input signatures
(shapes, dtypes, device) a segment has seen — the shape ledger the two
packages are compared on.  A failure inside a segment raises and fails
its batch: no eager retry, no poisoned signatures.  With a device fault
domain attached (:func:`attach_device_domain`, which ``BatchPredictor``
calls), a CUDA error in a segment's dispatch or finalize is re-raised as
a ``DeviceExecError`` naming the segment and its input signature, so it
classifies at the predictor.  ``_bind`` returning
None is not a failure but the plan's dtype rule (an ``F32_ONLY`` gather
over a non-float32 column runs the eager stages), counted in
``fallbacks``.  Both counts are mirrored into
``sntc_fuse_compile_events_total`` and ``sntc_fuse_fallbacks_total``.

Observability, at the JAX planner's sites: a dispatch runs in the span
``fuse.dispatch`` and a finalize's copy back in ``fuse.finalize``
(``obs.trace``; free while tracing is off).  Under
``SNTC_OBS_COST_ANALYSIS`` a segment counts each fresh signature's cost
from its bound shapes (``cost_analyses``: the FLOPs of its plans' and
its head's products, the bytes of its inputs read once and its outputs
written once), times every dispatch to its host copy
(``cost_timings``: ``[seconds, invocations]`` per signature), publishes
``sntc_mfu_ratio`` / ``sntc_mfu_bw_ratio`` per segment at each finalize
(``obs.cost.emit_mfu``), and :func:`fusion_stats` adds the
``cost_analysis`` and ``roofline`` blocks.
"""

from __future__ import annotations

import threading
import time
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from sntc_tpu_torch.core.base import PipelineModel, Transformer
from sntc_tpu_torch.core.frame import Frame, to_host
from sntc_tpu_torch.feature.vector_assembler import VectorAssembler
from sntc_tpu_torch.fuse.registry import (
    F32_CAST,
    F32_ONLY,
    F64,
    DevicePlan,
    device_plan_for,
)
from sntc_tpu_torch.fuse.rules import fold_scalers
from sntc_tpu_torch.models.base import ClassificationModel
from sntc_tpu_torch.obs import cost as obs_cost
from sntc_tpu_torch.obs.metrics import inc
from sntc_tpu_torch.obs.trace import span
from sntc_tpu_torch.utils.profiling import active_ledgers


# the bind casts of the casting policies (F32_ONLY binds float32 only)
_NP_DTYPE = {F32_CAST: np.float32, F64: np.float64}
_TORCH_DTYPE = {F32_CAST: torch.float32, F64: torch.float64}


def _concrete(device) -> torch.device:
    """``device`` with its index: a tensor's device always has one, so
    "cuda" must become "cuda:<current>" to compare equal to it."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _fusible_head(stage) -> bool:
    return isinstance(stage, ClassificationModel) and stage.has_device_serve()


class FusedSegment(Transformer):
    """One maximal fusible run served as a single device dispatch.

    A segment with a head binds its inputs on the head's device; one
    without binds them where they live (on the device of its tensor
    inputs, else the CPU), as the staged stages would run."""

    def __init__(
        self,
        stages: Sequence[Transformer],
        plans: Sequence[DevicePlan],
        head: Optional[ClassificationModel] = None,
        keep: Iterable[str] = (),
    ):
        super().__init__()
        if len(stages) != len(plans):
            raise ValueError("one DevicePlan per fused stage required")
        self._stages = list(stages)
        self._plans = list(plans)
        self._head = head
        self._keep = frozenset(keep)
        self.device = _concrete(head.device) if head is not None else None
        # the segment's position in its plan, and the device fault domain
        # (attach_device_domain): the context a device error carries
        self.segment_index: Optional[int] = None
        self._domain = None
        self._signatures: set = set()
        self._lock = threading.Lock()
        self.compile_events = 0  # distinct input signatures
        self.invocations = 0  # fused dispatches
        self.fallbacks = 0  # eager serves (empty frame / dtype rule)
        self.uploads = 0  # arguments bound from the host
        self.device_binds = 0  # arguments bound as they were, on device
        self.downloads = 0  # outputs copied to the host
        self.mesh_splits = 0  # dispatches split over a serve mesh
        # the roofline plane (SNTC_OBS_COST_ANALYSIS): per signature
        # repr, the counted cost and [seconds, invocations]
        self.cost_analyses: dict = {}
        self.cost_timings: dict = {}

        # external inputs: the first reading plan's policy decides the
        # bind.  Two plans reading ONE external column under different
        # policies cannot share a segment (the first one's cast would
        # bypass the other's dtype rule); the planner splits such runs.
        external: List[Tuple[str, str]] = []
        produced: set = set()
        policies: dict = {}
        for plan in self._plans:
            for r in plan.reads:
                if r in produced:
                    continue
                if r not in policies:
                    policies[r] = plan.read_policy
                    external.append((r, plan.read_policy))
                elif policies[r] != plan.read_policy:
                    raise ValueError(
                        f"conflicting read policies for column {r!r} "
                        f"({policies[r]} vs {plan.read_policy}): split "
                        "these stages into separate segments"
                    )
            produced.update(plan.writes)
        if head is not None:
            # the head casts its features to float32 itself, so any
            # bind of an external features column is compatible
            fc = head.getFeaturesCol()
            if fc not in produced and fc not in policies:
                external.append((fc, F32_CAST))
        self._external = external

        # liveness: a written column whose final value only this segment
        # reads never leaves the device; leaf outputs and `keep` columns
        # (those a later stage reads) are copied out
        write_order: List[str] = []
        last_writer: dict = {}
        for i, plan in enumerate(self._plans):
            for w in plan.writes:
                if w in write_order:
                    write_order.remove(w)
                write_order.append(w)
                last_writer[w] = i
        head_reads = {head.getFeaturesCol()} if head is not None else set()
        self._live_writes = [
            w
            for w in write_order
            if w in self._keep
            or not (
                w in head_reads
                or any(
                    w in self._plans[j].reads
                    for j in range(last_writer[w] + 1, len(self._plans))
                )
            )
        ]

    # -- introspection ------------------------------------------------------

    @property
    def fused_stages(self) -> List[Transformer]:
        """The original fitted stages of this segment (head last)."""
        out = list(self._stages)
        if self._head is not None:
            out.append(self._head)
        return out

    def input_columns(self) -> List[str]:
        return [name for name, _ in self._external]

    def __repr__(self) -> str:
        names = ", ".join(type(s).__name__ for s in self.fused_stages)
        return f"FusedSegment[{names}]"

    # -- execution ----------------------------------------------------------

    def _bind(self, frame: Frame):
        """``(tensors, host_arrays)`` for the segment's inputs, cast per
        policy, or None when an ``F32_ONLY`` plan sees a non-float32
        column (the eager stages keep its exact semantics).  A column
        already on the segment's device is bound as it is; a host column
        is cast on the host, as the JAX package casts it, and uploaded
        (``host_arrays``, for the ledger)."""
        cols = [frame[name] for name, _ in self._external]
        dev = self.device
        if dev is None:  # no head: run where the inputs live
            dev = next((c.device for c in cols
                        if isinstance(c, torch.Tensor)), torch.device("cpu"))
        args, uploaded = [], []
        for col, (_name, policy) in zip(cols, self._external):
            if isinstance(col, torch.Tensor) and col.device == dev:
                if policy == F32_ONLY:
                    if col.dtype != torch.float32:
                        return None
                else:
                    col = col.to(_TORCH_DTYPE[policy])
                args.append(col)
                continue
            col = to_host(col)
            if policy == F32_ONLY:
                if col.dtype != np.float32:
                    return None
            else:
                col = col.astype(_NP_DTYPE[policy], copy=False)
            col = np.ascontiguousarray(col)
            uploaded.append(col)
            args.append(torch.from_numpy(col).to(dev))
        return args, uploaded

    def _transform_eager(self, frame: Frame) -> Frame:
        out = frame
        for stage in self._stages:
            out = stage.transform(out)
        if self._head is not None:
            out = self._head.transform(out)
        return out

    def transform(self, frame: Frame) -> Frame:
        return self.transform_async(frame)()

    def _device_error(self, e: BaseException, sig, during: str):
        """``e`` as a ``DeviceExecError`` naming this segment and ``sig``
        when a domain is attached and ``e`` is a CUDA failure, else
        None."""
        from sntc_tpu_torch.resilience.device import (
            DeviceExecError,
            classify_device_error,
        )

        if self._domain is None:
            return None
        kind = classify_device_error(e)
        if kind is None:
            return None
        return DeviceExecError(
            f"device {kind} while {during} fused segment "
            f"{self.segment_index} ({type(self).__name__}) signature "
            f"{_sig_repr(sig)}: {e}",
            kind=kind, segment=self.segment_index, signature=_sig_repr(sig),
        )

    def transform_async(self, frame: Frame):
        bound = self._bind(frame) if frame.num_rows else None
        if bound is None:
            with self._lock:
                self.fallbacks += 1
            inc("sntc_fuse_fallbacks_total")
            out = self._transform_eager(frame)
            return lambda: out
        args, uploaded = bound
        sig = tuple((tuple(a.shape), a.dtype, a.device) for a in args)
        # the ledgers to record into, taken at dispatch: finalize may
        # run on the delivery thread, outside the engine's scope
        ledgers = active_ledgers()
        nbytes = sum(a.nbytes for a in uploaded)
        for led in ledgers:
            led.record_uploads(len(uploaded), nbytes)
        head, live = self._head, self._live_writes
        sig_key = _sig_repr(sig)
        costed = obs_cost.enabled()
        platform, device_name = _platform(args[0].device) if costed \
            else (None, None)
        count = costed and sig_key not in self.cost_analyses
        t_disp = time.perf_counter() if costed else None
        try:
            with span("fuse.dispatch", args=len(args)):
                outs, flops = self._launch(args, head, live, count)
        except Exception as e:
            err = self._device_error(e, sig, "dispatching")
            if err is None:
                raise
            raise err from e
        with self._lock:
            fresh = sig not in self._signatures
            if fresh:
                self._signatures.add(sig)
                self.compile_events += 1
            self.invocations += 1
            self.uploads += len(uploaded)
            self.device_binds += len(args) - len(uploaded)
            if count:
                self.cost_analyses[sig_key] = {
                    "platform": platform,
                    "device_name": device_name,
                    "flops": flops,
                    "bytes accessed": float(
                        sum(a.nbytes for a in args)
                        + sum(o.nbytes for o in outs)),
                }
        if fresh:
            inc("sntc_fuse_compile_events_total")
        seg_index = self.segment_index

        def finalize() -> Frame:
            try:
                with span("fuse.finalize"):
                    host = [o.cpu().numpy() for o in outs]
            except Exception as e:
                # an execution error shows at this copy, on the delivery
                # thread in the pipelined engine
                err = self._device_error(e, sig, "finalizing")
                if err is None:
                    raise
                raise err from e
            nbytes = sum(h.nbytes for h in host)
            for led in ledgers:
                led.record_downloads(len(host), nbytes)
            with self._lock:
                self.downloads += len(host)
            if t_disp is not None:
                # dispatch to host copy: the roofline's time for this
                # signature; the gauges follow every batch
                dt = time.perf_counter() - t_disp
                with self._lock:
                    acc = self.cost_timings.setdefault(sig_key, [0.0, 0])
                    acc[0] += dt
                    acc[1] += 1
                    secs, inv = acc
                obs_cost.emit_mfu(
                    seg_index if seg_index is not None else 0,
                    obs_cost.roofline(self.cost_analyses.get(sig_key),
                                      secs, inv, platform, device_name))
            out_frame = frame
            for name, arr in zip(live, host[1:] if head is not None else host):
                out_frame = out_frame.with_column(name, arr)
            if head is not None:
                out_frame = head._with_packed(out_frame, host[0])
            return out_frame

        return finalize

    def _launch(self, args, head, live, count: bool = False):
        """Every plan's ``apply`` and the head's packed program on the
        bound tensors: the segment's device work.  Returns the outputs
        and, when ``count``, the FLOPs of their products (else 0).

        With a serve mesh of more than one shard
        (``parallel.context.get_serve_mesh``), a batch whose rows divide
        it is split into row blocks, one on each shard's device; the
        blocks run the same segment, the head's parameters replicated on
        each block's device (``replica_on``), and their outputs are
        concatenated on the first shard's device.  Any other batch
        dispatches unchanged, as in the JAX package (``_place_args``)."""
        blocks = _serve_blocks(args)
        if blocks is None:
            return self._launch_one(args, head, live, count)
        with self._lock:
            self.mesh_splits += 1
        parts = []
        for b in blocks:
            h = head
            if h is not None and _concrete(b[0].device) != self.device:
                h = head.replica_on(b[0].device)
            parts.append(self._launch_one(b, h, live, count))
        home = parts[0][0][0].device if parts[0][0] else None
        outs = [torch.cat([p[0][j].to(home) for p in parts])
                for j in range(len(parts[0][0]))]
        return outs, sum(p[1] for p in parts)

    def _launch_one(self, args, head, live, count: bool = False):
        env = dict(zip((n for n, _ in self._external), args))
        flops = 0.0
        for plan in self._plans:
            env.update(plan.apply(env))
            if count and plan.flops is not None:
                flops += plan.flops(env)
        outs = []
        if head is not None:
            x = env[head.getFeaturesCol()]
            outs.append(head._predict_all_dev(x))
            if count:
                flops += head.serve_flops(x.shape[0])
        outs.extend(env[w] for w in live)
        return outs, flops


def _serve_blocks(args):
    """The bound tensors split into one row block a serve-mesh shard,
    each on its shard's device, or None when no serve mesh of more than
    one shard is set or the rows do not divide it."""
    from sntc_tpu_torch.parallel.context import get_serve_mesh
    from sntc_tpu_torch.parallel.mesh import DATA_AXIS

    mesh = get_serve_mesh()
    if mesh is None or not args:
        return None
    size = int(mesh.shape.get(DATA_AXIS, 1))
    n = int(args[0].shape[0])
    if size <= 1 or n == 0 or n % size:
        return None
    per = n // size
    devices = mesh.data_devices()
    return [[a[s * per:(s + 1) * per].to(devices[s]) for a in args]
            for s in range(size)]


def _platform(device: torch.device):
    """The roofline's platform of a segment bound on ``device``, and
    the card's name on a GPU."""
    if device.type == "cuda":
        return "gpu", torch.cuda.get_device_name(device)
    return "cpu", None


def _sig_repr(sig) -> str:
    """The input signature as text: the shapes and dtypes bound."""
    return repr([(shape, str(dtype)) for shape, dtype, _dev in sig])


def compile_pipeline(
    pipeline: PipelineModel,
    keep: Iterable[str] = (),
    fuse_heads: bool = True,
) -> PipelineModel:
    """Compile a fitted PipelineModel for serving: rewrite rules first
    (scaler folding), then each maximal run of registry-fusible stages
    (plus a terminating device-servable classifier head) becomes one
    :class:`FusedSegment`; everything else passes through eagerly.

    ``keep`` names intermediate columns to copy out of a segment even
    when only a fused stage reads them; columns that later eager stages
    read are kept anyway.  ``fuse_heads=False`` fuses feature stages
    only (the head stays a plain stage), as tuning's prefix needs."""
    stages = fold_scalers(list(pipeline.getStages()))
    out: List[Transformer] = []
    i, n = 0, len(stages)
    while i < n:
        plan = device_plan_for(stages[i])
        if plan is None:
            out.append(stages[i])
            i += 1
            continue
        seg_stages: List[Transformer] = [stages[i]]
        seg_plans: List[DevicePlan] = [plan]
        seg_produced: set = set(plan.writes)
        seg_policies: dict = {r: plan.read_policy for r in plan.reads}
        i += 1
        while i < n:
            p = device_plan_for(stages[i])
            if p is None:
                break
            # a stage reading a shared EXTERNAL column under another
            # policy than the run already binds it with would skip its
            # own dtype rule: it starts a new segment instead
            if any(
                r not in seg_produced
                and seg_policies.get(r, p.read_policy) != p.read_policy
                for r in p.reads
            ):
                break
            for r in p.reads:
                if r not in seg_produced:
                    seg_policies.setdefault(r, p.read_policy)
            seg_produced.update(p.writes)
            seg_stages.append(stages[i])
            seg_plans.append(p)
            i += 1
        head = None
        if fuse_heads and i < n and _fusible_head(stages[i]):
            head = stages[i]
            i += 1
        # single-upload rule: an assembler LEADING a segment would turn
        # the one upload into one upload per input column — its host
        # stack is the upload's preparation, so it runs eagerly
        while (
            seg_plans
            and isinstance(seg_stages[0], VectorAssembler)
            and len(seg_plans[0].reads) > 1
        ):
            out.append(seg_stages.pop(0))
            seg_plans.pop(0)
        if not seg_plans:
            if head is not None:
                out.append(head)
            continue
        later_reads = set(keep)
        for later in stages[i:]:
            later_reads.update(later.input_columns())
        seg = FusedSegment(seg_stages, seg_plans, head=head,
                           keep=later_reads)
        seg.segment_index = sum(isinstance(x, FusedSegment) for x in out)
        out.append(seg)
    return PipelineModel(stages=out)


def attach_device_domain(model, domain) -> int:
    """Hand a ``DeviceFaultDomain`` to every fused segment of ``model``
    (``BatchPredictor`` does, at construction): a segment's CUDA errors
    are then re-raised as ``DeviceExecError`` with its context.  No
    signature is poisoned and nothing falls back.  Returns the segment
    count."""
    segs = fused_segments(model)
    for i, seg in enumerate(segs):
        seg._domain = domain
        if seg.segment_index is None:
            seg.segment_index = i
    return len(segs)


def fused_segments(model) -> List[FusedSegment]:
    """Every FusedSegment reachable from ``model`` (PipelineModels are
    walked recursively; a BatchPredictor's wrapped model too)."""
    segs: List[FusedSegment] = []
    stack = [model]
    while stack:
        node = stack.pop()
        if isinstance(node, FusedSegment):
            segs.append(node)
        elif isinstance(node, PipelineModel):
            stack.extend(node.getStages())
        elif hasattr(node, "model") and isinstance(node.model, Transformer):
            stack.append(node.model)
    return segs


def fusion_stats(model) -> Optional[dict]:
    """Fusion evidence of ``model``: segment count, signature ledger,
    fallbacks and THIS model's transfer counters (per-segment sums; the
    process-wide view is ``utils.profiling.transfer_ledger``).  None
    when the model holds no fused segment."""
    segs = fused_segments(model)
    if not segs:
        return None
    out = {
        "segments": len(segs),
        "fused_stages": sum(len(s.fused_stages) for s in segs),
        "compile_events": sum(s.compile_events for s in segs),
        "invocations": sum(s.invocations for s in segs),
        "fallbacks": sum(s.fallbacks for s in segs),
        "uploads": sum(s.uploads for s in segs),
        "device_binds": sum(s.device_binds for s in segs),
        "downloads": sum(s.downloads for s in segs),
    }
    # keyed per segment: two segments may bind equal shapes
    costs = {f"segment{i}:{sig}": cost for i, s in enumerate(segs)
             for sig, cost in s.cost_analyses.items()}
    if costs:  # only under SNTC_OBS_COST_ANALYSIS
        out["cost_analysis"] = costs
        roof = {}
        for i, s in enumerate(segs):
            for sig, cost in s.cost_analyses.items():
                secs, inv = s.cost_timings.get(sig, (0.0, 0))
                roof[f"segment{i}:{sig}"] = obs_cost.roofline(
                    cost, secs, inv, cost["platform"], cost["device_name"])
        out["roofline"] = roof
    return out
