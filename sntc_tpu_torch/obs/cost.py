"""Roofline evidence plane for the fused serving segments.

Counterpart of ``sntc_tpu/obs/cost.py``.  The JAX package asks XLA's
``cost_analysis()`` for a compiled program's FLOPs and bytes; the port
has no compiled program to ask, so a fused segment counts them from its
bound shapes instead (``FusedSegment`` in ``fuse/planner.py``): the FLOPs of every matrix product
its plans and its head run (``2·M·K·N`` each; elementwise work is not
counted), and ``bytes accessed`` = every bound input read once plus
every output written once.  :func:`roofline` combines that count with
the measured wall time into achieved-against-peak numbers::

    achieved FLOP/s      = flops x invocations / seconds
    mfu                  = achieved FLOP/s / peak FLOP/s
    bw_util              = achieved bytes/s / peak bytes/s
    arithmetic intensity = flops / bytes accessed

The peaks are NVIDIA's data sheet for the H100 SXM5 80 GB (dense, no
sparsity, at the full 700 W power limit): 3.35 TB/s of HBM3, 989 TFLOP/s
in bf16 on the tensor cores, and 67 TFLOP/s in float32 outside them, the
rate of the full-f32 products these segments run (``mfu_f32``).  Every
roofline carries ``peak_source``: ``"datasheet"`` for a segment on a
card whose name (``torch.cuda.get_device_name``) is one of
``H100_NAMES``, ``"none"`` on any other card and on the CPU, where no
peak and no MFU are reported, so no other device's number is read
against the H100's peaks.

The plane is opt-in (``SNTC_OBS_COST_ANALYSIS``): the planner pays for
the count and a clock read a batch only when it is set.  It surfaces as
the catalogued ``sntc_mfu_ratio`` / ``sntc_mfu_bw_ratio`` gauges per
segment (:func:`emit_mfu`) and the ``roofline`` block of
``fuse.fusion_stats()``.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

#: NVIDIA H100 SXM5 80 GB data sheet (dense rates, 700 W)
H100_PEAKS = {
    "flops": 989e12,  # bf16 / fp16 tensor cores
    "flops_f32": 67e12,  # float32 outside the tensor cores
    "bw": 3.35e12,  # HBM3 bytes/s
    "peak_source": "datasheet",
    "device": "NVIDIA H100 SXM5 80GB",
}
#: the names CUDA gives the card those peaks belong to
H100_NAMES = ("NVIDIA H100 80GB HBM3",)


def enabled() -> bool:
    """True when the opt-in roofline plane is armed."""
    return bool(os.environ.get("SNTC_OBS_COST_ANALYSIS"))


def matmul_flops(m: int, k: int, n: int) -> float:
    """FLOPs of one ``[m, k] @ [k, n]`` product (a multiply and an add
    per term)."""
    return 2.0 * m * k * n


def peaks_for(platform: Optional[str],
              device_name: Optional[str] = None) -> Dict[str, Any]:
    """The peaks a roofline on ``platform`` is held against: the H100
    data sheet on a ``"cuda"`` / ``"gpu"`` card named in ``H100_NAMES``,
    none elsewhere."""
    gpu = platform in ("cuda", "gpu")
    if gpu and device_name in H100_NAMES:
        return {**H100_PEAKS, "platform": "gpu"}
    return {"flops": None, "flops_f32": None, "bw": None,
            "peak_source": "none", "device": device_name if gpu else None,
            "platform": "gpu" if gpu else (platform or "cpu")}


def roofline(
    cost: Optional[Dict[str, float]],
    seconds: float = 0.0,
    invocations: int = 0,
    platform: Optional[str] = None,
    device_name: Optional[str] = None,
) -> Optional[Dict[str, Any]]:
    """Achieved-against-peak accounting of one segment signature.

    ``cost`` holds ``flops`` and ``bytes accessed``; ``seconds`` is the
    measured wall time over ``invocations`` dispatches of it, on the
    card named ``device_name`` where ``platform`` is a GPU.  The static
    numbers report before any timing (warmup); the achieved rates appear
    with a measurement, and ``mfu`` / ``bw_util`` only where there is a
    peak."""
    if not cost:
        return None
    peaks = peaks_for(platform, device_name)
    flops = float(cost.get("flops", 0.0))
    nbytes = float(cost.get("bytes accessed", 0.0))
    out: Dict[str, Any] = {
        "flops": flops,
        "bytes_accessed": nbytes,
        "arithmetic_intensity": (flops / nbytes) if nbytes else None,
        "peak_flops": peaks["flops"],
        "peak_flops_f32": peaks["flops_f32"],
        "peak_bw": peaks["bw"],
        "peak_source": peaks["peak_source"],
        "peak_device": peaks["device"],
        "platform": peaks["platform"],
        "invocations": int(invocations),
        "seconds": float(seconds),
    }
    if seconds > 0 and invocations > 0:
        achieved_flops = flops * invocations / seconds
        achieved_bw = nbytes * invocations / seconds
        out["achieved_flops"] = achieved_flops
        out["achieved_bw"] = achieved_bw
        if peaks["flops"]:
            out["mfu"] = achieved_flops / peaks["flops"]
            out["mfu_f32"] = achieved_flops / peaks["flops_f32"]
            out["bw_util"] = achieved_bw / peaks["bw"]
    return out


def emit_mfu(segment: int, roof: Optional[Dict[str, Any]]) -> None:
    """Publish one segment's roofline onto the catalogued gauges
    (``sntc_mfu_ratio`` / ``sntc_mfu_bw_ratio``, labelled by segment);
    a roofline without a peak publishes nothing."""
    if not roof or "mfu" not in roof:
        return
    from sntc_tpu_torch.obs.metrics import set_gauge

    seg = str(segment)
    set_gauge("sntc_mfu_ratio", roof["mfu"], segment=seg)
    set_gauge("sntc_mfu_bw_ratio", roof["bw_util"], segment=seg)
