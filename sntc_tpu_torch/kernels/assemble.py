"""pad_assemble — bucket padding for the serve path, a CUDA kernel for Hopper.

Counterpart of ``sntc_tpu/kernels/assemble.py`` (``pad_rows_pallas``, the
Pallas kernel ``_pad_kernel``, driven per column by ``pad_assemble``).
``BatchPredictor`` rounds a batch up to its shape bucket by repeating the
last row and attaches a ``VALID_COL`` mask marking the real rows.

:func:`pad_rows` pads one ``[N, C]`` block: on a CUDA tensor it launches
``csrc/pad_rows.cu`` (:func:`pad_rows_cuda`) or raises; on a CPU tensor
it computes :func:`pad_rows_reference`.  Both are bitwise the numpy
repeat-last-row twin.

:func:`pad_assemble` does not pad column by column as the JAX package
does: a CICIDS2017 batch has 78 numeric columns, and a host→device→host
round trip per column would dominate the batch.  It stacks the 1-D
numeric columns of one item size (float64 and int64; float32 and int32)
into one ``[N, C]`` block, uploads it once, pads it in one launch and
leaves the padded block on the device; each column of the padded frame
is a view of it, in its own dtype (the copy moves bits, so an integer
column rides a float block exactly).  The assembled features then reach
the serve kernels without a second upload, and a CSV batch costs one
upload (recorded in the transfer ledger).  Other columns pad on the
host.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from sntc_tpu_torch.core.frame import Frame, to_host
from sntc_tpu_torch.kernels import _build
from sntc_tpu_torch.utils.profiling import upload

_DTYPES = {torch.float32: "f32", torch.float64: "f64"}
# numeric column dtypes padded on the device, by the float dtype of the
# block that carries their bits
_BLOCK_OF = {
    np.dtype(np.float64): np.float64, np.dtype(np.int64): np.float64,
    np.dtype(np.float32): np.float32, np.dtype(np.int32): np.float32,
}
_TORCH_OF = {
    np.dtype(np.float64): torch.float64, np.dtype(np.int64): torch.int64,
    np.dtype(np.float32): torch.float32, np.dtype(np.int32): torch.int32,
}
_NP_FLOATS = (np.float32, np.float64)


def _pad_column_np(a: np.ndarray, target: int) -> np.ndarray:
    """The numpy repeat-last-row twin (the JAX package's
    ``Frame.pad_rows`` on one column)."""
    pad = target - a.shape[0]
    tail = np.broadcast_to(a[-1:], (pad,) + a.shape[1:])
    return np.concatenate([a, tail])


def pad_rows_reference(a: torch.Tensor, target: int) -> torch.Tensor:
    """Plain version: the block followed by ``target - N`` copies of its
    last row."""
    n = a.shape[0]
    return torch.cat([a, a[n - 1:].expand(target - n, *a.shape[1:])])


def _check(a: torch.Tensor, target: int) -> None:
    if a.ndim != 2:
        raise ValueError(f"pad_rows takes an [N, C] block, got {tuple(a.shape)}")
    if a.shape[0] < 1:
        raise ValueError("cannot pad an empty block (no row to repeat)")
    if target < a.shape[0]:
        raise ValueError(f"pad target {target} < {a.shape[0]} rows")
    if a.dtype not in _DTYPES:
        raise TypeError(f"pad_rows takes float32 or float64, got {a.dtype}")


def pad_launch_shape(n: int, c: int, dtype: torch.dtype, target: int) -> str:
    """The key :data:`~sntc_tpu_torch.kernels._build.PAD_LAUNCH_SHAPES`
    counts a launch under."""
    return f"[{n}, {c}] {_DTYPES[dtype]} -> {target}"


def pad_rows_cuda(a: torch.Tensor, target: int) -> torch.Tensor:
    """Launch the CUDA kernel on a contiguous ``[N, C]`` CUDA block."""
    _check(a, target)
    if a.device.type != "cuda":
        raise ValueError(f"block is not on a CUDA device: {a.device}")
    if not a.is_contiguous():
        raise ValueError("block must be contiguous")
    n, c = a.shape
    out = torch.empty((target, c), dtype=a.dtype, device=a.device)
    if c == 0:
        return out
    lib = _build.library()
    fn = getattr(lib, f"sntc_pad_rows_{_DTYPES[a.dtype]}")
    with torch.cuda.device(a.device):
        err = fn(a.data_ptr(), out.data_ptr(), n, c, int(target),
                 _build.stream_handle(a.device))
    _build.check_launch(lib, err, "pad_assemble")
    _build.LAUNCHES["pad_assemble"] += 1
    shapes = _build.PAD_LAUNCH_SHAPES
    shape = pad_launch_shape(n, c, a.dtype, target)
    shapes[shape] = shapes.get(shape, 0) + 1
    return out


def pad_rows(a: torch.Tensor, target: int) -> torch.Tensor:
    """Pad ``[N, C]`` to ``[target, C]`` by repeating the last row: the
    CUDA kernel on a CUDA tensor, the plain version on a CPU tensor."""
    if a.device.type == "cuda":
        return pad_rows_cuda(a, target)
    if a.device.type == "cpu":
        _check(a, target)
        return pad_rows_reference(a, target)
    raise ValueError(f"unsupported device {a.device}")


def pad_assemble(frame: Frame, target: int, valid: np.ndarray,
                 device) -> Frame:
    """Bucket-pad ``frame`` to ``target`` rows by repeating its last row
    and attach the ``VALID_COL`` mask, with the numeric columns padded on
    ``device`` (see the module docs).  Column order and dtypes are
    kept."""
    from sntc_tpu_torch.serve.transform import VALID_COL

    device = torch.device(device)
    n = frame.num_rows
    host = {name: to_host(frame[name]) for name in frame.columns}
    cols: Dict[str, object] = dict.fromkeys(host)  # keeps the order
    groups: Dict[type, List[str]] = {}
    for name, a in host.items():
        if n == 0:
            cols[name] = _pad_column_np(a, target)
        elif a.ndim == 1 and a.dtype in _BLOCK_OF:
            groups.setdefault(_BLOCK_OF[a.dtype], []).append(name)
        elif a.ndim == 2 and a.dtype in _NP_FLOATS:
            cols[name] = pad_rows(
                upload(np.ascontiguousarray(a), device), target)
        else:
            cols[name] = _pad_column_np(a, target)
    for block_dtype, names in groups.items():
        # one upload and one launch for every column of this item size;
        # an integer column is stored as its bits
        block = np.empty((n, len(names)), block_dtype)
        for j, name in enumerate(names):
            block.view(host[name].dtype)[:, j] = host[name]
        padded = pad_rows(upload(block, device), target)
        for j, name in enumerate(names):
            cols[name] = padded[:, j].view(_TORCH_OF[host[name].dtype])
    cols[VALID_COL] = np.asarray(valid, dtype=bool)
    return Frame._wrap(cols, int(target))
