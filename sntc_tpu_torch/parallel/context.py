"""The process-wide default mesh and the serve mesh.

Counterpart of ``sntc_tpu/parallel/context.py``.  Estimators take an
explicit ``mesh=``; the ``train`` command passes
:func:`get_default_mesh`, built lazily over the visible devices of the
command's device type (the SparkContext analog).  On a host with one
card that is one shard on ``cuda:0``, and a one-shard mesh fits exactly
as no mesh does.

The serve mesh is separate and off by default: when it has more than
one shard, a fused segment splits a bucketed batch whose rows divide it
into row blocks, one a shard (``fuse.planner``).  It is armed by
:func:`set_serve_mesh` or by ``SNTC_SERVE_MESH_DEVICES=N`` (N > 1: the
first N CUDA devices).
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from sntc_tpu_torch.parallel.mesh import Mesh, default_mesh

_default: Optional[Mesh] = None
_built: dict = {}


def get_default_mesh(device="cuda") -> Mesh:
    """The mesh set by :func:`set_default_mesh`, else one over the
    visible devices of ``device``'s type (``device`` itself when it has
    an index), built once per device."""
    if _default is not None:
        return _default
    key = str(torch.device(device))
    mesh = _built.get(key)
    if mesh is None:
        mesh = _built[key] = default_mesh(device=device)
    return mesh


def set_default_mesh(mesh: Optional[Mesh]) -> None:
    global _default
    _default = mesh


_serve_mesh: Optional[Mesh] = None
_serve_set = False
_env_serve_meshes: dict = {}


def get_serve_mesh() -> Optional[Mesh]:
    """The mesh the serve plane splits fused dispatches over, or None
    (one-device dispatch)."""
    if _serve_set:
        return _serve_mesh
    try:
        n = int(os.environ.get("SNTC_SERVE_MESH_DEVICES", "0") or 0)
    except ValueError:
        return None
    if n <= 1:
        return None
    mesh = _env_serve_meshes.get(n)
    if mesh is None:
        mesh = _env_serve_meshes[n] = default_mesh(n)
    return mesh


def set_serve_mesh(mesh: Optional[Mesh]) -> None:
    """Pin the serve mesh, or clear it with ``None`` (which also keeps
    the environment knob off until :func:`reset_serve_mesh`)."""
    global _serve_mesh, _serve_set
    _serve_mesh = mesh
    _serve_set = True


def reset_serve_mesh() -> None:
    """Return serve-mesh resolution to the environment knob."""
    global _serve_mesh, _serve_set
    _serve_mesh = None
    _serve_set = False
