"""Mid-fit checkpoints: a boosting fit's state every N rounds.

Counterpart of ``sntc_tpu/mlio/optimizer_checkpoint.py``, in its
directory layout: ``<dir>/lbfgs_state.npz`` holds the state's arrays and
``<dir>/lbfgs_meta.json`` a fingerprint of the problem (shapes and
hyperparameters).  :func:`load_state` returns the state only when the
fingerprint matches, so a stale state never resumes into another
problem; a completed fit deletes it with :func:`clear_state`.

The state is npz only: the JAX package's orbax payload
(``SNTC_CHECKPOINT_FORMAT=orbax``) is not readable here, and a directory
holding one is refused.  The segmented LBFGS loop (``run_segmented``)
comes with the port's LBFGS.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Tuple

import numpy as np

_STATE_FILE = "lbfgs_state.npz"
_META_FILE = "lbfgs_meta.json"


def _paths(ckpt_dir: str) -> Tuple[str, str]:
    return (
        os.path.join(ckpt_dir, _STATE_FILE),
        os.path.join(ckpt_dir, _META_FILE),
    )


def save_state(ckpt_dir: str, state: Dict, fingerprint: Dict) -> None:
    """Write ``state`` (arrays or scalars) and its fingerprint."""
    os.makedirs(ckpt_dir, exist_ok=True)
    state_path, meta_path = _paths(ckpt_dir)
    np.savez(state_path, **{k: np.asarray(v) for k, v in state.items()})
    with open(meta_path, "w") as f:
        json.dump(fingerprint, f)


def load_state(ckpt_dir: str, fingerprint: Dict) -> Optional[Dict]:
    """The saved state, or None when there is none or it was saved for
    another fingerprint."""
    state_path, meta_path = _paths(ckpt_dir)
    if os.path.isdir(state_path + ".orbax"):
        raise NotImplementedError(
            f"{ckpt_dir}: orbax checkpoint payloads are not readable here"
        )
    if not (os.path.exists(state_path) and os.path.exists(meta_path)):
        return None
    with open(meta_path) as f:
        stored = json.load(f)
    if stored != fingerprint:
        return None  # another problem or other hyperparameters
    with np.load(state_path) as z:
        return {k: z[k] for k in z.files}


def clear_state(ckpt_dir: str) -> None:
    for p in _paths(ckpt_dir):
        if os.path.exists(p):
            os.remove(p)
