"""Mid-fit checkpoints: an LBFGS fit's state every N iterations, a
boosting fit's every N rounds.

Counterpart of ``sntc_tpu/mlio/optimizer_checkpoint.py``, in its
directory layout: ``<dir>/lbfgs_state.npz`` holds the state's arrays and
``<dir>/lbfgs_meta.json`` a fingerprint of the problem (shapes and
hyperparameters).  :func:`load_state` returns the state only when the
fingerprint matches, so a stale state never resumes into another
problem; a completed fit deletes it with :func:`clear_state`.
:func:`run_segmented` drives a resumable LBFGS in checkpointed segments.

The state is npz only: the JAX package's orbax payload
(``SNTC_CHECKPOINT_FORMAT=orbax``) is not readable here, and a directory
holding one is refused.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, Optional, Tuple

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


def run_segmented(
    opt_call: Callable,
    target_iters: int,
    interval: int,
    ckpt_dir: Optional[str],
    fingerprint: Dict,
):
    """Drive a resumable optimizer in checkpointed segments.

    ``opt_call(init_state, resume, iter_limit) -> (LbfgsResult, state)``
    must stop at ``iter_limit`` (absolute).  The state is saved after
    every segment and a re-run with the same ``ckpt_dir`` resumes from
    it.  With ``interval <= 0`` or no ``ckpt_dir``: one uncheckpointed
    call.  The result counts the evaluations and host reads of every
    segment of this run."""
    from sntc_tpu_torch.ops.lbfgs import state_to_host

    if not ckpt_dir or interval <= 0:
        res, _ = opt_call(None, False, target_iters)
        return res

    loaded = load_state(ckpt_dir, fingerprint)
    state = None
    k_done = 0
    if loaded is not None:
        k_done = int(loaded["k"])
        if bool(loaded.get("done", False)) or k_done >= target_iters:
            # finished previously; re-run the final no-op segment to
            # materialize the result from the stored state
            res, _ = opt_call(loaded, True, k_done)
            clear_state(ckpt_dir)
            return res
        state = loaded

    res = None
    evals = syncs = 0
    while k_done < target_iters:
        limit = min(k_done + interval, target_iters)
        res, dev_state = opt_call(state, state is not None, limit)
        evals += res.n_evals
        syncs += res.n_syncs
        state = state_to_host(dev_state)
        k_done = int(res.n_iters)
        save_state(ckpt_dir, state, fingerprint)
        if res.converged:
            break
        if k_done < limit:  # line-search stall: no further progress
            break
    clear_state(ckpt_dir)
    return res._replace(n_evals=evals, n_syncs=syncs)
