"""Deterministic fault injection at named sites, armable by tests or the
environment.

Counterpart of ``sntc_tpu/resilience/faults.py``.  Real code calls
``fault_point("<site>")`` before its work.  Unarmed, that is a
dictionary miss.  Armed (through :func:`arm` or the ``SNTC_FAULTS``
variable) the point raises on a deterministic schedule and emits a
``fault_injected`` event (mirrored into ``sntc_faults_injected_total``).

Wired sites:

======================  =================================================
``stream.wal``          ``StreamingQuery`` before the intent WAL write
``stream.read``         ``StreamingQuery`` micro-batch source read
``stream.commit``       ``StreamingQuery`` after the sink, before commit
``sink.write``          ``StreamingQuery`` sink delivery (per batch)
``cv.fit``              ``CrossValidator`` per-(fold, grid-point) fit
``predict.compile``     ``BatchPredictor`` before a FRESH padded row
                        shape's dispatch
``device.dispatch``     ``BatchPredictor`` before every dispatch
======================  =================================================

Environment grammar (comma-separated specs)::

    SNTC_FAULTS=site[:kind[:prob[:seed]]][,site2:...]

``kind`` is ``exc`` (RuntimeError), ``io`` (OSError), ``timeout``
(TimeoutError), ``kill`` (``os._exit(137)``, a process crash) or a
DEVICE kind, ``device_oom`` / ``compile_error`` / ``device_lost``, which
raises an :class:`InjectedDeviceFault` whose message copies the
PyTorch/CUDA error line of that kind, so that
``resilience.device.classify_device_error`` treats injected and real
errors alike.  ``prob`` in [0, 1] is drawn per call from a numpy
generator seeded by ``seed``, as in the JAX package: the same string
gives the same fault sequence in both packages.  Environment faults
fire without a limit; :func:`arm` adds Nth-call precision
(``arm("sink.write", after=2, times=1)`` raises on exactly the 3rd
call).  A malformed string warns once on stderr and arms nothing.

The DATA kinds and ``fault_data`` wait for the capture sources, the IO
kinds and ``fault_disk`` for the storage plane, tenant-namespaced sites
for tenancy (ROADMAP queue A).
"""

from __future__ import annotations

import os
import sys
import threading
from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np

from sntc_tpu_torch.resilience.policy import emit_event


class InjectedFault(RuntimeError):
    """Base class of every injected fault (never raised by real code)."""


class InjectedIOFault(InjectedFault, OSError):
    pass


class InjectedTimeoutFault(InjectedFault, TimeoutError):
    pass


class InjectedDeviceFault(InjectedFault):
    """An injected CUDA failure: the message copies the real PyTorch
    error line of its kind, and ``device_kind`` names the kind."""

    def __init__(self, msg: str, kind: str):
        super().__init__(msg)
        self.device_kind = kind


_KINDS = {
    "exc": InjectedFault,
    "io": InjectedIOFault,
    "timeout": InjectedTimeoutFault,
}
KILL_KIND = "kill"
KILL_EXIT_CODE = 137
DEVICE_KINDS = ("device_oom", "compile_error", "device_lost")
ALL_KINDS = tuple(sorted(_KINDS)) + (KILL_KIND,) + DEVICE_KINDS
SITES = (
    "stream.wal",
    "stream.read",
    "stream.commit",
    "sink.write",
    "cv.fit",
    "predict.compile",
    "device.dispatch",
)


@dataclass
class _Armed:
    site: str
    kind: str = "exc"
    prob: float = 1.0
    seed: int = 0
    after: int = 0  # calls to let through before the faults start
    times: Optional[int] = None  # max faults to raise; None = unlimited
    from_env: bool = False
    calls: int = 0
    raised: int = 0
    rng: np.random.Generator = field(default=None)  # type: ignore[assignment]

    def __post_init__(self):
        if self.kind not in ALL_KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r}; expected one of "
                f"{list(ALL_KINDS)}"
            )
        if not 0.0 <= self.prob <= 1.0:
            raise ValueError(f"fault prob must lie in [0, 1], got {self.prob}")
        self.rng = np.random.default_rng(self.seed)

    def decide(self) -> bool:
        """Called under the registry lock, once per fault_point hit.  One
        draw per eligible call, so the sequence depends only on (seed,
        call index)."""
        self.calls += 1
        if self.calls <= self.after:
            return False
        if self.times is not None and self.raised >= self.times:
            return False
        fire = self.prob >= 1.0 or float(self.rng.uniform()) < self.prob
        if fire:
            self.raised += 1
        return fire


_registry: Dict[str, _Armed] = {}
_lock = threading.Lock()
_env_installed: Optional[str] = None


def arm(
    site: str,
    kind: str = "exc",
    prob: float = 1.0,
    seed: int = 0,
    *,
    after: int = 0,
    times: Optional[int] = 1,
    _from_env: bool = False,
) -> None:
    """Arm ``site``; by default it raises on the next call, once."""
    spec = _Armed(site=site, kind=kind, prob=prob, seed=seed, after=after,
                  times=times, from_env=_from_env)
    with _lock:
        _registry[site] = spec


def disarm(site: str) -> None:
    with _lock:
        _registry.pop(site, None)


def clear() -> None:
    """Drop every armed fault, those of ``SNTC_FAULTS`` too (the string
    is installed again at the next fault_point if still set)."""
    global _env_installed
    with _lock:
        _registry.clear()
        _env_installed = None


def call_count(site: str) -> int:
    with _lock:
        spec = _registry.get(site)
        return spec.calls if spec else 0


def parse_faults_env(raw: str) -> list:
    """The ``SNTC_FAULTS`` grammar as :func:`arm` argument dicts; a
    malformed spec raises a ValueError naming it and the field that
    broke."""
    out = []
    for chunk in raw.split(","):
        chunk = chunk.strip()
        if not chunk:
            continue
        parts = chunk.split(":")
        if len(parts) > 4:
            raise ValueError(
                f"malformed SNTC_FAULTS spec {chunk!r}: expected at most "
                f"4 ':'-separated fields (site[:kind[:prob[:seed]]]), "
                f"got {len(parts)}"
            )
        if not parts[0]:
            raise ValueError(
                f"malformed SNTC_FAULTS spec {chunk!r}: empty site name"
            )
        spec = {"site": parts[0]}
        if len(parts) > 1:
            if parts[1] not in ALL_KINDS:
                raise ValueError(
                    f"malformed SNTC_FAULTS spec {chunk!r}: unknown kind "
                    f"{parts[1]!r}; expected one of {list(ALL_KINDS)}"
                )
            spec["kind"] = parts[1]
        if len(parts) > 2:
            try:
                prob = float(parts[2])
            except ValueError:
                raise ValueError(
                    f"malformed SNTC_FAULTS spec {chunk!r}: prob "
                    f"{parts[2]!r} is not a float"
                ) from None
            if not 0.0 <= prob <= 1.0:
                raise ValueError(
                    f"malformed SNTC_FAULTS spec {chunk!r}: prob {prob} "
                    "must lie in [0, 1]"
                )
            spec["prob"] = prob
        if len(parts) > 3:
            try:
                spec["seed"] = int(parts[3])
            except ValueError:
                raise ValueError(
                    f"malformed SNTC_FAULTS spec {chunk!r}: seed "
                    f"{parts[3]!r} is not an int"
                ) from None
        out.append(spec)
    return out


def _drop_env_specs() -> None:
    with _lock:
        for site in [s for s, a in _registry.items() if a.from_env]:
            del _registry[site]


def _sync_env() -> None:
    """(Re)install the ``SNTC_FAULTS`` specs when the variable changed;
    programmatically armed sites are left alone."""
    global _env_installed
    raw = os.environ.get("SNTC_FAULTS") or None
    if raw == _env_installed:
        return
    _drop_env_specs()
    if raw:
        try:
            for spec in parse_faults_env(raw):
                arm(times=None, _from_env=True, **spec)
        except ValueError as e:
            _drop_env_specs()
            print(f"sntc_tpu_torch: ignoring malformed SNTC_FAULTS: {e}",
                  file=sys.stderr)
    _env_installed = raw


def _device_fault(kind: str, site: str, call: int) -> InjectedDeviceFault:
    """The message copies PyTorch's error line for the kind."""
    tag = f"[injected {kind} at site {site!r} (call {call})]"
    if kind == "device_oom":
        msg = ("CUDA out of memory. Tried to allocate 1.00 GiB. GPU 0 has "
               "a total capacity of 79.19 GiB of which 512.00 MiB is free. "
               + tag)
    elif kind == "compile_error":
        msg = ("CUDA error: no kernel image is available for execution on "
               "the device " + tag)
    else:
        msg = ("CUDA error: an illegal memory access was encountered "
               + tag)
    return InjectedDeviceFault(msg, kind)


def fault_point(site: str) -> None:
    """The per-site hook real code calls; raises when armed and
    scheduled."""
    _sync_env()
    spec = _registry.get(site)
    if spec is None:
        return
    with _lock:
        fire = spec.decide()
        call = spec.calls
    if not fire:
        return
    try:
        from sntc_tpu_torch.obs.metrics import inc

        inc("sntc_faults_injected_total", site=site, kind=spec.kind)
    except Exception:
        pass
    emit_event(event="fault_injected", site=site, kind=spec.kind,
               call=call)
    if spec.kind == KILL_KIND:
        # a crash, not an exception: no finally blocks, no WAL flush
        os._exit(KILL_EXIT_CODE)
    if spec.kind in DEVICE_KINDS:
        raise _device_fault(spec.kind, site, call)
    raise _KINDS[spec.kind](
        f"injected {spec.kind} fault at site {site!r} (call {call})"
    )
