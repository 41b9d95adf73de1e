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
``source.parse``        ``data.ingest.load_csv`` on the raw bytes: a
                        :func:`fault_data` site taking the DATA kinds
``ckpt.save``           ``mlio.save_model`` before the atomic publish
``ckpt.load``           ``mlio.load_model`` before manifest verification
``cv.fit``              ``CrossValidator`` per-(fold, grid-point) fit
``model.publish``       ``lifecycle.ModelPromoter`` before the candidate
                        checkpoint publish
``model.swap``          ``lifecycle`` promotion: post-publish/pre-swap
                        (first call) and post-swap (second call)
``storage.wal``         physical WAL writes (log lines, files-mode
                        records, the compaction checkpoint): a
                        :func:`fault_disk` site taking the IO kinds
``storage.journal``     JSONL journal appends (the repair, shed and
                        controller journals)
``storage.dead_letter`` dead-letter evidence (the quarantine journal,
                        the row dead letters)
``storage.marker``      atomic marker and status writes (drain marker,
                        ``--health-json``)
``predict.compile``     ``BatchPredictor`` before a FRESH padded row
                        shape's dispatch
``device.dispatch``     ``BatchPredictor`` before every dispatch
``ctl.apply``           ``serve.ServeController`` inside every live knob
                        setter, before the knob moves
======================  =================================================

Environment grammar (comma-separated specs)::

    SNTC_FAULTS=site[:kind[:prob[:seed]]][,site2:...]

``kind`` is ``exc`` (RuntimeError), ``io`` (OSError), ``timeout``
(TimeoutError), ``kill`` (``os._exit(137)``, a process crash), a DATA
kind (``corrupt_bytes``, ``truncate``, ``ragged``), which mutates the
payload at a :func:`fault_data` site instead of raising, an IO kind
(``enospc``, ``io_error``: an :class:`InjectedDiskFault` carrying the
real errno at any site; ``torn_write``: a partial write at a
:func:`fault_disk` site only), or a DEVICE kind, ``device_oom`` /
``compile_error`` / ``device_lost``, which raises an
:class:`InjectedDeviceFault` whose message copies the
PyTorch/CUDA error line of that kind, so that
``resilience.device.classify_device_error`` treats injected and real
errors alike.  ``prob`` in [0, 1] is drawn per call from a numpy
generator seeded by ``seed``, as in the JAX package: the same string
gives the same fault sequence in both packages.  Environment faults
fire without a limit; :func:`arm` adds Nth-call precision
(``arm("sink.write", after=2, times=1)`` raises on exactly the 3rd
call).  A malformed string warns once on stderr and arms nothing.

For the same spec and payload, :func:`fault_data` mutates the bytes
exactly as the JAX package does.  :func:`fault_point` and
:func:`fault_disk` look up a tenant-namespaced site
(``tenant/<id>/<site>``) before the bare one.
"""

from __future__ import annotations

import errno
import os
import sys
import threading
import zlib
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


class InjectedDiskFault(InjectedIOFault):
    """An injected disk failure: an OSError whose ``errno`` is the real
    ENOSPC or EIO code, so ``except OSError`` handlers treat it as the
    genuine article."""

    def __init__(self, errno_code: int, msg: str):
        super().__init__(errno_code, msg)
        self.errno = errno_code


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
# inert at fault_point: they mutate the bytes of a fault_data site
DATA_KINDS = ("corrupt_bytes", "truncate", "ragged")
# enospc/io_error raise at any site; torn_write fires at fault_disk only
IO_KINDS = ("enospc", "io_error", "torn_write")
DEVICE_KINDS = ("device_oom", "compile_error", "device_lost")
ALL_KINDS = (tuple(sorted(_KINDS)) + (KILL_KIND,) + DATA_KINDS + IO_KINDS
             + DEVICE_KINDS)
SITES = (
    "stream.wal",
    "stream.read",
    "stream.commit",
    "sink.write",
    "source.parse",
    "ckpt.save",
    "ckpt.load",
    "collective.dispatch",
    "cv.fit",
    "model.publish",
    "model.swap",
    "storage.wal",
    "storage.journal",
    "storage.dead_letter",
    "storage.marker",
    "storage.state",
    "predict.compile",
    "device.dispatch",
    "ctl.apply",
    "flow.emit",
    "flow.evict",
    "flow.state_snapshot",
    "ingress.recv",
    "ingress.spool",
    # the mesh substrate: ``mesh.resize`` fires inside the collective
    # layer's elastic response, after a ``device_lost`` is classified but
    # before the data axis shrinks and the batch is placed again on the
    # survivors; arming it exercises a resize that itself fails (the
    # double fault reaches the caller)
    "mesh.resize",
    # the fleet's coordination boundaries: before a worker renews its
    # lease, before the coordinator publishes an assignment epoch, and
    # before each file of a tenant tree's migration ship
    "fleet.lease",
    "fleet.assign",
    "fleet.migrate",
    # the standby plane's boundaries: before each changed file ships to
    # the replica, before the sealed replica manifest publishes, before
    # a commit-barrier record is appended
    "repl.ship",
    "repl.apply",
    "repl.barrier",
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


def _count_injection(site: str, kind: str) -> None:
    """Mirror one fired injection into ``sntc_faults_injected_total``
    (never fatal)."""
    try:
        from sntc_tpu_torch.obs.metrics import inc

        inc("sntc_faults_injected_total", site=site, kind=kind)
    except Exception:
        pass


def _disk_fault(kind: str, site: str, call: int) -> InjectedDiskFault:
    code = errno.ENOSPC if kind == "enospc" else errno.EIO
    return InjectedDiskFault(
        code, f"injected {kind} fault at site {site!r} (call {call})")


def fault_point(site: str, tenant: Optional[str] = None) -> None:
    """The per-site hook real code calls; raises when armed and
    scheduled.  A DATA kind or ``torn_write`` is inert here.  With
    ``tenant`` it checks ``tenant/<id>/<site>`` before the bare site, so
    one tenant's boundary can be armed alone while a bare-site fault
    still hits every tenant."""
    _sync_env()
    spec = None
    if tenant is not None:
        spec = _registry.get(f"tenant/{tenant}/{site}")
    if spec is None:
        spec = _registry.get(site)
    if spec is None or spec.kind in DATA_KINDS or spec.kind == "torn_write":
        return
    site = spec.site  # the event and the error name the armed site
    with _lock:
        fire = spec.decide()
        call = spec.calls
    if not fire:
        return
    _count_injection(site, spec.kind)
    emit_event(event="fault_injected", site=site, kind=spec.kind,
               call=call)
    if spec.kind == KILL_KIND:
        # a crash, not an exception: no finally blocks, no WAL flush
        os._exit(KILL_EXIT_CODE)
    if spec.kind in ("enospc", "io_error"):
        raise _disk_fault(spec.kind, site, call)
    if spec.kind in DEVICE_KINDS:
        raise _device_fault(spec.kind, site, call)
    raise _KINDS[spec.kind](
        f"injected {spec.kind} fault at site {site!r} (call {call})"
    )


def fault_disk(site: str, tenant: Optional[str] = None) -> Optional[float]:
    """The physical-write hook of the storage helpers (``storage.*``
    sites), checking ``tenant/<id>/<site>`` before the bare site.
    Unarmed, or armed with a non-IO kind, it returns None; ``enospc`` /
    ``io_error`` raise :class:`InjectedDiskFault` (nothing written);
    ``torn_write`` returns a seeded fraction in [0.2, 0.8): the caller
    writes that prefix of its payload, flushes it and raises, leaving
    the torn tail a crash mid-``write(2)`` would."""
    _sync_env()
    spec = None
    if tenant is not None:
        spec = _registry.get(f"tenant/{tenant}/{site}")
    if spec is None:
        spec = _registry.get(site)
    if spec is None or spec.kind not in IO_KINDS:
        return None
    site = spec.site
    with _lock:
        fire = spec.decide()
        call = spec.calls
        torn = float(spec.rng.uniform(0.2, 0.8)) if fire else 0.0
    if not fire:
        return None
    _count_injection(site, spec.kind)
    emit_event(event="fault_injected", site=site, kind=spec.kind,
               call=call)
    if spec.kind == "torn_write":
        return torn
    raise _disk_fault(spec.kind, site, call)


def _mutate(kind: str, data: bytes, draws: np.ndarray) -> bytes:
    """One deterministic corruption of ``data``; ``draws`` are uniform
    [0, 1) floats consumed in order, so the mutation depends only on
    (seed, payload)."""
    n = len(data)
    if n == 0:
        return data
    if kind == "truncate":  # a strict prefix: the torn capture
        return data[: int(draws[0] * n)]
    if kind == "corrupt_bytes":
        buf = bytearray(data)
        for i in range(max(1, n // 64)):
            buf[int(draws[2 * i] * n)] = int(draws[2 * i + 1] * 256) % 256
        return bytes(buf)
    # ragged: one extra field on a data line (never the header); a
    # payload of fewer lines takes it at a raw offset
    lines = data.split(b"\n")
    if len(lines) > 2:
        li = 1 + int(draws[0] * max(1, len(lines) - 2))
        lines[li] = lines[li] + b",__sntc_ragged__"
        return b"\n".join(lines)
    pos = int(draws[0] * n)
    return data[:pos] + b",__sntc_ragged__," + data[pos:]


def data_fault_armed(site: str) -> bool:
    """True when a DATA kind is armed at ``site``: a reader that streams
    from a path buffers the payload only then."""
    _sync_env()
    spec = _registry.get(site)
    return spec is not None and spec.kind in DATA_KINDS


def fault_data(site: str, data: bytes) -> bytes:
    """The byte-corruption hook of a parse boundary (``source.parse``):
    ``data`` unchanged unless a DATA kind is armed.  The fire decision
    and the mutation draw from a generator seeded by ``(seed,
    crc32(data), len(data))``, not the call order, so concurrent readers
    corrupt the same payloads the same way in every run."""
    _sync_env()
    spec = _registry.get(site)
    if spec is None or spec.kind not in DATA_KINDS:
        return data
    with _lock:
        spec.calls += 1
        call = spec.calls
        if call <= spec.after or (
            spec.times is not None and spec.raised >= spec.times
        ):
            return data
    rng = np.random.default_rng([spec.seed, zlib.crc32(data), len(data)])
    if not (spec.prob >= 1.0 or float(rng.uniform()) < spec.prob):
        return data
    with _lock:
        spec.raised += 1
    draws = rng.uniform(size=2 * max(1, len(data) // 64))
    mutated = _mutate(spec.kind, data, draws)
    _count_injection(site, spec.kind)
    emit_event(event="fault_injected", site=site, kind=spec.kind,
               call=call, bytes_in=len(data), bytes_out=len(mutated))
    return mutated
