"""Span tracer: host-side stage timing on a ring buffer, exported as
Chrome-trace/Perfetto JSON.

Counterpart of ``sntc_tpu/obs/trace.py``.  ``obs.span("stage.name",
**attrs)`` wraps a hot-path stage; each closed span records (name,
monotonic start, duration, wall start, thread id, attrs) onto a bounded
ring.  Tracing is off by default, and then a span is one attribute read
and a shared null context: the engine's hot paths carry the calls
permanently.

:meth:`SpanTracer.export_chrome_trace` writes the ring as Chrome
``traceEvents`` JSON (``chrome://tracing``, ui.perfetto.dev), every span
a complete ("X") event on its thread's track.  Ring overflow drops the
oldest spans and counts them (``sntc_spans_dropped_total``).

:class:`device_trace` is a ``torch.profiler`` capture into a directory
(CUDA activity too when the card is in use), so device work lines up
with the host spans recorded inside it; the serve and train commands
expose it as ``--device-trace DIR``.  A profiler window may drop
launches, so the port's device times come from CUDA events, not from
this trace.

Imports only the standard library and ``obs.metrics`` at import time.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

from sntc_tpu_torch.obs.metrics import inc


class _NullSpan:
    """Shared no-op context manager for the tracing-disabled path."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    """One live span: records itself on exit, a failing stage's time
    included."""

    __slots__ = ("_tracer", "name", "attrs", "_t0", "_wall0")

    def __init__(self, tracer: "SpanTracer", name: str, attrs):
        self._tracer = tracer
        self.name = name
        self.attrs = attrs

    def __enter__(self):
        self._wall0 = self._tracer._wall()
        self._t0 = self._tracer._clock()
        return self

    def __exit__(self, exc_type, exc, tb):
        self._tracer._record(
            self.name,
            self._t0,
            self._tracer._clock() - self._t0,
            self._wall0,
            threading.get_ident(),
            self.attrs,
        )
        return False


class SpanTracer:
    """Bounded ring of closed spans (thread-safe; injectable clocks).
    Overflow evicts the oldest span and counts ``dropped``."""

    def __init__(
        self,
        capacity: int = 65_536,
        *,
        clock=time.perf_counter,
        wall=time.time,
    ):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = int(capacity)
        self._clock = clock
        self._wall = wall
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=self.capacity)
        self.dropped = 0

    def span(self, name: str, **attrs: Any) -> _Span:
        return _Span(self, name, attrs or None)

    def _record(self, name, t0, dur, wall0, tid, attrs) -> None:
        with self._lock:
            if len(self._ring) == self._ring.maxlen:
                self.dropped += 1
                inc("sntc_spans_dropped_total")
            self._ring.append((name, t0, dur, wall0, tid, attrs))

    def spans(self) -> List[Dict[str, Any]]:
        with self._lock:
            ring = list(self._ring)
        return [
            {
                "name": name, "t0": t0, "dur_s": dur, "wall": wall0,
                "tid": tid, "attrs": attrs or {},
            }
            for name, t0, dur, wall0, tid, attrs in ring
        ]

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "spans": len(self._ring),
                "capacity": self.capacity,
                "dropped": self.dropped,
            }

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self.dropped = 0

    def export_chrome_trace(self, path: str) -> str:
        """Write the ring as Chrome trace-event JSON (``ph: "X"``
        complete events, µs timestamps); published atomically (tmp +
        rename)."""
        with self._lock:
            ring = list(self._ring)
        pid = os.getpid()
        thread_names = {
            t.ident: t.name for t in threading.enumerate()
            if t.ident is not None
        }
        events: List[Dict[str, Any]] = []
        for tid, tname in sorted(thread_names.items()):
            events.append({
                "name": "thread_name", "ph": "M", "pid": pid,
                "tid": tid, "args": {"name": tname},
            })
        for name, t0, dur, wall0, tid, attrs in ring:
            ev: Dict[str, Any] = {
                "name": name, "cat": "host", "ph": "X",
                "ts": round(t0 * 1e6, 3),
                "dur": round(dur * 1e6, 3),
                "pid": pid, "tid": tid,
            }
            args = dict(attrs) if attrs else {}
            args["wall_ts"] = wall0
            ev["args"] = args
            events.append(ev)
        doc = {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {
                "tool": "sntc_tpu_torch.obs",
                "dropped_spans": self.dropped,
            },
        }
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, path)  # storage: telemetry
        return path


# the process tracer: disabled (None) by default; span() is the
# permanent hot-path call site
_tracer: Optional[SpanTracer] = None


def span(name: str, **attrs: Any):
    """``with obs.span("stream.read", batch=3): ...``: records onto the
    process tracer when enabled, a shared no-op otherwise."""
    t = _tracer
    if t is None:
        return _NULL_SPAN
    return t.span(name, **attrs)


def tracer() -> Optional[SpanTracer]:
    return _tracer


def tracing_enabled() -> bool:
    return _tracer is not None


def enable_tracing(capacity: int = 65_536, **kwargs: Any) -> SpanTracer:
    """Arm the process tracer (an armed tracer is returned unchanged
    unless another capacity is asked for)."""
    global _tracer
    if _tracer is None or _tracer.capacity != capacity:
        _tracer = SpanTracer(capacity, **kwargs)
    return _tracer


def disable_tracing() -> Optional[SpanTracer]:
    """Disarm and return the tracer (its ring stays readable)."""
    global _tracer
    t, _tracer = _tracer, None
    return t


class device_trace:
    """``with device_trace(log_dir):`` a ``torch.profiler`` capture of
    the block, written to ``log_dir`` as a Chrome trace
    (``device_trace.json``).  CUDA activity is recorded where CUDA is
    available, CPU activity always.  Expensive: the
    commands gate it behind ``--device-trace DIR``."""

    FILE = "device_trace.json"

    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        self._prof = None

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        os.makedirs(self.log_dir, exist_ok=True)
        self._prof = profile(activities=activities)
        self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        prof, self._prof = self._prof, None
        prof.__exit__(*exc)
        prof.export_chrome_trace(os.path.join(self.log_dir, self.FILE))
        return False
