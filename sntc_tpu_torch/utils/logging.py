"""Structured JSONL metrics logging.

Counterpart of ``sntc_tpu/utils/logging.py``: an append-only JSONL
event stream, one object a line (a step number, the seconds since the
logger was made, and the caller's scalar fields), that tooling can
tail.  The models keep their own ``summary.objectiveHistory``.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional


class MetricsLogger:
    """Append-only JSONL logger: ``logger.log(event="fit", loss=0.3)``.
    A path truncates its file at construction (one run a file); without
    one the records are only returned."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self._step = 0
        self._t0 = time.perf_counter()
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            open(path, "w").close()

    def log(self, **fields: Any) -> Dict[str, Any]:
        record = {
            "step": self._step,
            "elapsed_s": round(time.perf_counter() - self._t0, 6),
            **fields,
        }
        self._step += 1
        if self.path:
            with open(self.path, "a") as f:  # storage: unbounded(caller-owned log path)
                f.write(json.dumps(record) + "\n")
        return record

    def read_all(self):
        if not self.path or not os.path.exists(self.path):
            return []
        with open(self.path) as f:
            return [json.loads(line) for line in f if line.strip()]
