"""Build and load the host parsers (``native/*.cpp``) with ``ctypes``.

Counterpart of ``sntc_tpu/native/_loader.py``.  Each source compiles on
first use with ``g++ -O3 -shared -fPIC`` into
``sntc_tpu_torch/_build/native/`` (gitignored), and rebuilds when the
source is newer than the library.  The compiler writes a name of its
own (pid and thread in it) that ``os.replace`` moves into place, so
processes and threads that build at once never load a half-written
library.  A failed build latches per library: the callers then use their
pure-Python parsers, as the JAX package does when ``g++`` is missing
(host code, not a device path).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "_build", "native",
)


class NativeLib:
    """Lazy ``ctypes`` loader of one ``.cpp`` source."""

    def __init__(self, src: str, name: str):
        self.src = src
        self.so = os.path.join(BUILD_DIR, name)
        self._lib: Optional[ctypes.CDLL] = None
        self._failed = False
        self._lock = threading.Lock()

    def _build(self) -> Optional[str]:
        if os.path.exists(self.so) and os.path.getmtime(
            self.so
        ) >= os.path.getmtime(self.src):
            return self.so
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{self.so}.{os.getpid()}.{threading.get_ident()}.tmp"
        try:
            subprocess.run(
                ["g++", "-O3", "-shared", "-fPIC", "-o", tmp, self.src],
                check=True, capture_output=True, timeout=120,
            )
            os.replace(tmp, self.so)  # storage: unbounded(host parser build)
            return self.so
        except (OSError, subprocess.SubprocessError):
            try:
                os.unlink(tmp)
            except OSError:
                pass
            return None

    def get(self, configure) -> Optional[ctypes.CDLL]:
        """The loaded library, built on the first call; ``configure(lib)``
        declares its argument and result types once after the load."""
        if self._lib is not None or self._failed:
            return self._lib
        with self._lock:
            if self._lib is not None or self._failed:
                return self._lib
            so = self._build()
            if so is None:
                self._failed = True
                return None
            lib = ctypes.CDLL(so)
            configure(lib)
            self._lib = lib
        return self._lib
