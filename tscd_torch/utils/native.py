"""Host C++ libraries of the port (tscd_torch/csrc/host), built with g++ at
first use into `build/native/` and loaded with ctypes, which releases the
GIL for each call. The library's file name carries a hash of its source and
flags; a build writes a temp file and renames it into place, so processes
that build at once do not read a half-written library. A failed build
raises: nothing falls back."""

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, Sequence, Tuple

BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
HOST_SRC = Path(__file__).resolve().parents[1] / "csrc" / "host"


class HostLibrary:
    """`HostLibrary("cocoeval.cpp", flags, {name: (argtypes, restype)})`;
    `load()` builds once and returns the CDLL with its signatures set."""

    def __init__(self, source: str, flags: Sequence[str],
                 signatures: Dict[str, Tuple[Sequence, object]]):
        self.src = HOST_SRC / source
        self.flags = list(flags)
        self.signatures = signatures
        self._lock = threading.Lock()
        self._lib = None

    def path(self) -> Path:
        """Where the library for the current source and flags lives."""
        h = hashlib.sha256(" ".join(self.flags).encode() + self.src.read_bytes())
        return BUILD_DIR / f"lib{self.src.stem}_{h.hexdigest()[:16]}.so"

    def load(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is not None:
                return self._lib
            target = self.path()
            if not target.exists():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = target.with_suffix(f".tmp{os.getpid()}")
                r = subprocess.run(["g++", *self.flags, str(self.src), "-o", str(tmp)],
                                   capture_output=True, text=True)
                if r.returncode != 0:
                    raise RuntimeError(f"g++ failed to build {self.src}:\n{r.stderr}")
                os.replace(tmp, target)
            lib = ctypes.CDLL(str(target))
            for name, (args, res) in self.signatures.items():
                fn = getattr(lib, name)
                fn.argtypes = list(args)
                fn.restype = res
            self._lib = lib
            return lib
