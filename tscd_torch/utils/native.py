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


DEPLOY_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]   # the JAX package's build
_P = ctypes.c_void_p
DEPLOY = HostLibrary("yolox_deploy.cpp", DEPLOY_FLAGS, {
    "yolox_decode_nms": ([_P, ctypes.c_int64, ctypes.c_int64, _P, _P, ctypes.c_int64,
                          ctypes.c_float, ctypes.c_float, ctypes.c_int32, _P], ctypes.c_int32)})


def yolox_decode_nms(raw, hw, strides, num_classes: int, conf: float = 0.25,
                     nms: float = 0.45, max_out: int = 30):
    """Grid decode and greedy class-aware NMS of one image's raw YOLOX
    head output (A, 5 + C) fp32 (logits; `csrc/host/yolox_deploy.cpp`, the
    AOTInductor runner's own): `hw` the levels' (h, w), `strides` theirs.
    Returns (n, 7) fp32 rows [x1, y1, x2, y2, 1, obj x cls, cls] in score
    order."""
    import numpy as np
    raw = np.ascontiguousarray(raw, np.float32)
    hw = np.ascontiguousarray(hw, np.int32).reshape(-1)
    strides = np.ascontiguousarray(strides, np.int32)
    out = np.zeros((max_out, 7), np.float32)
    n = DEPLOY.load().yolox_decode_nms(raw.ctypes.data, raw.shape[0], num_classes,
                                       hw.ctypes.data, strides.ctypes.data, len(strides), conf,
                                       nms, max_out, out.ctypes.data)
    return out[:n]


def torch_flags():
    """g++ flags that compile and link against this torch: its C++ ABI, its
    and CUDA's headers, its libraries (with their directory as rpath)."""
    import torch
    from torch.utils import cpp_extension as ce
    cuda = ce.CUDA_HOME or "/usr/local/cuda"
    libs = ce.library_paths()
    return ([f"-D_GLIBCXX_USE_CXX11_ABI={int(torch._C._GLIBCXX_USE_CXX11_ABI)}"]
            + [f"-I{p}" for p in ce.include_paths()] + [f"-I{cuda}/include"],
            # no --as-needed: nothing names a symbol of libtorch_cuda, which
            # registers the CUDA kernels when it loads
            [f"-L{p}" for p in libs] + [f"-Wl,-rpath,{p}" for p in libs]
            + ["-Wl,--no-as-needed", "-ltorch", "-ltorch_cpu", "-ltorch_cuda", "-lc10",
               "-lc10_cuda", "-Wl,--as-needed"])


_torch_build_locks: Dict[str, threading.Lock] = {}
_torch_build_locks_lock = threading.Lock()


def build_with_torch(sources: Sequence[Path], out_dir: Path, name: str, shared: bool,
                     extra: Sequence[str] = ()) -> Path:
    """`sources` compiled and linked by g++ (-O3, C++17) against this torch
    into `out_dir`/`name`_<hash>[.so], the hash over the sources, flags and
    `extra` (more link arguments); built once, written to a temp file and
    renamed into place. Raises if g++ fails."""
    cflags, lflags = torch_flags()
    flags = ["-O3", "-std=c++17"] + (["-shared", "-fPIC"] if shared else []) + cflags
    h = hashlib.sha256(" ".join(flags + lflags + list(extra)).encode())
    for src in sources:
        h.update(Path(src).read_bytes())
    target = Path(out_dir) / f"{name}_{h.hexdigest()[:16]}{'.so' if shared else ''}"
    with _torch_build_locks_lock:
        lock = _torch_build_locks.setdefault(str(target), threading.Lock())
    with lock:          # one build a target; builds of two targets run at once
        if not target.exists():
            Path(out_dir).mkdir(parents=True, exist_ok=True)
            tmp = target.with_name(target.name + f".tmp{os.getpid()}")
            r = subprocess.run(["g++", *flags, *map(str, sources), "-o", str(tmp), *extra,
                                *lflags, "-ldl"], capture_output=True, text=True)
            if r.returncode != 0:
                raise RuntimeError(f"g++ failed to build {name}:\n{r.stderr[-4000:]}")
            os.replace(tmp, target)
    return target


def aoti_runner() -> Path:
    """`csrc/host/aoti_runner.cpp` with `yolox_deploy.cpp` built into an
    executable (against torch, in `build/native/`); returns its path."""
    return build_with_torch([HOST_SRC / "aoti_runner.cpp", HOST_SRC / "yolox_deploy.cpp"],
                            BUILD_DIR, "aoti_runner", shared=False)


def synth_image(H: int, W: int):
    """The runners' synthetic image (1, H, W, 3) float32: element i of
    the flat NHWC array is (i * 2654435761) mod 256, as aoti_runner.cpp
    and tscd_tpu/native/pjrt_runner.cpp make it."""
    import numpy as np
    i = np.arange(H * W * 3, dtype=np.uint64)
    return ((i * np.uint64(2654435761)) % np.uint64(256)).astype(np.float32).reshape(1, H, W, 3)
