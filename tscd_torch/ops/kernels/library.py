"""Builds `tscd_torch/csrc/*.cu` into one shared library with a plain C
interface and loads it through ctypes.

The build runs at first use, never at import: one nvcc per source, all
started together, then one link. The library is cached in
`build/kernels/` under a hash of the sources and flags, so an edited
source is rebuilt and an unchanged one is not.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import List, Optional

_SRC_DIR = Path(__file__).resolve().parents[2] / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                           "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signature of every kernel entry point; each returns a cudaError_t
_SIGNATURES = {
    "tscd_fused_dual_attention":
        [_P] * 9 + [_P] * 3 + [_P, ctypes.c_size_t, ctypes.POINTER(ctypes.c_longlong)]
        + [_I] * 5 + [_F, _I, _P],
    "tscd_fused_dual_attention_stream":
        [_P] * 9 + [_P] * 3 + [ctypes.POINTER(ctypes.c_longlong)] + [_I] * 5 + [_F, _I, _P],
    "tscd_fused_dual_attention_stream_config": [_I] * 5 + [ctypes.POINTER(_I)],
    "tscd_linear_sum_assignment": [_P, _P, _I, _I, _P],
    "tscd_linear_sum_assignment_block": [_P, _P, _I, _I, _P],
    "tscd_nms_pack": [_P, _P, _P, _I, _I, _F, _P],
    "tscd_nms_sorted": [_P] * 4 + [_I, _I, _F, _P],
    "tscd_focus_stem": [_P] * 4 + [_I] * 5 + [_P],
    "tscd_focus_stem_bf16": [_P] * 3 + [_I] * 6 + [_P],
    "tscd_focus_stem_bf16_config": [_I] * 4 + [ctypes.POINTER(_I)],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def sources() -> List[Path]:
    return sorted(_SRC_DIR.glob("*.cu"))


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only "
                           "where the CUDA toolkit is installed")
    return path


def _build(target: Path) -> None:
    nvcc = _nvcc()
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    objs, procs = [], []
    for src in sources():
        obj = _BUILD_DIR / f"{src.stem}.{os.getpid()}.o"
        objs.append(obj)
        procs.append((src, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log = []
    failed = []
    for src, p in procs:
        out, _ = p.communicate()
        log.append(f"== {src.name}\n{out}")
        if p.returncode != 0:
            failed.append(src.name)
    # with -Xptxas -v: registers, shared memory and spills of every kernel
    (_BUILD_DIR / "build.log").write_text("\n".join(log))
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
    tmp = target.with_suffix(f".tmp{os.getpid()}")
    subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
                    *map(str, objs)], check=True)
    os.replace(tmp, target)
    for obj in objs:
        obj.unlink()


def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for src in sources():
            h.update(src.name.encode())
            h.update(src.read_bytes())
        target = _BUILD_DIR / f"libtscd_kernels_{h.hexdigest()[:16]}.so"
        if not target.exists():
            _build(target)
        lib = ctypes.CDLL(str(target))
        for name, args in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = ctypes.c_int
        lib.tscd_error_string.argtypes = [ctypes.c_int]
        lib.tscd_error_string.restype = ctypes.c_char_p
        _lib = lib
        return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a launch was refused (the C entry point returns
    cudaGetLastError() right after the launch)."""
    if rc != 0:
        raise RuntimeError(
            f"{what} launch failed: {lib.tscd_error_string(rc).decode()}")
