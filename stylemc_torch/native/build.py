"""Build the repository's host-ops library (`native/host_ops.cpp`: box NMS,
MTCNN crop extraction, uint8 resize and normalise) with g++ at first use.

The library lands in `build/stylemc_torch_native/<md5 of source and
flags>/libhost_ops.so` under the repository root; a file lock makes
concurrent first uses wait for one build. `get_host_ops` returns None
where no compiler or no source is found, or the build fails, and the
callers take their numpy paths (host code either way).
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

_REPO_ROOT = Path(__file__).resolve().parents[2]
SOURCE = _REPO_ROOT / "native" / "host_ops.cpp"
BUILD_ROOT = _REPO_ROOT / "build" / "stylemc_torch_native"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
ABI_VERSION = 1

_lib: Optional[ctypes.CDLL] = None
_failed = False


def build_host_ops() -> Path:
    """Compile (or reuse) libhost_ops.so and return its path; raises if
    there is no compiler or the build fails (with g++'s output)."""
    h = hashlib.md5(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    out_dir = BUILD_ROOT / h.hexdigest()
    lib = out_dir / "libhost_ops.so"
    if lib.exists():
        return lib
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++ or c++) on PATH")
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if lib.exists():
            return lib
        tmp = out_dir / f"libhost_ops.so.tmp{os.getpid()}"
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"{cxx} failed with code {proc.returncode} "
                               f"building host_ops:\n{proc.stdout}"
                               f"{proc.stderr}")
        os.replace(tmp, lib)
    return lib


def get_host_ops() -> Optional[ctypes.CDLL]:
    """The loaded library (built on first call), or None where it cannot
    be built or STYLEMC_DISABLE_NATIVE is set."""
    global _lib, _failed
    if _lib is not None:
        return _lib
    if _failed or os.environ.get("STYLEMC_DISABLE_NATIVE"):
        return None
    try:
        lib = ctypes.CDLL(str(build_host_ops()))
        lib.nms.restype = ctypes.c_int
        lib.host_ops_abi_version.restype = ctypes.c_int
        if lib.host_ops_abi_version() != ABI_VERSION:
            raise RuntimeError("host_ops ABI version mismatch")
    except (OSError, RuntimeError):
        _failed = True
        return None
    _lib = lib
    return _lib
