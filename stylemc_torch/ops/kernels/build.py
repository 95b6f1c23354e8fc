"""Build a kernel library with nvcc at first use.

The library is a shared object with a plain C interface (no torch headers),
so a build takes seconds. It lands in
`build/stylemc_torch_kernels/<md5 of sources and flags>/lib<name>.so` under
the repository root; a file lock makes concurrent first uses wait for one
build. A failed build raises with nvcc's output.
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Sequence

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_REPO_ROOT = Path(__file__).resolve().parents[3]
BUILD_ROOT = _REPO_ROOT / "build" / "stylemc_torch_kernels"


def find_nvcc() -> str:
    for cand in (os.environ.get("CUDACXX"), shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError("nvcc not found (set CUDACXX or put the CUDA "
                       "toolkit's bin/ on PATH); it builds the port's kernels")


def library_dir(sources: Sequence[Path]) -> Path:
    h = hashlib.md5()
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_ROOT / h.hexdigest()


def build_library(name: str, sources: Sequence[Path]) -> Path:
    """Compile the `.cu` files of `sources` into lib<name>.so (cached by the
    content of all of `sources`, headers included) and return its path.
    `build.log` beside it keeps the command and ptxas' report."""
    sources = [Path(s) for s in sources]
    out_dir = library_dir(sources)
    lib = out_dir / f"lib{name}.so"
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if lib.exists():  # another process built it while we waited
            return lib
        tmp = out_dir / f"lib{name}.so.tmp{os.getpid()}"
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               *(str(s) for s in sources if s.suffix == ".cu")]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        (out_dir / "build.log").write_text(
            " ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"nvcc failed with code {proc.returncode} building {name}:\n"
                f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib)
    return lib
