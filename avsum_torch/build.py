"""Build the port's native code from the checkout's sources, at first use.

- CUDA kernels: each ``csrc/<name>.cu`` compiles with ``nvcc`` for
  ``sm_90a`` into a shared library with a plain C interface, loaded with
  ctypes. No PyTorch headers are included, so a build takes seconds. The
  library is cached under ``build/avsum_torch/`` by a hash of its source,
  of every ``csrc`` header it includes, and of the flags; ``nvcc``'s
  ``-Xptxas -v`` report (registers, shared memory, spills) is kept beside
  it as ``<lib>.log``.
- The host decoder ``native/avsumio.cc`` compiles with ``g++`` (no
  ``-march=native``) into ``native/build/libavsumio.so``, the first place
  ``avsum_torch.io.native`` looks. Call :func:`ensure_native_io` before the
  first video is opened in the process.

Run ``python -m avsum_torch.build`` to build everything (the kernels in
parallel) and print the ptxas reports.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List

PKG_DIR = Path(__file__).resolve().parent
REPO_ROOT = PKG_DIR.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = REPO_ROOT / "build" / "avsum_torch"
KERNELS = ("melspec", "flash_fwd", "flash_bwd", "gemm_tf32x3", "kda")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
NATIVE_SRC = REPO_ROOT / "native" / "avsumio.cc"
NATIVE_LIB = REPO_ROOT / "native" / "build" / "libavsumio.so"
GXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-pthread", "-shared"]

_LOADED: Dict[str, ctypes.CDLL] = {}
_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]+"([^"]+)"', re.M)


def _tag(data: bytes, flags: List[str]) -> str:
    return hashlib.sha256(data + "\0".join(flags).encode()).hexdigest()[:16]


def _run(cmd: List[str], what: str) -> str:
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(
            f"building {what} failed ({' '.join(cmd)}):\n{res.stderr}")
    return res.stderr


def nvcc_path() -> str:
    home = Path(os.environ.get("CUDA_HOME") or "/usr/local/cuda")
    if (home / "bin" / "nvcc").exists():
        return str(home / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found: the CUDA kernels build only where the CUDA "
            "toolkit is installed (set CUDA_HOME)")
    return found


def _source_bytes(src: Path, seen=None) -> bytes:
    """``src`` followed by every header beside it that it includes
    (``#include "..."``), recursively, each once."""
    seen = set() if seen is None else seen
    seen.add(src)
    data = src.read_bytes()
    for name in _INCLUDE.findall(data):
        header = src.parent / name.decode()
        if header.exists() and header not in seen:
            data += b"\0" + _source_bytes(header, seen)
    return data


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` is cached: the name carries
    a hash of the source, the headers it includes and the flags."""
    src = CSRC_DIR / f"{name}.cu"
    return BUILD_DIR / f"lib{name}-{_tag(_source_bytes(src), NVCC_FLAGS)}.so"


def kernel_library(name: str) -> Path:
    """Path of the built ``csrc/<name>.cu`` library, building it if the
    cache holds no library for this source."""
    src = CSRC_DIR / f"{name}.cu"
    out = library_path(name)
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        log = _run([nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                   str(src))
        out.with_name(out.name + ".log").write_text(log)
        os.replace(tmp, out)
    return out


def build_all() -> List[Path]:
    """Build every kernel library, one ``nvcc`` per source, all at once."""
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        return list(pool.map(kernel_library, KERNELS))


def load_kernel(name: str) -> ctypes.CDLL:
    """The loaded kernel library (built on first use in this checkout)."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(kernel_library(name)))
        _LOADED[name] = lib
    return lib


def ensure_native_io() -> Path:
    """Build ``native/build/libavsumio.so`` from ``native/avsumio.cc``
    unless the build there matches the source (a hash stamp beside it)."""
    tag = _tag(NATIVE_SRC.read_bytes(), GXX_FLAGS)
    stamp = NATIVE_LIB.with_name(NATIVE_LIB.name + ".tag")
    if NATIVE_LIB.exists() and stamp.exists() and stamp.read_text() == tag:
        return NATIVE_LIB
    NATIVE_LIB.parent.mkdir(parents=True, exist_ok=True)
    tmp = NATIVE_LIB.with_name(f"{NATIVE_LIB.name}.{os.getpid()}.tmp")
    _run([shutil.which("g++") or "g++", *GXX_FLAGS, str(NATIVE_SRC),
          "-o", str(tmp)], str(NATIVE_SRC))
    os.replace(tmp, NATIVE_LIB)
    stamp.write_text(tag)
    return NATIVE_LIB


if __name__ == "__main__":
    print(f"built {ensure_native_io()}")
    for lib in build_all():
        print(f"built {lib}")
        print(lib.with_name(lib.name + ".log").read_text())
