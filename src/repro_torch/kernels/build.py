"""Build the port's CUDA sources (``src/repro_torch/csrc/*.cu``) with
``nvcc`` into shared libraries with a plain C interface, and load them
with ``ctypes``.

Each source builds at first use into ``build/repro_torch/`` at the root
of the checkout, under a name keyed by a hash of the source and the
compiler flags, so a re-run reuses the library and an edited source
rebuilds.  Nothing is built when the package is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Callable, Dict, List

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = CSRC.parents[2] / "build" / "repro_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

#: nvcc's output (ptxas register / shared-memory report) per built source
build_log: Dict[str, str] = {}

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found: the CUDA kernels are compiled at first use and "
        "need the CUDA toolkit (nvcc on PATH or under CUDA_HOME)")


def sources() -> List[str]:
    """Names of every CUDA source of the package."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def library_path(name: str) -> Path:
    """The library's path, keyed by the source, the shared headers
    (``csrc/*.cuh``) and the flags."""
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library is already built."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}.cu:\n{proc.stderr}")
    build_log[name] = proc.stdout + proc.stderr
    os.replace(tmp, out)          # atomic: concurrent builders agree
    return out


def build_all() -> Dict[str, Path]:
    """Compile every source at once, one nvcc process per source."""
    names = sources()
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as ex:
        paths = list(ex.map(build, names))
    return dict(zip(names, paths))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            _libs[name] = lib
        return lib


def launch_on(t: torch.Tensor, entry: Callable[..., int], *args) -> int:
    """``entry(*args, stream)``: a library's C entry point called with
    PyTorch's current CUDA stream on ``t``'s device, with that device
    current during the call; returns the entry's CUDA error code.  It
    switches devices only when ``t`` is not on the current one."""
    dev = t.get_device()
    stream = torch.cuda.current_stream(dev).cuda_stream
    if torch.cuda.current_device() == dev:
        return entry(*args, stream)
    with torch.cuda.device(dev):
        return entry(*args, stream)
