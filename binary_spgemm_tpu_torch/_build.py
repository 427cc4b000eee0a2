"""Build the port's CUDA kernels and load them with ctypes.

Every ``csrc/*.cu`` compiles with ``nvcc`` into its own shared library under
``build/`` beside this file, at first use, one ``nvcc`` process per source,
all started together.  The library name carries a hash of its source, so an
edited kernel is rebuilt and a stale one is never loaded.  Sources expose a
plain C interface: every pointer and the stream travel as ``c_void_p``, and
each entry point returns ``cudaGetLastError()`` after its launch.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

__all__ = ["NVCC_FLAGS", "build_all", "build_log", "load"]

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD = _PKG / "build"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

# source stem -> {"seconds": wall time of its nvcc, "ptxas": compiler report};
# filled by builds in this process, empty when the libraries were cached
build_log: dict[str, dict] = {}
_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if path.is_file():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the CUDA kernels cannot be built"
        )
    return found


def _target(src: Path) -> Path:
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD / f"lib{src.stem}-{digest.hexdigest()[:12]}.so"


def build_all() -> dict[str, Path]:
    """Compile every source whose library is missing, in parallel; return
    ``{stem: library path}``.  Raises with the compiler's output if any
    build fails."""
    sources = sorted(CSRC.glob("*.cu"))
    targets = {src.stem: _target(src) for src in sources}
    todo = [src for src in sources if not targets[src.stem].exists()]
    if not todo:
        return targets
    BUILD.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for src in todo:
        tmp = targets[src.stem].with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        procs.append((src, tmp, proc, time.perf_counter()))
    failures = []
    for src, tmp, proc, t0 in procs:
        out, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"{src.name} (exit {proc.returncode}):\n{out}")
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, targets[src.stem])
        build_log[src.stem] = {"seconds": seconds, "ptxas": out}
    if failures:
        raise RuntimeError("nvcc failed for " + "\n".join(failures))
    return targets


def load(stem: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<stem>.cu`` (built on first use)."""
    with _lock:
        lib = _libs.get(stem)
        if lib is None:
            targets = build_all()
            if stem not in targets:
                raise FileNotFoundError(f"no kernel source csrc/{stem}.cu")
            lib = ctypes.CDLL(str(targets[stem]))
            _libs[stem] = lib
        return lib
