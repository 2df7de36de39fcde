"""Build the port's hand-written CUDA sources at first use.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` into a shared library that ``ctypes`` loads (no PyTorch headers,
so a build takes seconds).  Libraries land in ``build/kernels/`` at the
repository root, named by a hash of the source and the flags, so an edited
source is rebuilt and a stale library is never loaded.  Nothing here runs at
import time: the CPU tests import every module on machines without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"

#: Hopper only (``sm_90a``).  ``-fmad=false`` keeps every multiply and add
#: separately rounded, as the search's bit-exact contract needs; no
#: ``--use_fast_math``, so double division stays IEEE round-to-nearest.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-fmad=false", "-std=c++17",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def nvcc_path() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found on PATH or under /usr/local/cuda/bin")
    return found


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to, keyed on its source and flags."""
    key = hashlib.sha256(
        (CSRC / f"{name}.cu").read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{key}.so"


def build_command(name: str, out: Path) -> List[str]:
    return [nvcc_path(), *NVCC_FLAGS, "-o", str(out), str(CSRC / f"{name}.cu")]


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library is already built; the
    compiler's report (registers, shared memory, spills) goes to a ``.log``
    beside the library.  Concurrent builders each write a private temporary
    file and rename it into place."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run(
        build_command(name, tmp), capture_output=True, text=True, check=False
    )
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed on csrc/{name}.cu (exit {proc.returncode}):\n"
            + proc.stdout + proc.stderr
        )
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


def build_all(names: Sequence[str]) -> Dict[str, float]:
    """Build several sources at once, one ``nvcc`` each, all started
    together; returns each build's wall seconds (near 0 if already built).
    The first failure is raised once all have finished."""
    def timed(name: str) -> float:
        t0 = time.perf_counter()
        build(name)
        return time.perf_counter() - t0

    with ThreadPoolExecutor(max_workers=max(len(names), 1)) as pool:
        futures = {name: pool.submit(timed, name) for name in names}
        return {name: f.result() for name, f in futures.items()}


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    return ctypes.CDLL(str(build(name)))
