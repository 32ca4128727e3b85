"""Build the port's CUDA sources (``tdeed_tpu_torch/csrc``) into shared
libraries with a plain C interface, loaded with ctypes.

nvcc runs at first use, never at import; the library lands under
``build/kernels/`` in the checkout (listed in .gitignore), named by a hash
of its source and flags, so an edited source rebuilds and an unchanged one
is reused by later processes.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"

# No fast math. FMA on: each kernel is held to 1 bf16 ulp of its fp32 plain
# version, which a fused multiply-add's one rounding fits easily, and it
# halves the instructions of the products and the blur.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "--fmad=true",
    "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
)


@dataclass(frozen=True)
class Built:
    lib: ctypes.CDLL
    path: Path
    seconds: float  # nvcc wall time; 0.0 when a cached library was reused
    log: str  # nvcc/ptxas output (registers, shared memory, spills)


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found on PATH, in $CUDA_HOME or /usr/local/cuda")


@functools.lru_cache(maxsize=None)
def load(name: str) -> Built:
    """Compile ``csrc/<name>.cu`` if needed and load it."""
    src = CSRC / f"{name}.cu"
    flags = NVCC_FLAGS
    digest = hashlib.sha256(src.read_bytes() + " ".join(flags).encode()).hexdigest()[:16]
    path = BUILD_DIR / f"lib{name}-{digest}.so"
    seconds, log = 0.0, ""
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [_nvcc(), *flags, "-o", str(tmp), str(src)],
            capture_output=True, text=True,
        )
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src} ({proc.returncode}):\n{log}")
        os.replace(tmp, path)  # atomic: concurrent builders never see half a file
    return Built(ctypes.CDLL(str(path)), path, seconds, log)
