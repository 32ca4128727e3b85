"""Build the port's CUDA sources (``tdeed_tpu_torch/csrc``) into shared
libraries with a plain C interface, loaded with ctypes.

nvcc runs at first use, never at import; the library lands under
``build/kernels/`` in the checkout (listed in .gitignore), named by a hash
of its source and flags, so an edited source rebuilds and an unchanged one
is reused by later processes. ``compile_library`` is the same build for
any compiler: the native JPEG decoder (native/jpeg.py) builds its C++
source with g++ through it into ``build/native/``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Sequence, Tuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build"
BUILD_DIR = BUILD_ROOT / "kernels"

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


def compile_library(src: Path, out_dir: Path, command: Sequence[str],
                    libs: Sequence[str] = ()) -> Tuple[Path, float, str]:
    """Build ``src`` into ``out_dir/lib<stem>-<hash>.so`` unless that file
    exists: ``command`` (the compiler and its flags), ``-o``, the source,
    then ``libs`` (link flags go after the source). The hash covers the
    source and the whole command line. Returns (path, compiler seconds,
    compiler output); both are 0.0 and "" when a built library is reused.
    Raises RuntimeError with the compiler's output when it fails, OSError
    when the compiler cannot be run."""
    digest = hashlib.sha256(
        src.read_bytes() + " ".join([*command, *libs]).encode()
    ).hexdigest()[:16]
    path = out_dir / f"lib{src.stem}-{digest}.so"
    if path.exists():
        return path, 0.0, ""
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([*command, "-o", str(tmp), str(src), *libs],
                          capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{command[0]} failed on {src} ({proc.returncode}):\n{log}")
    os.replace(tmp, path)  # atomic: a concurrent build never sees half a file
    return path, seconds, log


@functools.lru_cache(maxsize=None)
def load(name: str) -> Built:
    """Compile ``csrc/<name>.cu`` if needed and load it."""
    path, seconds, log = compile_library(CSRC / f"{name}.cu", BUILD_DIR, [_nvcc(), *NVCC_FLAGS])
    return Built(ctypes.CDLL(str(path)), path, seconds, log)
