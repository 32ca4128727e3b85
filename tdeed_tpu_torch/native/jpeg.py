"""ctypes binding for the C++ JPEG decoder (csrc/jpeg_decode.cpp), the
port's counterpart of ``tdeed_tpu/native/jpeg.py``.

The library is built at first use, never at import: g++ with the flags of
``tdeed_tpu/native/Makefile`` into ``build/native/libjpeg_decode-<hash>.so``
in the checkout (kernels/build.py:compile_library, hashed on the source and
the command line), linked against the first libjpeg of:
  1. the system's (``jpeglib.h`` and ``-ljpeg``), as the Makefile links;
  2. the libjpeg-turbo with the 6.2 ABI that a Pillow wheel bundles
     (``site-packages/pillow.libs/libjpeg-<hash>.so.62.*``), compiled
     against the 6.2 headers in csrc/libjpeg62/, for a machine with
     Pillow and no libjpeg development files.
Both are the same decoder: the same source, the libjpeg 6.2 API, the
default IDCT and upsampling. When no route builds and loads, every
compiler's or loader's message is kept: ``available()`` is False, and
``error()`` returns them for the callers that asked for this decoder by
name (data/frames.py:get_decoder). Every entry point releases the GIL
(ctypes foreign calls), and ``decode_batch`` fans out over C++ threads
into one contiguous (N, H, W, 3) buffer.
"""

from __future__ import annotations

import ctypes
import importlib.util
import os
import re
import threading
from pathlib import Path
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from tdeed_tpu_torch.kernels.build import BUILD_ROOT, CSRC, compile_library

CXX = "g++"
CXXFLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall")
LDFLAGS = ("-shared", "-ljpeg", "-lpthread")
SOURCE = CSRC / "jpeg_decode.cpp"
HEADERS_62 = CSRC / "libjpeg62"
BUILD_DIR = BUILD_ROOT / "native"
_LIBJPEG = re.compile(r"libjpeg(-[0-9a-f]+)?\.so\.(\d+)")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_error: Optional[str] = None
_route: Optional[str] = None
_build_seconds = 0.0


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    c_int_p = ctypes.POINTER(ctypes.c_int)
    lib.tdeed_jpeg_probe.argtypes = [ctypes.c_char_p, c_int_p, c_int_p]
    lib.tdeed_jpeg_probe.restype = ctypes.c_int
    lib.tdeed_jpeg_decode.argtypes = [ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int,
                                      ctypes.c_int]
    lib.tdeed_jpeg_decode.restype = ctypes.c_int
    lib.tdeed_jpeg_decode_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int,
    ]
    lib.tdeed_jpeg_decode_batch.restype = ctypes.c_int
    return lib


def bundled_libjpeg() -> Optional[Path]:
    """The libjpeg with the 6.2 ABI that an installed Pillow wheel bundles,
    found without importing Pillow, or None."""
    spec = importlib.util.find_spec("PIL")
    for pkg in (spec.submodule_search_locations or []) if spec else []:
        found = sorted((Path(pkg).parent / "pillow.libs").glob("libjpeg-*.so.62*"))
        if found:
            return found[0]
    return None


def _routes() -> Iterator[Tuple[str, List[str], Tuple[str, ...]]]:
    """(what it links, compiler command, link flags) in the order tried."""
    yield "the system libjpeg", [CXX, *CXXFLAGS], LDFLAGS
    lib = bundled_libjpeg()
    if lib is not None:
        yield (f"Pillow's {lib}", [CXX, *CXXFLAGS, f"-I{HEADERS_62}"],
               ("-shared", str(lib), f"-Wl,-rpath,{lib.parent}", "-lpthread"))


def _load() -> Optional[ctypes.CDLL]:
    """The built library, or None with every route's failure in ``_error``."""
    global _lib, _error, _route, _build_seconds
    if _lib is not None or _error is not None:
        return _lib
    with _lock:
        if _lib is None and _error is None:
            failed = []
            for route, command, ldflags in _routes():
                try:
                    path, _build_seconds, _ = compile_library(SOURCE, BUILD_DIR, command, ldflags)
                    _lib = _bind(ctypes.CDLL(str(path)))
                except (OSError, RuntimeError) as e:
                    failed.append(f"against {route}: {e}")
                else:
                    _route = route
                    break
            if _lib is None:
                _error = "the native JPEG decoder did not build: " + "; ".join(failed)
    return _lib


def available() -> bool:
    """True when the decoder is built (building it on the first call)."""
    return _load() is not None


def error() -> Optional[str]:
    """Why the decoder is not available (the compiler's or the loader's
    message), or None when it is."""
    _load()
    return _error


def build_seconds() -> float:
    """The compiler's wall seconds in this process (0.0 when a library an
    earlier process built was reused)."""
    _load()
    return _build_seconds


def route() -> Optional[str]:
    """Which libjpeg the built decoder links, or None when it did not build."""
    _load()
    return _route


def libjpeg_path() -> Optional[str]:
    """The libjpeg file the decoder loaded: the bundled file it was linked
    against, or the system's libjpeg.so.<n> as /proc/self/maps shows it
    (a wheel's hashed copy that another module loaded is not it), or None."""
    if _load() is None:
        return None
    if _route != "the system libjpeg":
        return str(bundled_libjpeg())
    try:
        with open("/proc/self/maps") as fp:
            for line in fp:
                path = line.split()[-1]
                if re.match(r"libjpeg\.so\.\d+", os.path.basename(path)):
                    return path
    except OSError:
        pass
    return None


def libjpeg_soname() -> Optional[str]:
    """The loaded libjpeg's soname without a wheel's hash ('libjpeg.so.62',
    'libjpeg.so.8', ...): which ABI, and so which family of IDCT and
    upsampling, made the decoder's pixels."""
    path = libjpeg_path()
    m = _LIBJPEG.match(os.path.basename(path)) if path else None
    return f"libjpeg.so.{m.group(2)}" if m else None


def _lib_or_raise() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError(_error)
    return lib


def probe(path: str) -> Tuple[int, int]:
    """(height, width) from the JPEG header."""
    lib = _lib_or_raise()
    h = ctypes.c_int()
    w = ctypes.c_int()
    rc = lib.tdeed_jpeg_probe(path.encode(), ctypes.byref(h), ctypes.byref(w))
    if rc != 0:
        raise FileNotFoundError(f"jpeg probe failed ({rc}): {path}")
    return h.value, w.value


def decode(path: str) -> np.ndarray:
    """Decode one JPEG to (H, W, 3) uint8 RGB."""
    lib = _lib_or_raise()
    h, w = probe(path)
    out = np.empty((h, w, 3), np.uint8)
    rc = lib.tdeed_jpeg_decode(path.encode(), out.ctypes.data_as(ctypes.c_void_p), h, w)
    if rc != 0:
        raise OSError(f"jpeg decode failed ({rc}): {path}")
    return out


def decode_batch(
    paths: Sequence[Optional[str]],
    height: int,
    width: int,
    out: Optional[np.ndarray] = None,
    n_threads: int = 0,
) -> Tuple[np.ndarray, int]:
    """Decode a clip's frames into one contiguous (N, H, W, 3) uint8 buffer.

    ``None`` entries, missing files and frames that fail to decode (corrupt,
    or not H x W) come back as zero frames (the data layer's padding
    contract, ref: dataset/frame.py:376-382). ``out``, when given, must be
    a C-contiguous (N, H, W, 3) uint8 array. ``n_threads`` <= 0 takes
    min(8, cpu count). Returns (buffer, n_decoded).
    """
    lib = _lib_or_raise()
    n = len(paths)
    if out is None:
        out = np.empty((n, height, width, 3), np.uint8)
    if out.shape != (n, height, width, 3) or out.dtype != np.uint8:
        raise ValueError(f"out is {out.dtype} {out.shape}, not uint8 {(n, height, width, 3)}")
    # the C++ writer assumes a dense (N, H, W, 3) layout from the base
    # pointer: a strided view would scatter frames over unrelated memory
    if not out.flags["C_CONTIGUOUS"]:
        raise ValueError("out must be C-contiguous")
    arr = (ctypes.c_char_p * n)(*[p.encode() if p is not None else None for p in paths])
    if n_threads <= 0:
        n_threads = min(8, os.cpu_count() or 1)
    n_ok = lib.tdeed_jpeg_decode_batch(
        arr, n, out.ctypes.data_as(ctypes.c_void_p), height, width, n_threads
    )
    return out, int(n_ok)
