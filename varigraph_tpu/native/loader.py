"""On-demand build + ctypes loading of the native helpers.

The shared library is compiled once per machine into the package directory
(falls back to a temp dir if read-only); all callers degrade gracefully to
the pure-Python paths if no C++ toolchain is available.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading

from ..utils.log import log

_LOCK = threading.Lock()
_LIB = None
_TRIED = False

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fastq_reader.cpp")


def _build(out_path: str) -> bool:
    base = ["g++", "-O3", "-march=native", "-shared", "-fPIC",
            "-o", out_path, _SRC]
    # prefer libdeflate (whole-file inflate ~2-3x faster than zlib); fall
    # back to plain zlib when the library/headers are absent
    for extra in (["-DVGF_USE_LIBDEFLATE", "-lz", "-ldeflate"], ["-lz"]):
        try:
            r = subprocess.run(
                base + extra, capture_output=True, text=True, timeout=300,
            )
            if r.returncode == 0:
                return True
        except Exception:
            pass
    return False


def get_fastq_lib():
    """Returns the loaded ctypes library, or None if unavailable."""
    global _LIB, _TRIED
    with _LOCK:
        if _TRIED:
            return _LIB
        _TRIED = True
        candidates = [
            os.path.join(os.path.dirname(_SRC), "libvgfastq.so"),
            os.path.join(tempfile.gettempdir(), "libvgfastq.so"),
        ]
        for so in candidates:
            if not os.path.exists(so) or os.path.getmtime(so) < os.path.getmtime(_SRC):
                if not _build(so):
                    continue
            try:
                lib = ctypes.CDLL(so)
            except OSError:
                continue
            lib.vgf_open.restype = ctypes.c_void_p
            lib.vgf_open.argtypes = [ctypes.c_char_p]
            lib.vgf_next_batch.restype = ctypes.c_long
            lib.vgf_next_batch.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_ubyte),
                ctypes.c_long, ctypes.c_long, ctypes.c_long,
                ctypes.POINTER(ctypes.c_long),
            ]
            try:
                lib.vgf_next_batch_packed.restype = ctypes.c_long
                lib.vgf_next_batch_packed.argtypes = [
                    ctypes.c_void_p, ctypes.POINTER(ctypes.c_ubyte),
                    ctypes.c_long, ctypes.c_long, ctypes.c_long,
                    ctypes.POINTER(ctypes.c_long),
                ]
            except AttributeError:  # stale .so without the packed API
                pass
            lib.vgf_close.restype = None
            lib.vgf_close.argtypes = [ctypes.c_void_p]
            lib.vgf_inflate_backend.restype = ctypes.c_char_p
            log(f"native FASTQ reader: {so} "
                f"({lib.vgf_inflate_backend().decode()})")
            _LIB = lib
            return _LIB
        return None


def native_available() -> bool:
    return get_fastq_lib() is not None
