"""ctypes bindings for the native wav library (native/worldio.cpp).

The library is built with g++ at first use into ``world_tpu_torch/_build/``
(ops/_cuda.py: the name carries a hash of source and flags).  Every entry
point falls back to the pure-Python reader/writer (io/audio.py) when no
toolchain is there; ``load_batch`` says which loader ran, so the fallback
never passes unseen.  The native path is the corpus feeder: a
multithreaded wav batch loader that packs padded float32 batches without
holding the GIL.
"""

import ctypes
import os
import threading
from pathlib import Path

import numpy as np

from ..ops._cuda import compile_shared

SRC = Path(__file__).resolve().parent.parent / "native" / "worldio.cpp"
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17", "-pthread")
_lock = threading.Lock()
_lib = None
_tried = False


class _WioWav(ctypes.Structure):
    _fields_ = [("samples", ctypes.POINTER(ctypes.c_double)),
                ("length", ctypes.c_int64),
                ("fs", ctypes.c_int32),
                ("nbit", ctypes.c_int32)]


def get_lib():
    """Load (building if needed) the native library, or None."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            path, _ = compile_shared("g++", CXX_FLAGS, SRC)
            lib = ctypes.CDLL(str(path))
        except (OSError, RuntimeError):
            return None
        lib.wio_read_wav.argtypes = [ctypes.c_char_p,
                                     ctypes.POINTER(_WioWav)]
        lib.wio_read_wav.restype = ctypes.c_int
        lib.wio_free.argtypes = [ctypes.POINTER(ctypes.c_double)]
        lib.wio_free.restype = None
        lib.wio_write_wav.argtypes = [ctypes.c_char_p,
                                      ctypes.POINTER(ctypes.c_double),
                                      ctypes.c_int64, ctypes.c_int32]
        lib.wio_write_wav.restype = ctypes.c_int
        lib.wio_load_batch.argtypes = [
            ctypes.c_char_p, ctypes.c_int32, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int32]
        lib.wio_load_batch.restype = ctypes.c_int
        _lib = lib
        return _lib


def wavread(path):
    """Native wav read; falls back to the Python reader."""
    lib = get_lib()
    if lib is None:
        from .audio import wavread as py_wavread
        return py_wavread(path)
    w = _WioWav()
    rc = lib.wio_read_wav(os.fsencode(path), ctypes.byref(w))
    if rc != 0:
        raise ValueError(f"wio_read_wav failed ({rc}) for {path}")
    x = np.ctypeslib.as_array(w.samples, shape=(w.length,)).copy()
    lib.wio_free(w.samples)
    return x, int(w.fs), int(w.nbit)


def wavwrite(x, fs, path):
    lib = get_lib()
    if lib is None:
        from .audio import wavwrite as py_wavwrite
        return py_wavwrite(x, fs, path)
    x = np.ascontiguousarray(x, np.float64)
    rc = lib.wio_write_wav(
        os.fsencode(path), x.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        len(x), fs)
    if rc != 0:
        raise OSError(f"wio_write_wav failed ({rc}) for {path}")


def load_batch(paths, bucket_len, n_threads=None):
    """Read ``paths`` into a padded (len(paths), bucket_len) float32
    batch.  The first file read sets fs; a file at another rate counts as
    failed, like one that cannot be read.  Returns (batch, lengths, fs,
    failed_indices, loader), ``loader`` being "native" or "python"."""
    out = np.zeros((len(paths), bucket_len), np.float32)
    lengths = np.zeros(len(paths), np.int64)
    lib = get_lib()
    if lib is None:
        from .audio import wavread as py_wavread
        failed, fs = [], 0
        for i, p in enumerate(paths):
            try:
                x, f, _ = py_wavread(p)
            except (ValueError, OSError):
                failed.append(i)
                continue
            if fs == 0:
                fs = f
            if f != fs:
                failed.append(i)
                continue
            n = min(len(x), bucket_len)
            out[i, :n] = x[:n]
            lengths[i] = len(x)
        return out, lengths, fs, failed, "python"
    if any(";" in os.fspath(p) for p in paths):
        raise ValueError("the native loader cannot take a path holding ';'")
    if n_threads is None:
        n_threads = min(16, os.cpu_count() or 1)
    fs = ctypes.c_int32(0)
    joined = b";".join(os.fsencode(p) for p in paths)
    lib.wio_load_batch(
        joined, len(paths), bucket_len,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.byref(fs), n_threads)
    failed = [i for i in range(len(paths)) if lengths[i] == 0]
    return out, lengths, int(fs.value), failed, "native"
