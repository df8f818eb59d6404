"""Build and load the port's native libraries: the CUDA C++ kernels
(csrc/*.cu) and the host wav loader (native/worldio.cpp).

Each source is compiled into a shared library with a plain C interface,
loaded with ctypes: the kernels with nvcc for sm_90a, the loader with
g++.  The build happens at first use, from the sources in the package,
into ``world_tpu_torch/_build/``; the library's name carries a hash of
its source and flags, so an edited source rebuilds.  Nothing here runs at
import time.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# Flags of one source on top of NVCC_FLAGS.  The contour walks, the IIR
# recurrences, Harvest's refinement and StoneMask's compute values that
# must round as the plain version's separate tensor ops do, so nvcc may
# not contract a multiply and an add into an FMA there.
SOURCE_FLAGS = {"dio_fix": ("-fmad=false",),
                "harvest_contour": ("-fmad=false",),
                "iir": ("-fmad=false",),
                "refine": ("-fmad=false",),
                "stonemask": ("-fmad=false",)}


def nvcc():
    """Path of the CUDA compiler: $CUDA_HOME/bin/nvcc, else PATH, else
    /usr/local/cuda/bin/nvcc."""
    home = os.environ.get("CUDA_HOME")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    candidates += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def hashed_path(src, flags):
    """Library path for ``src`` built with ``flags``."""
    digest = hashlib.sha256(Path(src).read_bytes()
                            + " ".join(flags).encode()).hexdigest()
    return BUILD_DIR / f"lib{Path(src).stem}-{digest[:16]}.so"


def compile_shared(compiler, flags, src):
    """Compile ``src`` with ``compiler`` unless its library is already
    built.  Returns (library path, compiler log; None when nothing was
    built).  Raises RuntimeError when the compiler fails, OSError when it
    cannot be run."""
    out = hashed_path(src, flags)
    if out.exists():
        return out, None
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [compiler, *flags, "-o", str(tmp), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{compiler} failed for {Path(src).name}:\n"
                           f"{proc.stderr}")
    os.replace(tmp, out)
    return out, proc.stdout + proc.stderr


def build(name):
    """Compile csrc/<name>.cu (NVCC_FLAGS and its SOURCE_FLAGS) unless its
    library is already built.  Returns (library path, compiler log; None
    when nothing was built)."""
    return compile_shared(nvcc(), NVCC_FLAGS + SOURCE_FLAGS.get(name, ()),
                          CSRC / f"{name}.cu")


@functools.lru_cache(maxsize=None)
def load(name):
    """ctypes handle of the built csrc/<name>.cu library."""
    path, _ = build(name)
    return ctypes.CDLL(str(path))


@functools.lru_cache(maxsize=None)
def entry(source, symbol, argtypes):
    """The C entry ``symbol`` of csrc/<source>.cu's library, its argument
    types set once (it returns a cudaError_t)."""
    fn = getattr(load(source), symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def launch(what, fn, device, *args):
    """Call the C entry ``fn`` with ``args`` and the current stream of the
    CUDA ``device``; raise on a failed launch."""
    import torch

    stream = torch.cuda.current_stream(device).cuda_stream
    if device.index == torch.cuda.current_device():
        rc = fn(*args, stream)
    else:
        with torch.cuda.device(device):
            rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: cudaError {rc}")
