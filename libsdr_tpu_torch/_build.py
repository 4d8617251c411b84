"""Build and bind the package's CUDA kernels.

At first use ``nvcc`` compiles ``csrc/fir_fm_exact.cu`` for ``sm_90a`` into a
shared library with a plain C interface under ``build/libsdr_tpu_torch/`` at
the root of the checkout, named by the hash of its source, and ``ctypes``
loads it.  A library already built from the same source is reused.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent
SOURCE = _PKG / "csrc" / "fir_fm_exact.cu"
BUILD_DIR = _PKG.parent / "build" / "libsdr_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME): the "
                           "kernels are built with nvcc at first use")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def build() -> tuple[Path, str]:
    """Compile the kernel library unless a build of the same source exists.

    Returns (path of the shared library, compiler log; empty when the
    library was already there)."""
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    lib = BUILD_DIR / f"fir_fm_exact-{digest[:16]}.so"
    if lib.exists():
        return lib, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    return lib, proc.stdout + proc.stderr


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, with every entry point's signature set."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    p, i64, i32, f32 = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                        ctypes.c_float)
    lib.sdr_fir_fm_exact.argtypes = [
        p, p, p, p,          # xr, xi, tail_r, tail_i
        p, p,                # taps_r, taps_i
        p, p, p,             # prev_r, prev_i, dstate
        p, p, p, p,          # out, ylast_r, ylast_i, ends
        i64, i64, i32, i32,  # C, B, T, D
        i32,                 # K (chunks per channel)
        f32, f32, f32,       # rot_r, rot_i, gain
        f32, f32, i32,       # a, b, deemph
        i32, p]              # bf16 planes, stream
    lib.sdr_fir_fm_exact.restype = i32
    lib.sdr_fir_fm_exact_chunks.argtypes = [i64, i64, i32, i32, i32]
    lib.sdr_fir_fm_exact_chunks.restype = i32
    lib.sdr_cuda_error_string.argtypes = [i32]
    lib.sdr_cuda_error_string.restype = ctypes.c_char_p
    return lib
