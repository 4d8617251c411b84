"""Build and bind the package's CUDA kernels.

At first use ``nvcc`` compiles every ``csrc/*.cu`` for ``sm_90a`` (one
process per source, all started together), links them into one shared
library with a plain C interface under ``build/libsdr_tpu_torch/`` at the
root of the checkout, named by the hash of all the sources (``*.cu`` and
``*.cuh``) and flags, and ``ctypes`` loads it.  A library already built
from the same sources is reused.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "libsdr_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v"]


def sources() -> list[Path]:
    """The compiled units: every ``csrc/*.cu`` (the ``*.cuh`` headers are
    included by them)."""
    return sorted(CSRC.glob("*.cu"))


def _digest(flags: list[str]) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    for path in sources() + sorted(CSRC.glob("*.cuh")):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    return h.hexdigest()


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME): the "
                           "kernels are built with nvcc at first use")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def build(defines: tuple[str, ...] = ()) -> tuple[Path, str]:
    """Compile the kernel library unless a build of the same sources exists.

    ``defines`` are extra ``NAME=VALUE`` macros (``tools/fir_paths.py``
    builds variants with them).  Returns (path of the shared library,
    compiler log; empty when the library was already there)."""
    flags = NVCC_FLAGS + [f"-D{d}" for d in defines]
    lib = BUILD_DIR / f"sdr_kernels-{_digest(flags)[:16]}.so"
    if lib.exists():
        return lib, ""
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    work = BUILD_DIR / f"objs.{os.getpid()}.{lib.stem}"
    work.mkdir(exist_ok=True)
    try:
        procs = []
        for src in sources():
            obj = work / (src.stem + ".o")
            cmd = [nvcc, *flags, "-c", "-o", str(obj), str(src)]
            procs.append((obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        log, failed = [], []
        for obj, proc in procs:
            out, _ = proc.communicate()
            log.append(out)
            if proc.returncode != 0:
                failed.append(f"{obj.stem}.cu ({proc.returncode})")
        if failed:
            raise RuntimeError("nvcc failed: " + ", ".join(failed) + "\n"
                               + "".join(log))
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, "-shared", "-o", str(tmp), *(str(o) for o, _ in procs)]
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              check=False)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return lib, "".join(log)


@functools.cache
def library(defines: tuple[str, ...] = ()) -> ctypes.CDLL:
    """The loaded kernel library (of :func:`build`), with every entry
    point's signature set."""
    path, _ = build(defines)
    lib = ctypes.CDLL(str(path))
    p, i64, i32, f32, f64 = (ctypes.c_void_p, ctypes.c_longlong,
                             ctypes.c_int, ctypes.c_float, ctypes.c_double)
    lib.sdr_fir_exact.argtypes = [
        i32,                 # mode
        p, p, p, p,          # xr, xi, tail_r, tail_i
        p, p,                # taps_r, taps_i
        p, p,                # prev_r, prev_i (fm)
        p, p, p, p,          # ramp_r, ramp_i, ph_r, ph_i (usb)
        p, p, p, p,          # out, out_i, ylast_r, ylast_i
        p, p, p,             # s_in, s_out, ends
        i64, i64, i32, i32,  # C, B, T, D
        i32, i32,            # K, K_agc (chunks per channel)
        f32, f32, f32,       # rot_r, rot_i, gain
        f64, f64, i32,       # a, b, iir (de-emphasis or AGC)
        p, i32,              # afsk: 13 operand pointers, window L
        i32, i32, p]         # fast (one bf16 pass), bf16 planes, stream
    lib.sdr_fir_exact.restype = i32
    lib.sdr_fir_mxu.argtypes = [
        p, p, p, p,          # xr, xi, tail_r, tail_i
        p, p, p, p,          # taps_r, taps_i, out, out_i
        i64, i64, i32, i32,  # C, B, T, D
        i64, i64, i64,       # window start s0, n_out, wrap
        i32, i32, i32, p]    # K, fast (one bf16 pass), bf16 planes, stream
    lib.sdr_fir_mxu.restype = i32
    lib.sdr_fir_fm_mxu.argtypes = [
        i32, p, p,           # mode, xr, xi
        p, p, p, p,          # taps_r, taps_i, prev_r, prev_i (fm)
        p, p, p,             # out, ylast_r, ylast_i (fm)
        p, p, p,             # s_in, s_out, ends
        i64, i64, i32, i32,  # C, B, T, D
        i64, i32, i32,       # window start s0, K, K_agc
        f32, f32, f32,       # rot_r, rot_i, gain
        f64, f64, i32,       # a, b, iir (de-emphasis or AGC)
        i32, i32, p]         # fast (one bf16 pass), bf16 planes, stream
    lib.sdr_fir_fm_mxu.restype = i32
    lib.sdr_pll.argtypes = [
        p, p, p, p, p, p,    # sym, signs, ss_in, ph_in, om_in, lb_in
        p, p, p, p, p,       # per-lane omin, omax, gain, transition, ell
        f32, f32, f32,       # omin, omax, gain (scalars)
        i32, i32,            # transition, ell (scalars)
        p, p,                # scratch, out
        p, p, p, p,          # ss_out, ph_out, om_out, lb_out
        i64, i64, i32, p]    # M, T, R, stream
    lib.sdr_pll.restype = i32
    lib.sdr_pll_scratch_words.argtypes = [i64, i64]   # M, T
    lib.sdr_pll_scratch_words.restype = i64
    lib.sdr_pll_lanes_per_warp.argtypes = [i64]       # M
    lib.sdr_pll_lanes_per_warp.restype = i32
    lib.sdr_pfb.argtypes = [
        p, p, p, p,          # xr, xi, hist_r, hist_i
        p, p, p,             # taps3, twiddle table re, im
        p, p,                # prev_r, prev_i (demod)
        p, p,                # out_r, out_i
        p, p, p, p,          # y_last r, i, y_first r, i (demod)
        i64, i64, i32, i32,  # C, F, M, P
        f32, i32, i32, p,    # gain, demod, bf16 planes, stream
        ctypes.POINTER(ctypes.c_int)]  # the route taken (out)
    lib.sdr_pfb.restype = i32
    lib.sdr_pfb_route.argtypes = [i32, i32]           # M, P
    lib.sdr_pfb_route.restype = i32
    # mode, tensor-core mode of the entry, C, n_out, T, D, L, bf16 planes,
    # fast, the route (out)
    lib.sdr_fir_chunks.argtypes = [i32, i32, i64, i64, i32, i32, i32, i32,
                                   i32, p]
    lib.sdr_fir_chunks.restype = i32
    # T, D, L (mode afsk's window, else 0), bf16 planes, fast, the plan
    # (out, 8 ints)
    lib.sdr_fir_tc_plan.argtypes = [i32, i32, i32, i32, i32, p]
    lib.sdr_fir_tc_plan.restype = i32
    lib.sdr_psk31.argtypes = [
        p, p, p, p,          # xr, xi, bank, dl_idx
        p, p,                # the carry's 19 pointers in, out (host arrays)
        p, p,                # bits, emits
        f32, f32, f32,       # alpha, beta, df
        f32, f32,            # omega_min, omega_max
        f32, f32, f32,       # gain_mu, gain_omega, 2 pi
        i64, i64, p]         # C, T, stream
    lib.sdr_psk31.restype = i32
    lib.sdr_deemph_int.argtypes = [
        p, p, p, p,          # x, avg_in, y, avg_out
        i64, i64, i32, i32,  # C, T, alpha, half
        p]                   # stream
    lib.sdr_deemph_int.restype = i32
    lib.sdr_window_pack.argtypes = [
        p, p, p,             # in, rows (or null), out
        i64, i64, i64, i64,  # M, C, T, w
        p, ctypes.POINTER(ctypes.c_int)]  # stream, the route taken (out)
    lib.sdr_window_pack.restype = i32
    lib.sdr_agc_chunks.argtypes = [i64, i64]
    lib.sdr_agc_chunks.restype = i32
    lib.sdr_cuda_error_string.argtypes = [i32]
    lib.sdr_cuda_error_string.restype = ctypes.c_char_p
    return lib
