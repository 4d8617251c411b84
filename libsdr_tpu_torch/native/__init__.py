"""Native host runtime (counterpart of ``libsdr_tpu.native``): C++ through
ctypes.

At first use ``g++`` builds ``src/sdr_native.cc`` into
``build/libsdr_tpu_torch/`` at the root of the checkout, named by the hash
of the source and flags (as ``_build.py`` names the kernel library), and
``ctypes`` loads it.  A library built from the same source is reused.  It
holds the wire-format converters, the SPSC byte ring, the file and live
pumps (ingest threads) and the POCSAG and AX.25 state machines.

There is no fallback: when ``g++`` is missing or the build fails,
:func:`get_lib` raises with the compiler's log.  The numpy converters and
the Python pump thread are kept as *plain versions* under their own names
(``*_plain``, :class:`PyLivePump`), which the tests hold the library
against; no code path takes them because the library is missing.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_HERE = Path(__file__).resolve().parent
SRC = _HERE / "src" / "sdr_native.cc"
BUILD_DIR = _HERE.parent.parent / "build" / "libsdr_tpu_torch"
GXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]


def build(build_dir: Path = None) -> tuple[Path, str]:
    """Compile the library unless a build of the same source and flags
    exists in ``build_dir`` (default :data:`BUILD_DIR`).  Returns (path of
    the shared library, compiler log; empty when it was already there).
    Raises RuntimeError when ``g++`` is not on the PATH or fails."""
    build_dir = Path(BUILD_DIR if build_dir is None else build_dir)
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode() + b"\0"
                       + SRC.read_bytes())
    lib = build_dir / f"sdr_native-{h.hexdigest()[:16]}.so"
    if lib.exists():
        return lib, ""
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found on the PATH: the native host "
                           f"runtime is built from {SRC} at first use")
    build_dir.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [gxx, *GXX_FLAGS, str(SRC), "-o", str(tmp), "-lpthread"]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                          check=False)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed ({proc.returncode}) building {SRC}:"
                           f"\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)   # atomic: concurrent builders race harmlessly
    return lib, proc.stdout + proc.stderr


@functools.cache
def get_lib() -> ctypes.CDLL:
    """The loaded library (built if needed), every entry's signature set."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    c_i64, c_p, c_int = ctypes.c_int64, ctypes.c_void_p, ctypes.c_int
    lib.u8_iq_to_planar_f32.argtypes = [c_p, c_i64, c_p, c_p]
    lib.u8_iq_to_planar_bf16.argtypes = [c_p, c_i64, c_p, c_p]
    lib.s16_iq_to_planar_f32.argtypes = [c_p, c_i64, c_p, c_p]
    lib.s16_to_f32.argtypes = [c_p, c_i64, c_p]
    lib.u8_to_f32.argtypes = [c_p, c_i64, c_p]
    lib.f32_planar_to_s16_interleaved.argtypes = [c_p, c_p, c_i64, c_p]
    lib.ring_create.argtypes = [c_i64]
    lib.ring_create.restype = c_p
    lib.ring_destroy.argtypes = [c_p]
    lib.ring_available.argtypes = [c_p]
    lib.ring_available.restype = c_i64
    lib.ring_space.argtypes = [c_p]
    lib.ring_space.restype = c_i64
    lib.ring_put.argtypes = [c_p, c_p, c_i64]
    lib.ring_put.restype = c_i64
    lib.ring_take.argtypes = [c_p, c_p, c_i64]
    lib.ring_take.restype = c_i64
    lib.ring_eos.argtypes = [c_p]
    lib.ring_eos.restype = c_int
    lib.ring_set_eos.argtypes = [c_p]
    lib.pump_start.argtypes = [ctypes.c_char_p, c_p, c_i64]
    lib.pump_start.restype = c_p
    lib.pump_stop.argtypes = [c_p]
    lib.live_pump_tcp_connect.argtypes = [ctypes.c_char_p, c_int, c_p,
                                          c_i64, c_i64, c_int]
    lib.live_pump_tcp_connect.restype = c_p
    lib.live_pump_tcp_listen.argtypes = [c_int, c_p, c_i64, c_i64]
    lib.live_pump_tcp_listen.restype = c_p
    lib.live_pump_udp.argtypes = [c_int, c_p, c_i64, c_i64]
    lib.live_pump_udp.restype = c_p
    lib.live_pump_fifo.argtypes = [ctypes.c_char_p, c_p, c_i64, c_i64]
    lib.live_pump_fifo.restype = c_p
    lib.live_pump_fd.argtypes = [c_int, c_p, c_i64, c_i64]
    lib.live_pump_fd.restype = c_p
    lib.live_pump_port.argtypes = [c_p]
    lib.live_pump_port.restype = c_int
    lib.live_pump_bytes_in.argtypes = [c_p]
    lib.live_pump_bytes_in.restype = c_i64
    lib.live_pump_bytes_dropped.argtypes = [c_p]
    lib.live_pump_bytes_dropped.restype = c_i64
    lib.live_pump_stop.argtypes = [c_p, ctypes.POINTER(c_i64),
                                   ctypes.POINTER(c_i64)]
    lib.pocsag_decode.argtypes = [c_p, c_i64, c_p, c_p, c_i64, c_i64]
    lib.pocsag_decode.restype = c_i64
    lib.ax25_decode.argtypes = [c_p, c_i64, c_p, c_p, c_i64, c_i64]
    lib.ax25_decode.restype = c_i64
    for name in ("u8_iq_to_planar_f32", "u8_iq_to_planar_bf16",
                 "s16_iq_to_planar_f32", "s16_to_f32", "u8_to_f32",
                 "f32_planar_to_s16_interleaved", "ring_destroy",
                 "ring_set_eos", "pump_stop", "live_pump_stop"):
        getattr(lib, name).restype = None
    return lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


# ---------------------------------------------------------------------------
# Converters, and their plain numpy versions
# ---------------------------------------------------------------------------

def u8_iq_to_planar(src: np.ndarray):
    """Interleaved u8 IQ (the rtl_sdr wire format, reference:
    src/rtlsource.cc:141-145) -> (re, im) float32 planes."""
    src = np.ascontiguousarray(src, dtype=np.uint8)
    n = len(src) // 2
    re, im = np.empty(n, np.float32), np.empty(n, np.float32)
    get_lib().u8_iq_to_planar_f32(_ptr(src), n, _ptr(re), _ptr(im))
    return re, im


def u8_iq_to_planar_bf16(src: np.ndarray):
    """Interleaved u8 IQ -> (re, im) bfloat16 planes as uint16 bit patterns
    (view them as ``torch.bfloat16``).  Lossless: bf16 holds every
    (u8 - 128)/128 exactly, at half the bytes of float32 planes."""
    src = np.ascontiguousarray(src, dtype=np.uint8)
    n = len(src) // 2
    re, im = np.empty(n, np.uint16), np.empty(n, np.uint16)
    get_lib().u8_iq_to_planar_bf16(_ptr(src), n, _ptr(re), _ptr(im))
    return re, im


def s16_iq_to_planar(src: np.ndarray):
    """Interleaved s16 IQ -> (re, im) float32 planes (x / 32768)."""
    src = np.ascontiguousarray(src, dtype=np.int16)
    n = len(src) // 2
    re, im = np.empty(n, np.float32), np.empty(n, np.float32)
    get_lib().s16_iq_to_planar_f32(_ptr(src), n, _ptr(re), _ptr(im))
    return re, im


def s16_to_f32(src: np.ndarray) -> np.ndarray:
    """Mono s16 samples -> float32 (x / 32768)."""
    src = np.ascontiguousarray(src, dtype=np.int16)
    out = np.empty(len(src), np.float32)
    get_lib().s16_to_f32(_ptr(src), len(src), _ptr(out))
    return out


def u8_to_f32(src: np.ndarray) -> np.ndarray:
    """Mono u8 samples -> float32 ((x - 128) / 128)."""
    src = np.ascontiguousarray(src, dtype=np.uint8)
    out = np.empty(len(src), np.float32)
    get_lib().u8_to_f32(_ptr(src), len(src), _ptr(out))
    return out


def u8_iq_to_planar_plain(src: np.ndarray):
    """Plain numpy version of :func:`u8_iq_to_planar`."""
    f = (np.asarray(src, np.uint8).astype(np.float32) - 128.0) / 128.0
    return np.ascontiguousarray(f[0::2]), np.ascontiguousarray(f[1::2])


def u8_iq_to_planar_bf16_plain(src: np.ndarray):
    """Plain numpy version of :func:`u8_iq_to_planar_bf16`: the float32
    value's upper 16 bits (exact for these values)."""
    f = ((np.asarray(src, np.uint8).astype(np.float32) - 128.0)
         / 128.0).view(np.uint32)
    h = (f >> 16).astype(np.uint16)
    return np.ascontiguousarray(h[0::2]), np.ascontiguousarray(h[1::2])


def s16_iq_to_planar_plain(src: np.ndarray):
    """Plain numpy version of :func:`s16_iq_to_planar`."""
    f = np.asarray(src, np.int16).astype(np.float32) / 32768.0
    return np.ascontiguousarray(f[0::2]), np.ascontiguousarray(f[1::2])


# ---------------------------------------------------------------------------
# Ring buffer and file pump
# ---------------------------------------------------------------------------

class RingBuffer:
    """SPSC byte ring, the analog of the reference's RawRingBuffer
    (src/buffer.hh:356-541), thread-safe by acquire/release atomics."""

    def __init__(self, capacity: int):
        self.capacity = int(capacity)
        self._lib = get_lib()
        self._h = self._lib.ring_create(self.capacity)

    def put(self, data: np.ndarray) -> int:
        """Copy ``data`` in whole; returns its length, or 0 without room."""
        data = np.ascontiguousarray(data).view(np.uint8).reshape(-1)
        if self._h is None:
            return 0
        return int(self._lib.ring_put(self._h, _ptr(data), len(data)))

    def take(self, n: int) -> Optional[np.ndarray]:
        """Exactly ``n`` bytes as a new array, or None while fewer are
        there.  Availability is checked before allocating (a polling
        consumer must not churn a block-sized array a failed poll; more
        data can only arrive), and a closed ring never hands NULL to the
        library."""
        if self._h is None or self.available < n:
            return None
        out = np.empty(n, np.uint8)
        got = int(self._lib.ring_take(self._h, _ptr(out), n))
        return out if got == n else None

    @property
    def available(self) -> int:
        if self._h is None:
            return 0
        return int(self._lib.ring_available(self._h))

    @property
    def eos(self) -> bool:
        if self._h is None:
            return True
        return bool(self._lib.ring_eos(self._h))

    def set_eos(self) -> None:
        if self._h is not None:
            self._lib.ring_set_eos(self._h)

    def close(self) -> None:
        if self._h:
            self._lib.ring_destroy(self._h)
        self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class FilePump:
    """Native ingest thread streaming a capture file into a
    :class:`RingBuffer` (the analog of BlockingSource's thread, reference:
    src/node.cc:154-176); end of file sets the ring's end of stream."""

    def __init__(self, path: str, ring: RingBuffer, chunk: int = 1 << 18):
        self.ring = ring
        self._lib = get_lib()
        self._h = self._lib.pump_start(str(path).encode(), ring._h, chunk)
        if not self._h:
            raise FileNotFoundError(path)

    def stop(self) -> None:
        if self._h is not None:
            self._lib.pump_stop(self._h)
            self._h = None


# ---------------------------------------------------------------------------
# Live pumps
# ---------------------------------------------------------------------------

class LivePump:
    """Native live-wire ingest thread (TCP, UDP or FIFO) feeding a
    :class:`RingBuffer` with the reference's back-pressure-by-drop
    contract: a full ring DISCARDS the overflow in whole frames and counts
    it (reference: src/firfilter.hh:219-226, src/rtlsource.cc:133-145).
    ``frame`` is the drop granularity in bytes (2 for u8 IQ, 4 for s16 IQ),
    so interleaved IQ never shifts across a drop.

    Construct with the classmethods: :meth:`tcp_connect` (the rtl_tcp
    topology: the server owns the radio, we pull), :meth:`tcp_listen`
    (raw-wire push, port 0 = ephemeral), :meth:`udp`, :meth:`fifo`, and
    :meth:`adopt` (a socket already connected, whose dup the pump owns)."""

    def __init__(self, ring: RingBuffer, handle, lib):
        self.ring = ring
        self._lib = lib
        self._h = handle
        self._bytes_in = 0
        self._bytes_dropped = 0

    @classmethod
    def tcp_connect(cls, host: str, port: int, ring: RingBuffer,
                    chunk: int = 1 << 18, frame: int = 2,
                    timeout_ms: int = 5000) -> "LivePump":
        lib = get_lib()
        h = lib.live_pump_tcp_connect(host.encode(), port, ring._h, chunk,
                                      frame, timeout_ms)
        if not h:
            raise ConnectionError(f"live tcp connect {host}:{port}")
        return cls(ring, h, lib)

    @classmethod
    def tcp_listen(cls, port: int, ring: RingBuffer, chunk: int = 1 << 18,
                   frame: int = 2) -> "LivePump":
        lib = get_lib()
        h = lib.live_pump_tcp_listen(port, ring._h, chunk, frame)
        if not h:
            raise OSError(f"live tcp listen :{port}")
        return cls(ring, h, lib)

    @classmethod
    def udp(cls, port: int, ring: RingBuffer, chunk: int = 1 << 18,
            frame: int = 2) -> "LivePump":
        lib = get_lib()
        h = lib.live_pump_udp(port, ring._h, chunk, frame)
        if not h:
            raise OSError(f"live udp bind :{port}")
        return cls(ring, h, lib)

    @classmethod
    def fifo(cls, path: str, ring: RingBuffer, chunk: int = 1 << 18,
             frame: int = 2) -> "LivePump":
        lib = get_lib()
        h = lib.live_pump_fifo(str(path).encode(), ring._h, chunk, frame)
        if not h:
            raise FileNotFoundError(path)
        return cls(ring, h, lib)

    @classmethod
    def adopt(cls, sock, ring: RingBuffer, chunk: int = 1 << 18,
              frame: int = 2) -> "LivePump":
        """Pump the stream of a connected socket.  The pump reads a dup of
        its descriptor and closes that on :meth:`stop`; the socket stays
        the caller's (to send on, and to close)."""
        lib = get_lib()
        fd = os.dup(sock.fileno())
        h = lib.live_pump_fd(fd, ring._h, chunk, frame)
        if not h:
            os.close(fd)
            raise OSError("live pump on an adopted socket")
        return cls(ring, h, lib)

    @property
    def port(self) -> int:
        """Bound port (listen and udp modes; resolves port 0)."""
        if self._h is None:
            return -1
        return int(self._lib.live_pump_port(self._h))

    @property
    def bytes_in(self) -> int:
        if self._h is not None:
            return int(self._lib.live_pump_bytes_in(self._h))
        return self._bytes_in

    @property
    def bytes_dropped(self) -> int:
        """Overflow discarded because the ring was full (reference:
        src/portaudio.cc:129-155)."""
        if self._h is not None:
            return int(self._lib.live_pump_bytes_dropped(self._h))
        return self._bytes_dropped

    def stop(self) -> None:
        """Join the thread; the final counters stay readable (with the
        trailing put) after the pump is freed."""
        if self._h is None:
            return
        fin, fdr = ctypes.c_int64(0), ctypes.c_int64(0)
        h, self._h = self._h, None
        self._lib.live_pump_stop(h, ctypes.byref(fin), ctypes.byref(fdr))
        self._bytes_in, self._bytes_dropped = int(fin.value), int(fdr.value)


class PyLivePump:
    """Plain Python version of :class:`LivePump` (a socket thread with the
    same frame-aligned put-or-drop contract), held against it by the
    tests.  Takes the ``tcp_listen`` and ``udp`` constructors."""

    def __init__(self, ring, frame: int):
        self.ring = ring
        self._frame = frame
        self._stop = False
        self._thread = None
        self._sock = None
        self._listen_sock = None
        self.bytes_in = 0
        self.bytes_dropped = 0

    @classmethod
    def tcp_listen(cls, port: int, ring, chunk: int = 1 << 18,
                   frame: int = 2) -> "PyLivePump":
        import socket

        p = cls(ring, frame)
        ls = socket.socket()
        ls.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        ls.bind(("", port))
        ls.listen(1)
        ls.settimeout(0.1)
        p._listen_sock = ls

        def read(buf):
            if p._sock is None:
                try:
                    c, _ = ls.accept()
                except TimeoutError:
                    return -2  # keep waiting
                c.settimeout(0.1)
                p._sock = c
            try:
                return p._sock.recv_into(buf)   # 0: peer closed, end
            except TimeoutError:
                return -2

        p._start(read, chunk)
        return p

    @classmethod
    def udp(cls, port: int, ring, chunk: int = 1 << 18,
            frame: int = 2) -> "PyLivePump":
        import socket

        p = cls(ring, frame)
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind(("", port))
        s.settimeout(0.1)
        p._sock = s

        def read(buf):
            try:
                n = s.recv_into(buf)
            except TimeoutError:
                return -2
            return n if n > 0 else -2  # UDP never signals the end
        p._start(read, chunk)
        return p

    def _start(self, read_fn, chunk: int) -> None:
        def run():
            # the end of stream in a finally: a reader that dies on an
            # unexpected OSError must not leave the consumer spinning
            try:
                buf = bytearray(chunk + self._frame)
                mv = memoryview(buf)
                rem = 0
                while not self._stop:
                    try:
                        got = read_fn(mv[rem:rem + chunk])
                    except OSError:
                        break
                    if got == -2:
                        continue
                    if got == 0:
                        break
                    have = rem + got
                    whole = (have // self._frame) * self._frame
                    if whole:
                        self._put(mv[:whole])
                    rem = have - whole
                    if rem:
                        mv[:rem] = mv[whole:have]
                if rem:
                    self._put(mv[:rem])   # trailing partial frame
            finally:
                self.ring.set_eos()

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def _put(self, mv) -> None:
        n = len(mv)
        self.bytes_in += n
        space = self.ring.capacity - self.ring.available
        fit = n if n <= space else (space // self._frame) * self._frame
        if fit > 0:
            self.ring.put(np.frombuffer(mv, np.uint8)[:fit])
        if fit < n:
            self.bytes_dropped += n - fit

    @property
    def port(self) -> int:
        s = self._listen_sock or self._sock
        return s.getsockname()[1] if s is not None else -1

    def stop(self, timeout: float = 5.0) -> None:
        if self._thread is not None:
            self._stop = True
            self._thread.join(timeout)
            self._thread = None
        for s in (self._sock, self._listen_sock):
            if s is not None:
                s.close()
        self._sock = self._listen_sock = None

