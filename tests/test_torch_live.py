"""The port's live ingest (``libsdr_tpu_torch.io.live`` over the native
pumps), the counterparts of tests/test_live.py: the tcp-listen,
tcp-connect, udp and fifo sources, frame-aligned drop accounting (native
and the plain ``PyLivePump``), the rtl_tcp client against a fake server,
the idle timeout, and the apps' live options (``scanner --live`` with and
without ``--bf16``, ``multimode --live --map``, ``tx --wire`` into a live
receiver), each run with ``--device cpu`` and equal to the JAX app's
output on the same capture.  Every socket and thread has a deadline."""

import os
import socket
import struct
import threading
import time

import numpy as np
import pytest

from libsdr_tpu_torch.native import LivePump, PyLivePump, RingBuffer

DEADLINE = 30.0   # seconds any one thread of a test may take


def u8_to_c64(u8):
    f = (u8.astype(np.float32) - 128.0) / 128.0
    return (f[0::2] + 1j * f[1::2]).astype(np.complex64)


def wait_until(cond, timeout=10.0):
    t0 = time.perf_counter()
    while not cond():
        if time.perf_counter() - t0 > timeout:
            raise TimeoutError("condition not met")
        time.sleep(0.01)


class Worker(threading.Thread):
    """A daemon thread whose exception resurfaces in :meth:`result`."""

    def __init__(self, fn, *args):
        super().__init__(daemon=True)
        self._fn, self._args, self.error, self.value = fn, args, None, None
        self.start()

    def run(self):
        try:
            self.value = self._fn(*self._args)
        except BaseException as e:  # noqa: BLE001 - re-raised in result()
            self.error = e

    def result(self, timeout=DEADLINE):
        self.join(timeout)
        assert not self.is_alive(), "worker thread did not finish"
        if self.error is not None:
            raise self.error
        return self.value


def _server(data: bytes, trickle: float = 0.0, chunk: int = 1 << 16):
    """A one-shot TCP server on an ephemeral port sending ``data`` (chunked,
    ``trickle`` seconds apart) to its one client, then closing."""
    srv = socket.socket()
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    srv.settimeout(DEADLINE)

    def run():
        try:
            c, _ = srv.accept()
            with c:
                for off in range(0, len(data), chunk):
                    c.sendall(data[off:off + chunk])
                    time.sleep(trickle)
        finally:
            srv.close()
    return srv.getsockname()[1], Worker(run)


def _fifo_writer(path, data: bytes):
    def run():
        with open(path, "wb") as f:
            f.write(data)
    return Worker(run)


# ---------------------------------------------------------------------------
# The sources
# ---------------------------------------------------------------------------

def test_tcp_listen_stream_blocks(rng):
    """Push topology: a client streams u8 IQ into the pump; the exact bytes
    come out as complex blocks, zero drops, the end of stream on close
    (the final partial block zero-padded)."""
    from libsdr_tpu_torch.io.live import (LiveStats, _block_loop,
                                          _host_block, _u8_block_to_c64)

    block = 4096
    data = rng.integers(0, 256, size=2 * int(3.5 * block), dtype=np.uint8)
    ring = RingBuffer(1 << 20)
    pump = LivePump.tcp_listen(0, ring, frame=2)
    port = pump.port
    assert port > 0

    def writer():
        with socket.create_connection(("127.0.0.1", port), timeout=5) as s:
            s.sendall(data.tobytes())

    w = Worker(writer)
    stats = LiveStats()
    blocks = list(_block_loop(ring, pump, block, 1, _u8_block_to_c64, stats,
                              10.0, _host_block))
    w.result()
    assert len(blocks) == 4  # 3 whole + 1 padded partial
    got = np.concatenate(blocks)
    want = u8_to_c64(data)
    np.testing.assert_array_equal(got[:len(want)], want)
    np.testing.assert_array_equal(got[len(want):], 0)
    assert stats.bytes_in == len(data) and stats.bytes_dropped == 0
    assert stats.blocks == 3


def test_tcp_connect_pull(rng):
    """Pull topology (rtl_tcp's): a server owns the wire, the pump connects
    and drains it."""
    from libsdr_tpu_torch.io.live import LiveStats, stream_live_iq

    data = rng.integers(0, 256, size=32768, dtype=np.uint8)
    port, srv = _server(data.tobytes())
    stats = LiveStats()
    blocks = list(stream_live_iq(f"tcp://127.0.0.1:{port}", 2048,
                                 stats=stats, timeout=10.0))
    srv.result()
    got = np.concatenate(blocks)
    np.testing.assert_array_equal(got[:len(data) // 2], u8_to_c64(data))
    assert stats.bytes_in == len(data) and stats.bytes_dropped == 0


def test_tcp_connect_resolves_hostname(rng):
    """The native pump resolves host names (getaddrinfo), not only IPv4
    literals."""
    data = rng.integers(0, 256, size=4096, dtype=np.uint8)
    port, srv = _server(data.tobytes())
    ring = RingBuffer(1 << 20)
    pump = LivePump.tcp_connect("localhost", port, ring)
    srv.result()
    wait_until(lambda: ring.eos)
    np.testing.assert_array_equal(ring.take(len(data)), data)
    pump.stop()
    ring.close()


def test_udp_datagrams(rng):
    """Datagram sink: payloads land in order on the loopback; the idle
    timeout ends the stream (UDP has no end) and drains the half block."""
    from libsdr_tpu_torch.io.live import LiveStats, stream_live_iq

    stats = LiveStats()
    gen = stream_live_iq("udp://:0", 1024, stats=stats, timeout=1.0)
    port = stats.port
    assert port > 0
    data = rng.integers(0, 256, size=9216, dtype=np.uint8)
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        for off in range(0, len(data), 2048):
            s.sendto(data[off:off + 2048].tobytes(), ("127.0.0.1", port))
            time.sleep(0.005)  # keep loopback datagrams ordered, undropped
    blocks = list(gen)
    assert len(blocks) == 5  # 4 whole + 1 timeout-drained padded partial
    got = np.concatenate(blocks)
    np.testing.assert_array_equal(got[:len(data) // 2], u8_to_c64(data))
    np.testing.assert_array_equal(got[len(data) // 2:], 0)
    assert stats.bytes_in == len(data)


def test_fifo_source(tmp_path, rng):
    """Named-pipe wire: the end of stream follows the writer's close, not
    the empty window before a writer."""
    from libsdr_tpu_torch.io.live import LiveStats, stream_live_iq

    path = str(tmp_path / "wire.fifo")
    os.mkfifo(path)
    data = rng.integers(0, 256, size=16384, dtype=np.uint8)

    def writer():
        time.sleep(0.2)  # the pump must survive the no-writer window
        with open(path, "wb") as f:
            f.write(data.tobytes())

    w = Worker(writer)
    stats = LiveStats()
    blocks = list(stream_live_iq(f"fifo://{path}", 2048, stats=stats,
                                 timeout=10.0))
    w.result()
    np.testing.assert_array_equal(np.concatenate(blocks)[:len(data) // 2],
                                  u8_to_c64(data))
    assert stats.bytes_in == len(data)


@pytest.mark.parametrize("dtype", [np.int16, np.uint8])
def test_live_audio_equals_jax(tmp_path, rng, dtype):
    """Mono audio wires (s16 and u8) block for block as the JAX package's
    stream of the same bytes."""
    from libsdr_tpu.io.live import stream_live_audio as j_stream
    from libsdr_tpu_torch.io.live import stream_live_audio

    info = np.iinfo(dtype)
    data = rng.integers(info.min, info.max + 1, 5000).astype(dtype)
    out = {}
    for name, fn in (("port", stream_live_audio), ("jax", j_stream)):
        path = str(tmp_path / f"{name}.fifo")
        os.mkfifo(path)
        w = _fifo_writer(path, data.tobytes())
        out[name] = list(fn(f"fifo://{path}", 1024, dtype=dtype,
                            timeout=10.0))
        w.result()
    assert len(out["port"]) == len(out["jax"]) == 5
    for a, b in zip(out["port"], out["jax"]):
        assert a.dtype == np.float32 and a.tobytes() == b.tobytes()


def test_live_bf16_equals_the_file_stream(tmp_path, rng):
    """``stream_live_iq_bf16`` yields the bf16 planes of
    ``stream_raw_iq_bf16`` over a file of the same bytes, bit for bit."""
    import torch

    from libsdr_tpu_torch.io.ingest import stream_raw_iq_bf16
    from libsdr_tpu_torch.io.live import stream_live_iq_bf16

    data = rng.integers(0, 256, size=2 * 3500, dtype=np.uint8)
    cap = tmp_path / "cap.u8"
    data.tofile(cap)
    port, srv = _server(data.tobytes())
    live = list(stream_live_iq_bf16(f"tcp://127.0.0.1:{port}", 1024,
                                    timeout=10.0))
    srv.result()
    filed = list(stream_raw_iq_bf16(str(cap), 1024))
    assert len(live) == len(filed) == 4
    for a, b in zip(live, filed):
        assert a.re.dtype == torch.bfloat16
        assert torch.equal(a.re.view(torch.int16), b.re.view(torch.int16))
        assert torch.equal(a.im.view(torch.int16), b.im.view(torch.int16))


# ---------------------------------------------------------------------------
# Drop accounting
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["native", "python"])
def test_drop_accounting_frame_aligned(kind):
    """The back-pressure-by-drop contract (reference:
    src/firfilter.hh:219-226): a full ring discards the overflow, counts
    it, and never splits a frame."""
    cls = LivePump if kind == "native" else PyLivePump
    ring = RingBuffer(1 << 12)
    pump = cls.tcp_listen(0, ring, frame=2, chunk=1 << 10)
    n = 1 << 16
    data = np.empty(n, np.uint8)
    data[0::2], data[1::2] = 0xAA, 0x55
    with socket.create_connection(("127.0.0.1", pump.port), timeout=5) as s:
        s.sendall(data.tobytes())  # nobody consumes: the ring overflows
    wait_until(lambda: ring.eos)
    kept = ring.available
    assert pump.bytes_in == n
    assert pump.bytes_dropped == n - kept > 0
    assert pump.bytes_dropped % 2 == 0
    out = ring.take(kept)
    np.testing.assert_array_equal(out[0::2], 0xAA)
    np.testing.assert_array_equal(out[1::2], 0x55)
    pump.stop()
    ring.close()


@pytest.mark.parametrize("kind", ["native", "python"])
def test_drop_accounting_under_a_racing_consumer(kind):
    """A slow consumer drains while the wire blasts numbered frames.  The
    invariants, not timings: bytes in = bytes taken + dropped + left in the
    ring; drops in whole frames; every kept frame intact, in order."""
    frame = 4   # u16 sequence number + its complement
    n_frames = 100_000
    seq = np.arange(n_frames, dtype=np.uint16)
    wire = np.empty((n_frames, 2), np.uint16)
    wire[:, 0], wire[:, 1] = seq, ~seq
    data = wire.view(np.uint8).reshape(-1)
    cls = LivePump if kind == "native" else PyLivePump
    ring = RingBuffer(1 << 14)
    pump = cls.tcp_listen(0, ring, frame=frame, chunk=1 << 12)
    port = pump.port

    def writer():
        with socket.create_connection(("127.0.0.1", port), timeout=10) as s:
            s.sendall(data.tobytes())

    w = Worker(writer)
    kept, t0 = [], time.perf_counter()
    while not ring.eos:
        assert time.perf_counter() - t0 < DEADLINE, "stream did not end"
        out = ring.take(37 * frame)
        if out is None:
            time.sleep(0.0002)
        else:
            kept.append(out)
    w.result()
    left = ring.available
    taken = sum(len(k) for k in kept)
    assert pump.bytes_in == len(data)
    assert pump.bytes_in == taken + pump.bytes_dropped + left
    assert pump.bytes_dropped % frame == 0 and left % frame == 0
    if left:
        kept.append(ring.take(left))
    got = np.concatenate(kept).view(np.uint16).reshape(-1, 2)
    assert np.array_equal(got[:, 1], (~got[:, 0]).astype(np.uint16))
    seqs = got[:, 0].astype(np.int64)
    unwrapped = seqs + 65536 * np.cumsum(
        np.concatenate([[0], (np.diff(seqs) < -32768).astype(np.int64)]))
    assert np.all(np.diff(unwrapped) > 0)
    pump.stop()
    ring.close()


def test_live_stats_feed_throughput():
    from libsdr_tpu_torch.core.runtime import Throughput
    from libsdr_tpu_torch.io.live import LiveStats

    st = LiveStats(bytes_in=2000, bytes_dropped=200)
    assert st.drop_fraction == pytest.approx(0.1)
    th = Throughput()
    th.add(900)
    th.update_from(st)
    assert th.dropped == 100 and th.drop_fraction == pytest.approx(0.1)


# ---------------------------------------------------------------------------
# rtl_tcp, the idle timeout
# ---------------------------------------------------------------------------

def _fake_rtl_tcp_server(burst_a: bytes, burst_b: bytes, cmds: list):
    """A minimal rtl_tcp: the RTL0 header, burst_a once the rate and
    frequency commands arrived, burst_b after a retune (a third command),
    then close."""
    srv = socket.socket()
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    srv.settimeout(DEADLINE)

    def run():
        c, _ = srv.accept()
        c.sendall(b"RTL0" + struct.pack(">II", 5, 29))  # R820T, 29 gains
        c.settimeout(0.05)
        buf = b""
        deadline = time.perf_counter() + 15.0
        sent_a = sent_b = False
        while time.perf_counter() < deadline and not sent_b:
            try:
                got = c.recv(4096)
                if not got:
                    break
                buf += got
                while len(buf) >= 5:
                    cmds.append(struct.unpack(">BI", buf[:5]))
                    buf = buf[5:]
            except socket.timeout:
                pass
            if not sent_a and len(cmds) >= 2:
                c.sendall(burst_a)
                sent_a = True
            if not sent_b and len(cmds) >= 3:
                c.sendall(burst_b)
                sent_b = True
        c.close()
        srv.close()

    return srv.getsockname()[1], Worker(run)


def test_rtl_tcp_source_retune_restream(rng):
    """Tune, stream, retune, stream again on one RTLTCPSource: the first
    generator ending (idle timeout) leaves the connection, ring and tuner
    usable; only close() tears down."""
    from libsdr_tpu_torch.io.live import RTLTCPSource

    burst_a = rng.integers(0, 256, size=8192, dtype=np.uint8)
    burst_b = rng.integers(0, 256, size=8192, dtype=np.uint8)
    cmds: list = []
    port, srv = _fake_rtl_tcp_server(burst_a.tobytes(), burst_b.tobytes(),
                                     cmds)
    src = RTLTCPSource("127.0.0.1", port, sample_rate=1_024_000,
                       frequency=144_800_000)
    assert src.tuner_type == 5 and src.tuner_gain_count == 29
    got_a = np.concatenate(list(src.blocks(2048, timeout=1.0)))
    np.testing.assert_array_equal(got_a[:len(burst_a) // 2],
                                  u8_to_c64(burst_a))
    src.set_frequency(145_000_000)      # the retune: the server sends B
    got_b = np.concatenate(list(src.blocks(2048, timeout=2.0)))
    np.testing.assert_array_equal(got_b[:len(burst_b) // 2],
                                  u8_to_c64(burst_b))
    src.close()
    srv.result()
    assert (0x02, 1_024_000) in cmds and (0x01, 144_800_000) in cmds
    assert (0x01, 145_000_000) in cmds
    assert src.stats.bytes_in >= len(burst_a) + len(burst_b)


def test_timeout_watches_wire_progress_not_blocks(rng):
    """The idle timeout measures time with NO WIRE BYTES: a wire that needs
    longer than the timeout to fill one block keeps streaming."""
    from libsdr_tpu_torch.io.live import LiveStats, stream_live_iq

    data = rng.integers(0, 256, size=8192, dtype=np.uint8)
    # 1 KB every 150 ms: a 4 KB block takes ~0.6 s > the 0.4 s timeout
    port, srv = _server(data.tobytes(), trickle=0.15, chunk=1024)
    stats = LiveStats()
    blocks = list(stream_live_iq(f"tcp://127.0.0.1:{port}", 2048,
                                 stats=stats, timeout=0.4))
    srv.result()
    assert sum(len(b) for b in blocks) * 2 == len(data)
    assert stats.bytes_in == len(data)


def test_idle_timeout_ends_a_silent_wire():
    """A source that never sends ends after the timeout with no block."""
    from libsdr_tpu_torch.io.live import stream_live_iq

    t0 = time.perf_counter()
    assert list(stream_live_iq("udp://:0", 1024, timeout=0.3)) == []
    assert time.perf_counter() - t0 < 5.0


# ---------------------------------------------------------------------------
# The apps' live options, against the JAX apps on the same capture
# ---------------------------------------------------------------------------

def _wide_pocsag_u8(ch, text, address, m=16, ch_bw=25_000.0):
    """tests/test_live.py's scanner band (one page on channel ``ch``) as
    u8 wire bytes."""
    from libsdr_tpu_torch.io.live import iq_to_u8_wire
    from tests.test_apps import _pocsag_iq

    fs = m * ch_bw
    n = int(fs)
    narrow = _pocsag_iq(ch_bw, text=text, address=address)
    t_ax = np.arange(n) / fs
    idx = np.minimum((np.arange(n) / m).astype(np.int64), len(narrow) - 1)
    wide = (0.6 * narrow[idx] * np.exp(2j * np.pi * (ch * fs / m) * t_ax)
            ).astype(np.complex64)
    return iq_to_u8_wire(wide), fs


def _pages(found):
    return {ch: [(x.address, x.function, x.payload) for x in msgs]
            for ch, msgs in found.items()}


@pytest.mark.parametrize("bf16", [False, True])
def test_scanner_live_like_jax(tmp_path, bf16):
    """``scanner --live`` (``--bf16``: the u8 wire as bf16 planes) from a
    FIFO decodes what the JAX scanner decodes from the same bytes."""
    from libsdr_tpu.apps import scanner as j_scanner
    from libsdr_tpu_torch.apps import scanner

    u8, fs = _wide_pocsag_u8(5, "LIVE WIRE", 99)
    cap = tmp_path / "band.u8"
    u8.tofile(cap)
    path = str(tmp_path / "antenna.fifo")
    os.mkfifo(path)
    w = _fifo_writer(path, u8.tobytes())
    extra = ["--bf16"] if bf16 else []
    found = scanner.main(["--live", f"fifo://{path}", "--rate", str(fs),
                          "--channels", "16", "--live-timeout", "10",
                          "--device", "cpu"] + extra)
    w.result()
    want = j_scanner.main(["--raw", str(cap), "--rate", str(fs),
                           "--channels", "16"] + extra)
    assert _pages(found) == _pages(want)
    assert found[5][0].address == 99
    assert found[5][0].as_text().startswith("LIVE WIRE")


def test_scanner_raw_bf16_like_jax(tmp_path):
    """``scanner --raw --bf16`` (the file through the native pump as bf16
    planes) decodes what the JAX scanner's ``--raw --bf16`` decodes."""
    from libsdr_tpu.apps import scanner as j_scanner
    from libsdr_tpu_torch.apps import scanner

    u8, fs = _wide_pocsag_u8(2, "BF16 FILE", 33)
    cap = tmp_path / "band.u8"
    u8.tofile(cap)
    args = ["--raw", str(cap), "--rate", str(fs), "--channels", "16",
            "--bf16"]
    found = scanner.main(args + ["--device", "cpu"])
    assert _pages(found) == _pages(j_scanner.main(args))
    assert found[2][0].address == 33
    assert found[2][0].as_text().startswith("BF16 FILE")


def test_multimode_live_map_like_jax(tmp_path):
    """``multimode --live --map`` from a FIFO: the POCSAG and RTTY channels
    decode as the JAX multimode bank decodes the same bytes."""
    from libsdr_tpu.apps import multimode as j_multimode
    from libsdr_tpu_torch.apps import multimode
    from libsdr_tpu_torch.io.live import iq_to_u8_wire
    from tests.test_apps import make_mixed_band

    m = 16
    fs = m * 24_000.0
    u8 = iq_to_u8_wire(make_mixed_band({2: "pocsag", 9: "rtty"}, m))
    cap = tmp_path / "band.u8"
    u8.tofile(cap)
    path = str(tmp_path / "band.fifo")
    os.mkfifo(path)
    w = _fifo_writer(path, u8.tobytes())
    args = ["--rate", str(fs), "--channels", str(m),
            "--map", "2:pocsag,9:rtty"]
    found = multimode.main(["--live", f"fifo://{path}", "--live-timeout",
                            "10", "--device", "cpu"] + args)
    w.result()
    want = j_multimode.main(["--raw", str(cap)] + args)
    assert sorted(found) == sorted(want) == [2, 9]
    assert found[2][0] == "pocsag" and [
        (x.address, x.payload) for x in found[2][1]] == [
        (x.address, x.payload) for x in want[2][1]]
    assert found[2][1][0].address == 99
    assert found[9] == want[9] and "RY MULTI" in found[9][1]


def test_tx_wire_to_live_rx_like_jax():
    """``tx pocsag --wire``: the port's transmitter sends the JAX
    transmitter's wire bytes, and the page decodes off the port's live
    source (the POCSAG chain on the CPU) as the JAX chain decodes it."""
    from libsdr_tpu.apps import tx as j_tx
    from libsdr_tpu.apps.chains import pocsag_front_end as j_front_end
    from libsdr_tpu.apps.chains import run_bit_chain as j_run
    from libsdr_tpu.decode import pocsag_decode_bits as j_decode
    from libsdr_tpu_torch.apps import tx
    from libsdr_tpu_torch.apps.chains import pocsag_front_end, run_bit_chain
    from libsdr_tpu_torch.decode import pocsag_decode_bits
    from libsdr_tpu_torch.io.live import LiveStats, stream_live_iq

    fs, block = 240_000.0, 48_000
    args = ["pocsag", "--address", "77", "--text", "LOOPBACK",
            "--fs", str(fs)]
    stats = LiveStats()
    gen = stream_live_iq("tcp-listen://:0", block, stats=stats, timeout=10.0)
    w = Worker(tx.main, args + ["--wire", f"tcp://127.0.0.1:{stats.port}"])
    iq = np.concatenate(list(gen))
    w.result()
    assert stats.bytes_dropped == 0

    # the JAX transmitter's bytes, through a plain socket
    ls = socket.socket()
    ls.bind(("127.0.0.1", 0))
    ls.listen(1)
    ls.settimeout(DEADLINE)
    wj = Worker(j_tx.main, args + ["--wire",
                                   f"tcp://127.0.0.1:{ls.getsockname()[1]}"])
    c, _ = ls.accept()
    c.settimeout(DEADLINE)
    wire = b""
    while chunk := c.recv(1 << 16):
        wire += chunk
    c.close()
    ls.close()
    wj.result()
    assert stats.bytes_in == len(wire)
    want_iq = u8_to_c64(np.frombuffer(wire, np.uint8))
    np.testing.assert_array_equal(iq[:len(want_iq)], want_iq)

    msgs = pocsag_decode_bits(run_bit_chain(
        pocsag_front_end(fs, block), iq, "cpu"))
    want = j_decode(j_run(j_front_end(fs, block), iq))
    assert [(m.address, m.payload) for m in msgs] == [
        (m.address, m.payload) for m in want]
    assert msgs and msgs[0].address == 77
    assert msgs[0].as_text().startswith("LOOPBACK")
