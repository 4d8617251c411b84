"""The pump-fed POCSAG decoder bank (the counterpart of the JAX package's
``tools/bench_decoder_bank.py::run_pump_fed_u8``): a capture file of u8
wire steps -> :class:`~libsdr_tpu_torch.native.FilePump` ->
:class:`~libsdr_tpu_torch.native.RingBuffer` -> one upload of the raw u8 a
step -> :func:`~libsdr_tpu_torch.io.ingest.u8_wire_to_planes` on the device
-> the POCSAG bank's stages (K1a at D = 10, then K2) ->
:func:`~libsdr_tpu_torch.core.ragged.compact_device` -> the native POCSAG
state machine per channel (:func:`run_steps` over :func:`pump_steps`).  And
the same chain fed the same bytes already on the device, which the
pump-fed run must equal bit for bit.

Used by ``chip_smoke.py`` (P2's shape, 256 channels) and
``tests/test_torch_cuda.py`` (16 channels).
"""

from __future__ import annotations

import time

import numpy as np
import torch

BAUD = 1200.0


def quantize_u8(x, scale: float) -> torch.Tensor:
    """A (C, N) planar block scaled by ``scale`` to the u8 rtl_sdr wire
    (C, 2N): round(v * 128 + 128) clipped to 0-255, I and Q interleaved,
    as ``io.live.send_live_iq`` rounds (``v * 128`` is exact, so the
    device's float32 arithmetic gives the host's bytes)."""
    planes = []
    for p in (x.re, x.im):
        v = p.to(torch.float32) * scale
        planes.append(torch.round(v * 128.0 + 128.0).clamp(0, 255)
                      .to(torch.uint8))
    return torch.stack(planes, dim=-1).reshape(x.re.shape[0], -1)


def unclipped_scale(blocks, headroom: float = 0.99) -> float:
    """A scale that keeps every sample of ``blocks`` inside the wire's
    range (|v| < 1 after scaling)."""
    peak = max(float(torch.maximum(b.re.abs().max(), b.im.abs().max()))
               for b in blocks)
    return headroom / peak


def pocsag_bank(fs: float, block: int, channels: int, plane_dtype=None):
    """The POCSAG bank's chain of ``apps/chains.pocsag_front_end`` (its
    stages bound on ``channels`` with ``plane_dtype`` planes), as the JAX
    package's ``tools/bench_decoder_bank.py::build_bank`` binds them."""
    from libsdr_tpu_torch.core.graph import Pipeline
    from libsdr_tpu_torch.core.stream import StreamSpec
    from libsdr_tpu_torch.ops import (ASKDetector, BitStream, FMDemod,
                                      IQBaseBand)

    fe = Pipeline([
        IQBaseBand(fc=0.0, width=12.5e3, order=32, out_rate=24e3,
                   design="textbook"),
        FMDemod(),
        ASKDetector(invert=True),
        BitStream(BAUD, mode="normal"),
    ], name="pocsag_bank")
    fe.bind(StreamSpec(np.complex64, fs, block, channels=(channels,),
                       plane_dtype=plane_dtype))
    return fe


def capacity(fs: float, block: int) -> int:
    """Compaction capacity a step: the PLL's ~baud/fs valid slots, +30%."""
    return int(block / fs * BAUD * 1.3)


def run_steps(raws, fe, fs: float, block: int, plane_dtype, device):
    """Drive ``fe`` over an iterable of (C, 2*block) u8 steps (numpy from
    :func:`pump_steps`, or tensors already on ``device``); returns
    (data list, counts list, seconds, {"take": s, "upload": s}) with the
    device synchronized at the end: the seconds spent waiting for the next
    step (the ring's take) and in its upload."""
    from libsdr_tpu_torch.core.ragged import compact_device
    from libsdr_tpu_torch.io.ingest import u8_wire_to_planes

    step = fe.compile()
    carry = fe.init_carry(device)
    cap = capacity(fs, block)
    datas, counts = [], []
    parts = {"take": 0.0, "upload": 0.0}
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    it = iter(raws)
    t0 = time.perf_counter()
    while True:
        t1 = time.perf_counter()
        raw = next(it, None)
        t2 = time.perf_counter()
        parts["take"] += t2 - t1
        if raw is None:
            break
        if isinstance(raw, np.ndarray):
            raw = torch.from_numpy(raw)
        dev_raw = raw.to(device)   # pageable: synchronous with the host
        parts["upload"] += time.perf_counter() - t2
        carry, y = step(carry, u8_wire_to_planes(dev_raw, plane_dtype))
        d, k = compact_device(y, cap)
        datas.append(d)
        counts.append(k)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return datas, counts, time.perf_counter() - t0, parts


def write_wire_file(path, steps) -> int:
    """Write the (C, 2*block) u8 steps one after another; returns bytes."""
    n = 0
    with open(path, "wb") as f:
        for s in steps:
            a = s.cpu().numpy() if isinstance(s, torch.Tensor) else s
            f.write(np.ascontiguousarray(a).tobytes())
            n += a.size
    return n


def pump_steps(path, channels: int, block: int, timeout: float = 60.0):
    """(C, 2*block) u8 steps of a wire file through the native pump and
    ring; raises TimeoutError when no step arrives within ``timeout``."""
    from libsdr_tpu_torch.native import FilePump, RingBuffer

    step_bytes = channels * 2 * block
    ring = RingBuffer(max(1 << 26, 2 * step_bytes))
    pump = FilePump(str(path), ring)
    try:
        while True:
            t0 = time.perf_counter()
            while True:
                raw = ring.take(step_bytes)
                if raw is not None or (ring.eos
                                       and ring.available < step_bytes):
                    break
                if time.perf_counter() - t0 > timeout:
                    raise TimeoutError("the file pump delivered no step")
                time.sleep(0.0005)
            if raw is None:
                return
            yield raw.reshape(channels, 2 * block)
    finally:
        pump.stop()
        ring.close()


def channel_bits(datas, counts) -> list:
    """Each channel's bits over the run, on the host."""
    d = [x.cpu().numpy() for x in datas]
    k = [x.cpu().numpy() for x in counts]
    return [np.concatenate([dd[ch, :kk[ch]] for dd, kk in zip(d, k)])
            for ch in range(d[0].shape[0])]


# ---------------------------------------------------------------------------
# The live scanner: a band's u8 wire bytes sent over loopback TCP, paced
# as a radio delivers them, into apps/scanner.scan_blocks
# ---------------------------------------------------------------------------

def scan_live(data: bytes, fs: float, channels: int, block: int,
              bf16: bool, device, rate=None, timeout: float = 60.0):
    """Send ``data`` (u8 wire bytes) to a ``tcp-listen://127.0.0.1:0``
    source through ``io.live``'s wire writer, paced to ``rate`` samples/s
    (None: as fast as the wire takes it), and decode the stream with
    ``scan_blocks(stream_live_iq(...))`` (``bf16``: ``stream_live_iq_bf16``
    and bf16 planes).  Returns (found, LiveStats, seconds)."""
    import threading

    from libsdr_tpu_torch.apps.scanner import scan_blocks
    from libsdr_tpu_torch.io.live import (LiveStats, send_live_bytes,
                                          stream_live_iq, stream_live_iq_bf16)

    stats = LiveStats()
    url = "tcp-listen://127.0.0.1:0"
    src = (stream_live_iq_bf16(url, block, stats=stats, timeout=timeout)
           if bf16 else stream_live_iq(url, block, stats=stats,
                                       timeout=timeout))
    err = []

    def send():
        try:
            send_live_bytes(f"tcp://127.0.0.1:{stats.port}", data, rate, 2,
                            timeout=timeout)
        except Exception as e:  # noqa: BLE001 - raised below
            err.append(e)

    sender = threading.Thread(target=send, daemon=True)
    t0 = time.perf_counter()
    sender.start()
    found = scan_blocks(src, fs, channels, block,
                        plane_dtype=torch.bfloat16 if bf16 else None,
                        device=device)
    seconds = time.perf_counter() - t0
    sender.join(timeout)
    if sender.is_alive():
        raise TimeoutError("the wire writer did not finish")
    if err:
        raise err[0]
    return found, stats, seconds


def scan_file(path, fs: float, channels: int, block: int, bf16: bool,
              device):
    """The same bytes from a file: ``stream_raw_iq`` (or
    ``stream_raw_iq_bf16`` and bf16 planes) into ``scan_blocks``."""
    from libsdr_tpu_torch.apps.scanner import scan_blocks
    from libsdr_tpu_torch.io.ingest import stream_raw_iq, stream_raw_iq_bf16

    src = (stream_raw_iq_bf16(str(path), block) if bf16
           else stream_raw_iq(str(path), block))
    return scan_blocks(src, fs, channels, block,
                       plane_dtype=torch.bfloat16 if bf16 else None,
                       device=device)


def pages_of(found) -> dict:
    """{channel: [(address, function, payload), ...]} of a scan."""
    return {ch: [(x.address, x.function, x.payload) for x in msgs]
            for ch, msgs in found.items()}


def misplaced(found, pages) -> dict:
    """Decodes of a sent page's address on a channel other than its own
    ({channel: [address, ...]}); ``pages`` is {channel: (address, text)}."""
    own = {addr: ch for ch, (addr, _) in pages.items()}
    out = {}
    for ch, msgs in found.items():
        bad = [x.address for x in msgs
               if x.address in own and own[x.address] != ch]
        if bad:
            out[ch] = bad
    return out


def decoded_pages(found, pages) -> list:
    """The sent pages decoded on their own channel with their text."""
    return [ch for ch, (addr, text) in pages.items()
            if any(x.address == addr and x.as_text().startswith(text)
                   for x in found.get(ch, []))]
