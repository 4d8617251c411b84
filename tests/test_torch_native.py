"""The port's native host runtime (``libsdr_tpu_torch.native``, its own copy
of ``sdr_native.cc``), its file ingest (``io/ingest.py``) and the native
POCSAG / AX.25 state machines, against the JAX package's on the same
seeded inputs: the converters byte for byte, the streams block for block
with the padded tail, ``u8_wire_to_planes`` bit for bit, and the decoders
message for message, also against the port's plain Python decoders.  The
loader raises, and falls back to nothing, where ``g++`` is missing."""

import ctypes

import numpy as np
import pytest
import torch

from libsdr_tpu import native as jnative
from libsdr_tpu.io import ingest as jingest
from libsdr_tpu_torch import native
from libsdr_tpu_torch.io import ingest


def test_builds_the_ports_own_library():
    path, _ = native.build()
    assert path.parent == native.BUILD_DIR
    assert path.name.startswith("sdr_native-") and path.suffix == ".so"
    lib = native.get_lib()
    assert isinstance(lib, ctypes.CDLL) and lib._name == str(path)
    assert "libsdr_tpu/native" not in lib._name


@pytest.mark.parametrize("name", ["u8_iq_to_planar", "u8_iq_to_planar_bf16",
                                  "s16_iq_to_planar"])
def test_converters_equal_jax_and_plain(rng, name):
    if name.startswith("s16"):
        src = rng.integers(-32768, 32768, 4098).astype(np.int16)
    else:
        src = np.concatenate([np.arange(512), rng.integers(0, 256, 3586)]
                             ).astype(np.uint8)   # every value, then noise
    got = getattr(native, name)(src)
    want = getattr(jnative, name)(src)
    plain = getattr(native, name + "_plain")(src)
    for g, w, p in zip(got, want, plain):
        assert g.dtype == np.asarray(w).dtype == p.dtype
        assert g.tobytes() == np.asarray(w).tobytes() == p.tobytes()


def test_mono_converters(rng):
    s16 = rng.integers(-32768, 32768, 1001).astype(np.int16)
    assert native.s16_to_f32(s16).tobytes() == (
        s16.astype(np.float32) / 32768.0).tobytes()
    u8 = np.arange(256, dtype=np.uint8)
    assert native.u8_to_f32(u8).tobytes() == (
        (u8.astype(np.float32) - 128.0) / 128.0).tobytes()


def test_ring_buffer_wraparound(rng):
    """The reference's RawRingBuffer test (test/buffertest.cc)."""
    ring = native.RingBuffer(256)
    data = rng.integers(0, 256, 100).astype(np.uint8)
    assert ring.put(data) == 100 and ring.available == 100
    np.testing.assert_array_equal(ring.take(100), data)
    for k in range(10):     # past the capacity's edge again and again
        d = rng.integers(0, 256, 200 + k).astype(np.uint8)
        assert ring.put(d) == len(d) and ring.available == len(d)
        np.testing.assert_array_equal(ring.take(len(d)), d)
    assert ring.put(np.zeros(300, np.uint8)) == 0   # over capacity
    assert ring.take(10) is None                    # under-filled
    assert not ring.eos
    ring.set_eos()
    assert ring.eos
    ring.close()
    assert ring.take(1) is None and ring.eos and ring.available == 0


def _blocks_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if hasattr(g, "re"):    # Complex of bf16 planes: the bit patterns
            assert g.re.dtype == torch.bfloat16
            for gp, wp in ((g.re, w.re), (g.im, w.im)):
                assert gp.view(torch.int16).numpy().tobytes() == \
                    np.asarray(wp).view(np.int16).tobytes()
        else:
            assert g.dtype == w.dtype and g.tobytes() == w.tobytes()


@pytest.mark.parametrize("stream,dtype", [
    ("stream_raw_iq", np.uint8), ("stream_raw_iq", np.int16),
    ("stream_raw_iq_u8", np.uint8), ("stream_raw_iq_bf16", np.uint8)])
def test_file_streams_equal_jax(tmp_path, rng, stream, dtype):
    """Block for block the JAX package's stream over one file: 3 whole
    blocks and a partial one, padded (zeros, or 128 on the raw wire)."""
    cap = tmp_path / "cap.bin"
    if dtype == np.int16:
        rng.integers(-32768, 32768, 2 * 3500, dtype=np.int16).tofile(cap)
        kw = dict(dtype=np.int16)
    else:
        rng.integers(0, 256, 2 * 3500, dtype=np.uint8).tofile(cap)
        kw = dict(dtype=np.uint8) if stream == "stream_raw_iq" else {}
    got = list(getattr(ingest, stream)(str(cap), 1024, **kw))
    want = list(getattr(jingest, stream)(str(cap), 1024, **kw))
    assert len(got) == 4
    _blocks_equal(got, want)


@pytest.mark.parametrize("plane", [None, torch.bfloat16])
def test_u8_wire_to_planes_equals_jax_and_the_host_lut(rng, plane):
    import jax.numpy as jnp

    src = np.concatenate([np.arange(512), rng.integers(0, 256, 1024)]
                         ).astype(np.uint8).reshape(3, 512)
    got = ingest.u8_wire_to_planes(torch.from_numpy(src), plane)
    want = jingest.u8_wire_to_planes(
        jnp.asarray(src), None if plane is None else jnp.bfloat16)
    assert tuple(got.shape) == (3, 256)
    assert got.re.dtype == (torch.float32 if plane is None else plane)
    assert got.re.is_contiguous() and got.im.is_contiguous()  # the kernels'
    for gp, wp in ((got.re, want.re), (got.im, want.im)):
        g = gp.view(torch.int16 if plane else torch.int32).numpy()
        assert g.tobytes() == np.asarray(wp).view(g.dtype).tobytes()
    if plane is not None:   # bit for bit the host LUT's bf16 patterns
        re, im = native.u8_iq_to_planar_bf16(src.reshape(-1))
        assert got.re.reshape(-1).view(torch.int16).numpy().tobytes() == \
            re.tobytes()
        assert got.im.reshape(-1).view(torch.int16).numpy().tobytes() == \
            im.tobytes()


def _pocsag_stream(seed):
    """Pages at seeded addresses and texts, between noise, with seeded
    single and double bit flips (repairable) and a burst (not)."""
    from libsdr_tpu_torch.decode import pocsag_encode_batch

    r = np.random.default_rng(seed)
    parts = [(r.random(int(r.integers(0, 300))) > 0.5).astype(np.uint8)]
    for k in range(4):
        text = "".join(chr(c) for c in r.integers(32, 127,
                                                  int(r.integers(1, 60))))
        parts.append(pocsag_encode_batch(int(r.integers(0, 1 << 21)),
                                         int(r.integers(0, 4)), text))
        parts.append((r.random(int(r.integers(0, 200))) > 0.5
                      ).astype(np.uint8))
    bits = np.concatenate(parts)
    for at in r.choice(len(bits), 6, replace=False):
        bits[at] ^= 1
    at = int(r.integers(0, len(bits) - 40))
    bits[at:at + 40] ^= 1
    return bits


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_pocsag_native_equals_jax_and_plain(seed):
    from libsdr_tpu.decode import pocsag_decode_bits as j_decode
    from libsdr_tpu_torch.decode import POCSAGDecoder, pocsag_decode_bits

    bits = _pocsag_stream(seed)
    got = pocsag_decode_bits(bits)
    want = j_decode(bits)
    plain = POCSAGDecoder().process(bits)
    assert len(got) >= 2
    key = [(m.address, m.function, m.bits, m.payload, m.best_decode())
           for m in got]
    assert key == [(m.address, m.function, m.bits, m.payload,
                    m.best_decode()) for m in want]
    assert key == [(m.address, m.function, m.bits, m.payload,
                    m.best_decode()) for m in plain]


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_ax25_native_equals_jax_and_plain(seed):
    from libsdr_tpu.decode import ax25_decode_bits as j_decode
    from libsdr_tpu_torch.decode import (AX25Decoder, ax25_decode_bits,
                                         ax25_frame_bits)

    r = np.random.default_rng(seed)
    parts = [(r.random(200) > 0.5).astype(np.uint8)]
    for k in range(4):
        info = r.integers(0, 256, int(r.integers(1, 80))).astype(
            np.uint8).tobytes()
        parts.append(ax25_frame_bits(f"K{k}ABC", "APRS", info,
                                     via=["WIDE1"] if k % 2 else None,
                                     n_flags=int(r.integers(2, 8))))
        if k == 1:
            parts.append(np.ones(9, np.uint8))     # an abort
        parts.append((r.random(int(r.integers(0, 100))) > 0.5
                      ).astype(np.uint8))
    bits = np.concatenate(parts)
    bad = bits.copy()
    bad[int(r.integers(250, len(bits) - 50))] ^= 1   # the CRC rejects
    for stream in (bits, bad):
        got = ax25_decode_bits(stream)
        want = j_decode(stream)
        plain = AX25Decoder()
        plain.process(stream)

        def key(ms):
            return [(str(m.frm), str(m.to), [str(v) for v in m.via],
                     m.payload) for m in ms]
        assert key(got) == key(want) == key(plain.messages)
    assert len(ax25_decode_bits(bits)) == 4


def test_loader_raises_without_gxx(tmp_path, monkeypatch):
    """No g++: the build raises (with why) and nothing falls back to the
    plain versions: the ring, the pumps and the decoders raise too."""
    from libsdr_tpu_torch.decode import pocsag_decode_bits

    monkeypatch.setenv("PATH", "")
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        native.build(tmp_path)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    native.get_lib.cache_clear()
    try:
        for call in (lambda: native.RingBuffer(64),
                     lambda: native.u8_iq_to_planar(np.zeros(4, np.uint8)),
                     lambda: pocsag_decode_bits(np.zeros(64, np.uint8))):
            with pytest.raises(RuntimeError, match="g\\+\\+"):
                call()
    finally:
        native.get_lib.cache_clear()
    assert not list(tmp_path.iterdir())


def test_loader_raises_with_the_compilers_log(tmp_path, monkeypatch):
    bad = tmp_path / "bad.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC", bad)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as e:
        native.build(tmp_path)
    assert "bad.cc" in str(e.value)
    assert not list(tmp_path.glob("*.so")) and not list(
        tmp_path.glob("*.tmp"))
