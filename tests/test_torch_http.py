"""The port's HTTP library (``libsdr_tpu_torch.utils.http``, a copy of the
stdlib-only JAX one: tests/test_http.py's four cases on it) and its APRS
service (``apps/aprs_service.py``): the oneshot spots and /spots, /update,
the websocket push and the map page, and the live FIFO path fed by ``tx
afsk --wire`` with /spots read over HTTP while it runs, each against the
JAX service on the same capture, with ``--device cpu``."""

import base64
import hashlib
import json
import os
import socket
import threading
import time
import urllib.error
import urllib.request

import numpy as np

from libsdr_tpu_torch.utils.http import (JSONHandler, StaticHandler,
                                         WebSocketHandler, serve_handlers,
                                         ws_accept, ws_parse_frames,
                                         ws_text_frame)

DEADLINE = 30.0


def test_http_library_dispatch_and_json():
    seen = []
    httpd = serve_handlers([
        StaticHandler("/", b"<html>hi</html>"),
        StaticHandler("/data.bin", b"\x00\x01", "application/octet-stream"),
        JSONHandler("/items", get=lambda: ["a", "b"],
                    post=lambda obj: seen.append(obj) or {"n": len(seen)}),
    ], port=0)
    port = httpd.server_address[1]
    base = f"http://127.0.0.1:{port}"
    try:
        with urllib.request.urlopen(base + "/", timeout=10) as r:
            assert r.read() == b"<html>hi</html>"
            assert r.headers.get_content_type() == "text/html"
        with urllib.request.urlopen(base + "/data.bin", timeout=10) as r:
            assert r.read() == b"\x00\x01"
            assert r.headers.get_content_type() == "application/octet-stream"
        with urllib.request.urlopen(base + "/items", timeout=10) as r:
            assert json.loads(r.read()) == ["a", "b"]
        req = urllib.request.Request(base + "/items", method="POST",
                                     data=json.dumps({"x": 1}).encode())
        with urllib.request.urlopen(req, timeout=10) as r:
            assert json.loads(r.read()) == {"n": 1}
        assert seen == [{"x": 1}]
        # an unknown path: 404; malformed JSON: 400 (never reaching the
        # delegate)
        for path, data, want in (("/nope", None, 404),
                                 ("/items", b"{broken", 400)):
            try:
                urllib.request.urlopen(urllib.request.Request(
                    base + path, method="POST" if data else "GET",
                    data=data), timeout=10)
                assert False, path
            except urllib.error.HTTPError as e:
                assert e.code == want, (path, e.code)
        assert seen == [{"x": 1}]
    finally:
        httpd.shutdown()


def _ws_connect(port, path):
    key = base64.b64encode(b"0123456789abcdef").decode()
    s = socket.create_connection(("127.0.0.1", port), timeout=10)
    s.sendall((f"GET {path} HTTP/1.1\r\nHost: 127.0.0.1:{port}\r\n"
               "Upgrade: websocket\r\nConnection: Upgrade\r\n"
               f"Sec-WebSocket-Key: {key}\r\n"
               "Sec-WebSocket-Version: 13\r\n\r\n").encode())
    buf = b""
    while b"\r\n\r\n" not in buf:
        buf += s.recv(4096)
    head, _, rest = buf.partition(b"\r\n\r\n")
    assert b"101" in head.splitlines()[0]
    assert ws_accept(key).encode() in head
    return s, rest


def _next_frames(s, data):
    while True:
        frames, data = ws_parse_frames(data)
        if frames:
            return frames, data
        data += s.recv(4096)


def test_http_library_websocket_echo():
    """A websocket consumer other than APRS: the server echoes each text
    frame uppercased, through the library's poll/send surface."""

    def on_open(ws):
        while True:
            frames = ws.poll(0.1)
            if frames is None:
                break
            for opcode, payload in frames:
                if opcode == 0x1:
                    ws.send_text(payload.decode().upper())

    httpd = serve_handlers([WebSocketHandler("/echo", on_open)], port=0)
    s, rest = _ws_connect(httpd.server_address[1], "/echo")
    try:
        mask = b"\x01\x02\x03\x04"
        payload = bytes(b ^ mask[i % 4] for i, b in enumerate(b"ping me"))
        s.sendall(bytes([0x81, 0x80 | len(payload)]) + mask + payload)
        frames, _ = _next_frames(s, rest)
        assert frames[0] == (0x1, b"PING ME")
    finally:
        s.close()
        httpd.shutdown()


def test_ws_frame_roundtrip_sizes():
    """The encoder and parser agree over the 7-, 16- and 64-bit length
    forms (RFC 6455 §5.2)."""
    for n in (0, 1, 125, 126, 65535, 65536):
        frames, rest = ws_parse_frames(ws_text_frame(b"x" * n))
        assert rest == b"" and frames == [(0x1, b"x" * n)]


def test_ws_accept_rfc_example():
    """RFC 6455 §1.3's worked handshake, and the general formula."""
    assert (ws_accept("dGhlIHNhbXBsZSBub25jZQ==")
            == "s3pPLMBiTxaQ9kYGzzhZRbK+xOo=")
    want = base64.b64encode(hashlib.sha1(
        ("abc" + "258EAFA5-E914-47DA-95CA-C5AB0DC85B11").encode()).digest())
    assert ws_accept("abc").encode() == want


# ---------------------------------------------------------------------------
# The APRS service
# ---------------------------------------------------------------------------

def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=10) as r:
        return r.read(), r.headers.get_content_type()


def test_aprs_service_oneshot_like_jax(tmp_path):
    """The oneshot decode of tests/test_apps.py's capture gives the JAX
    service's spots; /spots serves them and /update appends."""
    from libsdr_tpu.apps import aprs_service as j_service
    from libsdr_tpu_torch.apps import aprs_service
    from libsdr_tpu_torch.decode import ax25_frame_bits
    from libsdr_tpu_torch.io import write_wav
    from libsdr_tpu_torch.ops import siggen
    from tests.test_apps import _nrzi

    fs = 24_000
    bits = ax25_frame_bits("N0CALL", "APRS", b"=5230.10N/01323.60E-Berlin",
                           n_flags=50)
    audio = siggen.fsk_modulate(fs, _nrzi(bits), 1202.0, 1200.0, 2200.0).real
    audio = np.concatenate([audio, np.zeros(4000, np.float32)])
    cap = tmp_path / "aprs.wav"
    write_wav(str(cap), 0.8 * audio.astype(np.float32), fs)
    args = ["--file", str(cap), "--oneshot", "--block-size", "12000"]
    store = aprs_service.main(args + ["--device", "cpu"])
    spots = store.spots()
    assert spots == j_service.main(args).spots()
    assert abs(spots[0]["latitude"] - (52 + 30.10 / 60)) < 1e-4

    httpd = aprs_service.serve(store, port=0)
    port = httpd.server_address[1]
    try:
        assert json.loads(_get(port, "/spots")[0]) == spots
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/update", method="POST",
            data=json.dumps({"from": "EXT-1", "comment": "pushed"}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=10) as r:
            assert r.status == 204
        assert json.loads(_get(port, "/spots")[0])[-1]["from"] == "EXT-1"
    finally:
        httpd.shutdown()


def test_aprs_service_websocket_push():
    """/ws pushes the stored spots, then each new one, and answers Ping
    and Close."""
    from libsdr_tpu_torch.apps import aprs_service

    store = aprs_service.APRSStore()
    store.add_spot({"from": "PRE-1", "comment": "stored"})
    httpd = aprs_service.serve(store, port=0)
    port = httpd.server_address[1]
    s, rest = _ws_connect(port, "/ws")
    try:
        frames, rest = _next_frames(s, rest)
        assert json.loads(frames[0][1])["from"] == "PRE-1"
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/update", method="POST",
            data=json.dumps({"from": "LIVE-1", "comment": "pushed"}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=10) as r:
            assert r.status == 204
        frames, rest = _next_frames(s, rest)
        assert json.loads(frames[0][1])["from"] == "LIVE-1"

        def masked(opcode, payload):
            mask = b"\x11\x22\x33\x44"
            body = bytes(b ^ mask[i % 4] for i, b in enumerate(payload))
            return bytes([0x80 | opcode, 0x80 | len(payload)]) + mask + body

        s.sendall(masked(0x9, b"hi"))       # Ping -> Pong
        frames, rest = _next_frames(s, rest)
        assert frames[0] == (0xA, b"hi")
        s.sendall(masked(0x8, b"\x03\xe8"))  # Close -> the Close reply
        frames, rest = _next_frames(s, rest)
        assert frames[0] == (0x8, b"\x03\xe8")
    finally:
        s.close()
        httpd.shutdown()


def test_aprs_service_map_page_is_the_jax_page():
    from libsdr_tpu.apps import aprs_service as j_service
    from libsdr_tpu_torch.apps import aprs_service

    store = aprs_service.APRSStore()
    httpd = aprs_service.serve(store, port=0)
    try:
        page, ctype = _get(httpd.server_address[1], "/")
    finally:
        httpd.shutdown()
    assert ctype == "text/html" and page == aprs_service._PAGE
    # the JAX package's page but for the header comment's source path
    assert page.split(b"-->", 1)[1] == j_service._PAGE.split(b"-->", 1)[1]
    text = page.decode()
    assert "<svg" in text and "/spots" in text and "new WebSocket" in text


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def serve_live_fifo(service_main, tx_main, fifo, extra=()):
    """Run ``aprs_service --live fifo://...`` fed by ``tx afsk --wire`` into
    the same FIFO; read GET /spots over HTTP while it runs (a held writer
    keeps the wire open until the spot shows), then end the wire.  Returns
    (the spots read over HTTP, the service's store)."""
    os.mkfifo(fifo)
    port = _free_port()
    out = {}

    def service():
        out["store"] = service_main(
            ["--live", f"fifo://{fifo}", "--rate", "24000", "--port",
             str(port), "--block-size", "12000", "--live-timeout", "20",
             *extra])

    th = threading.Thread(target=service, daemon=True)
    th.start()
    t0 = time.perf_counter()
    while True:         # a writer opens once the service's pump reads
        try:
            hold = os.open(fifo, os.O_WRONLY | os.O_NONBLOCK)
            break
        except OSError:
            assert time.perf_counter() - t0 < DEADLINE and th.is_alive()
            time.sleep(0.01)
    try:
        tx_main(["afsk", "--wire", f"fifo://{fifo}"])
        while True:
            try:
                spots = json.loads(_get(port, "/spots")[0])
            except OSError:
                spots = []
            if spots:
                break
            assert time.perf_counter() - t0 < DEADLINE, "no spot served"
            time.sleep(0.05)
    finally:
        os.close(hold)
    th.join(DEADLINE)
    assert not th.is_alive()
    return spots, out["store"]


def test_aprs_service_live_fifo_like_jax(tmp_path):
    """The live path (the s16 wire through the native pump, the AFSK front
    end block by block, streaming decode) serves the frame over HTTP, and
    its spots are the JAX service's on the same transmission."""
    from libsdr_tpu.apps import aprs_service as j_service
    from libsdr_tpu.apps import tx as j_tx
    from libsdr_tpu_torch.apps import aprs_service, tx

    spots, store = serve_live_fifo(aprs_service.main, tx.main,
                                   str(tmp_path / "port.fifo"),
                                   ["--device", "cpu"])
    j_spots, j_store = serve_live_fifo(j_service.main, j_tx.main,
                                       str(tmp_path / "jax.fifo"))
    assert spots == store.spots() == j_store.spots() == j_spots
    assert spots[0]["from"] == "N0CALL-0"
    assert spots[0]["comment"] == "libsdr_tpu"
