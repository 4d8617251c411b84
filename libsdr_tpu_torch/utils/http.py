"""Reusable threaded HTTP/1.1 server library (a copy of the stdlib-only
``libsdr_tpu.utils.http``) — the analog of the reference's
``src/http.{hh,cc}`` (reference: src/http.hh:87-621: Server +
Handler dispatch, StaticHandler, DelegateJSONHandler, its own JSON value
type, and a protocol-upgrade hook shipped with sha1.cc for websockets).

Design differences from a translation: Python's stdlib
``ThreadingHTTPServer`` already provides the reference's
thread-per-connection model (src/http.cc:141-210), ``dict``/``list`` ARE
the JSON value type, and the upgrade hook is actually implemented —
:class:`WebSocketHandler` performs the RFC 6455 handshake and hands the
application a :class:`WebSocket` with send + control-frame handling
(Ping→Pong, Close handshake), which the reference never wired up.

Handlers are matched in registration order (first match wins), mirroring
the reference's ``Server::addHandler`` dispatch:

    serve([StaticHandler("/", page),
           JSONHandler("/spots", get=store.spots),
           JSONHandler("/update", post=store.add_spot, post_status=204),
           WebSocketHandler("/ws", on_open)], port=8080)

Consumed by ``apps/aprs_service.py``; any other HTTP-facing app can reuse
the same pieces.
"""

from __future__ import annotations

import base64
import hashlib
import json
import select
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Iterable, List, Optional

# RFC 6455 §1.3 handshake GUID (the constant the reference's sha1.cc was
# shipped for).
_WS_GUID = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"
_MAX_BODY = 1 << 20  # bound attacker-controlled reads (POST bodies)


# -- websocket wire helpers (RFC 6455 §4-5) ---------------------------------

def ws_accept(key: str) -> str:
    """Sec-WebSocket-Accept for a client key (RFC 6455 §4.2.2)."""
    digest = hashlib.sha1((key + _WS_GUID).encode("ascii")).digest()
    return base64.b64encode(digest).decode("ascii")


def ws_frame(opcode: int, payload: bytes) -> bytes:
    """One unmasked server->client frame (RFC 6455 §5.2)."""
    n = len(payload)
    if n < 126:
        head = bytes([0x80 | opcode, n])
    elif n < 1 << 16:
        head = bytes([0x80 | opcode, 126]) + n.to_bytes(2, "big")
    else:
        head = bytes([0x80 | opcode, 127]) + n.to_bytes(8, "big")
    return head + payload


def ws_text_frame(payload: bytes) -> bytes:
    """One unmasked server->client text frame (RFC 6455 §5.2)."""
    return ws_frame(0x1, payload)


def ws_parse_frames(buf: bytes):
    """Parse complete (possibly masked) frames from ``buf``; returns
    ([(opcode, payload), ...], unconsumed_rest) (RFC 6455 §5.2-5.3)."""
    frames = []
    while len(buf) >= 2:
        opcode = buf[0] & 0x0F
        masked = bool(buf[1] & 0x80)
        n = buf[1] & 0x7F
        off = 2
        if n == 126:
            if len(buf) < 4:
                break
            n = int.from_bytes(buf[2:4], "big")
            off = 4
        elif n == 127:
            if len(buf) < 10:
                break
            n = int.from_bytes(buf[2:10], "big")
            off = 10
        need = off + (4 if masked else 0) + n
        if len(buf) < need:
            break
        if masked:
            mask = buf[off:off + 4]
            raw = buf[off + 4:need]
            payload = bytes(b ^ mask[i % 4] for i, b in enumerate(raw))
        else:
            payload = buf[off:need]
        frames.append((opcode, payload))
        buf = buf[need:]
    return frames, buf


# -- handler library (reference: http.hh Handler hierarchy) ------------------

class Handler:
    """Dispatch unit: claims (method, path) pairs and serves them
    (reference: src/http.hh Handler::match + handle)."""

    def __init__(self, path: str, methods: Iterable[str] = ("GET",)):
        self.path = path
        self.methods = tuple(m.upper() for m in methods)

    def matches(self, method: str, path: str) -> bool:
        return method in self.methods and path == self.path

    def handle(self, req: "BaseHTTPRequestHandler") -> None:
        raise NotImplementedError


class StaticHandler(Handler):
    """Fixed content at a fixed path (reference: http.hh StaticHandler —
    the baked-resource pages of cmd/aprsapplication.cc:13-16)."""

    def __init__(self, path: str, body: bytes,
                 content_type: str = "text/html"):
        super().__init__(path, ("GET",))
        self.body = body
        self.content_type = content_type

    def handle(self, req) -> None:
        _respond(req, 200, self.content_type, self.body)


class JSONHandler(Handler):
    """JSON endpoint (reference: http.hh DelegateJSONHandler).

    ``get()`` -> object serialized as the response; ``post(obj)`` receives
    the parsed request body (dict/list) and its return value (or
    ``post_status`` with an empty body when it returns None) is the
    response.  Malformed/oversized bodies get 400/413 without reaching the
    delegate."""

    def __init__(self, path: str,
                 get: Optional[Callable[[], object]] = None,
                 post: Optional[Callable[[object], object]] = None,
                 post_status: int = 200):
        methods = [m for m, fn in (("GET", get), ("POST", post)) if fn]
        super().__init__(path, methods)
        self._get, self._post = get, post
        self.post_status = post_status

    def handle(self, req) -> None:
        if req.command == "GET":
            body = json.dumps(self._get()).encode()
            _respond(req, 200, "application/json", body)
            return
        try:
            n = int(req.headers.get("Content-Length", "0"))
        except ValueError:
            req.send_error(400)
            return
        if not (0 < n <= _MAX_BODY):
            req.send_error(413 if n > _MAX_BODY else 400)
            return
        try:
            obj = json.loads(req.rfile.read(n))
        except Exception:
            req.send_error(400)
            return
        if not isinstance(obj, (dict, list)):
            req.send_error(400)
            return
        out = self._post(obj)
        if out is None:
            req.send_response(self.post_status)
            req.end_headers()
        else:
            _respond(req, 200, "application/json", json.dumps(out).encode())


class WebSocket:
    """Server side of one upgraded connection.

    ``send_text``/``send_json`` write frames; :meth:`poll` services the
    read side for up to ``timeout`` seconds — answering Ping with Pong and
    a client Close with the closing-handshake echo (RFC 6455 §5.5.1-2) —
    and returns False once the connection is finished.  Reads poll via
    ``select()`` so sends stay blocking: a socket-wide timeout would also
    abort any write that stalls longer than the poll interval, defeating
    slow-consumer handling."""

    def __init__(self, req) -> None:
        self._req = req
        # A client may pipeline frames in the same TCP segment as the
        # upgrade request; those bytes sit in rfile's read-ahead buffer,
        # invisible to select()/recv().  Drain them first (non-blocking:
        # read1 returns buffered bytes, and raises BlockingIOError only
        # when the buffer is empty).
        self._inbuf = b""
        try:
            req.connection.setblocking(False)
            try:
                self._inbuf = req.rfile.read1(65536) or b""
            except (BlockingIOError, ValueError):
                pass
        finally:
            req.connection.setblocking(True)

    def send_text(self, payload) -> None:
        if isinstance(payload, str):
            payload = payload.encode()
        self._req.wfile.write(ws_text_frame(payload))
        self._req.wfile.flush()

    def send_json(self, obj) -> None:
        self.send_text(json.dumps(obj).encode())

    def poll(self, timeout: float = 0.25):
        """Service the read side for up to ``timeout`` s.

        Control frames are handled in the library (Ping -> Pong; Close ->
        closing-handshake echo).  Returns ``None`` once the connection is
        finished (client closed or hung up), else the list of DATA frames
        received — ``[(opcode, payload), ...]``, empty when only control
        traffic (or nothing) arrived.  Check ``is None`` for liveness."""
        req = self._req
        r, _, _ = select.select([req.connection], [], [], timeout)
        if r:
            data = req.connection.recv(4096)
            if not data:
                return None                # client hung up
            self._inbuf += data
        elif not self._inbuf:
            return []
        frames, self._inbuf = ws_parse_frames(self._inbuf)
        # Only <=125-byte control frames are expected unsolicited; a giant
        # claimed frame length (or endless unparseable bytes) must not
        # grow the buffer unboundedly.
        if len(self._inbuf) > 1 << 16:
            return None
        out = []
        for opcode, payload in frames:
            if opcode == 0x8:              # Close: echo + finish
                req.wfile.write(ws_frame(0x8, payload[:125]))
                req.wfile.flush()
                return None
            elif opcode == 0x9:            # Ping -> Pong, same payload
                # clamp: control frames must be <=125 bytes (RFC 6455
                # §5.5), even when echoing an oversized ping
                req.wfile.write(ws_frame(0xA, payload[:125]))
                req.wfile.flush()
            elif opcode != 0xA:            # drop unsolicited Pongs
                out.append((opcode, payload))
        return out


class WebSocketHandler(Handler):
    """RFC 6455 upgrade endpoint (the protocol-upgrade hook of the
    reference's http.hh, actually wired): ``on_open(ws)`` runs on the
    connection's thread and owns the session; transport errors from a
    vanished client are swallowed (the serving thread is a daemon)."""

    def __init__(self, path: str, on_open: Callable[[WebSocket], None]):
        super().__init__(path, ("GET",))
        self._on_open = on_open

    def handle(self, req) -> None:
        key = req.headers.get("Sec-WebSocket-Key")
        upgrade = (req.headers.get("Upgrade") or "").lower()
        if upgrade != "websocket" or not key:
            req.send_error(400, "websocket upgrade required")
            return
        req.send_response(101, "Switching Protocols")
        req.send_header("Upgrade", "websocket")
        req.send_header("Connection", "Upgrade")
        req.send_header("Sec-WebSocket-Accept", ws_accept(key))
        req.end_headers()
        req.close_connection = True
        try:
            self._on_open(WebSocket(req))
        except (BrokenPipeError, ConnectionResetError, OSError):
            pass


def _respond(req, status: int, content_type: str, body: bytes) -> None:
    req.send_response(status)
    req.send_header("Content-Type", content_type)
    req.send_header("Content-Length", str(len(body)))
    req.end_headers()
    req.wfile.write(body)


# -- server (reference: http.hh Server + addHandler) -------------------------

def make_http_handler(handlers: List[Handler]):
    """A BaseHTTPRequestHandler subclass dispatching to ``handlers`` in
    registration order (first match wins)."""

    class _Dispatch(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def _dispatch(self):
            for h in handlers:
                if h.matches(self.command, self.path):
                    h.handle(self)
                    return
            self.send_error(404)

        do_GET = do_POST = do_PUT = do_DELETE = _dispatch  # noqa: N815

        def log_message(self, *a):  # quiet
            pass

    return _Dispatch


def serve_handlers(handlers: List[Handler], port: int = 8080,
                   host: str = "0.0.0.0") -> ThreadingHTTPServer:
    """Start a daemon-threaded server on ``host:port`` (port 0 = ephemeral;
    read ``httpd.server_address``).  Returns the httpd; ``shutdown()``
    stops it."""
    httpd = ThreadingHTTPServer((host, port), make_http_handler(handlers))
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    return httpd


# Short alias matching the reference's Server spelling.
serve = serve_handlers
