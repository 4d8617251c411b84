"""APRS web service (counterpart of ``libsdr_tpu.apps.aprs_service``;
reference: cmd/ APRSApplication + src/http.{hh,cc}).

The HTTP machinery is ``utils/http.py`` (the reference's Handler /
StaticHandler / DelegateJSONHandler surface plus a working RFC 6455
websocket upgrade); this app is the store of decoded spots and its
endpoints (cmd/aprsapplication.cc:10-60: the static map page, /spots JSON,
/update push, the live /ws spot stream).  The AFSK front end (FSK detector
and bit-sync PLL) runs on ``--device``, the card by default.

Usage:
  python -m libsdr_tpu_torch.apps.aprs_service --file afsk.wav --oneshot
  python -m libsdr_tpu_torch.apps.aprs_service --live tcp-listen://:7373 \
      --rate 24000 --port 8080
"""

from __future__ import annotations

import json
import queue
import threading
from pathlib import Path
from typing import List

from libsdr_tpu_torch.decode.aprs import APRSDecoder, APRSMessage
from libsdr_tpu_torch.utils.http import (JSONHandler, StaticHandler,
                                         WebSocket, WebSocketHandler,
                                         serve_handlers)

# The static map page served at '/' (the reference's baked page,
# cmd/aprsapplication.cc:13-16: here a self-contained SVG map polling
# /spots and following /ws, with no external dependencies).
_PAGE = (Path(__file__).resolve().parent / "aprs_map.html").read_bytes()


class APRSStore:
    """Thread-safe store of decoded spots
    (reference: cmd/aprsapplication.cc:24-40)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._spots: List[dict] = []
        self._subs: List[queue.Queue] = []

    def subscribe(self) -> "queue.Queue[dict]":
        """A live-push subscriber's queue, loaded with every stored spot and
        then each new one.  Bounded: a stalled client drops its OLDEST
        pending spots rather than grow the server's memory."""
        q: queue.Queue = queue.Queue(maxsize=4096)
        with self._lock:
            for s in self._spots[-4096:]:
                q.put(s)
            self._subs.append(q)
        return q

    def unsubscribe(self, q: queue.Queue) -> None:
        with self._lock:
            if q in self._subs:
                self._subs.remove(q)

    def _append(self, spot: dict) -> None:
        with self._lock:
            self._spots.append(spot)
            for q in self._subs:
                try:
                    q.put_nowait(spot)
                except queue.Full:      # a slow consumer: drop its oldest
                    try:
                        q.get_nowait()
                    except queue.Empty:
                        pass
                    try:
                        q.put_nowait(spot)
                    except queue.Full:
                        pass

    def add(self, msg: APRSMessage) -> None:
        spot = {
            "from": str(msg.ax25.frm),
            "to": str(msg.ax25.to),
            "via": [str(v) for v in msg.ax25.via],
            "comment": msg.comment,
        }
        if msg.has_location:
            spot.update(latitude=msg.latitude, longitude=msg.longitude,
                        symbol=msg.symbol)
        if msg.has_time and msg.time is not None:
            spot["time"] = msg.time.isoformat()
        self._append(spot)

    def add_spot(self, spot: dict) -> None:
        """Append a spot pushed from outside (the REST /update path)."""
        self._append(spot)

    def spots(self) -> List[dict]:
        with self._lock:
            return list(self._spots)


def _ws_spot_stream(store: APRSStore):
    """/ws session: push every stored spot, then each new one, while the
    library's poll answers Ping and Close."""

    def on_open(ws: WebSocket) -> None:
        q = store.subscribe()
        try:
            while True:
                try:
                    while True:
                        ws.send_json(q.get_nowait())
                except queue.Empty:
                    pass
                if ws.poll(0.25) is None:
                    break
        finally:
            store.unsubscribe(q)

    return on_open


def handlers_for(store: APRSStore):
    """The app's endpoints (reference: cmd/aprsapplication.cc:13-60)."""
    return [
        StaticHandler("/", _PAGE, "text/html"),
        JSONHandler("/spots", get=store.spots),
        JSONHandler("/update", post=store.add_spot, post_status=204),
        WebSocketHandler("/ws", _ws_spot_stream(store)),
    ]


def serve(store: APRSStore, port: int = 8080):
    """Start the service on ``port`` (0 = ephemeral); returns the httpd."""
    return serve_handlers(handlers_for(store), port)


def _serve_live(args, device):
    """The live serving loop: an s16 AFSK audio wire -> the bit front end
    on ``device`` block by block -> streaming APRS decode -> spots pushed
    to /ws as they decode (the always-on deployment of the reference's
    cmd/ app; its live source: src/portaudio.cc PortSource)."""
    import torch

    from libsdr_tpu_torch.apps.chains import afsk_front_end
    from libsdr_tpu_torch.core import cplx
    from libsdr_tpu_torch.core.ragged import compact
    from libsdr_tpu_torch.io.live import LiveStats, stream_live_audio

    store = APRSStore()
    httpd = serve(store, args.port)
    print(f"live APRS on :{httpd.server_address[1]} (GET /spots, ws /ws) "
          f"from {args.live}")
    fe = afsk_front_end(args.rate, args.block_size)
    step = fe.compile()
    carry = fe.init_carry(device)
    dec = APRSDecoder()
    stats = LiveStats()
    n_pushed = 0
    try:
        for blk in stream_live_audio(args.live, args.block_size,
                                     stats=stats,
                                     timeout=args.live_timeout):
            carry, y = step(carry, cplx.as_block(blk, torch.float32, device))
            dec.process(compact(y.to_numpy()))
            while n_pushed < len(dec.aprs_messages):
                store.add(dec.aprs_messages[n_pushed])  # wakes /ws queues
                n_pushed += 1
    except KeyboardInterrupt:
        pass
    finally:
        httpd.shutdown()
        httpd.server_close()
    print(f"live done: {n_pushed} spots, {stats.bytes_in} bytes in, "
          f"{stats.bytes_dropped} dropped "
          f"({100 * stats.drop_fraction:.2f}%)")
    return store


def main(argv=None):
    import numpy as np

    from libsdr_tpu_torch.apps.chains import afsk_front_end, run_bit_chain
    from libsdr_tpu_torch.utils.options import (add_source_args,
                                                common_parser, device_of,
                                                load_source)

    p = common_parser("APRS web service (reference: cmd/)")
    add_source_args(p)
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--oneshot", action="store_true",
                   help="decode the file, print the spots' JSON, exit")
    p.add_argument("--live",
                   help="live s16 AFSK audio wire instead of a file "
                        "(tcp://h:p, tcp-listen://:p, udp://:p, "
                        "fifo:///path); needs --rate; spots stream to /ws "
                        "websocket clients as they decode")
    p.add_argument("--live-timeout", type=float, default=None,
                   help="stop after this many seconds with no wire data")
    args = p.parse_args(argv)
    dev = device_of(args)

    if args.live:
        if not args.rate:
            raise SystemExit("--live requires --rate")
        return _serve_live(args, dev)

    audio, fs = load_source(args)
    if np.iscomplexobj(audio):
        raise SystemExit("aprs_service expects demodulated AFSK audio")
    store = APRSStore()
    fe = afsk_front_end(fs, args.block_size)
    bits = run_bit_chain(fe, audio.astype(np.float32), dev)
    dec = APRSDecoder()
    dec.process(bits)
    for m in dec.aprs_messages:
        store.add(m)
    if args.oneshot:
        print(json.dumps(store.spots(), indent=2))
        return store
    httpd = serve(store, args.port)
    print(f"serving {len(store.spots())} spots on "
          f":{httpd.server_address[1]} (GET /spots); Ctrl-C to stop")
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        httpd.shutdown()
    return store


if __name__ == "__main__":
    main()
