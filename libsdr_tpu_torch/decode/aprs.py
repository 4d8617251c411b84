"""APRS parsing on top of AX.25 UI frames (reference: src/aprs.{hh,cc}).

UI-frame filter: ctrl byte 0x03 and PID 0xF0 (reference: src/aprs.cc:18-41);
position reports with type chars '!', '=', '@', '/', ';', latitude
``ddmm.mm[N/S]``, longitude ``dddmm.mm[E/W]`` (src/aprs.cc:162-255), and
timestamps ``z`` (day/hour/min UTC), ``/`` (local), ``h`` (hour/min/sec),
``MDHM`` (src/aprs.cc:258-318).
"""

from __future__ import annotations

import dataclasses
import datetime
from typing import List, Optional

from libsdr_tpu_torch.decode.ax25 import AX25Decoder, AX25Message

# Symbol classes recognized by the reference (src/aprs.cc:56-99).
_SYMBOLS = {
    "POLICE": "P!", "DIGI": "%&(Bn#", "JOGGER": "[e$", "AIRCRAFT": "X^g'",
    "HOUSE": "-", "MOTORCYCLE": "b<", "CAR": "=*Ujkuv>", "BOAT": "YsC",
    "BALLOON": "O", "WX": "_",
}


def _to_symbol(table: str, sym: str) -> str:
    if table == "/":
        for name, chars in _SYMBOLS.items():
            if sym in chars:
                return name
    return "NONE"


@dataclasses.dataclass
class APRSMessage:
    """Parsed APRS report (reference: src/aprs.hh APRS::Message)."""

    ax25: AX25Message
    has_location: bool = False
    latitude: float = 0.0
    longitude: float = 0.0
    symbol: str = "NONE"
    has_time: bool = False
    time: Optional[datetime.datetime] = None
    comment: str = ""

    def __str__(self) -> str:
        s = f"APRS: {self.ax25.frm} > {self.ax25.to}"
        if self.has_location:
            s += f" @ ({self.latitude:.4f}, {self.longitude:.4f}) {self.symbol}"
        if self.comment:
            s += f" '{self.comment}'"
        return s


class _Reader:
    def __init__(self, s: str):
        self.s = s
        self.i = 0

    def digit(self) -> Optional[int]:
        # ASCII-only, like the reference's __is_number ('0' <= c <= '9',
        # src/aprs.cc:12): str.isdigit() also accepts Unicode digits
        # (e.g. latin-1 superscripts), which must NOT parse.
        if self.i < len(self.s) and "0" <= self.s[self.i] <= "9":
            d = ord(self.s[self.i]) - 0x30
            self.i += 1
            return d
        return None

    def two(self) -> Optional[int]:
        a = self.digit()
        if a is None:
            return None
        b = self.digit()
        if b is None:
            return None
        return a * 10 + b

    def char(self) -> Optional[str]:
        if self.i < len(self.s):
            c = self.s[self.i]
            self.i += 1
            return c
        return None

    def expect(self, c: str) -> bool:
        return self.char() == c


def _read_latitude(r: _Reader) -> Optional[float]:
    """ddmm.mm[N/S] (reference: src/aprs.cc:180-219)."""
    deg = r.two()
    mins = r.two()
    if deg is None or mins is None or not r.expect("."):
        return None
    dec = r.two()
    if dec is None:
        return None
    lat = deg + (mins + dec / 100.0) / 60.0
    c = r.char()
    if c == "N":
        return lat
    if c == "S":
        return -lat
    return None


def _read_longitude(r: _Reader) -> Optional[float]:
    """dddmm.mm[E/W] (reference: src/aprs.cc:222-255)."""
    d1, rest = r.digit(), r.two()
    if d1 is None or rest is None:
        return None
    deg = d1 * 100 + rest
    mins = r.two()
    if mins is None or not r.expect("."):
        return None
    dec = r.two()
    if dec is None:
        return None
    lon = deg + (mins + dec / 100.0) / 60.0
    c = r.char()
    if c == "E":
        return lon
    if c == "W":
        return -lon
    return None


def _read_time(r: _Reader, now: datetime.datetime) -> Optional[datetime.datetime]:
    """z / '/' / h / MDHM formats (reference: src/aprs.cc:258-318)."""
    a, b, c = r.two(), r.two(), r.two()
    if a is None or b is None or c is None:
        return None
    k = r.char()
    # The reference pokes the raw digits into a struct tm and calls
    # mktime (src/aprs.cc:277-316), which NORMALIZES every out-of-range
    # field (day 0 -> last day of the previous month, hour 25 -> next
    # day, ...).  datetime.replace would raise instead, so replicate the
    # normalization with timedelta arithmetic from an in-range base.
    td = datetime.timedelta
    try:
        if k == "z" or k == "/":
            return (now.replace(day=1, hour=0, minute=0)
                    + td(days=a - 1, hours=b, minutes=c))
        if k == "h":
            return (now.replace(hour=0, minute=0, second=0)
                    + td(hours=a, minutes=b, seconds=c))
        if k is not None and "0" <= k <= "9":     # ASCII, like the reference
            d2 = r.digit()
            if d2 is None:
                return None
            d = (ord(k) - 0x30) * 10 + d2
            # Reference QUIRK (src/aprs.cc:306-316): the MDHM month digits
            # are stored into the 0-BASED tm_mon directly, so payload "08"
            # parses as September; mktime normalizes month 12 into January
            # of the next year.  Replicated for golden parity.
            return (now.replace(year=now.year + a // 12, month=a % 12 + 1,
                                day=1, hour=0, minute=0)
                    + td(days=b - 1, hours=c, minutes=d))
    except (ValueError, OverflowError):
        return None
    return None


def parse_aprs(msg: AX25Message,
               now: Optional[datetime.datetime] = None) -> Optional[APRSMessage]:
    """Parse an AX.25 message as APRS.  Returns None for non-UI frames
    (ctrl != 0x03 or PID != 0xF0, reference: src/aprs.cc:18-41)."""
    p = msg.payload
    if len(p) < 2 or p[0] != 0x03 or p[1] != 0xF0:
        return None
    now = now or datetime.datetime.now()
    out = APRSMessage(ax25=msg)
    body = p[2:].decode("latin-1")
    r = _Reader(body)
    t = r.char()
    if t in ("=", "!"):
        out.has_location = True
    elif t in ("/", "@"):
        out.has_time = True
        out.has_location = True
    elif t == ";":
        out.has_time = True
        out.has_location = True
        r.i += 10  # object id (9) + delimiter (reference: src/aprs.cc:128-132)
    else:
        out.comment = body
        return out

    if out.has_time:
        tm = _read_time(r, now)
        if tm is None:
            out.has_time = out.has_location = False
            return out
        out.time = tm
    if out.has_location:
        lat = _read_latitude(r)
        table = r.char()
        lon = _read_longitude(r) if lat is not None else None
        sym = r.char()
        if lat is None or lon is None:
            out.has_location = False
            return out
        out.latitude, out.longitude = lat, lon
        out.symbol = _to_symbol(table or "", sym or "")
    out.comment = r.s[r.i:]
    return out


class APRSDecoder(AX25Decoder):
    """AX.25 deframer + APRS parser; collects :attr:`aprs_messages`."""

    def __init__(self) -> None:
        super().__init__()
        self.aprs_messages: List[APRSMessage] = []

    def process(self, bits) -> List[APRSMessage]:
        before = len(self.aprs_messages)
        for m in super().process(bits):
            parsed = parse_aprs(m)
            if parsed is not None:
                self.aprs_messages.append(parsed)
        return self.aprs_messages[before:]
