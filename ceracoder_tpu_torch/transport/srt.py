"""SRT client over libsrt via ctypes.

Mirrors the reference's 6-call client surface
(reference: src/net/srt_client.h:45-84 — init/connect/send/get_stats/
get_sockopt/close/cleanup) and its socket tuning
(reference: src/net/srt_client.c:49-103: SRTO_MAXBW=0, SRTO_OHEADBW=20,
SRTO_LATENCY, SRTO_STREAMID, SRTO_RETRANSMITALGO=1, negotiated-latency
readback via SRTO_PEERLATENCY). The system libsrt has no dev headers, so
the ABI (option ids + SRT_TRACEBSTATS layout) is declared here and
validated empirically by tests/test_srt.py over a loopback link.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import socket as pysocket
import struct
from dataclasses import dataclass
from typing import Optional

# SRT overhead bandwidth %, as in the reference (src/net/srt_client.h:34)
SRT_MAX_OHEAD = 20

SRT_INVALID_SOCK = -1
SRT_ERROR = -1

# SRT_SOCKOPT ids (srt.h, v1.5 ABI)
SRTO_MSS = 0
SRTO_SNDSYN = 1
SRTO_RCVSYN = 2
SRTO_SNDBUF = 5
SRTO_RCVBUF = 6
SRTO_MAXBW = 16
SRTO_SNDDATA = 19
SRTO_RCVDATA = 20
SRTO_SENDER = 21
SRTO_TSBPDMODE = 22
SRTO_LATENCY = 23
SRTO_INPUTBW = 24
SRTO_OHEADBW = 25
SRTO_RCVLATENCY = 43
SRTO_PEERLATENCY = 44
SRTO_STREAMID = 46
SRTO_PAYLOADSIZE = 49
SRTO_RETRANSMITALGO = 61


class TraceBStats(ctypes.Structure):
    """SRT_TRACEBSTATS / CBytePerfMon (srt.h v1.5 layout)."""

    _fields_ = [
        # total measurements
        ("msTimeStamp", ctypes.c_int64),
        ("pktSentTotal", ctypes.c_int64),
        ("pktRecvTotal", ctypes.c_int64),
        ("pktSndLossTotal", ctypes.c_int),
        ("pktRcvLossTotal", ctypes.c_int),
        ("pktRetransTotal", ctypes.c_int),
        ("pktSentACKTotal", ctypes.c_int),
        ("pktRecvACKTotal", ctypes.c_int),
        ("pktSentNAKTotal", ctypes.c_int),
        ("pktRecvNAKTotal", ctypes.c_int),
        ("usSndDurationTotal", ctypes.c_int64),
        ("pktSndDropTotal", ctypes.c_int),
        ("pktRcvDropTotal", ctypes.c_int),
        ("pktRcvUndecryptTotal", ctypes.c_int),
        ("byteSentTotal", ctypes.c_uint64),
        ("byteRecvTotal", ctypes.c_uint64),
        ("byteRcvLossTotal", ctypes.c_uint64),
        ("byteRetransTotal", ctypes.c_uint64),
        ("byteSndDropTotal", ctypes.c_uint64),
        ("byteRcvDropTotal", ctypes.c_uint64),
        ("byteRcvUndecryptTotal", ctypes.c_uint64),
        # local (interval) measurements
        ("pktSent", ctypes.c_int64),
        ("pktRecv", ctypes.c_int64),
        ("pktSndLoss", ctypes.c_int),
        ("pktRcvLoss", ctypes.c_int),
        ("pktRetrans", ctypes.c_int),
        ("pktRcvRetrans", ctypes.c_int),
        ("pktSentACK", ctypes.c_int),
        ("pktRecvACK", ctypes.c_int),
        ("pktSentNAK", ctypes.c_int),
        ("pktRecvNAK", ctypes.c_int),
        ("mbpsSendRate", ctypes.c_double),
        ("mbpsRecvRate", ctypes.c_double),
        ("usSndDuration", ctypes.c_int64),
        ("pktReorderDistance", ctypes.c_int),
        ("pktRcvAvgBelatedTime", ctypes.c_double),
        ("pktRcvBelated", ctypes.c_int64),
        ("pktSndDrop", ctypes.c_int),
        ("pktRcvDrop", ctypes.c_int),
        ("pktRcvUndecrypt", ctypes.c_int),
        ("byteSent", ctypes.c_uint64),
        ("byteRecv", ctypes.c_uint64),
        ("byteRcvLoss", ctypes.c_uint64),
        ("byteRetrans", ctypes.c_uint64),
        ("byteSndDrop", ctypes.c_uint64),
        ("byteRcvDrop", ctypes.c_uint64),
        ("byteRcvUndecrypt", ctypes.c_uint64),
        # instant measurements
        ("usPktSndPeriod", ctypes.c_double),
        ("pktFlowWindow", ctypes.c_int),
        ("pktCongestionWindow", ctypes.c_int),
        ("pktFlightSize", ctypes.c_int),
        ("msRTT", ctypes.c_double),
        ("mbpsBandwidth", ctypes.c_double),
        ("byteAvailSndBuf", ctypes.c_int),
        ("byteAvailRcvBuf", ctypes.c_int),
        ("mbpsMaxBW", ctypes.c_double),
        ("byteMSS", ctypes.c_int),
        ("pktSndBuf", ctypes.c_int),
        ("byteSndBuf", ctypes.c_int),
        ("msSndBuf", ctypes.c_int),
        ("msSndTsbPdDelay", ctypes.c_int),
        ("pktRcvBuf", ctypes.c_int),
        ("byteRcvBuf", ctypes.c_int),
        ("msRcvBuf", ctypes.c_int),
        ("msRcvTsbPdDelay", ctypes.c_int),
        ("pktSndFilterExtraTotal", ctypes.c_int),
        ("pktRcvFilterExtraTotal", ctypes.c_int),
        ("pktRcvFilterSupplyTotal", ctypes.c_int),
        ("pktRcvFilterLossTotal", ctypes.c_int),
        ("pktSndFilterExtra", ctypes.c_int),
        ("pktRcvFilterExtra", ctypes.c_int),
        ("pktRcvFilterSupply", ctypes.c_int),
        ("pktRcvFilterLoss", ctypes.c_int),
        ("pktReorderTolerance", ctypes.c_int),
        ("pktSentUniqueTotal", ctypes.c_int64),
        ("pktRecvUniqueTotal", ctypes.c_int64),
        ("byteSentUniqueTotal", ctypes.c_uint64),
        ("byteRecvUniqueTotal", ctypes.c_uint64),
        ("pktSentUnique", ctypes.c_int64),
        ("pktRecvUnique", ctypes.c_int64),
        ("byteSentUnique", ctypes.c_uint64),
        ("byteRecvUnique", ctypes.c_uint64),
    ]


@dataclass
class SrtStats:
    """The stats subset the 20 ms control loop consumes
    (reference: src/ceracoder.c:241-252, 277-286)."""

    ms_rtt: float = 0.0
    mbps_send_rate: float = 0.0
    pkt_snd_loss_total: int = 0
    pkt_retrans_total: int = 0
    pkt_recv_ack_total: int = 0
    pkt_flight_size: int = 0
    byte_sent_total: int = 0


_lib: Optional[ctypes.CDLL] = None


def load_libsrt() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is not None:
        return _lib
    for name in ("libsrt-gnutls.so.1.5", "libsrt.so.1.5", "libsrt.so",
                 ctypes.util.find_library("srt")):
        if not name:
            continue
        try:
            lib = ctypes.CDLL(name)
        except OSError:
            continue
        lib.srt_startup()
        lib.srt_send.argtypes = [ctypes.c_int, ctypes.c_char_p, ctypes.c_int]
        lib.srt_getlasterror_str.restype = ctypes.c_char_p
        _lib = lib
        return lib
    return None


def srt_available() -> bool:
    return load_libsrt() is not None


def _sockaddr_in(host: str, port: int) -> bytes:
    addr = pysocket.inet_aton(pysocket.gethostbyname(host))
    return struct.pack("<H", pysocket.AF_INET) + struct.pack("!H", port) \
        + addr + b"\x00" * 8


class SrtError(OSError):
    pass


class SrtSocket:
    """Thin RAII wrapper over one SRT socket."""

    def __init__(self, lib=None):
        self.lib = lib or load_libsrt()
        if self.lib is None:
            raise SrtError("libsrt not available")
        self.sock = self.lib.srt_create_socket()
        if self.sock == SRT_INVALID_SOCK:
            raise SrtError("srt_create_socket failed")

    def _check(self, rc, what):
        if rc == SRT_ERROR:
            err = self.lib.srt_getlasterror_str().decode()
            raise SrtError(f"{what}: {err}")
        return rc

    def set_int(self, opt: int, value: int):
        v = ctypes.c_int(value)
        self._check(self.lib.srt_setsockopt(
            self.sock, 0, opt, ctypes.byref(v), ctypes.sizeof(v)),
            f"setsockopt({opt})")

    def set_int64(self, opt: int, value: int):
        v = ctypes.c_int64(value)
        self._check(self.lib.srt_setsockopt(
            self.sock, 0, opt, ctypes.byref(v), ctypes.sizeof(v)),
            f"setsockopt({opt})")

    def set_str(self, opt: int, value: str):
        b = value.encode()
        self._check(self.lib.srt_setsockopt(self.sock, 0, opt, b, len(b)),
                    f"setsockopt({opt})")

    def get_int(self, opt: int) -> int:
        v = ctypes.c_int(0)
        sz = ctypes.c_int(ctypes.sizeof(v))
        self._check(self.lib.srt_getsockopt(
            self.sock, 0, opt, ctypes.byref(v), ctypes.byref(sz)),
            f"getsockopt({opt})")
        return v.value

    def bind(self, host: str, port: int):
        sa = _sockaddr_in(host, port)
        self._check(self.lib.srt_bind(self.sock, sa, len(sa)), "bind")

    def listen(self, backlog: int = 1):
        self._check(self.lib.srt_listen(self.sock, backlog), "listen")

    def accept(self) -> "SrtSocket":
        alen = ctypes.c_int(32)
        abuf = ctypes.create_string_buffer(32)
        fd = self.lib.srt_accept(self.sock, abuf, ctypes.byref(alen))
        if fd == SRT_INVALID_SOCK:
            raise SrtError("accept failed")
        peer = SrtSocket.__new__(SrtSocket)
        peer.lib = self.lib
        peer.sock = fd
        return peer

    def connect(self, host: str, port: int):
        sa = _sockaddr_in(host, port)
        self._check(self.lib.srt_connect(self.sock, sa, len(sa)), "connect")

    def send(self, data: bytes) -> int:
        return self._check(self.lib.srt_send(self.sock, data, len(data)),
                           "send")

    def recv(self, size: int = 1500) -> bytes:
        buf = ctypes.create_string_buffer(size)
        n = self.lib.srt_recvmsg(self.sock, buf, size)
        if n == SRT_ERROR:
            raise SrtError("recv failed")
        return buf.raw[:n]

    def bstats(self, clear: bool = False) -> TraceBStats:
        st = TraceBStats()
        self._check(self.lib.srt_bstats(self.sock, ctypes.byref(st),
                                        1 if clear else 0), "bstats")
        return st

    def reject_reason(self) -> int:
        return self.lib.srt_getrejectreason(self.sock)

    def close(self):
        if self.sock != SRT_INVALID_SOCK:
            self.lib.srt_close(self.sock)
            self.sock = SRT_INVALID_SOCK


class SrtClient:
    """The reference's SRT client behavior: tuned caller socket + stats
    poll (reference: src/net/srt_client.c)."""

    def __init__(self, latency_ms: int = 2000,
                 stream_id: Optional[str] = None,
                 payload_size: int = 1316,
                 expected_bps: int = 0):
        self.latency_ms = latency_ms
        self.stream_id = stream_id
        self.payload_size = payload_size
        self.expected_bps = expected_bps
        self.sock: Optional[SrtSocket] = None
        self.negotiated_latency: Optional[int] = None

    def connect(self, host: str, port: int) -> None:
        s = SrtSocket()
        # tuning mirrors reference srt_client.c:49-86
        s.set_int64(SRTO_MAXBW, 0)           # auto from input rate
        s.set_int(SRTO_OHEADBW, SRT_MAX_OHEAD)
        if self.expected_bps > 0:
            # The reference leaves INPUTBW at 0 (the encoder rate is
            # opaque to it, so libsrt estimates the input rate); here
            # the rate controller OWNS the target bitrate, so seed the
            # pacer with the configured maximum. Without this, a burst
            # before the estimator converges is paced at the stale
            # low estimate, the send buffer backs up, and the balancer
            # reads self-inflicted congestion (observed: a 6 Mbps
            # loopback stream pinned at ~1 Mbps pacing).
            s.set_int64(SRTO_INPUTBW, self.expected_bps // 8)
        s.set_int(SRTO_LATENCY, self.latency_ms)
        if self.stream_id:
            s.set_str(SRTO_STREAMID, self.stream_id)
        try:
            s.set_int(SRTO_RETRANSMITALGO, 1)
        except SrtError:
            pass                              # older libsrt
        s.connect(host, port)
        self.negotiated_latency = s.get_int(SRTO_PEERLATENCY)
        self._abi_probe(s)
        self.sock = s

    @staticmethod
    def libsrt_version() -> tuple[int, int, int] | None:
        """(major, minor, patch) via srt_getversion, or None."""
        lib = load_libsrt()
        if lib is None or not hasattr(lib, "srt_getversion"):
            return None
        try:
            v = int(lib.srt_getversion())
        except Exception:
            return None
        return (v >> 16) & 0xFF, (v >> 8) & 0xFF, v & 0xFF

    def _abi_probe(self, s: "SrtSocket") -> None:
        """Detect libsrt ABI drift instead of silently skewed stats:
        the sockopt ids and SRT_TRACEBSTATS layout here are
        hand-declared (no dev headers on the host), so a libsrt
        upgrade could silently shift every field the balancer reads.

        An unknown version series (not 1.3-1.5) HARD-fails — the
        layout is genuinely unvalidated there. The plausibility
        heuristics on a just-connected socket's bstats (msTimeStamp
        small and monotonic, msRTT sane, near-zero loss counters) only
        WARN: on a lossy link early data packets may legitimately have
        been retransmitted already, and killing a working connection
        over a heuristic would be worse than skewed telemetry."""
        ver = self.libsrt_version()
        if ver is not None and not (ver[0] == 1 and 3 <= ver[1] <= 5):
            raise SrtError(
                f"libsrt {ver[0]}.{ver[1]}.{ver[2]}: untested ABI "
                "series — revalidate sockopt ids and the "
                "SRT_TRACEBSTATS layout in transport/srt.py")
        st = s.bstats()
        ok = (0 <= st.msTimeStamp < 600_000
              and 0.0 <= st.msRTT < 60_000.0
              and 0 <= st.pktRetransTotal <= 16
              and 0 <= st.pktSndLossTotal <= 16)
        st2 = s.bstats()
        ok = ok and st2.msTimeStamp >= st.msTimeStamp
        if not ok:
            import sys
            print(
                "ceracoder: warning: SRT_TRACEBSTATS plausibility "
                f"probe failed (msTimeStamp={st.msTimeStamp}, "
                f"msRTT={st.msRTT}, retrans={st.pktRetransTotal}) — "
                "possible libsrt ABI drift; balancer stats may be "
                "skewed (transport/srt.py)", file=sys.stderr)

    def send(self, payload: bytes) -> int:
        assert self.sock is not None
        return self.sock.send(payload)

    def get_stats(self) -> SrtStats:
        assert self.sock is not None
        st = self.sock.bstats()
        return SrtStats(
            ms_rtt=st.msRTT,
            mbps_send_rate=st.mbpsSendRate,
            pkt_snd_loss_total=st.pktSndLossTotal,
            pkt_retrans_total=st.pktRetransTotal,
            pkt_recv_ack_total=st.pktRecvACKTotal,
            pkt_flight_size=st.pktFlightSize,
            byte_sent_total=st.byteSentTotal,
        )

    def get_snd_buffer(self) -> int:
        """SRTO_SNDDATA: unacknowledged packets in the send buffer — the
        balancer's `bs` input (reference: src/ceracoder.c:241)."""
        assert self.sock is not None
        return self.sock.get_int(SRTO_SNDDATA)

    def close(self) -> None:
        if self.sock is not None:
            self.sock.close()
            self.sock = None
