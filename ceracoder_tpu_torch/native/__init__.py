"""ctypes bindings to the native host runtime (native/src/*.cc).

Copy of ceracoder_tpu/native/__init__.py: the balancer core (exact
clone of the rate-control contract, reference:
src/core/bitrate_control.c:81-222), the output buffer that the audio
encoder shim writes into, the MPEG-TS muxer and SRT payload packer
(reference: new_buf_cb, src/ceracoder.c:297-339) and an SRT client with
the reference's socket tuning (src/net/srt_client.c:49-103). The Python
implementations in `control/` and `transport/` are the executable spec;
the app runs the native balancer and the Python muxer, packer and SRT
client. Each library is built from native/src in place by
utils/host_build.py, once per process, when first asked for; a build
that fails raises, where the JAX package's `load()` returns None.
"""

from __future__ import annotations

import ctypes
import functools

from ceracoder_tpu_torch.transport.srt import TraceBStats
from ceracoder_tpu_torch.utils.host_build import build_library


class CConfig(ctypes.Structure):
    _fields_ = [
        ("min_bitrate", ctypes.c_int64),
        ("max_bitrate", ctypes.c_int64),
        ("srt_latency", ctypes.c_int32),
        ("srt_pkt_size", ctypes.c_int32),
        ("adaptive_incr_step", ctypes.c_int64),
        ("adaptive_decr_step", ctypes.c_int64),
        ("adaptive_incr_interval", ctypes.c_int32),
        ("adaptive_decr_interval", ctypes.c_int32),
        ("aimd_incr_step", ctypes.c_int64),
        ("aimd_decr_mult", ctypes.c_double),
        ("aimd_incr_interval", ctypes.c_int32),
        ("aimd_decr_interval", ctypes.c_int32),
    ]


class CInput(ctypes.Structure):
    _fields_ = [
        ("buffer_size", ctypes.c_int32),
        ("rtt", ctypes.c_double),
        ("send_rate_mbps", ctypes.c_double),
        ("timestamp", ctypes.c_int64),
        ("pkt_loss_total", ctypes.c_int64),
        ("pkt_retrans_total", ctypes.c_int64),
    ]


class COutput(ctypes.Structure):
    _fields_ = [
        ("new_bitrate", ctypes.c_int64),
        ("throughput", ctypes.c_double),
        ("rtt", ctypes.c_int32),
        ("rtt_th_min", ctypes.c_int32),
        ("rtt_th_max", ctypes.c_int32),
        ("bs", ctypes.c_int32),
        ("bs_th1", ctypes.c_int32),
        ("bs_th2", ctypes.c_int32),
        ("bs_th3", ctypes.c_int32),
    ]


class CLinkStats(ctypes.Structure):
    _fields_ = [
        ("msRTT", ctypes.c_double),
        ("mbpsSendRate", ctypes.c_double),
        ("pktSndLossTotal", ctypes.c_int32),
        ("pktRetransTotal", ctypes.c_int32),
        ("pktRecvACKTotal", ctypes.c_int32),
        ("msTimeStamp", ctypes.c_int64),
    ]


@functools.lru_cache(maxsize=None)
def load_balancer() -> ctypes.CDLL:
    """Build (if needed) and load native/src/balancer.cc, once per
    process, with its C ABI declared."""
    lib = ctypes.CDLL(str(build_library("balancer")))
    lib.cc_balancer_create.restype = ctypes.c_void_p
    lib.cc_balancer_create.argtypes = [ctypes.c_char_p,
                                       ctypes.POINTER(CConfig)]
    lib.cc_balancer_step.restype = ctypes.c_int
    lib.cc_balancer_step.argtypes = [ctypes.c_void_p,
                                     ctypes.POINTER(CInput),
                                     ctypes.POINTER(COutput)]
    lib.cc_balancer_update_bounds.argtypes = [ctypes.c_void_p,
                                              ctypes.c_int64,
                                              ctypes.c_int64]
    lib.cc_balancer_destroy.argtypes = [ctypes.c_void_p]
    lib.cc_balancer_list.restype = ctypes.c_char_p
    return lib


def declare_outbuf(lib: ctypes.CDLL) -> None:
    """Declare the output buffer's C ABI (native/src/mpegts.cc)."""
    lib.cc_outbuf_create.restype = ctypes.c_void_p
    lib.cc_outbuf_destroy.argtypes = [ctypes.c_void_p]
    lib.cc_outbuf_data.restype = ctypes.POINTER(ctypes.c_uint8)
    lib.cc_outbuf_data.argtypes = [ctypes.c_void_p]
    lib.cc_outbuf_size.restype = ctypes.c_int64
    lib.cc_outbuf_size.argtypes = [ctypes.c_void_p]
    lib.cc_outbuf_clear.argtypes = [ctypes.c_void_p]


@functools.lru_cache(maxsize=None)
def load_mpegts() -> ctypes.CDLL:
    """Build (if needed) and load native/src/mpegts.cc (the TS muxer,
    the payload packer and their output buffer), with its C ABI
    declared."""
    lib = ctypes.CDLL(str(build_library("mpegts")))
    lib.cc_tsmux_create.restype = ctypes.c_void_p
    lib.cc_tsmux_create.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.cc_tsmux_create2.restype = ctypes.c_void_p
    lib.cc_tsmux_create2.argtypes = [ctypes.c_int, ctypes.c_int,
                                     ctypes.c_int]
    if hasattr(lib, "cc_tsmux_create3"):
        lib.cc_tsmux_create3.restype = ctypes.c_void_p
        lib.cc_tsmux_create3.argtypes = [ctypes.c_int, ctypes.c_int,
                                         ctypes.c_int, ctypes.c_int]
    lib.cc_tsmux_destroy.argtypes = [ctypes.c_void_p]
    declare_outbuf(lib)
    lib.cc_tsmux_psi.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.cc_tsmux_video.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64, ctypes.c_uint64,
        ctypes.c_int, ctypes.c_uint64, ctypes.c_int, ctypes.c_void_p]
    lib.cc_tsmux_audio.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                   ctypes.c_int64, ctypes.c_uint64,
                                   ctypes.c_void_p]

    lib.cc_packer_create.restype = ctypes.c_void_p
    lib.cc_packer_create.argtypes = [ctypes.c_int]
    lib.cc_packer_destroy.argtypes = [ctypes.c_void_p]
    lib.cc_packer_feed.restype = ctypes.c_int
    lib.cc_packer_feed.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                   ctypes.c_int64, ctypes.c_void_p]
    lib.cc_packer_residue.restype = ctypes.c_int
    lib.cc_packer_residue.argtypes = [ctypes.c_void_p]
    lib.cc_packer_flush.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    return lib


@functools.lru_cache(maxsize=None)
def load_srt_client() -> ctypes.CDLL:
    """Build (if needed) and load native/src/srt_client.cc, with its C
    ABI declared. It builds and loads without libsrt, which it
    `dlopen`s when first asked (`cc_srt_available`)."""
    lib = ctypes.CDLL(str(build_library("srt_client")))
    lib.cc_srt_available.restype = ctypes.c_int
    lib.cc_srt_init.restype = ctypes.c_int
    lib.cc_srt_cleanup.restype = None
    lib.cc_srt_set_stat_offsets.argtypes = [ctypes.c_int64] * 6
    lib.cc_srt_connect.restype = ctypes.c_void_p
    lib.cc_srt_connect.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                   ctypes.c_int, ctypes.c_char_p,
                                   ctypes.c_char_p, ctypes.c_int]
    lib.cc_srt_negotiated_latency.restype = ctypes.c_int
    lib.cc_srt_negotiated_latency.argtypes = [ctypes.c_void_p]
    lib.cc_srt_send.restype = ctypes.c_int
    lib.cc_srt_send.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                ctypes.c_int]
    lib.cc_srt_get_stats.restype = ctypes.c_int
    lib.cc_srt_get_stats.argtypes = [ctypes.c_void_p,
                                     ctypes.POINTER(CLinkStats)]
    lib.cc_srt_get_snddata.restype = ctypes.c_int
    lib.cc_srt_get_snddata.argtypes = [ctypes.c_void_p]
    lib.cc_srt_close.argtypes = [ctypes.c_void_p]
    return lib


def _to_cconfig(config) -> CConfig:
    c = CConfig()
    c.min_bitrate = config.min_bitrate
    c.max_bitrate = config.max_bitrate
    c.srt_latency = config.srt_latency
    c.srt_pkt_size = config.srt_pkt_size
    c.adaptive_incr_step = config.adaptive_incr_step
    c.adaptive_decr_step = config.adaptive_decr_step
    c.adaptive_incr_interval = config.adaptive_incr_interval
    c.adaptive_decr_interval = config.adaptive_decr_interval
    c.aimd_incr_step = config.aimd_incr_step
    c.aimd_decr_mult = config.aimd_decr_mult
    c.aimd_incr_interval = config.aimd_incr_interval
    c.aimd_decr_interval = config.aimd_decr_interval
    return c


class NativeBalancer:
    """Balancer-protocol adapter over the C++ core."""

    def __init__(self, name: str, config) -> None:
        lib = load_balancer()
        self._lib = lib
        self.name = name
        self.description = f"native {name}"
        self._h = lib.cc_balancer_create(name.encode(),
                                         ctypes.byref(_to_cconfig(config)))
        if not self._h:
            raise ValueError(f"unknown balancer {name!r}")

    def step(self, inp):
        # imported here: control/ imports this module
        from ceracoder_tpu_torch.control.types import BalancerOutput
        ci = CInput(buffer_size=inp.buffer_size, rtt=inp.rtt,
                    send_rate_mbps=inp.send_rate_mbps,
                    timestamp=inp.timestamp,
                    pkt_loss_total=inp.pkt_loss_total,
                    pkt_retrans_total=inp.pkt_retrans_total)
        co = COutput()
        self._lib.cc_balancer_step(self._h, ctypes.byref(ci),
                                   ctypes.byref(co))
        return BalancerOutput(
            new_bitrate=co.new_bitrate, throughput=co.throughput,
            rtt=co.rtt, rtt_th_min=co.rtt_th_min, rtt_th_max=co.rtt_th_max,
            bs=co.bs, bs_th1=co.bs_th1, bs_th2=co.bs_th2, bs_th3=co.bs_th3)

    def update_bounds(self, min_bitrate: int, max_bitrate: int) -> None:
        self._lib.cc_balancer_update_bounds(self._h, min_bitrate,
                                            max_bitrate)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.cc_balancer_destroy(self._h)
            self._h = None


class _OutBuf:
    def __init__(self, lib):
        self._lib = lib
        self._h = lib.cc_outbuf_create()

    def take(self) -> bytes:
        n = self._lib.cc_outbuf_size(self._h)
        data = ctypes.string_at(self._lib.cc_outbuf_data(self._h), n)
        self._lib.cc_outbuf_clear(self._h)
        return data

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.cc_outbuf_destroy(self._h)
            self._h = None


class NativeTsMuxer:
    """Same surface as transport.mpegts.TsMuxer, C++ implementation."""

    def __init__(self, video_stream_type: int = 0x1B,
                 with_audio: bool = False, audio_kind: str = "aac",
                 audio_channels: int = 2):
        lib = load_mpegts()
        self._lib = lib
        kind = 1 if audio_kind == "opus" else 0
        if hasattr(lib, "cc_tsmux_create3"):
            self._h = lib.cc_tsmux_create3(
                video_stream_type, int(with_audio), kind,
                audio_channels)
        else:
            self._h = lib.cc_tsmux_create2(
                video_stream_type, int(with_audio), kind)
        self._out = _OutBuf(lib)

    def psi(self) -> bytes:
        self._lib.cc_tsmux_psi(self._h, self._out._h)
        return self._out.take()

    def mux_video(self, annexb: bytes, pts90: int,
                  dts90: int | None = None, keyframe: bool = False) -> bytes:
        self._lib.cc_tsmux_video(self._h, annexb, len(annexb), pts90,
                                 int(dts90 is not None), dts90 or 0,
                                 int(keyframe), self._out._h)
        return self._out.take()

    def mux_audio(self, adts: bytes, pts90: int) -> bytes:
        self._lib.cc_tsmux_audio(self._h, adts, len(adts), pts90,
                                 self._out._h)
        return self._out.take()

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.cc_tsmux_destroy(self._h)
            self._h = None


class NativeTsPacker:
    """Same surface as transport.mpegts.TsPacker, C++ implementation."""

    def __init__(self, pkt_size: int = 1316):
        if pkt_size % 188:
            raise ValueError("pkt_size must be a multiple of 188")
        lib = load_mpegts()
        self._lib = lib
        self.pkt_size = pkt_size
        self._h = lib.cc_packer_create(pkt_size)
        self._out = _OutBuf(lib)

    def feed(self, data: bytes) -> list[bytes]:
        n = self._lib.cc_packer_feed(self._h, data, len(data), self._out._h)
        blob = self._out.take()
        return [blob[i * self.pkt_size:(i + 1) * self.pkt_size]
                for i in range(n)]

    @property
    def residue(self) -> int:
        return self._lib.cc_packer_residue(self._h)

    def flush(self) -> bytes:
        self._lib.cc_packer_flush(self._h, self._out._h)
        return self._out.take()

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.cc_packer_destroy(self._h)
            self._h = None


class NativeSrtClient:
    """C++ SRT client mirroring transport.srt.SrtClient's surface.

    Unlike the JAX package's client, `close` balances the SRT runtime
    reference that the constructor takes (srt_startup / srt_cleanup):
    left taken, libsrt's threads outlive the interpreter's teardown, and
    a process that has loaded torch dies at exit (double free)."""

    def __init__(self) -> None:
        lib = load_srt_client()
        if not lib.cc_srt_available():
            raise RuntimeError("libsrt unavailable")
        self._lib = lib
        lib.cc_srt_init()
        self._started = True
        # align the stats layout with the Python ctypes declaration
        off = TraceBStats
        lib.cc_srt_set_stat_offsets(
            off.msTimeStamp.offset, off.pktSndLossTotal.offset,
            off.pktRetransTotal.offset, off.pktRecvACKTotal.offset,
            off.mbpsSendRate.offset, off.msRTT.offset)
        self._h = None
        self.negotiated_latency = -1

    def connect(self, host: str, port: int, latency_ms: int = 2000,
                streamid: str = "") -> None:
        err = ctypes.create_string_buffer(256)
        h = self._lib.cc_srt_connect(host.encode(), port, latency_ms,
                                     streamid.encode(), err, 256)
        if not h:
            raise ConnectionError(err.value.decode() or "srt connect failed")
        self._h = h
        self.negotiated_latency = self._lib.cc_srt_negotiated_latency(h)

    def send(self, payload: bytes) -> int:
        return self._lib.cc_srt_send(self._h, payload, len(payload))

    def get_stats(self) -> CLinkStats:
        s = CLinkStats()
        if self._lib.cc_srt_get_stats(self._h, ctypes.byref(s)) != 0:
            raise RuntimeError("srt_bstats failed")
        return s

    def get_snddata(self) -> int:
        return self._lib.cc_srt_get_snddata(self._h)

    def close(self) -> None:
        if self._h:
            self._lib.cc_srt_close(self._h)
            self._h = None
        if self._started:
            self._lib.cc_srt_cleanup()
            self._started = False
