"""ctypes bindings to the native balancer core and the native output
buffer.

Copy of the parts of ceracoder_tpu/native/__init__.py on the app's
path: the balancer core (exact clone of the rate-control contract,
reference: src/core/bitrate_control.c:81-222), whose Python classes in
`control/` are the executable spec, and the output buffer that the
audio encoder shim writes into. The libraries are built from
native/src in place by utils/host_build.py; a build that fails raises.
"""

from __future__ import annotations

import ctypes
import functools

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
