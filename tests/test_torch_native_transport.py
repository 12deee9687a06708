"""The port's native TS muxer, payload packer and SRT client
(ceracoder_tpu_torch/native: NativeTsMuxer, NativeTsPacker,
NativeSrtClient over native/src/mpegts.cc and srt_client.cc, each built
alone by utils/host_build.py) against the JAX package's Python
TsMuxer / TsPacker, byte for byte, as tests/test_native.py holds the
JAX package's native classes; the build keys; a failed build raising;
and the SRT client over loopback where libsrt loads."""

import shutil
import socket
import threading
import time

import numpy as np
import pytest
import torch

import ceracoder_tpu_torch.native as native
import ceracoder_tpu_torch.utils.host_build as hb
from ceracoder_tpu.transport import mpegts as jts
from ceracoder_tpu.transport.srt import TraceBStats as JTraceBStats
from ceracoder_tpu_torch.native import (
    NativeSrtClient,
    NativeTsMuxer,
    NativeTsPacker,
)
from ceracoder_tpu_torch.transport import mpegts as tts
from ceracoder_tpu_torch.transport.srt import TraceBStats

# one intra-op thread: pytest-xdist workers share the cores
torch.set_num_threads(1)

MUXERS = [
    dict(),
    dict(video_stream_type=0x24),
    dict(video_stream_type=0x24, with_audio=True),
    dict(with_audio=True, audio_kind="opus", audio_channels=1),
    dict(video_stream_type=0x24, with_audio=True, audio_kind="opus",
         audio_channels=2),
]


@pytest.mark.parametrize("kw", MUXERS)
def test_mux_psi_equal_to_jax(kw):
    ref, nat = jts.TsMuxer(**kw), NativeTsMuxer(**kw)
    assert nat.psi() == ref.psi()
    assert nat.psi() == ref.psi()          # continuity counters advance


@pytest.mark.parametrize("kw", MUXERS[:3])
def test_mux_video_equal_to_jax(kw):
    """Access units of every packetization case (one packet, exactly
    184/183/170 bytes around the PCR and stuffing edges, many packets),
    with and without DTS, keyframes with PSI."""
    rng = np.random.default_rng(3)
    ref, nat, port = (jts.TsMuxer(**kw), NativeTsMuxer(**kw),
                      tts.TsMuxer(**kw))
    sizes = [5000, 183, 184, 170, 14, 200000, 1, 171, 368, 175, 176, 0]
    pts = 90_000
    for i, size in enumerate(sizes):
        au = rng.integers(0, 256, size, dtype=np.uint8).tobytes()
        key = i % 4 == 0
        dts = pts - 3000 if i % 3 == 0 else None
        want = ref.mux_video(au, pts, dts, keyframe=key)
        assert nat.mux_video(au, pts, dts, keyframe=key) == want, (i, size)
        assert port.mux_video(au, pts, dts, keyframe=key) == want, (i, size)
        pts += 3003


@pytest.mark.parametrize("kw", [MUXERS[2], MUXERS[3]])
def test_mux_audio_equal_to_jax(kw):
    rng = np.random.default_rng(4)
    ref, nat = jts.TsMuxer(**kw), NativeTsMuxer(**kw)
    pts = 45_000
    for size in [371, 12, 184, 1000, 170]:
        adts = rng.integers(0, 256, size, dtype=np.uint8).tobytes()
        assert nat.mux_audio(adts, pts) == ref.mux_audio(adts, pts)
        pts += 1920


@pytest.mark.parametrize("pkt_size", [1316, 1128, 188])
def test_packer_equal_to_jax(pkt_size):
    """feed (payload lists), the residue carried across feeds, and the
    flushed tail."""
    rng = np.random.default_rng(5)
    ref, nat = jts.TsPacker(pkt_size), NativeTsPacker(pkt_size)
    for _ in range(50):
        chunk = rng.integers(0, 256, int(rng.integers(1, 4000)),
                             dtype=np.uint8).tobytes()
        assert nat.feed(chunk) == ref.feed(chunk)
        assert nat.residue == ref.residue
    assert nat.residue > 0 or pkt_size == 188
    assert nat.flush() == ref.flush()
    assert nat.residue == 0 and nat.flush() == ref.flush() == b""


def test_packer_rejects_a_size_off_the_packet_grid():
    with pytest.raises(ValueError, match="multiple of 188"):
        NativeTsPacker(1000)


def test_loaders_build_alone_and_declare_the_abi():
    mux, srt = native.load_mpegts(), native.load_srt_client()
    assert mux.cc_packer_feed.argtypes is not None
    assert mux.cc_tsmux_video.argtypes is not None
    assert mux.cc_outbuf_size.restype is not None
    assert srt.cc_srt_get_stats.argtypes is not None
    for lib, name in ((mux, "mpegts"), (srt, "srt_client")):
        assert hb.library_path(name).exists()
        assert "libceracoder_native" not in lib._name


@pytest.mark.parametrize("name", ["mpegts", "srt_client"])
def test_build_keys_follow_flags_and_sources(name, tmp_path, monkeypatch):
    """mpegts.cc alone; srt_client.cc alone, linked with -ldl."""
    lib = hb.LIBRARIES[name]
    assert lib.sources == (f"{name}.cc",) and lib.includes == ()
    assert lib.link == (("-ldl",) if name == "srt_client" else ())
    for f in lib.files:
        shutil.copy(hb.NATIVE_SRC / f, tmp_path / f)
    monkeypatch.setattr(hb, "NATIVE_SRC", tmp_path)
    first = hb.library_path(name)
    assert first.name.startswith(f"lib{name}-")
    seen = {first}
    monkeypatch.setattr(hb, "CXX_FLAGS", [*hb.CXX_FLAGS, "-g"])
    seen.add(hb.library_path(name))
    src = tmp_path / f"{name}.cc"
    src.write_text(src.read_text() + "\n// changed\n")
    seen.add(hb.library_path(name))
    monkeypatch.setitem(hb.LIBRARIES, name, hb.NativeLib(
        lib.sources, lib.includes, (*lib.link, "-lm")))
    seen.add(hb.library_path(name))
    assert len(seen) == 4


@pytest.mark.parametrize("make", [NativeTsMuxer, NativeTsPacker,
                                  NativeSrtClient])
def test_failed_build_raises(make, monkeypatch):
    """A library that cannot be built stops the class; nothing falls
    back to the Python muxer, packer or client."""
    def broken(name):
        raise RuntimeError(f"g++ failed for {name}.cc")

    native.load_mpegts.cache_clear()
    native.load_srt_client.cache_clear()
    monkeypatch.setattr(native, "build_library", broken)
    try:
        with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
            make()
    finally:
        native.load_mpegts.cache_clear()
        native.load_srt_client.cache_clear()


class _FakeSrtLib:
    def __init__(self, available: int):
        self.available = available
        self.offsets = None
        self.cleanups = 0

    def cc_srt_available(self):
        return self.available

    def cc_srt_init(self):
        return 0

    def cc_srt_set_stat_offsets(self, *offsets):
        self.offsets = offsets

    def cc_srt_cleanup(self):
        self.cleanups += 1


def test_srt_client_without_libsrt_raises(monkeypatch):
    monkeypatch.setattr(native, "load_srt_client", lambda: _FakeSrtLib(0))
    with pytest.raises(RuntimeError, match="libsrt unavailable"):
        NativeSrtClient()


def test_srt_client_reads_the_port_stats_layout(monkeypatch):
    """The C++ client reads SRT_TRACEBSTATS at the offsets of the port's
    own ctypes declaration (transport/srt.py), which are JAX's."""
    lib = _FakeSrtLib(1)
    monkeypatch.setattr(native, "load_srt_client", lambda: lib)
    cli = NativeSrtClient()
    names = ("msTimeStamp", "pktSndLossTotal", "pktRetransTotal",
             "pktRecvACKTotal", "mbpsSendRate", "msRTT")
    assert lib.offsets == tuple(getattr(TraceBStats, n).offset
                                for n in names)
    assert lib.offsets == tuple(getattr(JTraceBStats, n).offset
                                for n in names)
    assert cli.negotiated_latency == -1
    # close gives back the runtime reference the constructor took, once
    cli.close()
    cli.close()
    assert lib.cleanups == 1


def test_native_srt_loopback():
    """C++ SRT client against the in-process Python listener (the
    reference's test_srt_integration.c strategy)."""
    from ceracoder_tpu_torch.transport.srt import (
        SRTO_RCVLATENCY, SrtError, SrtSocket, srt_available)
    if not srt_available():
        pytest.skip("libsrt not available")

    probe = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    probe.bind(("127.0.0.1", 0))
    port = probe.getsockname()[1]
    probe.close()
    sock = SrtSocket()
    sock.set_int(SRTO_RCVLATENCY, 120)
    sock.bind("127.0.0.1", port)
    sock.listen()
    received = []
    stop = threading.Event()

    def serve():
        try:
            peer = sock.accept()
            while not stop.is_set():
                data = peer.recv(2000)
                if not data:
                    return
                received.append(data)
        except SrtError:
            pass

    th = threading.Thread(target=serve, daemon=True)
    th.start()
    time.sleep(0.1)

    cli = NativeSrtClient()
    try:
        cli.connect("127.0.0.1", port, latency_ms=300, streamid="nat-test")
        assert cli.negotiated_latency >= 300
        payload = bytes([0x47]) + bytes(1315)
        for _ in range(10):
            assert cli.send(payload) == len(payload)
        deadline = time.time() + 3
        while len(received) < 10 and time.time() < deadline:
            time.sleep(0.02)
        assert len(received) == 10
        assert all(p == payload for p in received)
        stats = cli.get_stats()
        assert stats.msRTT >= 0.0
        assert stats.pktRecvACKTotal >= 0
        assert cli.get_snddata() >= 0
    finally:
        cli.close()
        stop.set()
        sock.close()
        th.join(timeout=2)
    assert not th.is_alive()


LOOPBACK_EXIT = r"""
import socket, threading, time
import torch
from ceracoder_tpu_torch.native import NativeSrtClient
from ceracoder_tpu_torch.transport.srt import SrtSocket
probe = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
probe.bind(("127.0.0.1", 0))
port = probe.getsockname()[1]
probe.close()
sock = SrtSocket()
sock.bind("127.0.0.1", port)
sock.listen()
peers = []
th = threading.Thread(target=lambda: peers.append(sock.accept()),
                      daemon=True)
th.start()
cli = NativeSrtClient()
cli.connect("127.0.0.1", port, latency_ms=300)
assert cli.send(bytes([0x47]) + bytes(1315)) == 1316
th.join(timeout=5)
cli.close()
for p in peers:
    p.close()
sock.close()
print("closed", flush=True)
"""


def test_native_srt_client_process_exits_cleanly():
    """A process that has loaded torch and used the native client exits
    0 after `close` (the JAX package's client, which never gives back
    its srt_startup reference, dies at exit with a double free)."""
    import subprocess
    import sys

    from ceracoder_tpu_torch.transport.srt import srt_available
    if not srt_available():
        pytest.skip("libsrt not available")
    root = hb.NATIVE_SRC.parents[1]
    proc = subprocess.run([sys.executable, "-c", LOOPBACK_EXIT], cwd=root,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.split() == ["closed"]
