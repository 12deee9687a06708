"""Audio pipeline: sources + AAC-LC / Opus encoding + PTS accounting.

The reference's audio branch is `alsasrc -> a_delay -> volume ->
{AAC|Opus} -> mpegtsmux` at 128 kbps (reference: pipeline files' audio
chains, bindings/typescript/src/pipeline/common.ts:55-90 — the pipeline code
offers both codecs at :71-87). avenc_aac is libavcodec's AAC encoder;
the native shim (native/src/audio_enc.cc) binds the same codecs and
adds the TS self-framing (ADTS for AAC — stream_type 0x0F; the
Opus-in-TS control header for Opus — stream_type 0x06 + 'Opus'
registration descriptor), so TsMuxer.mux_audio carries either
unchanged.

Copy of ceracoder_tpu/audio/__init__.py; the shim is built alone from
native/src by utils/host_build.py, where the libavcodec headers are.
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from ceracoder_tpu_torch.native import _OutBuf, declare_outbuf
from ceracoder_tpu_torch.utils.host_build import build_library, have_avcodec

AUDIO_DEFAULT_BITRATE = 128_000   # reference: common.ts audio 128 kbps


@functools.lru_cache(maxsize=None)
def load_audio() -> ctypes.CDLL:
    """Build (if needed) and load native/src/audio_enc.cc, once per
    process, with its C ABI and the output buffer's declared. Raises if
    the build fails."""
    lib = ctypes.CDLL(str(build_library("audio_enc")))
    lib.cc_audioenc_create.restype = ctypes.c_void_p
    lib.cc_audioenc_create.argtypes = [ctypes.c_int, ctypes.c_int,
                                       ctypes.c_int, ctypes.c_int64]
    lib.cc_aacenc_frame_size.restype = ctypes.c_int
    lib.cc_aacenc_frame_size.argtypes = [ctypes.c_void_p]
    lib.cc_aacenc_encode.restype = ctypes.c_int
    lib.cc_aacenc_encode.argtypes = [ctypes.c_void_p,
                                     ctypes.POINTER(ctypes.c_float),
                                     ctypes.c_int64, ctypes.c_void_p]
    lib.cc_aacenc_flush.restype = ctypes.c_int
    lib.cc_aacenc_flush.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.cc_aacenc_destroy.argtypes = [ctypes.c_void_p]
    declare_outbuf(lib)
    return lib


def aac_available() -> bool:
    """Whether the audio encoder can be built here: the libavcodec
    headers are present (native/Makefile's HAVE_AVCODEC test)."""
    return have_avcodec()


class AacEncoder:
    """Audio encoder producing TS-self-framed access units from float
    PCM: ADTS frames (codec="aac") or control-header-prefixed Opus
    packets (codec="opus")."""

    def __init__(self, sample_rate: int = 48000, channels: int = 2,
                 bitrate: int = AUDIO_DEFAULT_BITRATE,
                 codec: str = "aac"):
        lib = load_audio()
        self._lib = lib
        self.codec = codec
        kind = {"aac": 0, "opus": 1}[codec]
        self._h = lib.cc_audioenc_create(kind, sample_rate, channels,
                                         bitrate)
        if not self._h:
            raise RuntimeError(f"libavcodec {codec} encoder unavailable")
        self.sample_rate = sample_rate
        self.channels = channels
        self.frame_size = lib.cc_aacenc_frame_size(self._h)
        self._out = _OutBuf(lib)

    def encode(self, pcm: np.ndarray) -> list[bytes]:
        """pcm: (N, channels) or (N,) float32 in [-1, 1]. Returns the
        ADTS frames completed by this feed."""
        pcm = np.ascontiguousarray(pcm, np.float32)
        if pcm.ndim == 1:
            pcm = pcm[:, None]
        if pcm.shape[1] != self.channels:
            raise ValueError("channel count mismatch")
        n = self._lib.cc_aacenc_encode(
            self._h,
            pcm.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            pcm.shape[0], self._out._h)
        if n < 0:
            raise RuntimeError(f"{self.codec} encode failed ({n})")
        return self._split(self._out.take())

    def _split(self, blob: bytes) -> list[bytes]:
        return (_split_opus_au(blob) if self.codec == "opus"
                else _split_adts(blob))

    def flush(self) -> list[bytes]:
        n = self._lib.cc_aacenc_flush(self._h, self._out._h)
        if n < 0:
            raise RuntimeError(f"{self.codec} flush failed ({n})")
        return self._split(self._out.take())

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.cc_aacenc_destroy(self._h)
            self._h = None


def _split_opus_au(blob: bytes) -> list[bytes]:
    """Split concatenated Opus-in-TS access units on their control
    headers (0x7F 0xE0.., base-255 size varint)."""
    frames = []
    pos = 0
    while pos + 2 <= len(blob):
        if blob[pos] != 0x7F or (blob[pos + 1] & 0xFC) != 0xE0:
            raise ValueError("bad Opus control header")
        start = pos
        pos += 2
        size = 0
        while pos < len(blob) and blob[pos] == 0xFF:
            size += 255
            pos += 1
        if pos >= len(blob):
            raise ValueError("truncated Opus control header")
        size += blob[pos]
        pos += 1
        pos += size
        frames.append(blob[start:pos])
    if pos != len(blob):
        raise ValueError("trailing Opus bytes")
    return frames


def _split_adts(blob: bytes) -> list[bytes]:
    """Split a concatenation of ADTS frames on their length fields."""
    frames = []
    pos = 0
    while pos + 7 <= len(blob):
        if blob[pos] != 0xFF or (blob[pos + 1] & 0xF0) != 0xF0:
            raise ValueError("bad ADTS sync")
        flen = ((blob[pos + 3] & 3) << 11) | (blob[pos + 4] << 3) \
            | (blob[pos + 5] >> 5)
        frames.append(blob[pos:pos + flen])
        pos += flen
    if pos != len(blob):
        raise ValueError("trailing ADTS bytes")
    return frames


@dataclass
class AudioFrame:
    adts: bytes
    pts90: int          # 90 kHz clock


class AudioPipeline:
    """PCM feed -> ADTS frames with 90 kHz PTS (for TsMuxer.mux_audio)."""

    def __init__(self, sample_rate: int = 48000, channels: int = 2,
                 bitrate: int = AUDIO_DEFAULT_BITRATE,
                 delay_ms: int = 0, codec: str = "aac"):
        self.enc = AacEncoder(sample_rate, channels, bitrate,
                              codec=codec)
        # a_delay adds |av_delay| ms to audio PTS when audio lags
        # (reference: cb_delay, src/ceracoder.c:341-344,525-533)
        self._pts_off = delay_ms * 90
        self._frames_out = 0

    def _pts(self) -> int:
        n = self._frames_out
        self._frames_out += 1
        return self._pts_off + n * self.enc.frame_size * 90_000 \
            // self.enc.sample_rate

    def feed(self, pcm: np.ndarray) -> list[AudioFrame]:
        return [AudioFrame(adts=f, pts90=self._pts())
                for f in self.enc.encode(pcm)]

    def flush(self) -> list[AudioFrame]:
        return [AudioFrame(adts=f, pts90=self._pts())
                for f in self.enc.flush()]


class ToneSource:
    """Stereo test-tone generator (the audio analog of the test-pattern
    video source; reference pipelines use audiotestsrc in test modes)."""

    def __init__(self, sample_rate: int = 48000, freq: float = 440.0,
                 amplitude: float = 0.3, channels: int = 2):
        self.sample_rate = sample_rate
        self.freq = freq
        self.amplitude = amplitude
        self.channels = channels
        self._phase = 0

    def read(self, n_samples: int) -> np.ndarray:
        t = (self._phase + np.arange(n_samples)) / self.sample_rate
        self._phase += n_samples
        mono = (self.amplitude
                * np.sin(2 * math.pi * self.freq * t)).astype(np.float32)
        return np.repeat(mono[:, None], self.channels, axis=1)


class WavSource:
    """16-bit PCM WAV reader (the file-based audio ingest)."""

    def __init__(self, path: str | Path):
        import wave
        self._w = wave.open(str(path), "rb")
        self.sample_rate = self._w.getframerate()
        self.channels = self._w.getnchannels()
        if self._w.getsampwidth() != 2:
            raise ValueError("only 16-bit PCM WAV supported")

    def read(self, n_samples: int) -> np.ndarray:
        raw = self._w.readframes(n_samples)
        a = np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
        return a.reshape(-1, self.channels)

    def close(self):
        self._w.close()
