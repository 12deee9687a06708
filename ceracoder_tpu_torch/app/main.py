"""App orchestration — the reference's main loop rebuilt around the
device encoder (reference: src/ceracoder.c:446-614).

Port of ceracoder_tpu/app/main.py on a torch device (default
``cuda``): `codec = hevc` (H265DeviceEncoder) and `codec = h264`
(H264Encoder: CABAC with intra-in-P, as the JAX app codes it).
Structure per frame period:
  encode (device) -> TS mux -> 1316 B packing -> transport send
with a >=20 ms housekeeping tick interleaved (SRT stats -> balancer ->
bitrate -> QP), plus the reference's failure detectors: ACK timeout
(6000 ms), SIGHUP config reload, SIGALRM forced teardown.

Where it departs from the JAX app: HEVC jobs with `[parallel]` bands or
gop_parallel raise NotImplementedError when the devices for them are
there (ROADMAP.md item 14); the JAX app's H.264 branch ignores those
knobs, and so does the port's.
"""

from __future__ import annotations

import signal
import socket as pysocket
import sys
import time
from dataclasses import dataclass, field
from typing import Optional

import torch

from ceracoder_tpu_torch.app.cli import CliOptions
from ceracoder_tpu_torch.app.jobspec import open_source, parse_jobspec
from ceracoder_tpu_torch.app.overlay import TickLog, overlay_text
from ceracoder_tpu_torch.app.source import DeviceTestPatternSource, pad_to_mb
from ceracoder_tpu_torch.codec.h264.encoder import H264Encoder
from ceracoder_tpu_torch.codec.h265.device import H265DeviceEncoder
from ceracoder_tpu_torch.control import (
    BalancerInput,
    BalancerRunner,
    CeracoderConfig,
)
from ceracoder_tpu_torch.control.config import config_load
from ceracoder_tpu_torch.control.qp_rate import QpRateController
from ceracoder_tpu_torch.control.types import MIN_BITRATE, ABS_MAX_BITRATE
from ceracoder_tpu_torch.transport.mpegts import TsMuxer, TsPacker
from ceracoder_tpu_torch.transport.srt import SrtClient, SrtError, srt_available
from ceracoder_tpu_torch.utils.device import resolve_device
from ceracoder_tpu_torch.utils.host_build import (
    load_h264_cabac,
    load_hevc_entropy,
)

SRT_ACK_TIMEOUT_MS = 6000      # reference: src/ceracoder.c:47
HOUSEKEEPING_MS = 20           # reference: BITRATE_UPDATE_INT
CONNECT_RETRY_S = 0.5          # reference: src/ceracoder.c:583
STALL_CHECK_S = 1.0            # reference: src/ceracoder.c:600


def getms() -> int:
    return int(time.monotonic() * 1000)


class StallDetector:
    """Pipeline stall watchdog (reference: stall_check,
    src/ceracoder.c:147-199): the position — here frames sent — being
    unchanged across two consecutive 1 s checks means the pipeline is
    wedged and the process must exit so a supervisor can restart it.
    Arms only once the position first advances (startup compiles and
    connects can legitimately take longer than the check interval)."""

    def __init__(self, get_pos, on_stall):
        self._get_pos = get_pos
        self._on_stall = on_stall
        self._last: Optional[int] = None
        self._armed = False

    def check(self) -> bool:
        pos = self._get_pos()
        if not self._armed:
            self._armed = pos > 0
            self._last = pos
            return False
        stalled = pos == self._last
        self._last = pos
        if stalled:
            self._on_stall()
        return stalled


class Transport:
    """ADDR dispatch: SRT host, `udp`, or a .ts file path."""

    def __init__(self, opts: CliOptions, latency: int,
                 expected_bps: int = 0):
        self.kind = "file" if (opts.addr.endswith(".ts") or opts.addr == "-") \
            else ("udp" if opts.addr == "udp" else "srt")
        self.opts = opts
        self.latency = latency
        self.expected_bps = expected_bps
        self.srt: Optional[SrtClient] = None
        self.udp = None
        self.file = None

    def connect(self, stop_flag) -> bool:
        if self.kind == "file":
            self.file = (sys.stdout.buffer if self.opts.addr == "-"
                         else open(self.opts.addr, "wb"))
            return True
        if self.kind == "udp":
            self.udp = pysocket.socket(pysocket.AF_INET, pysocket.SOCK_DGRAM)
            self.udp.connect(("127.0.0.1", self.opts.port))
            return True
        if not srt_available():
            print("libsrt not available", file=sys.stderr)
            return False
        pkt = 1128 if self.opts.reduced_pkt_size else 1316
        # retry-forever with backoff (reference: src/ceracoder.c:554-588)
        while not stop_flag():
            client = SrtClient(latency_ms=self.latency,
                               stream_id=self.opts.stream_id,
                               payload_size=pkt,
                               expected_bps=self.expected_bps)
            try:
                client.connect(self.opts.addr, self.opts.port)
                print(f"SRT connected, negotiated latency "
                      f"{client.negotiated_latency} ms", file=sys.stderr)
                self.srt = client
                return True
            except SrtError as e:
                print(f"SRT connect failed: {e}; retrying", file=sys.stderr)
                client.close()
                time.sleep(CONNECT_RETRY_S)
        return False

    def send(self, payload: bytes) -> bool:
        """False signals a fatal transport error (reference: short
        srt_send => stop, src/ceracoder.c:320-327)."""
        if self.kind == "file":
            self.file.write(payload)
            return True
        if self.kind == "udp":
            return self.udp.send(payload) == len(payload)
        try:
            return self.srt.send(payload) == len(payload)
        except SrtError:
            return False

    def stats(self):
        if self.kind == "srt" and self.srt is not None:
            return self.srt.get_stats(), self.srt.get_snd_buffer()
        return None, 0

    def close(self):
        if self.file is not None and self.file is not sys.stdout.buffer:
            self.file.close()
        if self.udp is not None:
            self.udp.close()
        if self.srt is not None:
            self.srt.close()


@dataclass
class AppState:
    quit: bool = False
    sighup: bool = False
    ticks: list = field(default_factory=list)


class CeracoderApp:
    """End-to-end live encoder app (reference: main, src/ceracoder.c).

    Encodes on `device` (default ``cuda``; raises without a card unless
    ``device="cpu"``)."""

    def __init__(self, opts: CliOptions, keep_ticks: bool = False,
                 max_frames: Optional[int] = None, realtime: bool = True,
                 device=None):
        self.opts = opts
        self.keep_ticks = keep_ticks
        self.max_frames = max_frames
        self.realtime = realtime
        self.state = AppState()
        self.device = resolve_device(device)

        self.spec = parse_jobspec(opts.job_file)
        self.source = open_source(self.spec, device=self.device)

        self.cfg = CeracoderConfig()
        if opts.config_file:
            config_load(opts.config_file, self.cfg)
        # latency: CLI > config > default (reference: src/ceracoder.c:503)
        self.latency = opts.latency if opts.latency else self.cfg.srt_latency

        pkt = 1128 if opts.reduced_pkt_size else 1316
        self.runner = BalancerRunner(self.cfg, opts.balancer,
                                     srt_latency=self.latency,
                                     srt_pkt_size=pkt)
        fps = self.source.fps_num / max(1, self.source.fps_den)
        self.rate = QpRateController(fps=fps,
                                     gop=self.spec.gop_frames)
        self.cur_bitrate = self.runner.config.max_bitrate

        if self.spec.codec == "hevc":
            # device compute + native entropy (the production HEVC
            # path). [parallel] bands/gop_parallel are the sharded and
            # GOP-parallel schedulers, not ported yet; with one device
            # they are ignored, as in the reference app.
            n_dev = (torch.cuda.device_count()
                     if self.device.type == "cuda" else 1)
            if ((self.spec.bands > 1 and n_dev >= self.spec.bands)
                    or (self.spec.gop_parallel > 1 and n_dev > 1)):
                raise NotImplementedError(
                    f"[parallel] bands = {self.spec.bands}, gop_parallel "
                    f"= {self.spec.gop_parallel} on {n_dev} devices: the "
                    "parallel encoders are not ported yet (ROADMAP.md "
                    "item 14)")
            if self.spec.bands > 1 or self.spec.gop_parallel > 1:
                print("parallel knobs ignored: "
                      f"{n_dev} device(s) available", file=sys.stderr)
            self.encoder = H265DeviceEncoder(
                self.source.width, self.source.height,
                qp=self.rate.current_qp, gop=self.spec.gop_frames,
                device=self.device)
            load_entropy = load_hevc_entropy
            self.video_stream_type = 0x24   # STREAM_TYPE_HEVC
        else:
            # CABAC with intra-in-P (the encoder's defaults), coded at
            # whole MBs; the SPS crops back to the source size
            w = (self.source.width + 15) // 16 * 16
            h = (self.source.height + 15) // 16 * 16
            self.encoder = H264Encoder(w, h, qp=self.rate.current_qp,
                                       fps_num=self.source.fps_num,
                                       fps_den=self.source.fps_den,
                                       gop=self.spec.gop_frames,
                                       device=self.device)
            self.encoder.sps.width = self.source.width
            self.encoder.sps.height = self.source.height
            load_entropy = load_h264_cabac
            self.video_stream_type = 0x1B   # STREAM_TYPE_H264
        # build the entropy library now, before the stall watchdog can
        # arm: a first build takes seconds of g++ with no frame sent
        load_entropy()
        # audio branch (reference: alsasrc -> a_delay -> AAC -> mux;
        # pipeline audio chains, common.ts:55-90)
        self.audio = None
        self.audio_src = None
        if self.spec.audio_kind not in ("", "none"):
            from ceracoder_tpu_torch.audio import (
                AudioPipeline, ToneSource, WavSource, aac_available)
            if aac_available():
                if self.spec.audio_kind == "wav":
                    self.audio_src = WavSource(self.spec.audio_path)
                else:
                    self.audio_src = ToneSource()
                # -d > 0 delays audio (a_delay), -d < 0 delays video
                # (v_delay) — reference: cb_delay wiring,
                # src/ceracoder.c:341-344,525-533
                a_extra = max(0, opts.av_delay)
                self.audio = AudioPipeline(
                    sample_rate=self.audio_src.sample_rate,
                    channels=self.audio_src.channels,
                    bitrate=self.spec.audio_bitrate * 1000,
                    delay_ms=self.spec.audio_delay_ms + a_extra,
                    codec=self.spec.audio_codec)
            else:
                print("audio requested but AAC encoder unavailable; "
                      "continuing video-only", file=sys.stderr)
        self.mux = TsMuxer(video_stream_type=self.video_stream_type,
                           with_audio=self.audio is not None,
                           audio_kind=self.spec.audio_codec,
                           audio_channels=(self.audio_src.channels
                                           if self.audio is not None
                                           else 2))
        self.packer = TsPacker(pkt_size=pkt)
        # seed libsrt's MAXBW=0 pacer with the configured ceiling
        # (+TS/audio overhead margin) — see SrtClient.connect
        self.transport = Transport(
            opts, self.latency,
            expected_bps=int(self.runner.config.max_bitrate * 1.3)
            + 512_000)
        self.frames_sent = 0
        self.frames_collected = 0
        self.overlay_line = ""
        # structured telemetry sink (SURVEY.md §5: structured version
        # of the overlay's per-tick controller state)
        self._stats_fh = (open(opts.stats_file, "w")
                          if getattr(opts, "stats_file", None) else None)

    # -- signal handling (reference: src/ceracoder.c:126-145,441-443)
    def _install_signals(self):
        signal.signal(signal.SIGHUP, lambda *_: self._flag_sighup())
        signal.signal(signal.SIGTERM, lambda *_: self.stop())
        signal.signal(signal.SIGINT, lambda *_: self.stop())

    def _flag_sighup(self):
        self.state.sighup = True

    def _burn(self, y):
        """Burn the telemetry line into the picture (the reference's
        textoverlay element, src/gst/overlay_ui.c:34-48); [encode]
        overlay = off disables it."""
        if not self.overlay_line or not self.spec.overlay:
            return y
        import numpy as np

        from ceracoder_tpu_torch.app.textoverlay import burn_overlay
        return burn_overlay(np.asarray(y), self.overlay_line)

    def _scene_cut(self, y) -> bool:
        """Relative cost-spike cut detection on 4x4-pooled luma (the
        lookahead's detector in immediate mode)."""
        from ceracoder_tpu_torch.control.lookahead import CutDetector
        det = getattr(self, "_cut_det", None)
        if det is None:
            det = self._cut_det = CutDetector()
        return det.feed(y)[1]

    def stop(self):
        if not self.state.quit:
            self.state.quit = True
            # force exit if teardown hangs (reference :129,441-443);
            # signals can only be installed from the main thread — the
            # stall watchdog thread has its own os._exit fallback
            import threading
            if threading.current_thread() is threading.main_thread():
                signal.signal(signal.SIGALRM, lambda *_: sys.exit(0))
                signal.alarm(3)

    def _reload_config(self):
        """SIGHUP: re-read config, re-apply bounds (reference :161-186)."""
        self.state.sighup = False
        if self.opts.config_file:
            cfg = CeracoderConfig()
            try:
                config_load(self.opts.config_file, cfg)
            except OSError:
                return
            self.runner.update_bounds(cfg.min_bitrate * 1000,
                                      cfg.max_bitrate * 1000)
            print(f"Config reloaded: {cfg.min_bitrate} - "
                  f"{cfg.max_bitrate} Kbps", file=sys.stderr)
        elif self.opts.bitrate_file:
            self._read_bitrate_file()

    def _read_bitrate_file(self):
        """Legacy 2-line bitrate file (reference: src/ceracoder.c:210-235)."""
        try:
            lines = open(self.opts.bitrate_file).read().splitlines()
            br = [int(float(lines[i])) for i in range(2)]
        except (OSError, ValueError, IndexError):
            return
        if all(MIN_BITRATE <= b <= ABS_MAX_BITRATE for b in br):
            self.runner.update_bounds(br[0], br[1])

    def _housekeeping(self, now_ms: int):
        """The 20 ms control tick (reference: connection_housekeeping,
        src/ceracoder.c:266-295)."""
        stats, bs = self.transport.stats()
        if stats is None:
            return
        # ACK watchdog
        if stats.pkt_recv_ack_total != self._prev_ack_count:
            self._prev_ack_count = stats.pkt_recv_ack_total
            self._prev_ack_ts = now_ms
        if (self._prev_ack_count != 0
                and now_ms - self._prev_ack_ts > SRT_ACK_TIMEOUT_MS):
            print("The SRT connection timed out, exiting", file=sys.stderr)
            self.stop()
            return

        inp = BalancerInput(
            buffer_size=bs,
            rtt=stats.ms_rtt,
            send_rate_mbps=stats.mbps_send_rate,
            timestamp=now_ms,
            pkt_loss_total=stats.pkt_snd_loss_total,
            pkt_retrans_total=stats.pkt_retrans_total,
        )
        out = self.runner.step(inp)
        self.cur_bitrate = out.new_bitrate
        self.overlay_line = overlay_text(out)
        if self.keep_ticks or self._stats_fh:
            tick = TickLog(
                t_ms=now_ms, bitrate=out.new_bitrate,
                qp=self.rate.current_qp, throughput=out.throughput,
                rtt=out.rtt, rtt_th_min=out.rtt_th_min,
                rtt_th_max=out.rtt_th_max, bs=out.bs, bs_th1=out.bs_th1,
                bs_th2=out.bs_th2, bs_th3=out.bs_th3).as_dict()
            if self.keep_ticks:
                self.state.ticks.append(tick)
            if self._stats_fh:
                import json
                self._stats_fh.write(json.dumps(tick) + "\n")

    def _position(self) -> int:
        """The stall watchdog's position: source progress + encode
        progress + egress progress, so a wedged source, encode or send
        path freezes it. Frames count as encoded when their device work
        starts: a 1080p run with an IDR launches for over a second on
        the H100 before any of its frames counts as collected or sent."""
        return (self.frames_collected + self.encoder.frames_launched
                + self.frames_sent)

    def _start_stall_watchdog(self):
        """1 s stall-check thread (reference: g_timeout_add(1000,
        stall_check)); a wedged encode dispatch or hung source blocks
        the frame loop, so the check runs off-thread, and if the
        process does not wind down within 3 s of a detected stall it
        is force-exited (the SIGALRM analog for a blocked main
        thread)."""
        import os
        import threading

        def on_stall():
            print("Pipeline stall detected, exiting", file=sys.stderr)
            self.stop()

        det = StallDetector(self._position, on_stall)

        def loop():
            while not self.state.quit:
                time.sleep(STALL_CHECK_S)
                if self.state.quit:
                    return
                if det.check():
                    time.sleep(3.0)
                    os._exit(1)

        t = threading.Thread(target=loop, daemon=True,
                             name="stall-watchdog")
        t.start()
        return t

    def run(self) -> int:
        self._install_signals()
        self._prev_ack_count = 0
        self._prev_ack_ts = getms()
        if not self.transport.connect(lambda: self.state.quit):
            return 1
        if self.realtime:
            # live pipelines only: offline/file runs legitimately
            # encode slower than the 1 s check on a loaded host
            self._start_stall_watchdog()

        fps = self.rate.fps
        frame_period = 1.0 / fps
        next_frame = time.monotonic()
        next_hk = getms()
        next_log = 0.0
        pts = 0

        # PTS fixup engages when the source carries real capture
        # timestamps (reference: cb_ptsfixup, src/ceracoder.c:371-423);
        # synchronous sources keep the synthetic fixed-period PTS
        fixer = None
        if hasattr(self.source, "frames_with_pts"):
            from ceracoder_tpu_torch.app.ptsfix import PtsFixup
            fixer = PtsFixup(self.source.fps_num, self.source.fps_den)
            frame_iter = self.source.frames_with_pts()
        elif isinstance(self.source, DeviceTestPatternSource):
            # the per-frame loop works on host planes, as the reference
            # app's does on a device source
            frame_iter = ((tuple(p.cpu().numpy() for p in f), None)
                          for f in self.source.frames())
        else:
            frame_iter = ((f, None) for f in self.source.frames())

        pacer = {"next_frame": next_frame, "next_hk": next_hk,
                 "next_log": next_log, "period": frame_period}
        run_len = max(1, self.spec.run)
        try:
            if run_len > 1 and isinstance(self.source,
                                          DeviceTestPatternSource):
                self._loop_pipelined_dev(pacer, run_len)
            elif run_len > 1:
                self._loop_pipelined(frame_iter, fixer, pacer, run_len)
            else:
                self._loop_per_frame(frame_iter, fixer, pacer, pts)
        finally:
            if self.transport.kind == "file":
                tail = self.packer.flush()
                if tail:
                    self.transport.send(tail)
            self.transport.close()
        return 0

    def _emit_frame(self, frame, fpts: int, pacer: dict):
        """Mux + send one encoded frame, then pace to its deadline
        with 20 ms housekeeping interleaved (reference: new_buf_cb +
        connection_housekeeping)."""
        au = frame.data
        if frame.keyframe:
            au = self.encoder.headers() + au
        self.rate.update(self.cur_bitrate, len(frame.data) * 8,
                         keyframe=frame.keyframe)

        v_delay90 = max(0, -self.opts.av_delay) * 90
        ts = self.mux.mux_video(au, pts90=fpts + v_delay90,
                                keyframe=frame.keyframe)
        if self.audio is not None:
            # one video period's worth of samples keeps A/V in
            # lockstep; the AAC frame boundary crossing is handled by
            # the encoder's internal FIFO
            n = round(self.audio_src.sample_rate
                      * self.source.fps_den / self.source.fps_num)
            for af in self.audio.feed(self.audio_src.read(n)):
                ts += self.mux.mux_audio(af.adts, af.pts90)
        for payload in self.packer.feed(ts):
            if not self.transport.send(payload):
                print("Transport send failed, exiting",
                      file=sys.stderr)
                self.stop()
                break
        self.frames_sent += 1

        # pace + housekeeping until the next frame deadline
        pacer["next_frame"] += pacer["period"]
        while True:
            now = getms()
            if now >= pacer["next_hk"]:
                self._housekeeping(now)
                pacer["next_hk"] = now + HOUSEKEEPING_MS
            if (time.monotonic() >= pacer["next_frame"]
                    or not self.realtime):
                break
            if self.state.quit:
                break
            time.sleep(min(0.005, max(0.0, pacer["next_frame"]
                                      - time.monotonic())))
        if time.monotonic() > pacer["next_frame"] + 5 * pacer["period"]:
            pacer["next_frame"] = time.monotonic()  # behind: resync
        if self.overlay_line and time.monotonic() >= pacer["next_log"]:
            print(self.overlay_line, file=sys.stderr)
            pacer["next_log"] = time.monotonic() + 1.0

    def _loop_per_frame(self, frame_iter, fixer, pacer, pts):
        for (y, u, v), in_pts in frame_iter:
            if self.state.quit:
                break
            if fixer is not None:
                fx = fixer.feed(in_pts)
                if fx.droppable:
                    continue
                pts = fx.pts90
            if self.max_frames and self.frames_sent >= self.max_frames:
                break
            if self.state.sighup:
                self._reload_config()

            self.frames_collected += 1
            y = self._burn(y)
            y, u, v = pad_to_mb(y, u, v)
            qp = self.rate.current_qp
            # scene-cut detection: a cut coded as P is mostly
            # intra-fallback CUs anyway; forcing a fresh IDR costs
            # little and restarts the prediction chain (the adaptive
            # analog of x264's scenecut; the reference's fixed-GOP
            # encoders lack this)
            cut = self._scene_cut(y)
            frame = self.encoder.encode_frame(y, u, v, qp=qp,
                                              force_idr=cut)
            self._emit_frame(frame, pts, pacer)
            if fixer is None:
                pts += int(90000 * self.source.fps_den
                           / self.source.fps_num)

    def _loop_pipelined(self, frame_iter, fixer, pacer, run_len: int):
        """Run-dispatch hot path (the product path must be the fast
        path): frames collect into runs of `run_len`, each run is
        launched as one encode_run_async (the reference stays on the
        device), and run N's results mux/send — paced, housekeeping
        interleaved — while run N+1 computes. Matches the
        reference's model where the hot data path is the product path
        (src/ceracoder.c:297-339)."""
        pending = []            # (PendingFrame, pts90)
        batch = []              # (y, u, v) padded planes
        batch_pts = []
        force_idr = False
        pts = 0
        n_collected = 0

        def drain(plist):
            for pf, fpts in plist:
                if self.state.quit:
                    return
                self._emit_frame(pf.result(), fpts, pacer)

        def dispatch():
            nonlocal batch, batch_pts, force_idr, pending
            if not batch:
                return
            pfs = self.encoder.encode_run_async(
                frames=batch, qp=self.rate.current_qp,
                force_idr=force_idr)
            force_idr = False
            newp = list(zip(pfs, batch_pts))
            batch, batch_pts = [], []
            drain(pending)       # overlap: host work vs device run
            pending = newp

        for (y, u, v), in_pts in frame_iter:
            if self.state.quit:
                break
            if fixer is not None:
                fx = fixer.feed(in_pts)
                if fx.droppable:
                    continue
                pts = fx.pts90
            if self.max_frames and n_collected >= self.max_frames:
                break
            if self.state.sighup:
                self._reload_config()

            self.frames_collected += 1
            y = self._burn(y)
            y, u, v = pad_to_mb(y, u, v)
            cut = self._scene_cut(y)
            if cut:
                dispatch()       # close the run; next starts the IDR
                force_idr = True
            batch.append((y, u, v))
            batch_pts.append(pts)
            n_collected += 1
            if fixer is None:
                pts += int(90000 * self.source.fps_den
                           / self.source.fps_num)
            if len(batch) >= run_len:
                dispatch()
        dispatch()
        drain(pending)


    def _loop_pipelined_dev(self, pacer, run_len: int):
        """Run dispatch over a DEVICE-SIDE source: frames are generated
        on the card inside the encode run (no host pixels at all), run
        N's results mux/send while run N+1 computes.
        Overlay burn-in and scene-cut detection need host pixels and
        are skipped — this is the test-pattern/bench path (reference
        analog: pipeline/jetson/h265_test_pattern)."""
        from collections import deque

        period90 = int(90000 * self.source.fps_den
                       / self.source.fps_num)
        # falsy max_frames means unlimited, like the other run loops
        total = self.max_frames or None
        if total is None:
            total = getattr(self.source, "num_frames", None)
        i0 = 0
        pts = 0
        # several runs in flight, as in the reference app: depth 3
        # keeps the device busy while two runs' transfers/entropy
        # drain (~0.5 s of latency at 60 fps — inside a live encoder's
        # buffering budget, and the pacer still emits on the frame
        # grid)
        depth = 3
        pending: deque = deque()   # each: list of (PendingFrame, pts)

        def drain_one():
            for pf, fpts in pending.popleft():
                if self.state.quit:
                    return
                self._emit_frame(pf.result(), fpts, pacer)

        while not self.state.quit:
            if self.state.sighup:
                self._reload_config()
            n = run_len if total is None else min(run_len, total - i0)
            if n <= 0:
                break
            pfs = self.encoder.encode_run_async(
                source=self.source, indices=range(i0, i0 + n),
                qp=self.rate.current_qp)
            pending.append([(pf, pts + k * period90)
                            for k, pf in enumerate(pfs)])
            pts += n * period90
            self.frames_collected += n
            i0 += n
            if len(pending) >= depth:
                drain_one()      # overlap: host work vs device runs
        while pending and not self.state.quit:
            drain_one()


def main(argv=None) -> int:
    from ceracoder_tpu_torch.app.cli import parse_args
    opts = parse_args(sys.argv[1:] if argv is None else argv)
    app = CeracoderApp(opts)
    return app.run()


if __name__ == "__main__":
    sys.exit(main())
