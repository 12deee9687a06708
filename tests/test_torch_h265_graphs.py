"""The HEVC encoder's CUDA graphs of P frames
(ceracoder_tpu_torch/codec/h265/device.py: H265DeviceEncoder._graph_row).

On a card (marked `cuda`, skipped without one) a P frame of a run with
the default frame hook replays a graph of encode_frame_row captured once
per QP; the stream and reconstruction must equal the same encoder's on
the CPU, which runs every frame eagerly: per-frame QPs that revisit a
QP after another QP's graph ran, an IDR inside a run, runs launched
before earlier ones are collected (the closed loop's order), and a
capacity that sends P frames to the dense levels copied out of the
graph. On the CPU the graph counters stay 0 and the bytes equal the JAX
encoder's (imported inside that test, so the card's run needs no JAX).
"""

import numpy as np
import pytest
import torch

from ceracoder_tpu_torch.codec.h265.device import H265DeviceEncoder
from ceracoder_tpu_torch.ops.h265 import LEVEL_CHUNK

# one intra-op thread: pytest-xdist workers share the cores, and at
# these frame sizes torch's extra threads only spin
torch.set_num_threads(1)

W, H = 320, 192


def _clip(n, w=W, h=H, seed=5, noise=4):
    """A texture panning by (1, 2) pel a frame with a patch moving the
    other way, plus noise of +-noise: P frames with motion, residual
    and some intra CTBs."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:3 * h, 0:3 * w]
    base = (128 + 60 * np.sin(xx / 9.0) * np.cos(yy / 13.0)
            + rng.integers(-20, 21, (3 * h, 3 * w)))
    frames = []
    for i in range(n):
        y = base[h + i:2 * h + i, w + 2 * i:2 * w + 2 * i].copy()
        y[40:72, 200 - 3 * i:232 - 3 * i] = 40 + 10 * i
        y = y + rng.integers(-noise, noise + 1, y.shape)
        y = np.clip(y, 0, 255).astype(np.uint8)
        u = (y[::2, ::2] // 2 + 60).astype(np.uint8)
        v = (y[1::2, 1::2] // 3 + 80).astype(np.uint8)
        frames.append((y, u, v))
    return frames


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")


def _expected_graphs(idr_flags, qps):
    """(graph_captures, graph_frames) that the P frames of one encoder's
    runs at one capacity should give: its first P frame runs eagerly,
    every later one replays the graph of its QP, captured on first
    use."""
    p = [q for i, q in zip(idr_flags, qps) if not i][1:]
    return len(set(p)), len(p)


def _same(gpu, cpu):
    """The card's frames equal the CPU's: bytes, kind, QP, recon."""
    assert len(gpu) == len(cpu)
    for f, (a, b) in enumerate(zip(gpu, cpu)):
        assert (a.keyframe, a.qp) == (b.keyframe, b.qp), f"frame {f}"
        assert a.data == b.data, f"frame {f}: bytes differ"
        for name, pa, pb in zip("yuv", a._recon_dev, b._recon_dev):
            assert torch.equal(pa.cpu(), pb), f"frame {f} {name}"


QPS = [30, 30, 33, 30, 28, 33, 30, 28, 30, 33, 35, 30, 28, 30, 33, 22,
       30, 33]
# gop 8: IDRs at frames 0 and 8 (the second inside run 1)
IDRS = [f % 8 == 0 for f in range(len(QPS))]


@pytest.mark.cuda
@pytest.mark.parametrize("sao,tu_split", [(False, False), (True, False),
                                          (False, True)])
def test_graph_runs_equal_cpu(sao, tu_split):
    """Three runs of 6 at per-frame QPs, launched in the closed loop's
    order (run 0, run 1, collect 0, run 2, collect 1, collect 2): the
    card's stream and reconstructions equal the CPU encoder's, and the
    counters show one capture per new QP after the first P frame."""
    _card()
    frames = _clip(len(QPS))
    kw = dict(qp=30, gop=8, sao=sao, tu_split=tu_split)
    gpu = H265DeviceEncoder(W, H, device="cuda", **kw)
    cpu = H265DeviceEncoder(W, H, device="cpu", **kw)
    runs = [range(0, 6), range(6, 12), range(12, 18)]

    def launch(enc, r):
        return enc.encode_run_async([frames[i] for i in r],
                                    qps=[QPS[i] for i in r])

    got = []
    p0, p1 = launch(gpu, runs[0]), launch(gpu, runs[1])
    got += [p.result() for p in p0]
    p2 = launch(gpu, runs[2])
    got += [p.result() for p in p1] + [p.result() for p in p2]
    want = [p.result() for r in runs for p in launch(cpu, r)]
    _same(got, want)
    assert [fr.keyframe for fr in got] == IDRS
    assert (gpu.graph_captures, gpu.graph_frames) == \
        _expected_graphs(IDRS, QPS)
    assert (cpu.graph_captures, cpu.graph_frames) == (0, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("cap", [None, LEVEL_CHUNK])
def test_graph_levels_past_chunk_and_dense_fallback(cap):
    """Noise at QP 26: the graphed P frames' levels run past chunk 0
    (`lv_rest`), or, with the capacity cut to one chunk, overflow it, so
    that they are coded from the dense levels copied out of the graph.
    The eager first P frame overflows either way."""
    _card()
    frames = _clip(6, noise=8, seed=9)
    gpu = H265DeviceEncoder(W, H, qp=26, gop=30, device="cuda")
    cpu = H265DeviceEncoder(W, H, qp=26, gop=30, device="cpu")
    got = [p.result() for p in gpu.encode_run_async(frames, cap=cap)]
    want = [p.result() for p in cpu.encode_run_async(frames, cap=cap)]
    _same(got, want)
    assert (gpu.graph_captures, gpu.graph_frames) == (1, 4)
    assert gpu.fallback_frames == cpu.fallback_frames == (5 if cap else 1)


@pytest.mark.cuda
def test_frame_hook_runs_eagerly():
    """A run given its own frame hook stays eager (a profiler's stage
    timing needs the launches): the counters do not move, and the bytes
    still equal the CPU's; a later default run replays graphs again."""
    _card()
    frames = _clip(9)
    gpu = H265DeviceEncoder(W, H, qp=30, gop=30, device="cuda")
    cpu = H265DeviceEncoder(W, H, qp=30, gop=30, device="cpu")
    got = [p.result() for p in gpu.encode_run_async(frames[:3])]
    assert (gpu.graph_captures, gpu.graph_frames) == (1, 1)
    seen = []

    def hook(kind, run, refs):
        seen.append(kind)
        return run()

    got += [p.result() for p in gpu.encode_run_async(frames[3:6],
                                                     frame_hook=hook)]
    assert seen == ["P"] * 3
    assert (gpu.graph_captures, gpu.graph_frames) == (1, 1)
    got += [p.result() for p in gpu.encode_run_async(frames[6:])]
    assert (gpu.graph_captures, gpu.graph_frames) == (1, 4)
    want = [p.result() for r in (frames[:3], frames[3:6], frames[6:])
            for p in cpu.encode_run_async(r)]
    _same(got, want)


def test_cpu_runs_eagerly_and_matches_jax():
    """On the CPU no frame is graphed: two runs with an IDR inside the
    second and per-frame QPs leave both counters at 0, and the bytes
    equal the JAX encoder's (112x64, as
    tests/test_torch_h265_encoder.py checks them)."""
    from ceracoder_tpu.codec.h265.device import H265DeviceEncoder as JEnc
    from tests.test_h265_rows import _panning

    w, h, qps = 112, 64, [30, 30, 33, 33, 28, 28]
    frames = _panning(6, w, h)
    port = H265DeviceEncoder(w, h, qp=30, gop=4, device="cpu")
    streams, kinds = [], []
    for enc in (port, JEnc(w, h, qp=30, gop=4)):
        data = enc.headers()
        for lo, hi in ((0, 3), (3, 6)):
            res = [p.result() for p in enc.encode_run_async(
                frames[lo:hi], qps=qps[lo:hi])]
            data += b"".join(r.data for r in res)
            kinds += [r.keyframe for r in res]
        streams.append(data)
    assert streams[0] == streams[1]
    assert kinds == [True, False, False, False, True, False] * 2
    assert (port.graph_captures, port.graph_frames) == (0, 0)
