"""Two-process GOP-parallel encode on the port, the counterpart of
tests/test_distributed.py: two real OS processes form a
torch.distributed group (gloo on the CPU, rendezvous on a free
localhost port), check a cross-process sum, split a clip's closed GOPs
between them and run per-process adaptive rate control over independent
bonded-link traces. The joined GOPs must equal the port's
single-process encode byte for byte, and each process's final bitrate
the JAX package's controller on the JAX link emulator.

The workers import torch, numpy and ceracoder_tpu_torch only; the
parent writes them the clip. The port's app stays one process, as the
JAX app does: this tests the schedule across processes.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from ceracoder_tpu.control.config import CeracoderConfig as JConfig
from ceracoder_tpu.control.runner import BalancerRunner as JRunner
from ceracoder_tpu.transport.linksim import BondedLink as JBondedLink
from ceracoder_tpu.transport.linksim import Modem as JModem
from ceracoder_tpu_torch.codec.h265.device import H265DeviceEncoder
from tests.test_h265_rows import _panning

# one intra-op thread: pytest-xdist workers share the cores
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
N_FRAMES = 16
GOP = 4
W, H = 112, 64
DROP_MS = 2000            # process 1's second modem drops here
SECONDS_MS = 8000

WORKER = r'''
import json, os, sys
import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)
pid, port, outdir = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{{port}}",
                        world_size=2, rank=pid)

# 1. cross-process collective: each process holds four values of
# arange(8); the sum over both is what JAX's psum over its 2x4 mesh
# reads
x = torch.arange(8.0)[4 * pid:4 * pid + 4].contiguous()
dist.all_reduce(x)
psum = float(x.sum())

# 2. GOP-parallel encode: this process codes GOPs g with g mod 2 == pid
from ceracoder_tpu_torch.codec.h265.device import H265DeviceEncoder

clip = np.load(os.path.join(outdir, "clip.npz"))
frames = list(zip(clip["y"], clip["u"], clip["v"]))
enc = H265DeviceEncoder({w}, {h}, qp=30, gop={gop}, device="cpu")
blobs = {{}}
for g0 in range(0, {nf}, {gop}):
    g = g0 // {gop}
    if g % 2 != pid:
        continue
    enc.resume()                    # closed GOP: fresh chain
    pend = enc.encode_run_async(frames=frames[g0:g0 + {gop}],
                                force_idr=True)
    blobs[g] = b"".join(p.result().data for p in pend)

# 3. per-process rate control over an independent bonded-link trace
from ceracoder_tpu_torch.control import BalancerRunner, CeracoderConfig
from ceracoder_tpu_torch.transport.linksim import BondedLink, Modem

runner = BalancerRunner(CeracoderConfig(), "adaptive", srt_latency=2000,
                        srt_pkt_size=1316, quiet=True)
# process 0 keeps both modems up; process 1 drops one
sched = [] if pid == 0 else [({drop}, False)]
link = BondedLink(modems=[Modem(4e6), Modem(4e6, schedule=sched)],
                  latency_ms=2000)
bps = runner.config.max_bitrate
for t in range(0, {secs}, 20):
    bps = runner.step(link.tick(bps)).new_bitrate

dist.barrier()
dist.destroy_process_group()
for g, blob in blobs.items():
    with open(os.path.join(outdir, f"gop{{g}}.bin"), "wb") as f:
        f.write(blob)
foreign = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "ceracoder_tpu"))
with open(os.path.join(outdir, f"meta{{pid}}.json"), "w") as f:
    json.dump({{"pid": pid, "psum": psum, "final_bps": bps,
               "gops": sorted(blobs), "foreign": foreign}}, f)
'''


def free_port() -> int:
    """A localhost TCP port that was free a moment ago (bound to port 0
    and released); the rendezvous takes it at once."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def jax_final_bitrate(pid: int) -> int:
    """The JAX controller (its Python algorithms) on the JAX link
    emulator under process `pid`'s schedule."""
    runner = JRunner(JConfig(), "adaptive", srt_latency=2000,
                     srt_pkt_size=1316, quiet=True, prefer_native=False)
    sched = [] if pid == 0 else [(DROP_MS, False)]
    link = JBondedLink(modems=[JModem(4e6), JModem(4e6, schedule=sched)],
                       latency_ms=2000)
    bps = runner.config.max_bitrate
    for _ in range(0, SECONDS_MS, 20):
        bps = runner.step(link.tick(bps)).new_bitrate
    return bps


def test_two_process_gop_parallel(tmp_path):
    frames = _panning(N_FRAMES, W, H)
    np.savez(tmp_path / "clip.npz", y=np.stack([f[0] for f in frames]),
             u=np.stack([f[1] for f in frames]),
             v=np.stack([f[2] for f in frames]))
    worker = tmp_path / "worker.py"
    worker.write_text(WORKER.format(w=W, h=H, gop=GOP, nf=N_FRAMES,
                                    drop=DROP_MS, secs=SECONDS_MS))
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    port = free_port()
    procs = [subprocess.Popen(
        [sys.executable, str(worker), str(i), str(port), str(tmp_path)],
        env=env, cwd=str(tmp_path), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE) for i in range(2)]
    try:
        # meanwhile: the single-process encode and the JAX controller
        ref = H265DeviceEncoder(W, H, qp=30, gop=GOP, device="cpu")
        want = b""
        for g0 in range(0, N_FRAMES, GOP):
            ref.resume()
            pend = ref.encode_run_async(frames=frames[g0:g0 + GOP],
                                        force_idr=True)
            want += b"".join(p.result().data for p in pend)
        jax_bps = [jax_final_bitrate(pid) for pid in range(2)]
        outs = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10)
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, se.decode()[-2000:]

    metas = [json.loads((tmp_path / f"meta{i}.json").read_text())
             for i in range(2)]
    assert [m["pid"] for m in metas] == [0, 1]
    assert [m["gops"] for m in metas] == [[0, 2], [1, 3]]
    assert [m["foreign"] for m in metas] == [[], []]
    # the cross-process sum saw all 8 values in both processes
    assert metas[0]["psum"] == 28.0 and metas[1]["psum"] == 28.0

    # per-stream control: the degraded link settled materially lower,
    # and each process's controller is the JAX controller
    assert metas[1]["final_bps"] < metas[0]["final_bps"]
    assert metas[0]["final_bps"] > 4_000_000      # healthy 8 Mbps link
    assert metas[1]["final_bps"] < 4_500_000      # one 4 Mbps modem
    assert [m["final_bps"] for m in metas] == jax_bps

    # distributed GOPs concatenate byte-identical to single-process
    got = b"".join((tmp_path / f"gop{g}.bin").read_bytes()
                   for g in range(N_FRAMES // GOP))
    assert got == want
    assert len(want) > 0
