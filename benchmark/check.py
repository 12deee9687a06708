"""What decides `correct`: a sample of the window's frames, drawn from the
seed, coded again by the reference and compared byte for byte, with the
reconstruction that each carries to the next frame.

The sample is one GOP drawn from those the window submitted whole as far
as the sample reaches, and in it:

- the IDR (the largest frame) and the first P frame, coded by the
  reference from the camera alone, the P frame from the reference's own
  IDR reconstruction;
- `extra` P frames at positions drawn from the seed, one of them the
  first frame of a run, each coded by the reference from the program's
  reconstruction of the frame before it (the program's carried state; the
  chain from the IDR would cost a frame of the reference per position).
  That the state is right is checked where it starts (the IDR and first
  P, from scratch) and at each sampled frame (its reconstruction against
  the reference's).

Every frame submitted has to come back: one that never comes, or that
raised, is missing. The limits are 0: the codec is integer-exact.
"""

from __future__ import annotations

import random

import numpy as np

from benchmark.camera import mix32


class Sample:
    """The GOP positions to check, drawn from the seed before the window
    (so that the loop keeps their bytes and reconstructions), and the GOP
    drawn after it."""

    def __init__(self, seed: int, gop: int, run_len: int, extra: int):
        self.gop = gop
        rng = random.Random(mix32(seed, 0x5A))
        cands = list(range(2, gop))
        picks = set()
        starts = [k for k in cands if k % run_len == 0]
        if starts and extra:
            picks.add(rng.choice(starts))
        while len(picks) < min(extra, len(cands)):
            picks.add(rng.choice(cands))
        self.extra = sorted(picks)
        self.rng = rng
        self.byte_pos = {0, 1, *self.extra}
        self.recon_pos = self.byte_pos | {k - 1 for k in self.extra}

    def keeps_bytes(self, i: int) -> bool:
        return i % self.gop in self.byte_pos

    def keeps_recon(self, i: int) -> bool:
        return i % self.gop in self.recon_pos

    def choose(self, submitted: int) -> tuple[int, list[int]]:
        """(GOP index, positions to check) among the GOPs that the window
        submitted as far as the sample reaches; where none did, the first
        GOP and the positions it reached."""
        need = max(self.byte_pos) + 1
        whole = [g for g in range(submitted // self.gop + 1)
                 if submitted - g * self.gop >= need]
        if whole:
            return self.rng.choice(whole), sorted(self.byte_pos)
        return 0, [k for k in sorted(self.byte_pos) if k < submitted]


def compare(codec, cfg: dict, camera, ring_len: int, qp, pps_qp: int,
            base: int, positions: list[int], got_bytes: dict,
            got_recon: dict, workers: int | None = None,
            headers: bool = False) -> dict:
    """Code the sampled frames of the GOP that starts at frame `base`
    with the reference and compare; returns {"checked", "bytes_differ",
    "recon_differ"} counts (a sampled frame that never came back is not
    checked). Frame i is camera frame i modulo `ring_len` and is coded at
    `qp`, a number or a dict of frame -> QP. With `headers`, the IDR's
    bytes are the parameter sets and the frame, as an access unit."""
    out = {"checked": 0, "bytes_differ": 0, "recon_differ": 0}

    def planes(ref, i):
        return ref.pad(*(p.cpu().numpy() for p in camera.frame(i % ring_len)))

    def qp_of(i):
        return qp[i] if isinstance(qp, dict) else qp

    def judge(i, data, rec):
        if i not in got_bytes or i not in got_recon:
            return
        out["checked"] += 1
        out["bytes_differ"] += int(got_bytes[i] != data)
        out["recon_differ"] += int(not all(
            np.array_equal(a, b) for a, b in zip(got_recon[i], rec)))

    with codec.reference(cfg, pps_qp, workers) as ref:
        rec0 = None
        for k in positions:
            i = base + k
            if i not in got_bytes:
                continue
            if k == 0:
                data, rec0 = ref.encode(planes(ref, i), qp_of(i))
                judge(i, (ref.headers() if headers else b"") + data, rec0)
            elif k == 1:
                if rec0 is None:
                    continue
                data, rec = ref.encode(planes(ref, i), qp_of(i), ref=rec0,
                                       poc=1)
                judge(i, data, rec)
            else:
                prev = got_recon.get(i - 1)
                if prev is None:
                    continue
                data, rec = ref.encode(planes(ref, i), qp_of(i), ref=prev,
                                       poc=k)
                judge(i, data, rec)
    return out


def checks(missing: int, got: dict, positions: list[int]) -> list:
    """The numbers that decide `correct`, as (name, value, limit, passed):
    frames that never came back or raised, the sampled frames checked,
    and those whose bytes or reconstruction differ from the reference."""
    return [
        ("frames_missing", missing, 0, missing == 0),
        ("frames_checked", got["checked"], len(positions),
         got["checked"] == len(positions) >= 1),
        ("bytes_differ", got["bytes_differ"], 0, got["bytes_differ"] == 0),
        ("recon_differ", got["recon_differ"], 0, got["recon_differ"] == 0),
    ]
