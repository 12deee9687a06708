"""The seeded camera: frame i a function of (seed, i) alone, the same
statistics for every seed."""

import numpy as np
import torch

from benchmark import harness
from benchmark.camera import Camera

PARAMS = harness.load_json(harness.BENCH / "traffic" / "live.json")["camera"]


def test_frame_depends_on_seed_and_index_only():
    seed = 2**33 + 5                      # seeds go past 32 bits
    a, b = Camera(160, 96, seed, PARAMS), Camera(160, 96, seed, PARAMS)
    later = [a.frame(i) for i in (7, 3, 7)]
    assert all(torch.equal(x, y) for x, y in zip(later[0], later[2]))
    assert all(torch.equal(x, y) for x, y in zip(later[1], b.frame(3)))
    assert not torch.equal(a.frame(4)[0], a.frame(3)[0])
    assert not torch.equal(Camera(160, 96, seed + 1, PARAMS).frame(3)[0],
                           later[1][0])
    y, u, v = later[0]
    assert y.shape == (96, 160) and u.shape == v.shape == (48, 80)
    assert y.dtype == torch.uint8


def test_statistics_do_not_follow_the_seed():
    stats = []
    for seed in (1, 2**31 + 3, 77777):
        y = Camera(320, 192, seed, PARAMS).frame(5)[0].numpy().astype(float)
        stats.append((y.mean(), y.std(), np.abs(np.diff(y, axis=1)).mean()))
    s = np.array(stats)
    assert np.ptp(s[:, 0]) < 12 and np.ptp(s[:, 1]) < 8
    assert np.ptp(s[:, 2]) < 1.5
