"""Device mesh + the sharded H.264 intra step.

Port of ceracoder_tpu/parallel/mesh.py. The JAX package shards over a
`jax.sharding.Mesh` with `shard_map`; the port runs in one process over
a (streams, rows) grid of torch devices and launches each shard on its
own device in turn. A device may appear in the grid more than once:
its shards then run one after another (one card runs the banded paths
that way).

- ``streams``: independent concurrent streams, no communication.
- ``rows``: MB-row bands of one frame. With one slice per MB row the
  bands share nothing while coding; the only cross-band value is the
  per-stream sum of nonzero levels that feeds rate control (the JAX
  ``psum`` over "rows").
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ceracoder_tpu_torch.ops.intra import encode_frame_i16_rows
from ceracoder_tpu_torch.utils.device import resolve_device

# encode_frame_i16_rows' level arrays, in the JAX step's order
_LEVEL_KEYS = ("dc_luma", "ac_luma", "mode_luma", "dc_chroma", "ac_chroma",
               "mode_chroma")
_NZ_KEYS = ("ac_luma", "dc_luma", "ac_chroma", "dc_chroma")


@dataclass
class Mesh:
    """A (streams, rows) grid of torch devices: devices[s][r] runs row
    band r of stream s; shape["streams"], shape["rows"] as in JAX."""

    devices: list

    @property
    def shape(self) -> dict:
        return {"streams": len(self.devices), "rows": len(self.devices[0])}


def available_devices(devices=None) -> list[torch.device]:
    """`devices` as torch devices, each checked (resolve_device); by
    default every CUDA device, which raises without a card."""
    if devices is None:
        resolve_device(None)
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [resolve_device(d) for d in devices]


def make_mesh(n_streams: int = 1, n_rows: int | None = None,
              devices=None) -> Mesh:
    """Build a (streams, rows) mesh over `devices` (default: every CUDA
    device), row-major as JAX's: stream s takes devices s * n_rows to
    (s + 1) * n_rows - 1. Raises when the devices are too few."""
    devices = available_devices(devices)
    if n_rows is None:
        n_rows = len(devices) // n_streams
    need = n_streams * n_rows
    if n_streams < 1 or n_rows < 1 or need > len(devices):
        raise ValueError(f"{n_streams}x{n_rows} mesh needs {need} devices, "
                         f"have {len(devices)}")
    return Mesh([devices[s * n_rows:(s + 1) * n_rows]
                 for s in range(n_streams)])


def band_bounds(n_units: int, n_bands: int) -> list[tuple[int, int]]:
    """Split n_units rows (MB or CTB rows) into n_bands bands of whole
    rows, as even as they can be: the first n_units % n_bands bands take
    one row more. Returns each band's (start, stop)."""
    if not 1 <= n_bands <= n_units:
        raise ValueError(f"{n_units} rows do not split into {n_bands} "
                         "bands of at least one row")
    base, extra = divmod(n_units, n_bands)
    bounds, r0 = [], 0
    for b in range(n_bands):
        r1 = r0 + base + (b < extra)
        bounds.append((r0, r1))
        r0 = r1
    return bounds


def stream_devices(mesh: Mesh, n: int) -> list:
    """The row-band devices of each of n streams: the streams split into
    mesh.shape["streams"] equal consecutive groups, as JAX shards a
    leading axis; group g runs on mesh.devices[g]."""
    groups = mesh.shape["streams"]
    if n % groups:
        raise ValueError(f"{n} streams do not split over a mesh of "
                         f"{groups} streams")
    return [mesh.devices[s // (n // groups)] for s in range(n)]


def encode_sharded(mesh: Mesh, qp: int, qp_c: int):
    """Build the multi-stream, row-banded Intra_16x16 encode step.

    Input: y (S, H, W), u, v (S, H/2, W/2) uint8 (tensors or arrays),
    the streams split over the mesh's (stream_devices) and the frame's MB
    rows into its row bands (band_bounds). Each (stream, band) is coded by
    encode_frame_i16_rows on its device (K3 on a card). Returns the
    per-MB arrays with the JAX step's keys, dtypes and shapes, and
    "recon" (y, u, v), all gathered on the mesh's first device, plus
    the per-stream count of nonzero levels summed over the bands, (S,)
    int32."""
    n_rows = mesh.shape["rows"]
    home = mesh.devices[0][0]

    def step(y, u, v):
        y, u, v = (torch.as_tensor(p) for p in (y, u, v))
        bounds = band_bounds(y.shape[1] // 16, n_rows)
        streams, nz = [], []
        for s, devs in enumerate(stream_devices(mesh, y.shape[0])):
            bands, counts = [], []
            for (r0, r1), dev in zip(bounds, devs):
                planes = (y[s, 16 * r0:16 * r1], u[s, 8 * r0:8 * r1],
                          v[s, 8 * r0:8 * r1])
                out = encode_frame_i16_rows(
                    *(p.to(dev, non_blocking=True) for p in planes), qp, qp_c)
                bands.append(out)
                counts.append(sum((out[k] != 0).sum(dtype=torch.int32)
                                  for k in _NZ_KEYS))
            streams.append({k: torch.cat([b[k].to(home) for b in bands])
                            for k in _LEVEL_KEYS})
            streams[-1]["recon"] = tuple(
                torch.cat([b["recon"][i].to(home) for b in bands])
                for i in range(3))
            nz.append(sum(c.to(home) for c in counts))
        outs = {k: torch.stack([st[k] for st in streams])
                for k in _LEVEL_KEYS}
        outs["recon"] = tuple(torch.stack([st["recon"][i] for st in streams])
                              for i in range(3))
        return outs, torch.stack(nz)

    return step
