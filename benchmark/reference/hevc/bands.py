"""The reference HEVC encoder, its CTB rows spread over worker processes.

Under the row-slice schedule every CTB row is a tile of its own: intra
prediction, the intra fallback of a P frame and the CABAC contexts never
cross rows. So a band of rows computes alone, from the band's rows of the
source and, for motion, of the reference picture with MARGIN rows above
and below (the search, the sub-pel refinement and the interpolation
filters reach at most 16 rows past a CTB). Only the deblocking filter
crosses rows; it runs on the whole picture in the calling process. The
bytes do not depend on the number of bands
(benchmark/tests/test_bench_reference.py holds one band against four).
"""

from __future__ import annotations

import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor

import numpy as np

from benchmark.reference.hevc import precision
from benchmark.reference.hevc.deblock import deblock_frame
from benchmark.reference.hevc.inter import (
    luma_qpel_planes,
    mc_chroma_qpel,
    mc_luma_qpel,
    motion_search,
    refine_subpel,
)
from benchmark.reference.hevc.intra import chroma_qp
from benchmark.reference.hevc.spec import (
    _assemble_tiles,
    _inter_tail_rows,
    compute_intra_rows,
    entropy_rows,
)
from benchmark.reference.hevc.syntax import (
    NAL_IDR_W_RADL,
    NAL_TRAIL_R,
    HevcParams,
    nal_unit,
    write_pps,
    write_sps,
    write_vps,
)

CTB = 16
MARGIN = 2 * CTB


def _pad(plane: np.ndarray, h: int, w: int) -> np.ndarray:
    """Edge-replicating pad on the bottom and right to (h, w)."""
    ph, pw = h - plane.shape[0], w - plane.shape[1]
    if ph or pw:
        plane = np.pad(plane, ((0, ph), (0, pw)), mode="edge")
    return plane


def _intra_band(mode, planes, r0: int, r1: int, qp: int, qp_c: int):
    precision.set_mode(mode)
    y, u, v = planes
    a, b = r0 * CTB, r1 * CTB
    return compute_intra_rows(y[a:b], u[a // 2:b // 2], v[a // 2:b // 2],
                              qp, qp_c)


def _p_band(mode, planes, ref, r0: int, r1: int, qp: int, qp_c: int):
    """The port's compute_p_rows for CTB rows r0..r1 of the picture."""
    precision.set_mode(mode)
    h = planes[0].shape[0]
    a, b = max(0, r0 * CTB - MARGIN), min(h, r1 * CTB + MARGIN)
    y, u, v = (np.asarray(p).astype(np.int32) for p in
               (planes[0][a:b], planes[1][a // 2:b // 2],
                planes[2][a // 2:b // 2]))
    ref_y, ref_u, ref_v = (ref[0][a:b], ref[1][a // 2:b // 2],
                           ref[2][a // 2:b // 2])
    hb, w = y.shape
    mvs = motion_search(y, ref_y)
    qpel = luma_qpel_planes(ref_y)
    mvs_q = refine_subpel(y, qpel, mvs)
    pred_y = mc_luma_qpel(qpel, mvs_q, hb, w)
    pred_u = mc_chroma_qpel(ref_u, mvs_q, hb // 2, w // 2)
    pred_v = mc_chroma_qpel(ref_v, mvs_q, hb // 2, w // 2)
    i0, i1 = r0 * CTB - a, r1 * CTB - a
    c0, c1 = i0 // 2, i1 // 2
    arrays, rec = _inter_tail_rows(
        y[i0:i1], u[c0:c1], v[c0:c1], pred_y[i0:i1], pred_u[c0:c1],
        pred_v[c0:c1], qp, qp_c)
    arrays["mv"] = np.where(arrays["is_intra"][..., None], 0,
                            mvs_q[i0 // CTB:i1 // CTB])
    return arrays, rec


def _entropy_band(params, arrays, qp: int, idr: bool, poc: int, r0: int,
                  nrows: int):
    return entropy_rows(params, arrays, qp, idr=idr, poc=poc, row0=r0,
                        nrows=nrows, bodies=True)


class BandedEncoder:
    """IDR and P frames of the device encoder's configuration (deblocking
    on, one tile per CTB row, no SAO, no TU split, no B frames), coded
    from numpy planes. `pps_qp` is the picture parameter set's QP, the
    program's `qp`; each frame takes its own. Use as a context manager:
    it owns a pool of `workers` processes."""

    def __init__(self, width: int, height: int, pps_qp: int,
                 workers: int | None = None):
        self.width, self.height = width, height
        self.pw = -(-width // CTB) * CTB
        self.ph = -(-height // CTB) * CTB
        self.params = HevcParams(width=width, height=height, qp=pps_qp,
                                 pcm_enabled=False, deblock=True,
                                 max_reorder=0, max_dpb_minus1=1,
                                 tile_rows=True, sao=False,
                                 tu_split_inter=False)
        nch = self.ph // CTB
        n = max(1, min(workers or os.cpu_count() or 1, nch))
        edges = np.linspace(0, nch, n + 1).round().astype(int)
        self.bands = [(int(a), int(b)) for a, b in zip(edges, edges[1:])
                      if b > a]
        self._pool = ProcessPoolExecutor(
            max_workers=len(self.bands),
            mp_context=multiprocessing.get_context("spawn"))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def close(self) -> None:
        self._pool.shutdown(wait=True, cancel_futures=True)

    def pad(self, y, u, v):
        """Source planes at the coded size, as the program pads them."""
        return (_pad(np.asarray(y), self.ph, self.pw),
                _pad(np.asarray(u), self.ph // 2, self.pw // 2),
                _pad(np.asarray(v), self.ph // 2, self.pw // 2))

    def headers(self) -> bytes:
        """The parameter sets (VPS, SPS, PPS) that lead an IDR access
        unit."""
        p = self.params
        return write_vps(p) + write_sps(p) + write_pps(p)

    def _map(self, fn, *args_per_band):
        futs = [self._pool.submit(fn, *a) for a in args_per_band]
        return [f.result() for f in futs]

    def encode(self, planes, qp: int, ref=None, poc: int = 0):
        """One frame from padded source planes: an IDR without `ref`,
        else a P frame from the reference picture `ref` (padded planes)
        at POC `poc`. Returns (Annex-B bytes of the frame, the deblocked
        reconstruction at the padded size)."""
        qp_c = chroma_qp(qp)
        mode = precision.mode()
        idr = ref is None
        if idr:
            parts = self._map(_intra_band, *((mode, planes, a, b, qp, qp_c)
                                             for a, b in self.bands))
        else:
            parts = self._map(_p_band, *((mode, planes, ref, a, b, qp, qp_c)
                                         for a, b in self.bands))
        arrays = {k: np.concatenate([p[0][k] for p in parts])
                  for k in parts[0][0]}
        rec = tuple(np.concatenate([p[1][i] for p in parts])
                    for i in range(3))
        nch, ncw = arrays["is_intra"].shape
        cbf_l = arrays["luma_lv"].reshape(nch, ncw, -1).any(-1)
        rec = deblock_frame(*rec, arrays["is_intra"], cbf_l, arrays["mv"],
                            qp)
        bodies = self._map(_entropy_band, *(
            (self.params, {k: v[a:b] for k, v in arrays.items()}, qp, idr,
             poc, a, nch) for a, b in self.bands))
        rbsp = _assemble_tiles(self.params, [x for b in bodies for x in b],
                               qp, idr, poc)
        data = nal_unit(NAL_IDR_W_RADL if idr else NAL_TRAIL_R, rbsp,
                        long_start_code=True)
        return data, rec
