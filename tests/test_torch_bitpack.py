"""K1 window merge: the plain version (merge_windows_ref) against the
JAX tree_merge and a numpy loop, against the JAX Pallas merge_windows
(interpret mode) only where that kernel is right, the kernel's launch
geometry (merge_geometry), and — on a card — the CUDA kernel against
the plain version on chip_smoke.py's edge cases."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ceracoder_tpu.ops.bitpack import merge_windows as j_merge_windows
from ceracoder_tpu.ops.bitpack import tree_merge
from ceracoder_tpu_torch.ops.bitpack import (
    MERGE_THREADS,
    MERGE_VECS,
    WIN,
    i32_to_u32,
    merge_geometry,
    merge_windows,
    merge_windows_ref,
    u32_to_i32,
)
from chip_smoke import merge_edge_cases

EDGE_CASES = merge_edge_cases()


def _case(seed, rows, nch, max_span, capw_pad):
    """Sorted chunk starts whose content spans 1..max_span words; the
    next chunk starts on the last word or just after it."""
    rng = np.random.default_rng(seed)
    sw = np.zeros((rows, nch), np.int64)
    partials = np.zeros((rows, nch, WIN), np.uint32)
    for r in range(rows):
        s = 0
        for c in range(nch):
            span = int(rng.integers(1, max_span + 1))
            sw[r, c] = s
            partials[r, c, :span] = rng.integers(1, 1 << 32, span,
                                                 dtype=np.uint64)
            s += span - int(rng.integers(0, 2))
    assert sw.max() + WIN <= capw_pad
    return sw.astype(np.int32), partials


def _numpy_merge(sw, partials, capw_pad):
    out = np.zeros((sw.shape[0], capw_pad), np.uint64)
    for r in range(sw.shape[0]):
        for c in range(sw.shape[1]):
            for k in range(WIN):
                pos = int(sw[r, c]) + k
                if 0 <= pos < capw_pad:
                    out[r, pos] += np.uint64(partials[r, c, k])
    return (out & 0xFFFFFFFF).astype(np.uint32)


def _ref(sw, partials, capw_pad):
    p = u32_to_i32(torch.as_tensor(partials.astype(np.int64)))
    out = merge_windows_ref(torch.as_tensor(sw), p, capw_pad)
    return i32_to_u32(out).numpy().astype(np.uint32)


@pytest.mark.parametrize("seed,max_span", [(0, 19), (1, 59), (2, 63)])
def test_ref_matches_tree_merge_and_numpy(seed, max_span):
    capw_pad = 1024
    sw, partials = _case(seed, 5, 12, max_span, capw_pad)
    want = _numpy_merge(sw, partials, capw_pad)
    got = _ref(sw, partials, capw_pad)
    assert np.array_equal(got, want)
    tm = np.asarray(tree_merge(jnp.asarray(sw), jnp.asarray(partials),
                               capw_pad))
    assert np.array_equal(tm, want)


def test_ref_drops_words_past_capacity():
    capw_pad = 256
    sw = np.array([[0, 200, 240, 300]], np.int32)
    partials = np.full((1, 4, WIN), 7, np.uint32)
    want = _numpy_merge(sw, partials, capw_pad)
    assert np.array_equal(_ref(sw, partials, capw_pad), want)
    assert want[0, 255] == 14 and want[0, 0] == 7


def test_ref_matches_pallas_kernel_where_it_is_right():
    """The Pallas kernel wraps words around its 128-lane window when a
    chunk starts past offset 64 of its 128-word block (ROADMAP F1), so
    it is compared only on starts at offsets <= 64."""
    rng = np.random.default_rng(5)
    capw_pad = 1024
    rows, nch = 5, 12
    cand = np.array([s for s in range(capw_pad - 2 * WIN) if s % 128 <= 64])
    sw = np.sort(rng.choice(cand, (rows, nch)), axis=1).astype(np.int32)
    sw[:, 0] = 0
    partials = rng.integers(1, 1 << 32, (rows, nch, WIN),
                            dtype=np.uint64).astype(np.uint32)
    want = _numpy_merge(sw, partials, capw_pad)
    pk = np.asarray(j_merge_windows(jnp.asarray(sw), jnp.asarray(partials),
                                    capw_pad=capw_pad))
    assert np.array_equal(pk, want)
    assert np.array_equal(_ref(sw, partials, capw_pad), want)


def test_wrapper_uses_plain_version_on_cpu():
    sw, partials = _case(3, 3, 6, 40, 512)
    p = u32_to_i32(torch.as_tensor(partials.astype(np.int64)))
    before = merge_windows.launches
    out = merge_windows(torch.as_tensor(sw), p, 512)
    assert merge_windows.launches == before      # no kernel launched
    assert np.array_equal(i32_to_u32(out).numpy(),
                          _numpy_merge(sw, partials, 512))
    with pytest.raises(TypeError):
        merge_windows(torch.as_tensor(sw).long(), p, 512)
    with pytest.raises(ValueError):
        merge_windows(torch.as_tensor(sw), p, 1 << 20)


@pytest.mark.parametrize("name", sorted(EDGE_CASES))
def test_ref_matches_numpy_on_edge_cases(name):
    sw, p, capw_pad = EDGE_CASES[name]
    want = _numpy_merge(sw.numpy(), i32_to_u32(p).numpy(), capw_pad)
    assert np.array_equal(_ref(sw.numpy(), i32_to_u32(p).numpy(),
                               capw_pad), want)


@pytest.mark.parametrize("rows,nch,capw_pad", [
    (68, 215, 5888), (68, 223, 5888), (135, 223, 16384), (7, 50, 1024),
    (3, 9, 256), (1, 3, 256), (2, 1, 256), (2, 517, 8192)])
def test_merge_geometry_invariants(rows, nch, capw_pad):
    """One CTA per row: its threads load every partial vector of the row
    exactly once, as the kernel indexes them, and its shared memory holds
    every output word below capw_pad in whole 16-byte vectors and fits
    one CTA."""
    g = merge_geometry(rows, nch, capw_pad)
    assert g.grid == rows
    j, k, t = np.meshgrid(np.arange(g.rounds), np.arange(MERGE_VECS),
                          np.arange(MERGE_THREADS), indexing="ij")
    v = (j * MERGE_VECS + k) * MERGE_THREADS + t
    nv = nch * (WIN // 4)
    assert np.array_equal(np.sort(v[v < nv]), np.arange(nv))
    assert (v[-1] < nv).any() or nv == 0           # no idle round
    assert g.smem_bytes % 16 == 0
    assert capw_pad * 4 <= g.smem_bytes < capw_pad * 4 + 16
    assert g.smem_bytes <= 232448


def test_wrapper_rejects_misaligned_partials():
    sw, partials = _case(4, 2, 5, 30, 512)
    p = u32_to_i32(torch.as_tensor(partials.astype(np.int64)))
    base = torch.zeros(p.numel() + 1, dtype=torch.int32)
    shifted = base[1:].view(p.shape)
    shifted.copy_(p)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 == 4
    with pytest.raises(ValueError, match="16-byte aligned"):
        merge_windows(torch.as_tensor(sw), shifted, 512)


@pytest.mark.cuda
@pytest.mark.parametrize("name", [*sorted(EDGE_CASES), "sorted_rows_1080p"])
def test_cuda_kernel_matches_plain_version(name):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    if name == "sorted_rows_1080p":
        capw_pad = 5888
        sw, partials = _case(9, 68, 40, 63, capw_pad)
        sw_t = torch.as_tensor(sw, device="cuda")
        p_t = u32_to_i32(torch.as_tensor(partials.astype(np.int64))).cuda()
    else:
        sw_t, p_t, capw_pad = EDGE_CASES[name]
        sw_t, p_t = sw_t.cuda(), p_t.cuda()
    before = merge_windows.launches
    got = merge_windows(sw_t, p_t, capw_pad)
    torch.cuda.synchronize()
    assert merge_windows.launches == before + 1
    want = merge_windows_ref(sw_t, p_t, capw_pad)
    assert torch.equal(got, want)
