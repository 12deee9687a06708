"""Port hygiene: ceracoder_tpu_torch and chip_smoke.py import neither
jax nor the JAX package, and entry points default to CUDA without
falling back to the CPU."""

import ast
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "ceracoder_tpu"}


def _port_files():
    files = sorted((ROOT / "ceracoder_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    return files


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_imports_no_jax():
    files = _port_files()
    assert len(files) > 10 and all(f.exists() for f in files)
    bad = [(f.relative_to(ROOT).as_posix(), m) for f in files
           for m in _imported_roots(f) if m in FORBIDDEN]
    assert bad == []


# the host reference codec's Python coders and numpy encoders: specs and
# test twins, never a fallback of a production path
REFERENCE_CODERS = {"H264RowCabac", "entropy_rows", "compute_intra_rows",
                    "compute_p_rows", "compute_b_rows", "H265RowEncoder"}
PRODUCTION = ("codec/h264/encoder.py", "codec/h264/cabac_assemble.py",
              "codec/h265/device.py", "parallel/*.py", "app/*.py",
              "ops/*.py")


def _names(path):
    """Every name a module defines, imports, reads or calls, attributes
    too."""
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            yield node.name
        elif isinstance(node, ast.Name):
            yield node.id
        elif isinstance(node, ast.Attribute):
            yield node.attr
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            yield from (a.name.split(".")[-1] for a in node.names)


def test_no_reference_coder_is_wired_as_a_fallback():
    """No production module of the port imports or calls the Python
    entropy coders (H264RowCabac, rowslice.entropy_rows) or the numpy
    encoders (compute_*_rows, H265RowEncoder), lazily or not: a failed
    native build or a full buffer raises instead."""
    pkg = ROOT / "ceracoder_tpu_torch"
    files = sorted({f for pat in PRODUCTION for f in pkg.glob(pat)})
    assert len(files) > 15
    bad = [(f.relative_to(ROOT).as_posix(), n) for f in files
           for n in _names(f) if n in REFERENCE_CODERS]
    assert bad == []
    # the names are the reference modules' own, so the check bites
    ref = {n for m in ("codec/h264/cabac.py", "codec/h265/rowslice.py")
           for n in _names(pkg / m)}
    assert REFERENCE_CODERS <= ref


# the legacy motion helpers and the CAVLC block decoder: ported for the
# tools and the tests, called by no module of the port
LEGACY = {"motion_search_dev": "ops/h265.py", "_refine_subpel": "ops/h265.py",
          "motion_search_fullpel": "ops/inter.py",
          "halfpel_refine": "ops/inter.py",
          "decode_block": "codec/h264/cavlc.py"}


def _calls_and_imports(path):
    """The names a module calls (plain or as attributes) or imports."""
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Call):
            f = node.func
            if isinstance(f, ast.Name):
                yield f.id
            elif isinstance(f, ast.Attribute):
                yield f.attr
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            yield from (a.name.split(".")[-1] for a in node.names)


def test_legacy_helpers_are_off_every_path():
    """No module of the port calls or imports the legacy full searches
    and refines or the CAVLC block decoder; each is defined where its
    JAX twin is."""
    pkg = ROOT / "ceracoder_tpu_torch"
    bad = [(f.relative_to(ROOT).as_posix(), n) for f in pkg.rglob("*.py")
           for n in _calls_and_imports(f) if n in LEGACY]
    assert bad == []
    for name, module in LEGACY.items():
        assert name in set(_names(pkg / module)), name


def test_every_kernel_source_is_built_through_cuda_build():
    """Each csrc/*.cu is one kernel: a wrapper loads it through
    utils/cuda_build.py's load_library (nvcc, keyed build into build/,
    ctypes), with its launch count beside it, and chip_smoke.py builds
    and checks it; nothing goes through PyTorch's extension builder."""
    import chip_smoke

    pkg = ROOT / "ceracoder_tpu_torch"
    sources = sorted(p.stem for p in (pkg / "csrc").glob("*.cu"))
    assert {"merge_windows", "h264_deblock", "h264_intra16"} <= set(sources)
    assert sources == sorted(chip_smoke.KERNELS)
    text = {f.relative_to(ROOT).as_posix(): f.read_text()
            for f in pkg.rglob("*.py")}
    for name in sources:
        loaders = [f for f, t in text.items()
                   if f'load_library("{name}")' in t]
        assert len(loaders) == 1, (name, loaders)
        wrapper = chip_smoke.KERNELS[name][0]
        assert f"{wrapper}.launches += 1" in text[loaders[0]], name
    assert not [f for f, t in text.items()
                if "torch.utils.cpp_extension" in t]


def test_entry_points_default_to_cuda(monkeypatch):
    from ceracoder_tpu_torch.app.source import DeviceTestPatternSource
    from ceracoder_tpu_torch.codec.h264.encoder import H264Encoder

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        H264Encoder(64, 48, cabac=False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DeviceTestPatternSource(64, 48)
    enc = H264Encoder(64, 48, device="cpu")
    assert enc.device.type == "cpu"
    # the JAX encoder's defaults: CABAC (Main profile) with intra-in-P
    assert enc.cabac and enc.intra_in_p and enc.pps.cabac
    assert enc.sps.profile_idc == 77
    assert not H264Encoder(64, 48, cabac=False, device="cpu").intra_in_p
    with pytest.raises(ValueError, match="intra_in_p requires cabac"):
        H264Encoder(64, 48, cabac=False, intra_in_p=True, device="cpu")


def test_hevc_entry_points_default_to_cuda(monkeypatch):
    from ceracoder_tpu_torch.codec.h265.device import H265DeviceEncoder

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        H265DeviceEncoder(64, 48)
    assert H265DeviceEncoder(64, 48, device="cpu").device.type == "cpu"
    assert H265DeviceEncoder(64, 48, device="cpu", sao=True).params.sao
    with pytest.raises(RuntimeError, match="device='cpu'"):
        H265DeviceEncoder(64, 48, bframes=1, tu_split=True)
    # the inter TU split and B frames set the parameter sets as the JAX
    # encoder's options do
    for kw, want in (({}, (False, 0, 1)),
                     ({"tu_split": True}, (True, 0, 1)),
                     ({"bframes": 1}, (False, 1, 2)),
                     ({"bframes": 1, "tu_split": True}, (True, 1, 2))):
        p = H265DeviceEncoder(64, 48, device="cpu", **kw).params
        assert (p.tu_split_inter, p.max_reorder, p.max_dpb_minus1) == want
    # the operating point is stated, not taken from HevcParams' defaults
    p = H265DeviceEncoder(64, 48, device="cpu").params
    assert (p.deblock, p.tile_rows, p.pcm_enabled) == (True, True, False)
    # the JAX encoder's options that the port does not take (its modes
    # without native entropy, deblocking or tile rows) are not accepted,
    # so no caller can believe it got them
    for kw in ({"native_entropy": False}, {"deblock": False},
               {"tile_rows": False}):
        with pytest.raises(TypeError, match="unexpected keyword"):
            H265DeviceEncoder(64, 48, device="cpu", **kw)


def test_hevc_has_no_python_entropy_fallback(monkeypatch):
    """A native entropy library that cannot be built stops the encoder;
    nothing falls back to a Python entropy coder."""
    import numpy as np

    import ceracoder_tpu_torch.utils.host_build as hb
    from ceracoder_tpu_torch.codec.h265.device import H265DeviceEncoder

    def broken(name):
        raise RuntimeError(f"g++ failed for {name}.cc")

    hb.load_hevc_entropy.cache_clear()
    monkeypatch.setattr(hb, "build_library", broken)
    try:
        enc = H265DeviceEncoder(32, 32, device="cpu")
        frame = (np.zeros((32, 32), np.uint8),
                 np.zeros((16, 16), np.uint8), np.zeros((16, 16), np.uint8))
        (pend,) = enc.encode_run_async([frame])
        with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
            pend.result()
    finally:
        hb.load_hevc_entropy.cache_clear()


def test_h264_has_no_python_entropy_fallback(monkeypatch):
    """A CABAC row coder that cannot be built, or whose output buffer is
    full, stops the encoder; nothing falls back to a Python row
    coder."""
    import numpy as np

    import ceracoder_tpu_torch.codec.h264.cabac_assemble as ca
    import ceracoder_tpu_torch.utils.host_build as hb
    from ceracoder_tpu_torch.codec.h264.encoder import H264Encoder

    frame = (np.full((32, 32), 90, np.uint8),
             np.zeros((16, 16), np.uint8), np.zeros((16, 16), np.uint8))

    def broken(name):
        raise RuntimeError(f"g++ failed for {name}.cc")

    hb.load_h264_cabac.cache_clear()
    try:
        with monkeypatch.context() as mp:
            mp.setattr(hb, "build_library", broken)
            (pend,) = H264Encoder(32, 32, device="cpu").encode_run_async(
                [frame])
            with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
                pend.result()
    finally:
        hb.load_h264_cabac.cache_clear()

    class FullBuffer:
        def h264_cabac_rows(self, *args):
            return -1

    monkeypatch.setattr(ca, "load_h264_cabac", lambda: FullBuffer())
    (pend,) = H264Encoder(32, 32, device="cpu").encode_run_async([frame])
    with pytest.raises(RuntimeError, match="output buffer"):
        pend.result()


def test_app_defaults_to_cuda(monkeypatch, tmp_path):
    """The app, its job's device source and `python -m
    ceracoder_tpu_torch` run on the card and raise without one; the CPU
    is used only when asked for."""
    import os
    import subprocess
    import sys

    from ceracoder_tpu_torch.app.cli import CliOptions
    from ceracoder_tpu_torch.app.jobspec import open_source, parse_jobspec
    from ceracoder_tpu_torch.app.main import CeracoderApp

    job = tmp_path / "job.ini"
    job.write_text("[source]\nkind = devtest\nwidth = 96\nheight = 64\n"
                   "\n[encode]\ncodec = hevc\n")
    opts = CliOptions(job_file=str(job), addr=str(tmp_path / "o.ts"), port=0)
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.run([sys.executable, "-m", "ceracoder_tpu_torch",
                           str(job), str(tmp_path / "o.ts"), "0"],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert "device='cpu'" in proc.stderr
    assert not (tmp_path / "o.ts").exists()

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CeracoderApp(opts)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        open_source(parse_jobspec(job))
    assert CeracoderApp(opts, device="cpu").encoder.device.type == "cpu"
    assert open_source(parse_jobspec(job), device="cpu").device.type == "cpu"
