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
    # the JAX encoder's options that are later slices of the port are
    # not accepted, so no caller can believe it got them
    for kw in ({"tu_split": True}, {"bframes": 1},
               {"native_entropy": False}, {"deblock": False},
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
