"""The native libraries' build keys: a built library is reused only
while the compiler flags, its link flags and every file it compiles or
includes are unchanged; the build lands in build/ and loads under the
port's own ctypes declarations, never as libceracoder_native.so."""

import shutil

import pytest

import ceracoder_tpu_torch.utils.host_build as hb


def test_library_path_follows_flags_include_and_source(tmp_path,
                                                      monkeypatch):
    for name in hb.LIBRARIES["hevc_entropy"].files:
        shutil.copy(hb.NATIVE_SRC / name, tmp_path / name)
    monkeypatch.setattr(hb, "NATIVE_SRC", tmp_path)
    first = hb.library_path("hevc_entropy")
    assert first == hb.library_path("hevc_entropy")
    assert first.parent == hb.BUILD_DIR
    assert first.name.startswith("libhevc_entropy-")

    seen = {first}
    monkeypatch.setattr(hb, "CXX_FLAGS", [*hb.CXX_FLAGS, "-g"])
    seen.add(hb.library_path("hevc_entropy"))
    inc = tmp_path / "hevc_tables.inc"
    inc.write_text(inc.read_text() + "\n// changed\n")
    seen.add(hb.library_path("hevc_entropy"))
    src = tmp_path / "hevc_entropy.cc"
    src.write_text(src.read_text() + "\n// changed\n")
    seen.add(hb.library_path("hevc_entropy"))
    assert len(seen) == 4


@pytest.mark.parametrize("name", ["balancer", "audio_enc", "h264_cabac"])
def test_app_library_keys_follow_flags_and_sources(name, tmp_path,
                                                   monkeypatch):
    """The balancer core, the audio shim (with mpegts.cc, whose output
    buffer it writes into, and its libavcodec link flags) and the H.264
    CABAC row coder (with both table files h264_cabac.cc includes)."""
    lib = hb.LIBRARIES[name]
    assert hb.library_path(name) != hb.library_path("hevc_entropy")
    for f in lib.files:
        shutil.copy(hb.NATIVE_SRC / f, tmp_path / f)
    monkeypatch.setattr(hb, "NATIVE_SRC", tmp_path)
    first = hb.library_path(name)
    assert first.name.startswith(f"lib{name}-")
    seen = {first}
    monkeypatch.setattr(hb, "CXX_FLAGS", [*hb.CXX_FLAGS, "-g"])
    seen.add(hb.library_path(name))
    for f in lib.files:
        (tmp_path / f).write_text((tmp_path / f).read_text() + "\n// x\n")
        seen.add(hb.library_path(name))
    monkeypatch.setitem(hb.LIBRARIES, name, hb.NativeLib(
        lib.sources, lib.includes, (*lib.link, "-lm")))
    seen.add(hb.library_path(name))
    assert len(seen) == 3 + len(lib.files)


def test_builds_and_declares_the_app_libraries():
    from ceracoder_tpu_torch.audio import aac_available, load_audio
    from ceracoder_tpu_torch.native import load_balancer

    lib = load_balancer()
    assert lib.cc_balancer_step.argtypes is not None
    assert lib.cc_balancer_list() == b"adaptive,aimd,fixed"
    assert "libceracoder_native" not in lib._name
    assert hb.have_avcodec() == aac_available()
    if aac_available():
        assert load_audio().cc_outbuf_create.restype is not None


def test_builds_and_declares_the_entropy_entry_point():
    lib = hb.load_hevc_entropy()
    assert hb.library_path("hevc_entropy").exists()
    assert lib.hevc_entropy_rows.argtypes is not None
    assert "libceracoder_native" not in lib._name


def test_h264_cabac_key_covers_both_table_includes():
    """h264_cabac.cc includes hevc_tables.inc (the shared arithmetic
    coder tables) and h264_tables.inc; both are in its build key, and
    the library builds and loads under the port's declaration."""
    src = (hb.NATIVE_SRC / "h264_cabac.cc").read_text()
    lib = hb.LIBRARIES["h264_cabac"]
    for inc in ("hevc_tables.inc", "h264_tables.inc"):
        assert f'#include "{inc}"' in src
        assert inc in lib.includes
    loaded = hb.load_h264_cabac()
    assert hb.library_path("h264_cabac").exists()
    assert loaded.h264_cabac_rows.argtypes is not None
    assert "libceracoder_native" not in loaded._name
