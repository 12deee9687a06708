"""The native HEVC entropy library's build key: a built library is
reused only while the compiler flags, hevc_entropy.cc and
hevc_tables.inc are unchanged; the build lands in build/ and loads under
the port's own ctypes declaration."""

import shutil

import ceracoder_tpu_torch.utils.host_build as hb


def test_library_path_follows_flags_include_and_source(tmp_path,
                                                      monkeypatch):
    for name in hb.SOURCES:
        shutil.copy(hb.NATIVE_SRC / name, tmp_path / name)
    monkeypatch.setattr(hb, "NATIVE_SRC", tmp_path)
    first = hb.library_path()
    assert first == hb.library_path()
    assert first.parent == hb.BUILD_DIR
    assert first.name.startswith("libhevc_entropy-")

    seen = {first}
    monkeypatch.setattr(hb, "CXX_FLAGS", [*hb.CXX_FLAGS, "-g"])
    seen.add(hb.library_path())
    inc = tmp_path / "hevc_tables.inc"
    inc.write_text(inc.read_text() + "\n// changed\n")
    seen.add(hb.library_path())
    src = tmp_path / "hevc_entropy.cc"
    src.write_text(src.read_text() + "\n// changed\n")
    seen.add(hb.library_path())
    assert len(seen) == 4


def test_builds_and_declares_the_entropy_entry_point():
    lib = hb.load_hevc_entropy()
    assert hb.library_path().exists()
    assert lib.hevc_entropy_rows.argtypes is not None
    assert "libceracoder_native" not in lib._name
