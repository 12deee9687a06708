"""The kernel build's cache key: a built library is reused only while
the nvcc flags, every header under csrc/ and the kernel's source are
unchanged (nothing is compiled here)."""

import ceracoder_tpu_torch.utils.cuda_build as cb


def test_library_path_follows_flags_headers_and_source(tmp_path,
                                                       monkeypatch):
    monkeypatch.setattr(cb, "CSRC_DIR", tmp_path)
    src = tmp_path / "k.cu"
    src.write_text("// kernel\n")
    first = cb.library_path("k")
    assert first == cb.library_path("k")
    assert first.parent == cb.BUILD_DIR and first.name.startswith("libk-")

    seen = {first}
    monkeypatch.setattr(cb, "NVCC_FLAGS", [*cb.NVCC_FLAGS, "-lineinfo"])
    seen.add(cb.library_path("k"))
    header = tmp_path / "common.cuh"
    header.write_text("// header\n")
    seen.add(cb.library_path("k"))
    header.write_text("// header, changed\n")
    seen.add(cb.library_path("k"))
    src.write_text("// kernel, changed\n")
    seen.add(cb.library_path("k"))
    assert len(seen) == 5
