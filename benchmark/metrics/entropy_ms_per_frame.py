"""Host ms per frame in the native entropy stage: the harness's "entropy"
spans around codec/h265/rowslice.py:entropy_rows_native (as the device
encoder calls it; native/src/hevc_entropy.cc), one per frame."""


def read(t):
    n = t.frames("entropy")
    return t.span_s("entropy") * 1e3 / n if n else None
