"""Host ms per frame in the native entropy stage inside the app: the
harness's "entropy" spans around codec/h265/rowslice.py:entropy_rows_native
(native/src/hevc_entropy.cc), one per frame."""


def read(t):
    n = t.frames("entropy")
    return t.span_s("entropy") * 1e3 / n if n else None
