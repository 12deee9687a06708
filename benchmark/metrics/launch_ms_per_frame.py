"""Host ms per frame in the encoder's run scheduler: the harness's
"launch" spans around H265DeviceEncoder.encode_run_async (which runs
ops/h265.py:encode_run_rows), over the frames they launched."""


def read(t):
    n = t.frames("launch")
    return t.span_s("launch") * 1e3 / n if n else None
