"""Host ms per frame in mux, pack and send: the harness's "send" spans
around transport/mpegts.py:TsMuxer.mux_video, TsPacker.feed and
app/main.py:Transport.send, over the frames muxed."""


def read(t):
    n = t.frames("send")
    return t.span_s("send") * 1e3 / n if n else None
