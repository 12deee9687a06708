"""Device ms per frame launched: the sum of the kernels' durations in the
traced window over the frames the window's "launch" spans covered."""


def read(t):
    n = t.frames("launch")
    if not n or not t.kernels:
        return None
    return sum(b - a for _, a, b, _ in t.kernels) / 1e6 / n
