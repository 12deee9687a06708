"""Kernels the card ran per frame launched: kernel events in the traced
window over the frames the window's "launch" spans covered."""


def read(t):
    n = t.frames("launch")
    return len(t.kernels) / n if n and t.kernels else None
