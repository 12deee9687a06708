"""Host ms from a frame's capture (its release by the camera) until the
app's run scheduler (app/main.py:_loop_pipelined) dispatches the run that
holds it, mean over the frames captured in the traced window: the
harness's "wait" spans, one per frame."""


def read(t):
    waits = t.spans_of("wait")
    if not waits:
        return None
    return sum(b - a for _, a, b, _ in waits) / 1e6 / len(waits)
