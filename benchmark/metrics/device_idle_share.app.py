"""Share of the app's traced window (%) in which no operation ran on the
card: one less the union of the device's operation intervals."""


def read(t):
    if not t.ops or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s() / t.window_s)
