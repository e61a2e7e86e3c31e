"""Share of the traced window in which no kernel, copy or set ran on
the device: 1 - (union of the device intervals) / (the traced requests'
span), in percent."""


def read(win):
    t = win.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
