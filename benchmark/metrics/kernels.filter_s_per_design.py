"""Seconds of the program's ``filter`` phase (the device Chebyshev
filter and Rayleigh-Ritz passes, ending in a host read of the pass
gate) summed over the window's requests, over the designs completed."""


def read(win):
    if not win.designs:
        return None
    return win.phase_sum(("filter",)) / win.designs
