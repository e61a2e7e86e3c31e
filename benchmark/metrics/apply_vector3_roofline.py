"""K1 (``apply_vector3``): the least time of its launches in the traced
requests (``roofline/apply_vector3.py``, against the card's published
peaks) over their device time, in percent."""
from benchmark.harness.roofline import share

ROOFLINE = "apply_vector3"


def read(win):
    return share(win, ROOFLINE)
