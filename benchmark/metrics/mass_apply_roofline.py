"""K3 (``mass_apply``), per launch as launched (plain mode or one step
of the B^-1 semi-iteration): the least time over the device time, in
percent (``roofline/mass_apply.py``)."""
from benchmark.harness.roofline import share

ROOFLINE = "mass_apply"


def read(win):
    return share(win, ROOFLINE)
