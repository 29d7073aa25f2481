"""``ivf_scan``'s share of its roofline, %: the least time for the work
of every batch in the window (``vsbench.roofline``) over the device time
of the kernels ``csrc/ivf_scan.cu`` defines. Moves qps."""

from vsbench.readers import roofline_pct


def read(view):
    return roofline_pct(view, "ivf_scan")
