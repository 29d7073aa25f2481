"""``fused_pq_topk``'s share of its roofline, %: the least time for the work
of every batch in the window (``vsbench.roofline``) over the device time
of the kernels ``csrc/fused_pq_topk.cu`` defines. Moves qps."""

from vsbench.readers import roofline_pct


def read(view):
    return roofline_pct(view, "fused_pq_topk")
