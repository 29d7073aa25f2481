"""Device ms a batch in kernels that are not the port's own ``csrc/``
kernels: the coarse product, masks, grouping glue and the unfused engines'
torch operations. Moves qps."""

from vsbench.readers import glue_ms


def read(view):
    return glue_ms(view)
