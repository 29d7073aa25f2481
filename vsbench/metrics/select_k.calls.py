"""``select_k`` calls a search call: the program's
``raft_tpu_select_k_total`` (every algorithm) over every search of the run
(the warm-up and both windows; nothing else of a run selects) over the
calls its ``raft_tpu_dispatch_total`` counted for the cell's family. Each
selection is a launch or more of glue beside the scan: the probes' and the
overflow merge's on the fused engines, more a query tile in the tile
loops. None where the program has no such counter. Moves qps."""

from vsbench.spans import counter_total, search_calls


def read(view):
    calls = search_calls(view)
    selects = counter_total("raft_tpu_select_k_total")
    if calls is None or selects is None:
        return None
    return selects / calls
