"""Overflow-block rows a query scans: the program's
``raft_tpu_overflow_rows_scanned_total`` of the cell's family over every
search of the run (the warm-up and both windows) over the queries those
calls took (``raft_tpu_dispatch_total`` × the batch's rows). None where the
program has no such counter. Moves qps."""

from vsbench.spans import counter_total, search_calls


def read(view):
    calls = search_calls(view)
    family = view.run.cfg["family"]
    rows = counter_total("raft_tpu_overflow_rows_scanned_total",
                         family=family)
    if calls is None or rows is None:
        return None
    return rows / (calls * view.run.batches[0].shape[0])
