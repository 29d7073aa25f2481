"""Host arrays a search call staged onto the card, each a wait of the host
on the device: the program's ``raft_tpu_host_sync_total`` over the sites of
the cell's family (``<family>.queries``, ``<family>.filter``) over every
search of the run (the warm-up and both windows, one path and so one count
a call) over the calls its ``raft_tpu_dispatch_total`` counted for that
family. The cells' batches are on the card already, so 0 is the reading;
it counts these sites only, and a read-back elsewhere in the search is not
seen here (``python3 -m vsbench.spans --sync-debug`` finds one). None where
the program has no such counter. Moves qps."""

from vsbench.spans import search_calls, staging_waits


def read(view):
    calls = search_calls(view)
    waits = staging_waits(view.run.cfg["family"])
    if calls is None or waits is None:
        return None
    return waits / calls
