"""Mean host ms from a search call to its return, before the harness
waits on the results, over the window that a traced run makes without the
profiler (whose own cost on the host would show here). Moves qps."""


def read(view):
    return view.run.return_ms() if view.run.n_steps else None
