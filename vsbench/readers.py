"""What the per-layer metric modules under ``metrics/`` share.

Each reader takes the ``View`` of a run (its trace, the traffic's run, and
the port's kernel names by source file) and returns a number, or None where
the run holds nothing to read: a kernel the path did not launch, a run
without a trace. None leaves the metric out of the result; a share is never
given as 0 for want of a reading.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Set

from vsbench import roofline
from vsbench.trace import Trace


@dataclasses.dataclass
class View:
    trace: Optional[Trace]
    run: object
    port: Dict[str, Set[str]]


def roofline_pct(view: View, kernel: str) -> Optional[float]:
    """``kernel``'s share of its roofline, %: the least time for the work
    of every step the window ran (``vsbench.roofline``) over the device
    time of the kernels that ``csrc/<kernel>.cu`` defines."""
    names = view.port.get(kernel)
    if view.trace is None or not names:
        return None
    seconds = view.trace.kernel_s(names)
    work = view.run.work(kernel)
    if seconds <= 0 or work is None:
        return None
    return 100.0 * roofline.bound_s(*work)[0] / seconds


def glue_ms(view: View) -> Optional[float]:
    """Device ms a step in kernels that are not the port's own."""
    if view.trace is None or not view.run.n_steps:
        return None
    own = set().union(*view.port.values())
    return 1e3 * view.trace.kernel_s(exclude=own) / view.run.n_steps


def idle_pct(view: View) -> Optional[float]:
    """Share of the traced window in which nothing ran on the device, %."""
    if view.trace is None or view.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - view.trace.busy_s / view.trace.window_s)
