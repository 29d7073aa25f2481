"""Share of the traced window in which no operation ran on the card, %."""

from vsbench.readers import idle_pct


def read(view):
    return idle_pct(view)
