"""Share of the traced stretch in which no kernel, copy or set ran on the card."""

from benchmark.metrics._lib import idle_pct


def read(view):
    return idle_pct(view)
