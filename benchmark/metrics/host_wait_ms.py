"""Device-idle time under any of the program's own `caduceus.*` spans: the idle that the entry points' host side accounts for (the rest of `idle_pct` is the harness's own); ms per unit of work."""

from benchmark.metrics._spans import idle_ms_under


def read(view):
    return idle_ms_under(view)
