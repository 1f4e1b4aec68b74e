"""One reader per per-layer metric, ``<metric>.py`` with ``read(view)``:
the value from the traced stretch, or None where the trace holds nothing
for it (the harness then leaves the metric out)."""
