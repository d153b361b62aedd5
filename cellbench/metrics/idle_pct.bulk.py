"""idle_pct.bulk: the share of the profiled slice in which nothing ran
on the card (one minus the union of its operations over the slice), in
%."""

from cellbench import trace


def read(record):
    share = trace.idle_share(record.slice) if record.slice else None
    return None if share is None else 100.0 * share
