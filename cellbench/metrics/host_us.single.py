"""host_us.single: the median host time of one call of the entry, in
microseconds: the harness's perf_counter span around the call, which
ends when the call returns, before the sync (the enqueue through
plan/api, plan/dispatch and the kernel wrappers). Over the traced run's
window; the profiled slice is left out."""

import statistics


def read(record):
    return statistics.median(record.host_s) * 1e6 if record.host_s else None
