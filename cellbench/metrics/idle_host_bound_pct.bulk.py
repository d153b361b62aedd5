"""idle_host_bound_pct.bulk: the share of the profiled slice in which the
card was idle waiting for a kernel the host had not launched yet, in %:
of the gap before the slice's k-th device operation, the part before the
end of the k-th launch's `call` span (fftlab_torch's recorder,
`cellbench.program_spans`). Nothing unless the device operations and the
launches pair by order and name."""

from cellbench import program_spans


def read(record):
    ps = program_spans.read(record)
    if ps is None or record.slice.window_us <= 0:
        return None
    idle = program_spans.host_bound_idle_us(record.slice, ps.launches)
    return None if idle is None else 100.0 * idle / record.slice.window_us
