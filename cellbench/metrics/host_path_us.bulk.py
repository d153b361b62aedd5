"""host_path_us.bulk: the program's host path a call, in microseconds:
the median over the profiled slice's calls of the program's own root
span `execute` (Plan.execute, or spectral_filter_auto; fftlab_torch's
recorder, on during the slice), placed on the trace's clock by
`cellbench.program_spans`. Nothing where the program records no spans or
its clock cannot be placed."""

from cellbench import program_spans


def read(record):
    ps = program_spans.read(record)
    return None if ps is None else program_spans.median([e - s for s, e in ps.roots])
