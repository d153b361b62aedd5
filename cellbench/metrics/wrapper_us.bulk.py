"""wrapper_us.bulk: the kernel wrappers' own time a call, in
microseconds: the median over the profiled slice's calls of the sum,
over the call's kernel launches, of the launch span less its `call`
child (the checks, the allocation and the table lookup; fftlab_torch's
recorder, `cellbench.program_spans`). Nothing where the program records
no launches or its clock cannot be placed."""

from cellbench import program_spans


def read(record):
    ps = program_spans.read(record)
    if ps is None or not ps.launches:
        return None
    return program_spans.median(
        ps.per_call(lambda ln: (ln.end - ln.start) - (ln.call_end - ln.call_start)))
