"""launch_call_us.bulk: the time of one kernel launch's `call` span, in
microseconds: the median over the profiled slice's launches of the span
around the device guard, the stream, the ctypes entry and its error
check (fftlab_torch's recorder, `cellbench.program_spans`), the floor no
trimming of the wrappers' Python removes. Nothing where the program
records no launches or its clock cannot be placed."""

from cellbench import program_spans


def read(record):
    ps = program_spans.read(record)
    if ps is None:
        return None
    return program_spans.median([ln.call_end - ln.call_start for ln in ps.launches])
