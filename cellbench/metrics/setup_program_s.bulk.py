"""setup_program_s.bulk: the program's own set-up in a run, in seconds:
fftlab_torch's set-up spans with no set-up parent, summed (its import,
the kernel library's digest, build and load, each table built, each plan
made; `cellbench.program_spans`). Read in a traced run, where the slice
holds the harness's spans; nothing where the program records no set-up
spans."""

from cellbench import program_spans


def read(record):
    mod = program_spans.recorder()
    if record.slice is None or not record.slice.host_spans or mod is None:
        return None
    setup = getattr(mod, "setup_spans", None)
    return program_spans.setup_roots_s(setup()) if callable(setup) else None
