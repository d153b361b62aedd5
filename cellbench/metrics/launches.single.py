"""launches.single: kernel launches per call, the sum of the kernel
wrappers' LAUNCHES counters over the traced run's window (read before
and after it), over the calls in it."""


def read(record):
    if not record.calls:
        return None
    return sum(record.launches.values()) / record.calls
