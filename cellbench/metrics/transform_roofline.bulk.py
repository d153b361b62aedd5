"""transform_roofline.bulk: the transform's least time on the card (its
bytes over the card's memory rate or its flops over its float32 rate,
whichever is longer; `work/<kind>.py` and peaks.json) as a share of the
device time of one call (the profiled slice's device operations summed,
over its calls), in %. Nothing where the card has no row in peaks.json
or the trace has no device operation."""

from cellbench import trace


def read(record):
    dev_us = trace.device_us_per_call(record.slice) if record.slice else None
    if not dev_us or not record.peaks:
        return None
    least_s = max(record.work["bytes"] / record.peaks["bytes_per_s"],
                  record.work["flops"] / record.peaks["flops_per_s"])
    return 100.0 * least_s * 1e6 / dev_us
