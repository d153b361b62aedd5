"""pass_a_roofline.bulk: pass A of the three-pass c2c (pass 1 at (L1, L2)
= (256, 65536), its twiddle in rank-1 form) as a share of its roofline,
in %. The least time of a pass that reads the call's planes once and
writes them once (the call's bytes, `work/<kind>.py`, over the card's
memory rate in peaks.json: 268,435,456 B at 2^24, 0.0801 ms on the
H100; the pass's flops take far less) over the device time a call of
the profiled slice's operations named `fourstep_pass1_kernel<0, 8>`
(`trace.short_kernel_name`: mode 0, the plain load, and log2 L1 = 8;
the name the H100's profiler trace gives), summed over the slice's
calls. Nothing where the slice has no such operation or the card has no
row in peaks.json."""

KERNEL = "fourstep_pass1_kernel<0, 8>"


def read(record):
    ops = record.slice.device_ops if record.slice else None
    if not ops or not record.peaks or record.slice.calls <= 0:
        return None
    us = sum(f - s for name, s, f in ops if name == KERNEL) / record.slice.calls
    if us <= 0:
        return None
    return 100.0 * record.work["bytes"] / record.peaks["bytes_per_s"] * 1e6 / us
