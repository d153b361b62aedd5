"""unpack_pct.bulk: the share of the profiled slice's device time (its
device operations summed) taken by the r2c's Hermitian unpack, the
operations whose short name (`trace.short_kernel_name`) starts with
`herm_unpack`, in %. 0 where the r2c ran no separate unpack; nothing
where the slice has no device operation."""

UNPACK = "herm_unpack"


def read(record):
    ops = record.slice.device_ops if record.slice else None
    if not ops:
        return None
    total = sum(f - s for _, s, f in ops)
    unpack = sum(f - s for name, s, f in ops if name.startswith(UNPACK))
    return 100.0 * unpack / total if total > 0 else None
