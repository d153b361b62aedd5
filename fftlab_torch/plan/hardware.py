"""Device capability report (counterpart of fftlab/plan/hardware.py:38-58).

Reads `torch.cuda.get_device_properties`; on a machine without a CUDA
card it reports the CPU. Routing does not read it: the port's routes
depend on n only (plan/dispatch.py).
"""

from __future__ import annotations

import dataclasses
import platform as _platform

import torch


@dataclasses.dataclass(frozen=True)
class HardwareCaps:
    platform: str  # 'gpu' | 'cpu'
    device_name: str
    num_devices: int
    sm_count: int | None
    smem_per_block_bytes: int | None  # opt-in dynamic shared memory limit
    l2_bytes: int | None
    memory_bytes: int | None

    def summary(self) -> str:
        return (
            f"platform={self.platform} device={self.device_name!r} "
            f"devices={self.num_devices} sms={self.sm_count} "
            f"smem/block={self.smem_per_block_bytes} l2={self.l2_bytes} "
            f"mem={self.memory_bytes}"
        )


def detect_hardware(device: int = 0) -> HardwareCaps:
    if not torch.cuda.is_available():
        return HardwareCaps("cpu", _platform.processor() or "cpu", 1,
                            None, None, None, None)
    p = torch.cuda.get_device_properties(device)
    smem = getattr(p, "shared_memory_per_block_optin", None)
    if smem is None:
        smem = getattr(p, "shared_memory_per_block", None)
    return HardwareCaps(
        platform="gpu",
        device_name=p.name,
        num_devices=torch.cuda.device_count(),
        sm_count=p.multi_processor_count,
        smem_per_block_bytes=smem,
        l2_bytes=getattr(p, "L2_cache_size", None),
        memory_bytes=p.total_memory,
    )


def print_hardware_info() -> None:
    """Print the report of the card (or of the CPU, where there is none)."""
    print(detect_hardware().summary())
