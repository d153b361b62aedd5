"""Overlapping frames (counterpart of fftlab/core/framing.py:89-108).

frames[k] = x[k*hop : k*hop + frame_size], built as one `unfold` view of
the signal after a pad or cut to the span the frames need. The JAX
package chooses between gather, patches and slices because only some of
them compile for its TPU; a strided view needs none of that.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def frame_signal_strided(x: torch.Tensor, frame_size: int, hop: int,
                         n_frames: int) -> torch.Tensor:
    """[..., total] -> [..., n_frames, frame_size] with frames starting at
    k*hop. `x` may be shorter (zero-extended) or longer (excess ignored)
    than the span the frames need."""
    if hop <= 0 or frame_size <= 0:
        raise ValueError(f"bad framing: frame={frame_size}, hop={hop}")
    need = (n_frames - 1) * hop + frame_size
    total = int(x.shape[-1])
    x = F.pad(x, (0, need - total)) if total < need else x[..., :need]
    return x.unfold(-1, frame_size, hop)


def frames_needed(total: int, frame_size: int, hop: int) -> int:
    """Frame count for 'valid' framing: floor((total - frame)/hop) + 1."""
    return max((total - frame_size) // hop + 1, 1)
