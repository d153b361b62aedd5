"""Distributed execution over a `torch.distributed` DeviceMesh
(counterpart of fftlab/dist/): one process per rank, each driving one
device, every rank calling the same function with the same whole input
(`mesh.py` states the contract).

- ``mesh``         meshes of ranks, each rank's block, `gather`
- ``comm``         the collectives: all_to_all, shift, psum, gather,
                   broadcast, for NCCL and gloo
- ``multihost``    joining the process group (torchrun's or explicit)
- ``four_step``    one large transform split over ranks with an
                   all_to_all transpose (`four_step_split` on the kernels)
- ``fft2_sharded`` / ``fft2_mesh2d``  2-D transforms over one or both
                   axes of a mesh
- ``overlap_save`` / ``overlap_save_split``  streaming FIR with time
                   blocks split over ranks and a halo exchange
- ``welch``, ``stft``  segment- and frame-sharded spectra
- ``tp_pipeline``  gather-free sharded FFT -> H -> IFFT
- ``pp_pipeline``  window/FFT/xH/IFFT as pipeline stages over ranks
"""

from fftlab_torch.dist.fft2_sharded import fft2_sharded_split
from fftlab_torch.dist.four_step import four_step_fft, four_step_fft_sharded
from fftlab_torch.dist.four_step_split import four_step_fft_sharded_split
from fftlab_torch.dist.mesh import gather, make_mesh, make_mesh_1d, replicate, shard_batch
from fftlab_torch.dist.overlap_save import overlap_save_filter_sharded
from fftlab_torch.dist.overlap_save_split import overlap_save_filter_sharded_split
from fftlab_torch.dist.pp_pipeline import pp_spectral_pipeline_split
from fftlab_torch.dist.stft import stft_sharded
from fftlab_torch.dist.tp_pipeline import tp_spectral_filter_split
from fftlab_torch.dist.welch import welch_psd_sharded

__all__ = [
    # fftlab.dist.__all__, in its order
    "make_mesh_1d",
    "shard_batch",
    "four_step_fft",
    "four_step_fft_sharded",
    "four_step_fft_sharded_split",
    "fft2_sharded_split",
    "overlap_save_filter_sharded_split",
    "overlap_save_filter_sharded",
    "pp_spectral_pipeline_split",
    "tp_spectral_filter_split",
    "welch_psd_sharded",
    "stft_sharded",
    # the mesh helpers of fftlab.dist.mesh, and the port's gather
    "make_mesh",
    "replicate",
    "gather",
]
