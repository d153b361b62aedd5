"""fftlab_torch.dist.multihost, as tests/test_multihost.py tests the JAX
package's: two OS processes join one world through
`ensure_initialized(coordinator_address="file://...", 2, rank,
backend="gloo", device_type="cpu")` and run the halo-exchange
overlap-save filter and the PP pipeline across the process boundary
(tests/_torch_dist_worker.py, suite "multihost"). Each result is held
against a float64 numpy oracle (>= 100 dB FIR, >= 110 dB PP) and against
the JAX function on 2 of conftest's virtual devices (>= 110 dB).
"""

import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch.distributed as dist
from jax.sharding import Mesh

from _torch_dist_worker import ROOT, rank_env, run_ranks
from _torch_parity import snr_db
from fftlab.dist.overlap_save_split import overlap_save_filter_sharded_split as jx_os
from fftlab.dist.pp_pipeline import pp_spectral_pipeline_split as jx_pp
from fftlab_torch.dist import multihost

GATE = 110.0
GATE_FIR = 100.0


@pytest.fixture(scope="module")
def res(tmp_path_factory):
    try:
        res = run_ranks("multihost", 2, tmp_path_factory.mktemp("multihost"))
    except RuntimeError as e:
        pytest.fail(str(e))
    if "two_process/error" in res:
        pytest.fail(f"the ranks raised:\n{res['two_process/error']}")
    return {k.split("/", 1)[1]: v for k, v in res.items()}


@pytest.fixture(scope="module")
def sp2():
    return Mesh(np.asarray(jax.devices()[:2]).reshape(2), ("sp",))


def test_two_processes_joined(res):
    assert int(res["process_count"]) == 2
    assert int(res["global_devices"]) == 2
    assert tuple(res["axes"]) == (1, 2)  # one host: dp 1, sp over its ranks


def test_two_process_overlap_save_parity(res, sp2):
    x, h = res["x"], res["h"].astype(np.float64)
    assert tuple(res["block_shape"]) == (2048,)
    want = (np.convolve(x.real.astype(np.float64), h)[:4096]
            + 1j * np.convolve(x.imag.astype(np.float64), h)[:4096])
    assert snr_db(res["y"], want) >= GATE_FIR
    seam = slice(2048 - 64, 2048 + 64)
    assert snr_db(res["y"][seam], want[seam]) >= GATE_FIR
    jr, ji = jx_os(x.real.astype(np.float32), x.imag.astype(np.float32),
                   res["h"], sp2)
    assert snr_db(res["y"], np.asarray(jr) + 1j * np.asarray(ji)) >= GATE


def test_two_process_pp_parity(res, sp2):
    b, H = res["b"], res["H"]
    want = np.fft.ifft(np.fft.fft(b.astype(np.complex128), axis=-1) * H, axis=-1)
    assert snr_db(res["pp"], want) >= GATE
    jr, ji = jx_pp(b.real.astype(np.float32), b.imag.astype(np.float32),
                   H.real.astype(np.float32), H.imag.astype(np.float32), sp2,
                   axis_name="sp")
    assert snr_db(res["pp"], np.asarray(jr) + 1j * np.asarray(ji)) >= GATE


def test_single_process_is_a_no_op(monkeypatch):
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    assert multihost.ensure_initialized() is False
    assert multihost.ensure_initialized("file:///nonexistent", num_processes=1) is False
    assert not dist.is_initialized()
    assert multihost.process_info() == {"process_index": 0, "process_count": 1,
                                        "local_devices": 1, "global_devices": 1}
    assert multihost.host_local_mesh_axes() == {"dp": 1, "sp": 1}


def test_nccl_refused_where_it_cannot_run(monkeypatch):
    """NCCL on a CPU mesh, or more ranks on a host than cards, raises
    before any process group starts; gloo is never picked silently."""
    with pytest.raises(ValueError, match="gloo"):
        multihost.check_backend("nccl", "cpu", 1)
    monkeypatch.setattr(multihost.torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="backend='gloo'"):
        multihost.check_backend("nccl", "cuda", 2)
    multihost.check_backend("gloo", "cuda", 2)
    multihost.check_backend("nccl", "cuda", 1)
    assert not dist.is_initialized()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("start", ["spawn", "torchrun"])
def test_dist_demo_runs_the_jax_demos_checks(capsys, start):
    """`python -m fftlab_torch.cli.dist_demo --ranks 8 --device cpu`, and
    the same under torchrun with 8 ranks, print the JAX demo's lines on 8
    virtual devices (the counts and sizes alike), each error at float32's
    scale."""
    from fftlab.cli import dist_demo as jx_demo

    demo = ["-m", "fftlab_torch.cli.dist_demo", "--device", "cpu"]
    argv = (demo + ["--ranks", "8"] if start == "spawn" else
            ["-m", "torch.distributed.run", "--nproc-per-node", "8", "--master-port",
             str(_free_port())] + demo)
    proc = subprocess.run([sys.executable] + argv, cwd=ROOT, env=rank_env(),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    jx_demo.main()
    theirs = capsys.readouterr().out.strip().splitlines()
    ours = proc.stdout.strip().splitlines()
    assert ours[0] == "8 device(s): cpu (gloo)" and theirs[0] == "8 device(s): cpu"
    # every check line ends in its max error
    assert [line.rsplit(" ", 1)[0] for line in ours[1:]] == \
        [line.rsplit(" ", 1)[0] for line in theirs[1:]]
    assert len(ours) == 6
    assert all(float(line.rsplit(" ", 1)[1]) < 1e-3 for line in ours[1:])
