"""fftlab_torch's CUDA kernels on the card: each kernel against its plain
version and a float64 oracle, the launch counts of the main paths (the
FFT, the spectral filter, the real-signal path and the huge-n path), the
kernels' adjoints, and the wrappers' refusals. Every test
here needs a CUDA card and skips without one.

This file imports neither jax nor fftlab, so it runs where JAX is not
installed. On the machine with the card, from the repo root:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Gates: kernel vs plain version >= 110 dB SNR; kernel vs the float64
oracle >= 120 dB (two-pass, and the two-pass sandwich) or >= 110 dB
(rows, and the row sandwich), the JAX suite's gates
(tests/test_resident_vmem.py:37, tests/test_kernels.py:39); the
overlap-save filter >= 100 dB against np.convolve (bench.py's serving
gate, :515-526); Bluestein >= 95 dB (tests/test_split.py:272); a stream
within 2e-4 of the whole-signal call (tests/test_filter_plan.py:75-89);
the real-signal kernels >= 110 dB against np.fft.rfft / irfft and a
float64 framed STFT, the pack and interleave bit-exact (a copy); the
three-pass FFT >= 120 dB and a fused stage or the stage pipeline
>= 115 dB against float64 (tests/test_stage_fused.py:31).
The plain versions run with TF32 off: TF32 matmuls would cost about
60 dB."""

import numpy as np
import pytest
import torch

import fftlab_torch
from _torch_parity import (CASE_IDS, CASES, cplx, hide_nvcc, oracle, planes,
                           requires_cuda, snr_db, tt, whole_scale)
from fftlab_torch.dsp import convolution
from fftlab_torch.kernels import (_build, fft_vmem, fourstep_vmem, os_filter_vmem,
                                  rfft_resident, rfft_vmem, stage_fused, stft_vmem,
                                  threestep_vmem)
from fftlab_torch.plan import hardware

pytestmark = requires_cuda


def _cuda_pair(seed, shape):
    xr, xi = planes(seed, shape)
    return tt(xr, "cuda"), tt(xi, "cuda")


@pytest.fixture
def no_tf32():
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def test_detect_hardware_gpu():
    caps = hardware.detect_hardware()
    assert caps.platform == "gpu"
    assert caps.device_name == torch.cuda.get_device_name(0)
    assert caps.sm_count > 0 and caps.smem_per_block_bytes >= 128 * 1024
    assert caps.l2_bytes > 0


@pytest.mark.parametrize("n", [1024, 8192, 16384])
@pytest.mark.parametrize("direction,scale", CASES, ids=CASE_IDS)
def test_fft_rows_matches_plain(no_tf32, n, direction, scale):
    xr, xi = _cuda_pair(n, (8, n))
    eff = whole_scale(n, direction, scale)
    before = fft_vmem.LAUNCHES["fft_rows"]
    got = cplx(*fft_vmem.fft_rows(xr, xi, direction, eff))
    assert fft_vmem.LAUNCHES["fft_rows"] == before + 1
    plain = cplx(*fft_vmem.fft_rows_plain(xr, xi, direction, eff))
    assert snr_db(got, plain) >= 110.0
    assert snr_db(got, oracle(xr.cpu(), xi.cpu(), direction, eff)) >= 110.0


@pytest.mark.parametrize("n", [1 << 15, 1 << 18, 1 << 21])
@pytest.mark.parametrize("direction,scale", CASES, ids=CASE_IDS)
def test_two_pass_matches_plain(no_tf32, n, direction, scale):
    xr, xi = _cuda_pair(n % 97, (2, n))
    eff = whole_scale(n, direction, scale)
    mid = fourstep_vmem.fourstep_pass1(xr, xi, direction)
    mid_plain = fourstep_vmem.fourstep_pass1_plain(xr, xi, direction)
    assert snr_db(cplx(*mid), cplx(*mid_plain)) >= 110.0
    got = cplx(*fourstep_vmem.fourstep_pass2(*mid, direction, eff))
    plain = cplx(*fourstep_vmem.fourstep_pass2_plain(*mid, direction, eff))
    assert snr_db(got, plain) >= 110.0
    assert snr_db(got, oracle(xr.cpu(), xi.cpu(), direction, eff)) >= 120.0


@pytest.mark.parametrize("n,route,kernels", [
    (16384, "smem_rows", ("fft_rows",)),
    (1 << 20, "two_pass", ("fourstep_pass1", "fourstep_pass2"))])
def test_slice_launches_kernels(n, route, kernels):
    xr, xi = planes(n, (4, n))
    before = {**fft_vmem.LAUNCHES, **fourstep_vmem.LAUNCHES}
    plan = fftlab_torch.plan_dft_1d_split(n, batch=4)
    yr, yi = plan.execute((tt(xr, "cuda"), tt(xi, "cuda")))
    after = {**fft_vmem.LAUNCHES, **fourstep_vmem.LAUNCHES}
    assert plan.algorithm == route and yr.device.type == "cuda"
    for k in kernels:
        assert after[k] == before[k] + 1
    gate = 110.0 if route == "smem_rows" else 120.0
    assert snr_db(cplx(yr, yi), oracle(xr, xi, -1)) >= gate


def _launches():
    return {**fft_vmem.LAUNCHES, **fourstep_vmem.LAUNCHES, **os_filter_vmem.LAUNCHES,
            **rfft_vmem.LAUNCHES, **stft_vmem.LAUNCHES, **threestep_vmem.LAUNCHES,
            **stage_fused.LAUNCHES}


def _sandwich_oracle(xr, xi, hr, hi):
    z = np.asarray(xr.cpu(), np.float64) + 1j * np.asarray(xi.cpu(), np.float64)
    h = np.asarray(hr.cpu(), np.float64) + 1j * np.asarray(hi.cpu(), np.float64)
    return np.fft.ifft(np.fft.fft(z) * h)


@pytest.mark.parametrize("n", [512, 1024, 2048, 4096, 8192, 16384])
def test_filter_rows_matches_plain(no_tf32, n):
    xr, xi = _cuda_pair(n, (8, n))
    hr, hi = _cuda_pair(n + 1, (n,))
    before = fft_vmem.LAUNCHES["filter_rows"]
    got = cplx(*fft_vmem.filter_rows(xr, xi, hr, hi))
    assert fft_vmem.LAUNCHES["filter_rows"] == before + 1
    plain = cplx(*fft_vmem.spectral_filter_rows_plain(xr, xi, hr, hi))
    assert snr_db(got, plain) >= 110.0
    assert snr_db(got, _sandwich_oracle(xr, xi, hr, hi)) >= 110.0


# one two-pass sandwich: pass 1, pass 2's sandwich mode, the inverse pass 1
SANDWICH_LAUNCHES = {"fourstep_pass1": 2, "fourstep_pass2_sandwich": 1, "fourstep_pass2": 0}


@pytest.mark.parametrize("B,n", [(64, 1 << 15), (16, 1 << 20), (4, 1 << 21)])
def test_two_pass_sandwich_matches_plain(no_tf32, B, n):
    """The sandwich mode in place against its plain version, and the three
    launches against theirs and float64, at chip_smoke.py's shapes."""
    xr, xi = _cuda_pair(n % 89, (B, n))
    hr, hi = _cuda_pair(n % 83, (n,))
    mid = fourstep_vmem.fourstep_pass1(xr, xi)
    plain2 = cplx(*fourstep_vmem.fourstep_pass2_sandwich_plain(*mid, hr, hi))
    got2 = fourstep_vmem.fourstep_pass2_sandwich(*mid, hr, hi)
    assert got2[0] is mid[0] and got2[1] is mid[1]  # in place
    assert snr_db(cplx(*got2), plain2) >= 110.0
    before = _launches()
    got = cplx(*fourstep_vmem.spectral_filter_large(xr, xi, hr, hi))
    after = _launches()
    assert {k: after[k] - before[k] for k in SANDWICH_LAUNCHES} == SANDWICH_LAUNCHES
    plain = cplx(*fourstep_vmem.spectral_filter_large_plain(xr, xi, hr, hi))
    assert snr_db(got, plain) >= 110.0
    assert snr_db(got, _sandwich_oracle(xr, xi, hr, hi)) >= 120.0


@pytest.mark.parametrize("nh,fft_size", [(9, 2048), (129, 16384), (1025, 16384),
                                         (1025, 2048), (1, 1024)])
def test_os_filter_matches_plain(no_tf32, nh, fft_size):
    C, n = 2, 200003
    xr, xi = _cuda_pair(nh, (C, n))
    h = np.random.default_rng(nh).standard_normal(nh) / nh
    before = os_filter_vmem.LAUNCHES["os_filter"]
    got = os_filter_vmem.pallas_os_filter_split(xr, xi, h, fft_size=fft_size)
    assert os_filter_vmem.LAUNCHES["os_filter"] == before + 1
    hr, hi = (torch.from_numpy(a).cuda()
              for a in os_filter_vmem.os_response_np(h, fft_size))
    plain = os_filter_vmem.os_filter_plain(xr, xi, hr, hi, nh)
    assert snr_db(cplx(*got), cplx(*plain)) >= 110.0
    want = [np.stack([np.convolve(row, h)[:n] for row in np.asarray(x.cpu(), np.float64)])
            for x in (xr, xi)]
    assert snr_db(cplx(*got), want[0] + 1j * want[1]) >= 100.0


def _os_frame_choices():
    """(fft_size, T): every frame size of the kernel at its default T, and
    1K frames also at the other T of chip_smoke.py's A/B."""
    sizes = (512, 1024, 2048, 4096, 8192, 16384)
    return [(f, os_filter_vmem.frames_per_block(f)) for f in sizes] + [(1024, 2), (1024, 8)]


@pytest.mark.parametrize("fft_size,T", _os_frame_choices())
@pytest.mark.parametrize("offset", [0, 1, 2, 3])
def test_os_filter_at_every_frame_size(no_tf32, fft_size, T, offset):
    """The span kernel at each frame size and T, with 1, 9, 129 and 1025
    taps where the halo fits the frame, on C = 2 channels whose planes
    start `offset` floats into a larger buffer (the span's lead) and whose
    rows start at odd offsets from one another; a ragged last block."""
    C = 2
    counts = {"os_filter": 0}
    taps = [nh for nh in (1, 9, 129, 1025) if nh - 1 < fft_size]
    for nh in taps:
        hop = fft_size - (nh - 1)
        n = 3 * T * hop + 777
        xr, xi = _cuda_pair(nh + offset, (C * n + 4,))
        xr = xr[offset:offset + C * n].view(C, n)
        xi = xi[3 - offset:3 - offset + C * n].view(C, n)
        h = np.random.default_rng(nh).standard_normal(nh) / nh
        hr, hi = (torch.from_numpy(a).cuda() for a in os_filter_vmem.os_response_np(h, fft_size))
        got = os_filter_vmem._launch_os(xr, xi, hr, hi, nh, T, counts)
        plain = os_filter_vmem.os_filter_plain(xr, xi, hr, hi, nh)
        assert snr_db(cplx(*got), cplx(*plain)) >= 110.0, nh
        want = [np.stack([np.convolve(row, h)[:n] for row in np.asarray(x.cpu(), np.float64)])
                for x in (xr, xi)]
        assert snr_db(cplx(*got), want[0] + 1j * want[1]) >= 100.0, nh
    assert counts["os_filter"] == len(taps)


@pytest.mark.parametrize("n,kernels", [
    (16384, {"filter_rows": 1}), (1 << 15, SANDWICH_LAUNCHES), (1 << 20, SANDWICH_LAUNCHES),
    (1 << 21, SANDWICH_LAUNCHES)])
def test_filter_path_launches_kernels(no_tf32, n, kernels):
    xr, xi = _cuda_pair(n, (4, n))
    hr = torch.randn(n, device="cuda")
    before = _launches()
    yr, yi = fftlab_torch.spectral_filter_auto(xr, xi, hr, torch.zeros_like(hr))
    after = _launches()
    assert {k: after[k] - before[k] for k in kernels} == kernels
    gate = 110.0 if n == 16384 else 120.0
    assert snr_db(cplx(yr, yi), _sandwich_oracle(xr, xi, hr, torch.zeros_like(hr))) >= gate


def test_profiled_calls_record_their_launches(no_tf32):
    """Under a torch.profiler profile of CUDA activity alone (the
    benchmark's traced slice), the recorder is on: a two-pass c2c call and
    a sandwich call each give execute -> dispatch -> wrapper, one launch
    span a LAUNCHES count with the children checks, alloc, tables and call
    in order, end to end, and self times that add up to the root."""
    from torch.profiler import ProfilerActivity, profile

    from fftlab_torch.utils import trace

    n = 1 << 20
    xr, xi = _cuda_pair(39, (4, n))
    hr, hi = _cuda_pair(40, (n,))
    plan = fftlab_torch.plan_dft_1d_split(n)
    plan.execute((xr, xi))
    fftlab_torch.spectral_filter_auto(xr, xi, hr, hi)
    torch.cuda.synchronize()
    trace.clear()
    before = _launches()
    with profile(activities=[ProfilerActivity.CUDA]):
        assert trace.on()
        got = plan.execute((xr, xi))
        fftlab_torch.spectral_filter_auto(xr, xi, hr, hi)
        torch.cuda.synchronize()
    assert not trace.on()
    delta = {k: v - before[k] for k, v in _launches().items() if v != before[k]}
    assert delta == {"fourstep_pass1": 3, "fourstep_pass2": 1, "fourstep_pass2_sandwich": 1}
    assert snr_db(cplx(*got), oracle(xr.cpu(), xi.cpu(), -1)) >= 120.0
    spans = trace.spans()
    kids = lambda i: [j for j, s in enumerate(spans) if s[3] == i]  # noqa: E731
    launches = [i for i, s in enumerate(spans) if s[0] in delta]
    assert [spans[i][0] for i in launches] == [
        "fourstep_pass1", "fourstep_pass2", "fourstep_pass1", "fourstep_pass2_sandwich",
        "fourstep_pass1"]
    for i in launches:
        ch = kids(i)
        assert [spans[j][0] for j in ch] == list(trace.PHASES)
        assert spans[ch[0]][1] == spans[i][1] and spans[ch[-1]][2] == spans[i][2]
        assert all(spans[a][2] == spans[b][1] for a, b in zip(ch, ch[1:]))
        assert spans[spans[i][3]][0] == "wrapper"
    roots = [i for i, s in enumerate(spans) if s[3] < 0]
    assert [spans[i][0] for i in roots] == ["execute", "execute"]
    for r in roots:
        call = [i for i, s in enumerate(spans) if s[4] == spans[r][4]]
        assert [spans[i][0] for i in call[:3]] == ["execute", "dispatch", "wrapper"]
        self_ns = sum((spans[i][2] - spans[i][1]) - sum(spans[j][2] - spans[j][1]
                                                        for j in kids(i)) for i in call)
        assert self_ns == spans[r][2] - spans[r][1]
        assert all(spans[spans[i][3]][1] <= spans[i][1] and
                   spans[i][2] <= spans[spans[i][3]][2] for i in call if i != r)


def test_bluestein_launches_the_sandwich(no_tf32):
    n = 500009
    xr, xi = planes(n, (2, n))
    before = _launches()
    yr, yi = fftlab_torch.fft_split_auto(tt(xr, "cuda"), tt(xi, "cuda"))
    after = _launches()
    assert {k: after[k] - before[k] for k in SANDWICH_LAUNCHES} == SANDWICH_LAUNCHES
    assert snr_db(cplx(yr, yi), oracle(xr, xi, -1)) >= 95.0
    br, bi = fftlab_torch.fft_split_auto(yr, yi, fftlab_torch.INVERSE)
    assert snr_db(cplx(br, bi), xr + 1j * xi.astype(np.float64)) >= 95.0


def test_filter_plan_on_the_card(no_tf32):
    rng = np.random.default_rng(5)
    h = rng.standard_normal(129) / 129
    x = rng.standard_normal(1 << 20).astype(np.float32)
    plan = fftlab_torch.FilterPlan(h, device="cuda")
    before = os_filter_vmem.LAUNCHES["os_filter"]
    whole = plan(x)
    assert os_filter_vmem.LAUNCHES["os_filter"] > before
    assert whole.device.type == "cuda"
    m = 1 << 17
    want = np.convolve(x[:m].astype(np.float64), h)[:m]
    assert snr_db(whole[:m].cpu().numpy(), want) >= 100.0
    cuts = (0, 1000, 1001, 70000, 500000, 1 << 20)
    streamed = torch.cat([plan.stream(x[a:b]) for a, b in zip(cuts, cuts[1:])])
    assert float((streamed - whole).abs().max()) <= 2e-4


def test_sandwich_wrappers_refuse():
    x64 = torch.zeros(2, 1 << 15, dtype=torch.float64, device="cuda")
    x = torch.zeros(2, 1 << 15, device="cuda")
    h = torch.zeros(1 << 15, device="cuda")
    with pytest.raises(TypeError, match="float32"):
        fourstep_vmem.spectral_filter_large(x64, x64, h, h)
    with pytest.raises(TypeError, match="float32"):
        fourstep_vmem.fourstep_pass2_sandwich(x, x, h.double(), h.double())
    with pytest.raises(ValueError, match="H as"):
        fourstep_vmem.fourstep_pass2_sandwich(x, x, h[:1024], h[:1024])
    with pytest.raises(TypeError, match="float32"):
        fourstep_vmem.fourstep_pass2_sandwich(x64, x64, h, h)
    x8 = torch.zeros(2, 8192, device="cuda")
    x256 = torch.zeros(2, 256, device="cuda")
    with pytest.raises(ValueError, match="H as"):
        fft_vmem.filter_rows(x8, x8, h, h)
    with pytest.raises(ValueError, match="512, 16384"):
        fft_vmem.filter_rows(x256, x256, h[:256], h[:256])
    with pytest.raises(ValueError, match="CUDA"):
        fft_vmem.filter_rows(x8, x8, h[:8192].cpu(), h[:8192].cpu())
    with pytest.raises(ValueError, match="contiguous"):
        fft_vmem.filter_rows(x[:, ::4], x[:, ::4], h[:8192], h[:8192])
    with pytest.raises(ValueError, match="too long"):
        os_filter_vmem.pallas_os_filter_split(x, x, np.ones(2000), fft_size=1024)
    with pytest.raises(ValueError, match="nh <= fft_size"):
        os_filter_vmem.os_filter(x, x, h[:1024], h[:1024], 2000)


def test_wrappers_refuse_without_casting():
    x64 = torch.zeros(2, 1 << 15, dtype=torch.float64, device="cuda")
    with pytest.raises(TypeError, match="float32"):
        fourstep_vmem.fft_split_large(x64, x64)
    xt = torch.zeros(1 << 15, 2, device="cuda").T  # non-contiguous
    with pytest.raises(ValueError, match="contiguous"):
        fourstep_vmem.fourstep_pass1(xt, xt)
    with pytest.raises(ValueError, match="contiguous"):
        fft_vmem.fft_rows(xt[:, :8192], xt[:, :8192])


def _real(seed, shape):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return x, tt(x, "cuda")


def test_pack_and_interleave_are_copies():
    x, xc = _real(1, (4, 1 << 16))
    before = _launches()
    zr, zi = rfft_vmem.pack_real(xc)
    back = rfft_vmem.interleave(zr, zi)
    after = _launches()
    assert after["pack_real"] == before["pack_real"] + 1
    assert after["interleave"] == before["interleave"] + 1
    assert np.array_equal(zr.cpu().numpy(), x[:, 0::2])
    assert np.array_equal(zi.cpu().numpy(), x[:, 1::2])
    assert np.array_equal(back.cpu().numpy(), x)


@pytest.mark.parametrize("m", [2, 6, 1 << 12, 1 << 20])
def test_herm_unpack_and_repack_match_plain(m):
    x, xc = _real(m, (3, 2 * m))
    z = x[:, 0::2].astype(np.float64) + 1j * x[:, 1::2]
    Z = np.fft.fft(z, axis=-1)
    zr, zi = tt(Z.real.astype(np.float32), "cuda"), tt(Z.imag.astype(np.float32), "cuda")
    got = cplx(*rfft_vmem.herm_unpack(zr, zi, 0.5))
    assert snr_db(got, cplx(*rfft_vmem.herm_unpack_plain(zr, zi, 2 * m, 0.5))) >= 110.0
    want = np.fft.rfft(x.astype(np.float64), axis=-1)
    assert snr_db(got, 0.5 * want) >= 110.0
    Xr, Xi = (tt(a.astype(np.float32), "cuda") for a in (want.real, want.imag))
    back = cplx(*rfft_vmem.herm_repack(Xr, Xi))
    assert snr_db(back, cplx(*rfft_vmem.herm_repack_plain(Xr, Xi))) >= 110.0
    assert snr_db(back, Z) >= 110.0


@pytest.mark.parametrize("n", [1 << 15, 1 << 20, 1 << 21])
@pytest.mark.parametrize("direction", [-1, 1])
def test_packed_and_interleaved_passes_match_plain(no_tf32, n, direction):
    x, xc = _real(n % 91, (2, 2 * n))
    mid = fourstep_vmem.fourstep_pass1_packed(xc, direction)
    mid_plain = fourstep_vmem.fourstep_pass1_packed_plain(xc, direction)
    assert snr_db(cplx(*mid), cplx(*mid_plain)) >= 110.0
    y = fourstep_vmem.fourstep_pass2_interleaved(*mid, direction, 0.5)
    y_plain = fourstep_vmem.fourstep_pass2_interleaved_plain(*mid, direction, 0.5)
    assert y.shape == (2, 2 * n)
    assert snr_db(y.cpu().numpy(), y_plain.cpu().numpy()) >= 110.0
    z = oracle(x[:, 0::2], x[:, 1::2], direction, 0.5)
    want = np.stack([z.real, z.imag], axis=-1).reshape(2, 2 * n)
    assert snr_db(y.cpu().numpy(), want) >= 110.0


@pytest.mark.parametrize("n", [1 << 16, 1 << 21])
def test_fused_real_transforms_match_plain(no_tf32, n):
    x, xc = _real(n % 89, (4, n))
    before = _launches()
    Xr, Xi = rfft_resident.rfft_resident(xc, scale=0.5)
    mid = _launches()
    y = rfft_resident.irfft_resident(Xr, Xi, scale=2.0)
    after = _launches()
    assert [mid[k] - before[k] for k in
            ("fourstep_pass1_packed", "fourstep_pass2", "herm_unpack")] == [1, 1, 1]
    assert [after[k] - mid[k] for k in
            ("herm_repack", "fourstep_pass1", "fourstep_pass2_interleaved")] == [1, 1, 1]
    got = cplx(Xr, Xi)
    assert snr_db(got, cplx(*rfft_resident.rfft_resident_plain(xc, 0.5))) >= 110.0
    assert snr_db(got, 0.5 * np.fft.rfft(x.astype(np.float64), axis=-1)) >= 110.0
    assert snr_db(y.cpu().numpy(),
                  rfft_resident.irfft_resident_plain(Xr, Xi, 2.0).cpu().numpy()) >= 110.0
    assert snr_db(y.cpu().numpy(), x.astype(np.float64)) >= 110.0


@pytest.mark.parametrize("n,algorithm,kernels", [
    (1 << 21, "rfft_resident", ("fourstep_pass1_packed", "herm_unpack")),
    (1 << 22, "rfft_split[two_pass]", ("pack_real", "fourstep_pass1", "herm_unpack")),
    (16384, "rfft_split[smem_rows]", ("pack_real", "fft_rows", "herm_unpack"))])
def test_real_plans_launch_kernels(no_tf32, n, algorithm, kernels):
    x, xc = _real(n % 83, (2, n))
    r2c = fftlab_torch.plan_r2c_1d_split(n, batch=2)
    c2r = fftlab_torch.plan_c2r_1d_split(n, batch=2)
    assert r2c.algorithm == algorithm and c2r.algorithm == "i" + algorithm
    before = _launches()
    X = r2c.execute(xc)
    after = _launches()
    for k in kernels:
        assert after[k] > before[k], k
    assert snr_db(cplx(*X), np.fft.rfft(x.astype(np.float64), axis=-1)) >= 110.0
    y = c2r.execute(X)
    assert _launches()["herm_repack"] > after["herm_repack"]
    assert snr_db(y.cpu().numpy(), x.astype(np.float64)) >= 110.0


@pytest.mark.parametrize("n", [1000, 8192])
def test_c2r_repack_runs_the_kernel(no_tf32, n):
    """Every c2r with an even half size repacks with `herm_repack` on the
    card, inside the pack window (8192) and outside it (1000)."""
    x, xc = _real(n, (3, n))
    X = fftlab_torch.rfft_split(xc)
    before = rfft_vmem.LAUNCHES["herm_repack"]
    y = fftlab_torch.irfft_split(*X, n=n)
    assert rfft_vmem.LAUNCHES["herm_repack"] == before + 1
    assert snr_db(cplx(*X), np.fft.rfft(x.astype(np.float64), axis=-1)) >= 110.0
    assert snr_db(y.cpu().numpy(), x.astype(np.float64)) >= 110.0


def _stft_oracle(x, fft_size, hop, n_frames, onesided):
    need = (n_frames - 1) * hop + fft_size
    xp = np.zeros(max(need, len(x)))
    xp[:len(x)] = x
    w = 0.5 * (1 - np.cos(2 * np.pi * np.arange(fft_size) / fft_size))
    frames = np.stack([xp[k * hop:k * hop + fft_size] * w for k in range(n_frames)])
    return np.fft.rfft(frames) if onesided else np.fft.fft(frames)


@pytest.mark.parametrize("fft_size,hop,n", [(2048, 512, 1 << 20), (256, 128, 1 << 20),
                                            (128, 128, 100003), (512, 256, 70001),
                                            (16384, 4096, 300001), (1024, 128, 99999),
                                            (4096, 1024, 200001), (8192, 2048, 250003)])
@pytest.mark.parametrize("onesided", [True, False], ids=["onesided", "twosided"])
def test_stft_frames_matches_plain(no_tf32, fft_size, hop, n, onesided):
    x, xc = _real(fft_size + n, n)
    before = stft_vmem.LAUNCHES["stft_frames"]
    got = fftlab_torch.stft_split(xc, fft_size, hop, onesided=onesided)
    assert stft_vmem.LAUNCHES["stft_frames"] == before + 1
    n_frames = max(-(-max(n - fft_size, 0) // hop) + 1, 1)
    w = stft_vmem.window_table("hann", fft_size, xc.device)
    plain = stft_vmem.stft_frames_plain(xc, fft_size, hop, w, n_frames, onesided)
    assert got[0].shape == plain[0].shape
    assert snr_db(cplx(*got), cplx(*plain)) >= 110.0
    assert snr_db(cplx(*got), _stft_oracle(x, fft_size, hop, n_frames, onesided)) >= 110.0


def _stft_frame_choices():
    """(fft_size, T): every frame size of the kernel window at every T the
    kernel takes (512..4096 values a block up to m = 1024, one frame
    above)."""
    out = []
    for fft_size in (128, 256, 512, 1024, 2048, 4096, 8192, 16384):
        m = fft_size // 2
        Ts = [1] if m > 1024 else [T for T in (1, 2, 4, 8, 16, 32, 64)
                                   if T > 1 and 512 <= T * m <= 4096]
        out += [(fft_size, T) for T in Ts]
    return out


@pytest.mark.parametrize("fft_size,T", _stft_frame_choices())
@pytest.mark.parametrize("offset", [0, 2], ids=["aligned", "offset8"])
def test_stft_frames_at_every_T(no_tf32, fft_size, T, offset):
    """The staged kernel at each frames-per-block choice, one- and
    two-sided, on a signal 16-byte aligned or 8 bytes past (the span's
    lead), with a ragged last block and frames past the signal's end."""
    n = 37 * fft_size + 555
    x, xc = _real(fft_size + T, n + 2)
    sig = xc[offset:offset + n]
    hop = fft_size // 4 if fft_size >= 512 else 128
    n_frames = (n - fft_size) // hop + 3
    w = stft_vmem.window_table("hann", fft_size, xc.device)
    counts = {"stft_frames": 0}
    for onesided in (True, False):
        got = stft_vmem._launch_stft(sig, fft_size, hop, w, n_frames, onesided, T, counts)
        plain = stft_vmem.stft_frames_plain(sig, fft_size, hop, w, n_frames, onesided)
        assert snr_db(cplx(*got), cplx(*plain)) >= 110.0
        want = _stft_oracle(x[offset:offset + n], fft_size, hop, n_frames, onesided)
        assert snr_db(cplx(*got), want) >= 110.0
    assert counts["stft_frames"] == 2


def test_einsum_route_at_high_precision():
    """"high" turns TF32 on for float32 matmuls on the card; the einsum
    route pins full float32 (core/precision.py) and keeps its 120 dB, and
    the caller's setting is back afterwards."""
    torch.set_float32_matmul_precision("high")
    try:
        xr, xi = planes(0, (4, 1000))
        yr, yi = fftlab_torch.fft_split(tt(xr, "cuda"), tt(xi, "cuda"))
        assert torch.get_float32_matmul_precision() == "high"
        assert torch.backends.cuda.matmul.allow_tf32
        assert snr_db(cplx(yr, yi), oracle(xr, xi, -1)) >= 120.0
        br, bi = fftlab_torch.spectral_filter_auto(tt(xr, "cuda"), tt(xi, "cuda"),
                                                   np.ones(1000), np.zeros(1000))
        assert snr_db(cplx(br, bi), xr + 1j * xi.astype(np.float64)) >= 120.0
    finally:
        torch.set_float32_matmul_precision("highest")


def test_real_kernels_refuse_odd_offsets():
    """The float2 loads and stores need 8-byte aligned data: a view at an
    odd element offset raises a ValueError, it is not copied."""
    x = torch.zeros(2 * (1 << 16) + 1, device="cuda")
    odd = x[1:].reshape(2, 1 << 16)
    with pytest.raises(ValueError, match="aligned"):
        rfft_vmem.pack_real(odd)
    with pytest.raises(ValueError, match="aligned"):
        fourstep_vmem.fourstep_pass1_packed(odd)
    w = torch.ones(2048, device="cuda")
    with pytest.raises(ValueError, match="aligned"):
        stft_vmem.stft_frames(x[1:], 2048, 512, w, 4)
    with pytest.raises(ValueError, match="aligned"):
        fftlab_torch.stft_split(x[1:], 2048, 512)
    with pytest.raises(ValueError, match="even hop"):
        stft_vmem.stft_frames(x[:-1], 2048, 511, w, 4)


def test_real_path_refuses_other_dtypes_on_the_card():
    x64 = torch.zeros(2, 1 << 16, dtype=torch.float64, device="cuda")
    for fn in (fftlab_torch.rfft_split, rfft_resident.rfft_resident, rfft_vmem.pack_real,
               lambda x: fftlab_torch.stft_split(x[0], 2048, 512)):
        with pytest.raises(ValueError, match="float32"):
            fn(x64)


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    """With nvcc hidden, a fresh build raises instead of falling back."""
    hide_nvcc(monkeypatch, tmp_path)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.compile_library(tmp_path / _build.LIB_NAME)


# ------------------------------------------- the huge-n path (three_pass)


def test_filter_plan_defaults_to_the_card():
    plan = fftlab_torch.FilterPlan(np.ones(9) / 9.0)
    assert plan.device.type == "cuda"
    assert plan(np.ones(4096, np.float32)).device.type == "cuda"


@pytest.mark.parametrize("nx,nh", [(3000, 97), (40000, 129)])  # m = 4096, 65536
def test_fft_convolution_defaults_to_the_card(no_tf32, nx, nh):
    """numpy planes with no `device`: the convolution runs on the card,
    through the row sandwich or the two-pass one."""
    xr, xi = planes(nx + nh, (2, nx))
    h = np.random.default_rng(nh).standard_normal(nh)
    before = _launches()
    yr, yi = convolution.fft_convolution_split(xr, xi, h)
    assert yr.device.type == "cuda" and yi.device.type == "cuda"
    assert sum(_launches()[k] - before[k] for k in before) >= 1
    z = xr.astype(np.float64) + 1j * xi.astype(np.float64)
    want = np.stack([np.convolve(row, h) for row in z])
    assert snr_db(cplx(yr, yi), want) >= 110.0


@pytest.mark.parametrize("n,B", [(1 << 22, 2), (1 << 25, 1)])
@pytest.mark.parametrize("direction,scale", CASES, ids=CASE_IDS)
def test_three_pass_matches_plain(no_tf32, n, B, direction, scale):
    xr, xi = _cuda_pair(n % 101, (B, n))
    eff = whole_scale(n, direction, scale)
    before = dict(threestep_vmem.LAUNCHES)
    a = threestep_vmem.threestep_pass_a(xr, xi, direction)
    b = threestep_vmem.threestep_pass_b(*a, direction)
    c = threestep_vmem.threestep_pass_c(*b, direction, eff)
    assert all(threestep_vmem.LAUNCHES[k] == before[k] + 1 for k in before)
    assert snr_db(cplx(*a), cplx(*threestep_vmem.threestep_pass_a_plain(xr, xi, direction))) >= 110.0
    assert snr_db(cplx(*b), cplx(*threestep_vmem.threestep_pass_b_plain(*a, direction))) >= 110.0
    assert snr_db(cplx(*c), cplx(*threestep_vmem.threestep_pass_c_plain(*b, direction, eff))) >= 110.0
    assert snr_db(cplx(*c), oracle(xr.cpu(), xi.cpu(), direction, eff)) >= 120.0


@pytest.mark.parametrize("n,B", [(1 << 22, 4), (1 << 24, 1)])
def test_huge_route_launches_kernels(no_tf32, n, B):
    xr, xi = planes(n % 97, (B, n))
    plan = fftlab_torch.plan_dft_1d_split(n, batch=B)
    before = dict(threestep_vmem.LAUNCHES)
    yr, yi = plan.execute((tt(xr, "cuda"), tt(xi, "cuda")))
    assert plan.algorithm == "three_pass"
    assert all(threestep_vmem.LAUNCHES[k] == before[k] + 1 for k in before)
    assert snr_db(cplx(yr, yi), oracle(xr, xi, -1)) >= 120.0
    br, bi = fftlab_torch.fft_split_auto(yr, yi, fftlab_torch.INVERSE)
    assert snr_db(cplx(br, bi), xr + 1j * xi.astype(np.float64)) >= 120.0


def test_huge_real_plans_launch_kernels(no_tf32):
    n = 1 << 23
    x, xc = _real(23, (2, n))
    r2c = fftlab_torch.plan_r2c_1d_split(n, batch=2)
    c2r = fftlab_torch.plan_c2r_1d_split(n, batch=2)
    assert r2c.algorithm == "rfft_split[three_pass]"
    before = dict(threestep_vmem.LAUNCHES)
    X = r2c.execute(xc)
    y = c2r.execute(X)
    assert all(threestep_vmem.LAUNCHES[k] == before[k] + 2 for k in before)
    assert snr_db(cplx(*X), np.fft.rfft(x.astype(np.float64), axis=-1)) >= 110.0
    assert snr_db(y.cpu().numpy(), x.astype(np.float64)) >= 110.0


def _stage_want(xr, xi, r, direction, twiddle):
    """One radix-r stage (and its twiddle) in float64: the DFT down the
    leading digit."""
    z = (np.asarray(xr.cpu(), np.float64) + 1j * np.asarray(xi.cpu(), np.float64))
    B, n = z.shape
    M = n // r
    z = z.reshape(B, r, M)
    want = np.fft.fft(z, axis=1) if direction == -1 else np.fft.ifft(z, axis=1) * r
    if twiddle:
        want = want * np.exp(2j * np.pi * direction * np.outer(np.arange(r), np.arange(M))
                             / (r * M))
    return want.reshape(B, n)


# every pow2 radix of the stage kernel, M at the pipelines' 128 and above
STAGE_CASES = [(2, 128), (4, 256), (8, 128), (16, 512), (32, 128), (64, 2048), (128, 1024)]


@pytest.mark.parametrize("r,M", STAGE_CASES)
@pytest.mark.parametrize("direction", [-1, 1])
@pytest.mark.parametrize("twiddle", [True, False], ids=["twiddle", "no_twiddle"])
def test_fused_stage_matches_plain(no_tf32, r, M, direction, twiddle):
    xr, xi = _cuda_pair(r + M, (3, r * M))
    before = stage_fused.LAUNCHES["fused_stage"]
    got = cplx(*stage_fused.fused_stage(xr, xi, r, direction, twiddle))
    assert stage_fused.LAUNCHES["fused_stage"] == before + 1
    plain = cplx(*stage_fused.fused_stage_plain(xr, xi, r, direction, twiddle))
    assert snr_db(got, plain) >= 110.0
    assert snr_db(got, _stage_want(xr, xi, r, direction, twiddle)) >= 115.0


@pytest.mark.parametrize("r,M", STAGE_CASES)
@pytest.mark.parametrize("f1", [2, 128])
def test_swap_stage_matches_plain(no_tf32, r, M, f1):
    xr, xi = _cuda_pair(r + M + f1, (3 * f1, r * M))
    before = stage_fused.LAUNCHES["fused_stage"]
    got = stage_fused.swap_stage(xr, xi, r, f1, -1)
    assert stage_fused.LAUNCHES["fused_stage"] == before + 1
    plain = stage_fused.swap_stage_plain(xr, xi, r, f1, -1)
    assert snr_db(cplx(*got), cplx(*plain)) >= 110.0
    # the swap is a permutation of the rows: [o, k, k1a] holds row (o, k1a)'s k
    want = _stage_want(xr, xi, r, -1, True).reshape(3, f1, r, M).transpose(0, 2, 1, 3)
    assert snr_db(cplx(*got), want.reshape(3 * f1, r * M)) >= 115.0


@pytest.mark.parametrize("B,n,leaf", [(3, 256, 128), (1, 512, 128), (2, 1 << 15, 128),
                                      (4, 1 << 20, 128), (2, 1 << 12, 256), (1, 1 << 14, 512),
                                      (2, 1 << 11, 1024), (1, 1 << 13, 2048), (5, 128, 128)])
@pytest.mark.parametrize("direction,scale", CASES, ids=CASE_IDS)
def test_stage_leaf_matches_plain(no_tf32, B, n, leaf, direction, scale):
    xr, xi = _cuda_pair(n + leaf + B, (B, n))
    eff = whole_scale(n, direction, scale)
    before = stage_fused.LAUNCHES["stage_leaf"]
    got = cplx(*stage_fused.stage_leaf(xr, xi, leaf, direction, eff))
    assert stage_fused.LAUNCHES["stage_leaf"] == before + 1
    assert snr_db(got, cplx(*stage_fused.stage_leaf_plain(xr, xi, leaf, direction, eff))) >= 110.0
    z = (np.asarray(xr.cpu(), np.float64) + 1j * np.asarray(xi.cpu(), np.float64))
    z = z.reshape(B, n // leaf, leaf)
    y = np.fft.fft(z, axis=-1) if direction == -1 else np.fft.ifft(z, axis=-1) * leaf
    assert snr_db(got, (y * eff).transpose(0, 2, 1).reshape(B, n)) >= 115.0


@pytest.mark.parametrize("n,B", [(1 << 15, 2), (1 << 20, 4), (256, 3), (1 << 22, 1)])
def test_stage_pipeline_launches_kernel(no_tf32, n, B):
    """K - 1 stage launches and one leaf launch, and nothing on the host:
    2^22 is (128, 128, 2, 128), two swap stages."""
    xr, xi = planes(n % 89, (B, n))
    plan = fftlab_torch.plan_from_jax("pallas_pipeline", n, -1)
    before = dict(stage_fused.LAUNCHES)
    yr, yi = plan.execute((tt(xr, "cuda"), tt(xi, "cuda")))
    assert plan.algorithm == "stage_pipeline"
    K = len(stage_fused.pipeline_factors(n))
    assert stage_fused.LAUNCHES["fused_stage"] == before["fused_stage"] + K - 1
    assert stage_fused.LAUNCHES["stage_leaf"] == before["stage_leaf"] + 1
    assert snr_db(cplx(yr, yi), oracle(xr, xi, -1)) >= 115.0


@pytest.mark.parametrize("n,factors", [(1 << 20, (64, 128, 128)), (1 << 17, (8, 128, 128)),
                                       (1 << 15, (2, 128, 128)), (1 << 16, (2, 2, 128, 128)),
                                       (1 << 15, (32, 1024)), (1 << 11, (2048,))])
@pytest.mark.parametrize("direction,scale", CASES, ids=CASE_IDS)
def test_stage_pipeline_custom_factors(no_tf32, n, factors, direction, scale):
    xr, xi = _cuda_pair(n % 83, (2, n))
    before = dict(stage_fused.LAUNCHES)
    got = cplx(*stage_fused.fft_split_pipeline(xr, xi, direction, factors, scale=scale))
    assert stage_fused.LAUNCHES["fused_stage"] == before["fused_stage"] + len(factors) - 1
    assert stage_fused.LAUNCHES["stage_leaf"] == before["stage_leaf"] + 1
    plain = stage_fused.pipeline_launches_plain(xr, xi, direction, factors, scale)
    assert snr_db(got, cplx(*plain)) >= 110.0
    eff = whole_scale(n, direction, scale)
    assert snr_db(got, oracle(xr.cpu(), xi.cpu(), direction, eff)) >= 115.0


def test_stage_pipeline_refuses_what_no_kernel_runs():
    """A leaf above 2048 or a radix above 128 raises on the card before
    any launch; nothing falls back to tensor ops."""
    x = torch.zeros(1, 1 << 15, device="cuda")
    before = dict(stage_fused.LAUNCHES)
    with pytest.raises(ValueError, match="leaf"):
        stage_fused.fft_split_pipeline(x, x, factors=(8, 4096))
    with pytest.raises(ValueError, match="pow2 r"):
        stage_fused.fft_split_pipeline(x, x, factors=(256, 128))
    assert stage_fused.LAUNCHES == before


@pytest.mark.parametrize("name,n", [("rows", 8192), ("two_pass", 1 << 15),
                                    ("three_pass", 1 << 21)])
def test_adjoints_on_the_card_match_cpu(no_tf32, name, n):
    fn = {"rows": fft_vmem.pallas_fft_split_ad, "two_pass": fourstep_vmem.fft_split_large_ad,
          "three_pass": threestep_vmem.fft_split_huge_ad}[name]
    xr, xi = planes(n + 3, (2, n))
    cr, ci = planes(n + 4, (2, n))
    grads = {}
    for dev in ("cpu", "cuda"):
        before = _launches()
        ar, ai = tt(xr, dev).requires_grad_(True), tt(xi, dev).requires_grad_(True)
        yr, yi = fn(ar, ai, -1)
        grads[dev] = torch.autograd.grad((yr * tt(cr, dev) + yi * tt(ci, dev)).sum(),
                                         (ar, ai))
        launched = sum(_launches()[k] - before[k] for k in before)
        assert launched == (0 if dev == "cpu" else 2 * {"rows": 1, "two_pass": 2,
                                                         "three_pass": 3}[name])
    assert snr_db(cplx(*grads["cuda"]), cplx(*grads["cpu"])) >= 110.0
    c = cr + 1j * ci.astype(np.float64)
    assert snr_db(cplx(*grads["cuda"]), np.fft.ifft(c) * n) >= 110.0


def test_huge_and_stage_wrappers_refuse():
    n = 1 << 22
    xt = torch.zeros(n, 2, device="cuda").T  # non-contiguous
    x = torch.zeros(2, n, device="cuda")
    for launch in (threestep_vmem.threestep_pass_a, threestep_vmem.threestep_pass_b,
                   threestep_vmem.threestep_pass_c):
        with pytest.raises(ValueError, match="contiguous"):
            launch(xt, xt)
        with pytest.raises(TypeError, match="float32"):
            launch(x.double(), x.double())
    with pytest.raises(ValueError, match="supports pow2 n"):
        threestep_vmem.fft_split_huge(x[:, : 1 << 20], x[:, : 1 << 20])
    with pytest.raises(ValueError, match="contiguous"):
        stage_fused.fused_stage(xt[:, : 64 * 128], xt[:, : 64 * 128], 64)
    y = torch.zeros(2, 3 * 128, device="cuda")
    with pytest.raises(ValueError, match="pow2 r"):
        stage_fused.fused_stage(y, y, 3)
    z = torch.zeros(3, 2 * 128, device="cuda")
    with pytest.raises(ValueError, match="multiple of pow2 F1"):
        stage_fused.swap_stage(z, z, 2, 2)
    with pytest.raises(ValueError, match="contiguous"):
        stage_fused.stage_leaf(xt[:, : 1 << 10], xt[:, : 1 << 10], 128)
    with pytest.raises(ValueError, match="leaf in"):
        stage_fused.stage_leaf(z, z, 64)


# ------------- the register engine (fft_reg.cuh) at every length and geometry


def _card_oracle(xr, xi, direction, scale):
    """The float64 transform on the card (an oracle only), as complex128
    numpy: numpy's would take seconds at 2^26."""
    z = torch.complex(xr.double(), xi.double())
    y = torch.fft.fft(z) if direction == -1 else torch.fft.ifft(z) * z.shape[-1]
    return (y * scale).cpu().numpy()


@pytest.mark.parametrize("n", [1 << e for e in range(9, 15)])
@pytest.mark.parametrize("direction,scale", CASES, ids=CASE_IDS)
def test_engine_rows_at_every_length(no_tf32, n, direction, scale):
    xr, xi = _cuda_pair(n + 7, (3, n))
    eff = whole_scale(n, direction, scale)
    before = fft_vmem.LAUNCHES["fft_rows"]
    got = cplx(*fft_vmem.fft_rows(xr, xi, direction, eff))
    assert fft_vmem.LAUNCHES["fft_rows"] == before + 1
    assert snr_db(got, cplx(*fft_vmem.fft_rows_plain(xr, xi, direction, eff))) >= 110.0
    assert snr_db(got, _card_oracle(xr, xi, direction, eff)) >= 110.0


def _pass_geometries(L1, L2):
    """Every pass geometry the wrappers or chip_smoke's A/B launch at
    (L1, L2): W in {8, 16} and R in {4, 8, 16} where the tile fits."""
    g1 = [fourstep_vmem.pass1_geometry(L1, L2, W) for W in (8, 16)]
    g2 = [fourstep_vmem.pass2_geometry(L1, L2, R) for R in (4, 8, 16) if R * L2 <= 16384]
    return g1, g2


@pytest.mark.parametrize("n", [1 << e for e in range(15, 22)])
@pytest.mark.parametrize("direction,scale", CASES, ids=CASE_IDS)
def test_engine_two_pass_at_every_length_and_geometry(no_tf32, n, direction, scale):
    xr, xi = _cuda_pair(n % 89 + 1, (2, n))
    eff = whole_scale(n, direction, scale)
    sides = fourstep_vmem._split_sides(n)
    want = _card_oracle(xr, xi, direction, eff)
    counts = dict.fromkeys(fourstep_vmem.LAUNCHES, 0)
    g1s, g2s = _pass_geometries(*sides)
    for g1 in g1s:
        mid = fourstep_vmem._launch_pass1("fourstep_pass1", xr, xi, direction, sides, counts,
                                          geometry=g1)
        assert snr_db(cplx(*mid), cplx(*fourstep_vmem.fourstep_pass1_plain(xr, xi, direction))) >= 110.0
        for g2 in g2s:
            got = cplx(*fourstep_vmem._launch_pass2("fourstep_pass2", *mid, direction, eff,
                                                    sides, counts, geometry=g2))
            assert snr_db(got, cplx(*fourstep_vmem.fourstep_pass2_plain(*mid, direction, eff))) >= 110.0
            assert snr_db(got, want) >= 120.0, (g1.T, g2.T)
    assert counts["fourstep_pass1"] == len(g1s) and counts["fourstep_pass2"] == len(g1s) * len(g2s)


@pytest.mark.parametrize("n", [1 << e for e in range(15, 22)])
@pytest.mark.parametrize("direction", [-1, 1])
def test_engine_pass_modes_at_every_length(no_tf32, n, direction):
    """The packed-real load, the interleaved store and the sandwich mode."""
    x, xc = _real(n % 83 + 2, (2, 2 * n))
    mid = fourstep_vmem.fourstep_pass1_packed(xc, direction)
    assert snr_db(cplx(*mid), cplx(*fourstep_vmem.fourstep_pass1_packed_plain(xc, direction))) >= 110.0
    y = fourstep_vmem.fourstep_pass2_interleaved(*mid, direction, 0.5)
    y_plain = fourstep_vmem.fourstep_pass2_interleaved_plain(*mid, direction, 0.5)
    assert snr_db(y.cpu().numpy(), y_plain.cpu().numpy()) >= 110.0
    z = _card_oracle(xc[:, 0::2], xc[:, 1::2], direction, 0.5)
    assert snr_db(y.cpu().numpy(), np.stack([z.real, z.imag], -1).reshape(2, 2 * n)) >= 120.0
    hr, hi = _cuda_pair(n % 79 + 3, (n,))
    sides = fourstep_vmem._split_sides(n)
    L2 = sides[1]
    plain = cplx(*fourstep_vmem.fourstep_pass2_sandwich_plain(*mid, hr, hi))
    for R in (4, 8, 16) if L2 <= 1024 else (4, 8):  # the default and chip_smoke.py's A/B
        geo = fourstep_vmem.sandwich_geometry(*sides, R)
        got = fourstep_vmem._launch_sandwich(*(t.clone() for t in mid), hr, hi,
                                             dict(fourstep_vmem.LAUNCHES), geometry=geo)
        assert snr_db(cplx(*got), plain) >= 110.0, R


@pytest.mark.parametrize("n", [1 << 22, 1 << 24, 1 << 26])
@pytest.mark.parametrize("direction,scale", CASES, ids=CASE_IDS)
def test_engine_three_pass_sides(no_tf32, n, direction, scale):
    xr, xi = _cuda_pair(n % 103, (1, n))
    eff = whole_scale(n, direction, scale)
    a = threestep_vmem.threestep_pass_a(xr, xi, direction)
    assert snr_db(cplx(*a), cplx(*threestep_vmem.threestep_pass_a_plain(xr, xi, direction))) >= 110.0
    b = threestep_vmem.threestep_pass_b(*a, direction)
    assert snr_db(cplx(*b), cplx(*threestep_vmem.threestep_pass_b_plain(*a, direction))) >= 110.0
    c = threestep_vmem.threestep_pass_c(*b, direction, eff)
    assert snr_db(cplx(*c), cplx(*threestep_vmem.threestep_pass_c_plain(*b, direction, eff))) >= 110.0
    assert snr_db(cplx(*c), _card_oracle(xr, xi, direction, eff)) >= 120.0


# ---------------------------------------------------------------- the complex API

REGISTRY_SIZES = {"mixed_radix": 3000, "four_step": 3000, "bluestein": 4099,
                  "recursive": 256, "iterative": 1024}
REGISTRY_NAMES = ["naive_dft", "optimized_dft", "radix2_dit", "radix2_dif", "radix4",
                  "split_radix", "bluestein", "mixed_radix", "recursive", "iterative",
                  "stockham_mxu", "pallas_vmem", "four_step"]


@pytest.fixture
def wisdom_file(monkeypatch, tmp_path):
    """A wisdom file of the test's own, an empty table and no cached plan."""
    from fftlab_torch.plan import api, wisdom

    monkeypatch.setenv("FFTLAB_WISDOM_PATH", str(tmp_path / "wisdom.json"))
    monkeypatch.delenv("FFTLAB_FORCE_IMPL", raising=False)
    wisdom.forget()
    api._cached_plan.cache_clear()
    yield wisdom
    wisdom.forget()
    api._cached_plan.cache_clear()


def _cuda_complex(seed, shape):
    xr, xi = planes(seed, shape)
    return torch.complex(tt(xr, "cuda"), tt(xi, "cuda")), xr + 1j * xi.astype(np.float64)


@pytest.mark.parametrize("direction", [-1, 1])
@pytest.mark.parametrize("name", REGISTRY_NAMES)
def test_registry_on_the_card(no_tf32, name, direction):
    from fftlab_torch.algos import build_registry

    assert list(build_registry()) == REGISTRY_NAMES
    n = REGISTRY_SIZES.get(name, 4096)
    x, z = _cuda_complex(n, (8, n))
    y = build_registry()[name].fn(x, direction)
    assert y.is_cuda and y.dtype == torch.complex64 and y.shape == x.shape
    want = np.fft.fft(z) if direction == -1 else np.fft.ifft(z)
    assert snr_db(y.cpu().numpy(), want) >= 110.0


def test_pallas_vmem_launches_fft_rows(no_tf32):
    x, z = _cuda_complex(3, (64, 8192))
    before = fft_vmem.LAUNCHES["fft_rows"]
    y = fftlab_torch.fft(x, algorithm="pallas_vmem")
    assert fft_vmem.LAUNCHES["fft_rows"] == before + 1
    plain = torch.complex(*fft_vmem.fft_rows_plain(x.real.contiguous(), x.imag.contiguous()))
    assert snr_db(y.cpu().numpy(), plain.cpu().numpy()) >= 110.0
    assert snr_db(y.cpu().numpy(), np.fft.fft(z)) >= 120.0


def test_complex_api_at_high_precision():
    """"high" turns TF32 on, for CGEMM too; the complex API's contractions
    pin full float32 and keep 120 dB, and the caller's setting is back."""
    torch.set_float32_matmul_precision("high")
    try:
        x, z = _cuda_complex(4, (4, 1 << 20))
        y = fftlab_torch.fft(x)
        assert torch.get_float32_matmul_precision() == "high"
        assert snr_db(y.cpu().numpy(), np.fft.fft(z)) >= 120.0
        assert snr_db(fftlab_torch.ifft(y).cpu().numpy(), z) >= 120.0
        u, w = _cuda_complex(5, (8, 4096))
        assert snr_db(fftlab_torch.fft(u, algorithm="naive_dft").cpu().numpy(),
                      np.fft.fft(w)) >= 110.0
    finally:
        torch.set_float32_matmul_precision("highest")


def test_numpy_input_goes_to_the_card():
    x = planes(6, (2, 64))[0].astype(np.complex64)
    y = fftlab_torch.fft(x)
    assert y.is_cuda
    assert fftlab_torch.fft(x, algorithm="radix2_dit").is_cuda
    assert fftlab_torch.to_split(x)[0].is_cuda


def test_measure_on_the_card_records_gpu(wisdom_file):
    from fftlab_torch.plan.flags import Flags

    plan = fftlab_torch.plan_dft_1d(1024, flags=Flags.MEASURE)
    rec = wisdom_file.lookup(1024, "f32")
    assert rec["algorithm"] == plan.algorithm
    assert rec["platform"] == "gpu" and rec["protocol"] == "cuda_events"
    assert rec["device_name"] == torch.cuda.get_device_name(0)
    assert "pallas_vmem" in rec["timings_ms"]
    split = fftlab_torch.plan_dft_1d_split(8192, flags=Flags.MEASURE, batch=64)
    rec = wisdom_file.lookup(8192, "f32", kind="route")
    assert split.algorithm == rec["algorithm"] and rec["platform"] == "gpu"
    assert set(rec["timings_ms"]) == {"einsum", "smem_rows"}
    assert fftlab_torch.plan_dft_1d_split(8192, flags=Flags.WISDOM_ONLY).algorithm == split.algorithm


def test_failing_candidate_on_the_card_fails_the_measurement(wisdom_file, monkeypatch):
    """A kernel route that raises on the card fails the measurement with
    its name; it is neither skipped nor replaced by einsum."""
    from fftlab_torch.plan import split_tuning
    from fftlab_torch.plan.flags import Flags

    def broken(*args, **kwargs):
        raise RuntimeError("launch failed")

    monkeypatch.setattr(fft_vmem, "fft_rows", broken)
    with pytest.raises(RuntimeError, match="route 'smem_rows' at n=8192 failed on cuda"):
        split_tuning.tune_split_route(8192, batch=8)
    with pytest.raises(RuntimeError, match="candidate 'pallas_vmem' failed on cuda"):
        fftlab_torch.plan_dft_1d(2048, flags=Flags.MEASURE)
    assert wisdom_file.snapshot() == {}


def test_measured_leaf_runs_on_the_card(wisdom_file):
    """The leaf `tune_split_leaf` records on the card, under the card's
    name, is the leaf the einsum route then runs there."""
    from fftlab_torch.plan import split_tuning
    from fftlab_torch.plan.dispatch import run_route

    leaf = split_tuning.tune_split_leaf(4096, leaves=(64, 512), batch=8, iters=2)
    rec = wisdom_file.lookup(4096, "f32", kind="split")
    assert rec["algorithm"] == f"leaf={leaf}" and rec["platform"] == "gpu"
    assert rec["device_name"] == torch.cuda.get_device_name(0)
    assert split_tuning.best_leaf(4096, "cuda") == leaf
    assert split_tuning.best_leaf(4096, "cpu") == 128  # not measured on the CPU
    xr, xi = planes(11, (8, 4096))
    want = np.fft.fft(xr.astype(np.complex128) + 1j * xi)
    yr, yi = run_route("einsum", torch.from_numpy(xr).cuda(), torch.from_numpy(xi).cuda(), -1)
    got = yr.cpu().numpy() + 1j * yi.cpu().numpy()
    assert np.linalg.norm(got - want) <= 1e-5 * np.linalg.norm(want)


# ------------------------------------------------- the complex-dtype DSP
# Each entry point on the card against the same entry point on host
# copies (the port's CPU path, which tests/test_torch_dsp*.py hold
# against the JAX package): >= 110 dB for outputs linear in the signal,
# >= 100 dB for products of two spectra, coherence within 1e-4, pitch
# within 1e-3 relative. numpy input with no `device` runs on the card.

from fftlab_torch.core.types import to_host  # noqa: E402
from fftlab_torch.dsp import analyzer as dsp_analyzer  # noqa: E402
from fftlab_torch.dsp import filtering as dsp_filtering  # noqa: E402
from fftlab_torch.dsp import image as dsp_image  # noqa: E402
from fftlab_torch.dsp import pitch as dsp_pitch  # noqa: E402
from fftlab_torch.dsp import spectrum as dsp_spectrum  # noqa: E402
from fftlab_torch.dsp.stft import istft, spectrogram, stft, stft_complex  # noqa: E402


def _reals(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


_LOWPASS = dsp_filtering.FilterParams(dsp_filtering.FilterType.LOWPASS, 0.1, 0.0, 1.0, 0.01)
DSP_CARD = {
    "fft_convolution": (lambda x, d: convolution.fft_convolution(x, x[0, :257], device=d), 110),
    "circular_convolution": (lambda x, d: convolution.circular_convolution(x, x[::-1].copy(),
                                                                          device=d), 110),
    "overlap_save": (lambda x, d: convolution.overlap_save(x, x[0, :129], device=d), 110),
    "overlap_add": (lambda x, d: convolution.overlap_add(x, x[0, :129], device=d), 110),
    "convolve2d": (lambda x, d: convolution.convolve2d(x[:, :1024].reshape(64, 64),
                                                      x[0, :81].reshape(9, 9), device=d), 110),
    "fft_filter": (lambda x, d: dsp_filtering.fft_filter(x, _LOWPASS, device=d), 110),
    "periodogram": (lambda x, d: dsp_spectrum.periodogram(x, device=d)[1], 100),
    "welch_psd": (lambda x, d: dsp_spectrum.welch_psd(x[0], device=d)[1], 100),
    "autocorrelation": (lambda x, d: dsp_spectrum.autocorrelation(x, device=d), 100),
    "cross_correlation": (lambda x, d: dsp_spectrum.cross_correlation(x, x[::-1].copy(),
                                                                     device=d), 100),
    "stft": (lambda x, d: stft(x[0], 2048, 512, device=d), 110),
    "stft_complex": (lambda x, d: stft_complex(x[0], 256, 128, device=d), 110),
    "spectrogram": (lambda x, d: spectrogram(x[0], 2048, 512, averaging=4, device=d), 100),
    "analyze_spectrum": (lambda x, d: dsp_analyzer.analyze_spectrum(x, 44100.0,
                                                                    device=d)[1], 110),
    "lowpass_ideal": (lambda x, d: dsp_image.lowpass_filter_image(
        x[0, :4096].reshape(64, 64), 8.0, device=d), 110),
    "highpass_gaussian": (lambda x, d: dsp_image.highpass_filter_image(
        x[0, :4096].reshape(64, 64), 6.0, "gaussian", device=d), 110),
    "detect_edges": (lambda x, d: dsp_image.detect_edges(x[0, :4096].reshape(64, 64),
                                                         device=d), 110),
    "log_magnitude_spectrum": (lambda x, d: dsp_image.log_magnitude_spectrum(
        x[0, :4096].reshape(64, 64), device=d), 110),
}


@pytest.mark.parametrize("name", list(DSP_CARD))
def test_dsp_on_the_card_matches_cpu(no_tf32, name):
    fn, gate = DSP_CARD[name]
    x = _reals(len(name), (4, 1 << 16))
    got = fn(x, "cuda")
    assert got.device.type == "cuda"
    want = fn(x, "cpu")
    assert snr_db(to_host(got), to_host(want)) >= gate


def test_dsp_default_device_is_the_card(no_tf32):
    x = _reals(1, (2, 4096))
    assert dsp_spectrum.periodogram(x)[1].device.type == "cuda"
    assert stft(x[0], 256, 64).device.type == "cuda"
    assert dsp_analyzer.RealtimeAnalyzer().device.type == "cuda"


def test_istft_on_the_card_matches_cpu(no_tf32):
    x = _reals(2, 1 << 18)
    S = stft(x, 2048, 512, device="cpu").numpy()
    got = to_host(istft(S, 2048, 512, length=x.size))
    want = to_host(istft(S, 2048, 512, length=x.size, device="cpu"))
    edge = 2048  # the summed window energy is under 1e-3 only in the first and last frame
    assert snr_db(got[edge:-edge], want[edge:-edge]) >= 110.0
    assert snr_db(got[edge:-edge], x[edge:-edge]) >= 110.0


def test_coherence_on_the_card_matches_cpu(no_tf32):
    x = _reals(3, 1 << 18)
    y = (0.6 * x + 0.4 * _reals(4, 1 << 18)).astype(np.float32)
    got = to_host(dsp_spectrum.coherence(x, y)[1])
    want = to_host(dsp_spectrum.coherence(x, y, device="cpu")[1])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("detector", ["pitch_spectral_peak", "harmonic_product_spectrum",
                                      "pitch_autocorrelation"])
def test_pitch_on_the_card_matches_cpu(no_tf32, detector):
    t = np.arange(4096) / 44100.0
    f0 = np.linspace(80.0, 1000.0, 64)[:, None]
    x = (np.sin(2 * np.pi * f0 * t) + 0.5 * np.sin(4 * np.pi * f0 * t)).astype(np.float32)
    got = to_host(getattr(dsp_pitch, detector)(x, 44100.0))
    want = to_host(getattr(dsp_pitch, detector)(x, 44100.0, device="cpu"))
    np.testing.assert_allclose(got, want, rtol=1e-3)
    r = dsp_pitch.detect_pitch(x[10], 44100.0)
    want = dsp_pitch.detect_pitch(x[10], 44100.0, device="cpu")
    assert r["note"] == want["note"] and r["confidence"] == want["confidence"]
    assert r["pitch"] == pytest.approx(want["pitch"], rel=1e-3)
    np.testing.assert_allclose(r["estimates"], want["estimates"], rtol=1e-3)


@pytest.mark.parametrize("dtype", [np.float32, np.complex64])
def test_direct_convolution_with_cudnn_tf32_on(dtype):
    """cuDNN's TF32 on outside the call, PyTorch's default: the conv1d
    inside runs at full float32 (core/precision.py full_float32), the
    complex product as four real convs (no conjugation), and the flag is
    on again after."""
    from fftlab_torch.dsp.convolution import direct_convolution

    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        _direct_convolution_check(direct_convolution, dtype)
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def _direct_convolution_check(direct_convolution, dtype):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((4, 1 << 16)).astype(np.float32)
    h = rng.standard_normal(129).astype(np.float32)
    if dtype is np.complex64:
        x = (x + 1j * rng.standard_normal(x.shape)).astype(np.complex64)
        h = (h + 1j * rng.standard_normal(129)).astype(np.complex64)
    y = direct_convolution(x, h)
    assert y.device.type == "cuda" and torch.backends.cudnn.allow_tf32
    want = np.stack([np.convolve(r.astype(np.complex128), h.astype(np.complex128))
                     for r in x])
    assert snr_db(to_host(y), want) >= 110.0


def test_spectrogram_batch_launches_stft_frames_once(no_tf32):
    an = dsp_analyzer.RealtimeAnalyzer()
    x = _reals(5, 1 << 20)
    before = stft_vmem.LAUNCHES["stft_frames"]
    got = an.spectrogram_batch(x)
    assert stft_vmem.LAUNCHES["stft_frames"] == before + 1
    want = dsp_analyzer.RealtimeAnalyzer(device="cpu").spectrogram_batch(x)
    assert snr_db(to_host(got), to_host(want)) >= 100.0


def test_realtime_analyzer_on_the_card_matches_cpu(no_tf32):
    card, host = dsp_analyzer.RealtimeAnalyzer(), dsp_analyzer.RealtimeAnalyzer(device="cpu")
    sig = _reals(6, 1 << 16)
    before = stft_vmem.LAUNCHES["stft_frames"]
    at, calls = 0, 0
    for size in (1000, 4096, 4097, 300, 20000, 4096):
        a, b = card.process(sig[at:at + size]), host.process(sig[at:at + size])
        at += size
        np.testing.assert_array_equal(card._tail, host._tail)
        if b is not None:
            calls += 1
            assert snr_db(a, b) >= 100.0
    assert stft_vmem.LAUNCHES["stft_frames"] == before + calls


@pytest.mark.parametrize("n,route,kernels", [
    (4096, "smem_rows", ("fft_rows",)),
    (1 << 15, "two_pass", ("fourstep_pass1", "fourstep_pass2")),
    (1 << 21, "three_pass", ("threestep_pass_a", "threestep_pass_b", "threestep_pass_c"))])
def test_split_correlations_launch_their_route(no_tf32, n, route, kernels):
    """At m = next_pow2(2n) the split correlations launch the kernels of
    the route `select_split_impl(m)` names, two FFTs a call."""
    from fftlab_torch.plan.dispatch import select_split_impl

    m = 2 * n
    assert select_split_impl(m) == route
    x, y = _reals(n % 89, (2, n)), _reals(n % 83, (2, n))
    for fn, args in ((dsp_spectrum.autocorrelation_split, (x,)),
                     (dsp_spectrum.cross_correlation_split, (x, y))):
        before = _launches()
        got = fn(*args)
        after = _launches()
        assert {k: after[k] - before[k] for k in kernels} == dict.fromkeys(kernels, 2)
        assert sum(after.values()) - sum(before.values()) == 2 * len(kernels)
        want = fn(*args, device="cpu")
        assert snr_db(to_host(got), to_host(want)) >= 100.0


@pytest.mark.parametrize("demo,argv", [
    ("spectrum", []), ("convolution", []), ("filter", []), ("image", []),
    ("pitch", []), ("analyzer", ["--frames", "2"])])
def test_dsp_demos_run_on_the_card(capsys, monkeypatch, demo, argv):
    import importlib
    import sys

    monkeypatch.setattr(sys, "argv", ["prog"] + argv)
    importlib.import_module(f"fftlab_torch.cli.{demo}").main()
    assert len(capsys.readouterr().out) > 50


# -- the single-card edges: serving, lowprec, trace, the harness, the demos ---

def _two_tones(n: int, fs: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(n) / fs
    return (0.4 * np.sin(2 * np.pi * 440 * t) + 0.3 * np.sin(2 * np.pi * 6000 * t)
            + 0.05 * rng.standard_normal(n)).astype(np.float32)


def test_native_builds_on_the_card_host():
    from fftlab_torch.native import lib
    from fftlab_torch.native.fft64 import fft64

    assert lib.load_native_lib()._name == str(lib.library_path())
    x = np.random.default_rng(0).standard_normal((2, 256)) + 0j
    assert snr_db(fft64(x), np.fft.fft(x)) > 250.0


def test_serve_stream_on_the_card(no_tf32, tmp_path):
    """cli/serve's path at its defaults on a 2^20-sample 48 kHz WAV: one
    `os_filter` launch a chunk, the stream >= 100 dB against float64
    np.convolve of the samples as read."""
    from fftlab_torch.cli import parse, serve
    from fftlab_torch.native.wav import write_wav

    n, fs = 1 << 20, 48000
    write_wav(str(tmp_path / "in.wav"), _two_tones(n, fs, 1), fs)
    args = parse(serve.build_parser(),
                 ["--in", str(tmp_path / "in.wav"), "--out", str(tmp_path / "out.wav")])
    before = os_filter_vmem.LAUNCHES["os_filter"]
    r = serve.run(args)
    assert os_filter_vmem.LAUNCHES["os_filter"] - before == -(-n // args.chunk)
    assert r.plan.device.type == "cuda" and r.plan.uses_kernel()
    want = np.convolve(r.audio.astype(np.float64), r.plan.h.astype(np.float64))[:n]
    assert r.filtered.shape == (n,)
    assert snr_db(r.filtered, want) >= 100.0


def test_lowprec_gates_on_the_card(no_tf32):
    from fftlab_torch.algos.lowprec import PRECISIONS, fft_split_lowprec

    xr, xi = _cuda_pair(12, (4, 1 << 16))
    want = oracle(xr.cpu().numpy(), xi.cpu().numpy(), -1)
    before = (torch.get_float32_matmul_precision(), torch.backends.cuda.matmul.allow_tf32)
    snr = {m: snr_db(cplx(*fft_split_lowprec(xr, xi, mode=m)), want) for m in PRECISIONS}
    assert (torch.get_float32_matmul_precision(),
            torch.backends.cuda.matmul.allow_tf32) == before
    assert snr["f32"] >= 120.0
    assert snr["f32"] >= snr["f32x3"] >= snr["bf16"] > 20.0


def test_span_waits_for_the_card():
    from fftlab_torch.bench import timing
    from fftlab_torch.utils.trace import span

    x = torch.randn(4096, 4096, device="cuda")
    work = lambda: [x @ x for _ in range(8)]  # noqa: E731
    work()
    device_ms = timing.event_ms(work, 3, 1)
    timers = {}
    torch.cuda.synchronize()
    with span("work", timers):
        work()
    assert timers["work"].total_s * 1e3 >= 0.9 * device_ms


def test_time_fn_on_cuda_events():
    from fftlab_torch.bench import harness, timing

    x = torch.randn(16, 1 << 16, dtype=torch.complex64, device="cuda")
    sec = harness.time_fn(torch.fft.fft, (x,), iters=20)
    ms = timing.time_ms(lambda: torch.fft.fft(x), "cuda", iters=3, inner=20)
    assert 0 < sec * 1e3 < 3 * ms and ms < 3 * sec * 1e3


def test_benchmark_suite_on_the_card():
    from fftlab_torch.bench.harness import benchmark_suite

    rows = benchmark_suite((1024,), ["stockham_mxu", "pallas_vmem", "radix2_dit"])
    assert [r.algorithm for r in rows] == ["stockham_mxu", "pallas_vmem", "radix2_dit"]
    assert all(r.roundtrip_ok and r.ms > 0 for r in rows)


def test_profiler_trace_on_the_card(tmp_path):
    from fftlab_torch.utils.trace import TRACE_FILE, profiler_trace

    x = torch.randn(16, 1 << 16, dtype=torch.complex64, device="cuda")
    with profiler_trace(str(tmp_path)):
        torch.fft.fft(x)
        torch.cuda.synchronize()
    assert (tmp_path / TRACE_FILE).stat().st_size > 0


def test_bigfft_kernels_on_the_card(no_tf32):
    from fftlab_torch.cli import bigfft

    xr, xi = _cuda_pair(13, (1, 1 << 20))
    before = {k: fourstep_vmem.LAUNCHES[k] for k in ("fourstep_pass1", "fourstep_pass2")}
    assert bigfft.two_pass_snr(xr, xi) >= 120.0
    assert {k: fourstep_vmem.LAUNCHES[k] - v for k, v in before.items()} == \
        {"fourstep_pass1": 1, "fourstep_pass2": 1}
    h = np.random.default_rng(3).standard_normal(257).astype(np.float32) / 257
    assert bigfft.convolution_error(xr[0, : 1 << 14], h) <= 1e-4


@pytest.mark.parametrize("demo,argv", [
    ("serve", ["--taps", "65", "--chunk", "16384"]), ("bigfft", []), ("features", []),
    ("benchmark", ["--sizes", "64,1024", "--algos", "radix2_dit,stockham_mxu"]),
    ("analyzer", ["--frames", "2", "--wav"])])
def test_edge_demos_run_on_the_card(capsys, monkeypatch, tmp_path, demo, argv):
    import importlib
    import sys

    from fftlab_torch.native.wav import write_wav

    if demo == "analyzer":
        write_wav(str(tmp_path / "a.wav"), _two_tones(1 << 15, 16000, 2), 16000)
        argv = argv + [str(tmp_path / "a.wav")]
    if demo == "serve":
        argv = argv + ["--out", str(tmp_path / "out.wav")]
    monkeypatch.setattr(sys, "argv", ["prog"] + argv)
    importlib.import_module(f"fftlab_torch.cli.{demo}").main()
    assert len(capsys.readouterr().out) > 50


# -- the sharded paths (fftlab_torch.dist) at world size 1 on NCCL --------------


@pytest.fixture
def nccl_mesh(tmp_path):
    """A one-rank NCCL world over a file store, and a 1-D mesh "tp" on it;
    the group is destroyed after the test."""
    import torch.distributed as dist

    from fftlab_torch.dist import make_mesh_1d

    dist.init_process_group("nccl", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1)
    try:
        yield make_mesh_1d("tp")
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("chunks", [1, 4])
def test_sharded_four_step_on_the_card(no_tf32, nccl_mesh, chunks):
    from fftlab_torch.dist import four_step_fft_sharded_split

    xr, xi = _cuda_pair(21, (1 << 20,))
    before = fft_vmem.LAUNCHES["fft_rows"]
    yr, yi = four_step_fft_sharded_split(xr, xi, nccl_mesh, "tp", chunks=chunks)
    torch.cuda.synchronize()
    # n1 = n2 = 1024: the column FFTs in `chunks` launches, the row FFTs in one
    assert fft_vmem.LAUNCHES["fft_rows"] - before == chunks + 1
    assert yr.device.type == "cuda"
    assert snr_db(cplx(yr, yi), oracle(xr.cpu().numpy(), xi.cpu().numpy(), -1)) >= 120.0
    br, bi = four_step_fft_sharded_split(yr, yi, nccl_mesh, "tp", direction=1)
    assert snr_db(cplx(br, bi), cplx(xr, xi)) >= 120.0
    if chunks > 1:
        one = four_step_fft_sharded_split(xr, xi, nccl_mesh, "tp")
        assert torch.equal(one[0], yr) and torch.equal(one[1], yi)


def test_filter_plan_mesh_on_the_card(no_tf32, nccl_mesh):
    rng = np.random.default_rng(22)
    h = (rng.standard_normal(129) / 129).astype(np.float32)
    x = rng.standard_normal(1 << 20).astype(np.float32)
    plan = fftlab_torch.FilterPlan(h, mesh=nccl_mesh, time_axis="tp")
    assert "mesh[tp]=1" in plan.describe()
    before = os_filter_vmem.LAUNCHES["os_filter"]
    y = plan(x)
    torch.cuda.synchronize()
    assert os_filter_vmem.LAUNCHES["os_filter"] - before == 1
    assert y.device.type == "cuda" and y.shape == (1 << 20,)
    m = 1 << 17
    want = np.convolve(x[:m].astype(np.float64), h.astype(np.float64))[:m]
    assert snr_db(y[:m].cpu().numpy(), want) >= 100.0


def test_shared_card_without_gloo_raises(monkeypatch):
    """More ranks than cards and no backend=: NCCL would refuse two ranks
    on one card, so the mesh raises before any process group starts, and
    nothing switches to gloo."""
    import torch.distributed as dist

    from fftlab_torch.dist import make_mesh_1d

    world = torch.cuda.device_count() + 1
    monkeypatch.setenv("WORLD_SIZE", str(world))
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("MASTER_PORT", "29511")
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    with pytest.raises(RuntimeError, match="backend='gloo'"):
        make_mesh_1d("x")
    assert not dist.is_initialized()


def test_dist_demo_on_the_card():
    """The demo's four gloo ranks share the card, and refuse NCCL there."""
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    run = lambda *args: subprocess.run(
        [sys.executable, "-m", "fftlab_torch.cli.dist_demo", *args], cwd=root,
        capture_output=True, text=True, timeout=300)
    proc = run("--ranks", "4", "--backend", "gloo")
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert lines[0] == "4 device(s): cuda (gloo)" and len(lines) == 6
    assert all(float(line.rsplit(" ", 1)[1]) < 1e-3 for line in lines[1:])
    refused = run("--ranks", str(torch.cuda.device_count() + 1))
    assert refused.returncode != 0 and "backend='gloo'" in refused.stderr


# ------------------------------------------------ the public entries (phase 4i)


def _counts() -> dict:
    return {**fft_vmem.LAUNCHES, **fourstep_vmem.LAUNCHES, **stft_vmem.LAUNCHES,
            **stage_fused.LAUNCHES}


def _launched(before: dict) -> dict:
    """The launches since `before` (a `_counts()`), by kernel."""
    return {k: c - before[k] for k, c in _counts().items() if c != before[k]}


@pytest.mark.parametrize("direction", [-1, 1])
def test_kernels_exports_on_the_card(no_tf32, direction):
    """fftlab_torch.kernels' JAX names launch their kernels once each on
    CUDA tensors and agree with the plain versions and float64."""
    from fftlab_torch import kernels

    n = 16384
    xr, xi = _cuda_pair(31, (8, n))
    hr, hi = _cuda_pair(32, (n,))
    before = _counts()
    rows = kernels.pallas_fft_split(xr, xi, direction)
    filt = kernels.pallas_spectral_filter(xr, xi, hr, hi)
    assert _launched(before) == {"fft_rows": 1, "filter_rows": 1}
    eff = whole_scale(n, direction, None)
    assert snr_db(cplx(*rows), cplx(*fft_vmem.fft_rows_plain(xr, xi, direction, eff))) >= 110.0
    assert snr_db(cplx(*rows), oracle(xr.cpu(), xi.cpu(), direction, eff)) >= 120.0
    want = np.fft.ifft(np.fft.fft(cplx(xr, xi)) * cplx(hr, hi))
    assert snr_db(cplx(*filt), want) >= 120.0
    x = torch.complex(xr, xi)
    assert snr_db(kernels.pallas_fft(x, direction).cpu().numpy(),
                  oracle(xr.cpu(), xi.cpu(), direction, eff)) >= 120.0


def test_kernels_stft_and_pipeline_exports_on_the_card(no_tf32):
    from fftlab_torch import kernels

    sig = tt(np.random.default_rng(33).standard_normal(1 << 16).astype(np.float32), "cuda")
    before = _counts()
    spec = kernels.pallas_stft_split(sig, 2048, 512)
    xr, xi = _cuda_pair(34, (2, 1 << 17))
    pipe = kernels.fft_split_pipeline(xr, xi, -1, (8, 128, 128))
    stage = kernels.fused_stage(xr, xi, r=8)
    assert _launched(before) == {"stft_frames": 1, "fused_stage": 3, "stage_leaf": 1}
    frames = ((1 << 16) - 2048) // 512 + 1
    w = stft_vmem.window_table("hann", 2048, sig.device)
    plain = stft_vmem.stft_frames_plain(sig, 2048, 512, w, frames)
    assert snr_db(cplx(*spec), cplx(*plain)) >= 110.0
    assert snr_db(cplx(*pipe), oracle(xr.cpu(), xi.cpu(), -1)) >= 115.0
    assert snr_db(cplx(*stage), cplx(*stage_fused.fused_stage_plain(xr, xi, 8))) >= 110.0


@pytest.mark.parametrize("direction", [-1, 1])
def test_fft_split_resident_cio_on_the_card(no_tf32, direction):
    from fftlab_torch.kernels import resident_vmem

    n = 1 << 20
    xr, xi = _cuda_pair(35, (2, n))
    before = _counts()
    got = resident_vmem.fft_split_resident_cio(xr, xi, direction, scale=0.5)
    assert _launched(before) == {"fourstep_pass1": 1, "fourstep_pass2": 1}
    eff = whole_scale(n, direction, 0.5)
    assert snr_db(cplx(*got), oracle(xr.cpu(), xi.cpu(), direction, eff)) >= 120.0


def test_argument_order_repairs_on_the_card(no_tf32):
    """F1, F2: the JAX-order calls raise on CUDA tensors and the keyword
    forms clear the gates; F3: precision in 6th place gives the sandwich."""
    from fftlab_torch.algos.split_stockham import spectral_filter_split_fused

    xr, xi = _cuda_pair(36, (4, 16384))
    with pytest.raises(TypeError):
        fft_vmem.fft_split_rows(xr, xi, -1, False)
    got = fft_vmem.fft_split_rows(xr, xi, -1, scale=0.5)
    assert snr_db(cplx(*got), oracle(xr.cpu(), xi.cpu(), -1, 0.5)) >= 120.0
    pr, pi = _cuda_pair(37, (2, 1 << 17))
    with pytest.raises(TypeError):
        stage_fused.fft_split_pipeline(pr, pi, -1, (8, 128, 128), 8)
    got = stage_fused.fft_split_pipeline(pr, pi, -1, (8, 128, 128), scale=2.0)
    assert snr_db(cplx(*got), oracle(pr.cpu(), pi.cpu(), -1, 2.0)) >= 115.0
    hr, hi = _cuda_pair(38, (16384,))
    got = spectral_filter_split_fused(xr, xi, hr, hi, 128, "highest")
    want = np.fft.ifft(np.fft.fft(cplx(xr, xi)) * cplx(hr, hi))
    assert snr_db(cplx(*got), want) >= 120.0


def test_copy_bandwidth_on_the_card():
    """The copy chain reads a positive rate no higher than 105% of the
    published 3.35 TB/s: above it, the timing is at fault."""
    from fftlab_torch.bench import timing

    for gbps in (timing.copy_bandwidth(), timing.quick_bandwidth()):
        assert 0 < gbps <= 1.05 * 3350.0
