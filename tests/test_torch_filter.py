"""fftlab_torch's spectral-filter path against the JAX package's, on the
same float32 inputs from a numpy seed: the tensor-op sandwich and its
digit-reversed form, each kernel's plain version against the JAX kernel
in interpret mode (as the JAX suite runs it on the CPU), the dispatcher
in each of its windows, the convolution, the filter designs, and the
wrappers' refusals. The CUDA kernels themselves are tested on the card
by tests/test_torch_cuda.py.

Gates: port vs JAX >= 110 dB SNR and port vs the float64 numpy oracle
>= 120 dB (>= 110 dB where the row sandwich runs), the JAX suite's own
(tests/test_resident_vmem.py:37, tests/test_kernels.py:39); the
overlap-save filter within 1e-5 of np.convolve relative to the peak
output, the JAX suite's gate (tests/test_kernels.py:133-134). Host
tables and designs must equal the JAX package's exactly (designs within
1e-12: the same float64 code)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fftlab.algos.split_stockham as jx_ss
import fftlab.dsp.convolution as jx_conv
import fftlab.dsp.filtering as jx_filt
import fftlab.kernels.fft_vmem as jx_rows
import fftlab.kernels.fourstep_vmem as jx_fs
import fftlab.kernels.os_filter_vmem as jx_os
import fftlab.kernels.resident_vmem as jx_res
import fftlab.plan.dispatch as jx_dispatch
import fftlab_torch
from _torch_parity import cplx, planes, snr_db, tt
from fftlab_torch.algos import split_stockham as ss
from fftlab_torch.algos.stockham import plan_factors
from fftlab_torch.dsp import convolution, filtering
from fftlab_torch.kernels import _common, fft_vmem, fourstep_vmem, os_filter_vmem, resident_vmem
from fftlab_torch.plan import dispatch


@pytest.fixture(autouse=True)
def _no_forced_route(monkeypatch):
    monkeypatch.delenv("FFTLAB_FORCE_IMPL", raising=False)


def sandwich_oracle(xr, xi, hr, hi) -> np.ndarray:
    """ifft(fft(x) * H) in float64."""
    z = np.asarray(xr, np.float64) + 1j * np.asarray(xi, np.float64)
    h = np.asarray(hr, np.float64) + 1j * np.asarray(hi, np.float64)
    return np.fft.ifft(np.fft.fft(z) * h)


def case(seed: int, batch: int, n: int):
    """Signal planes [batch, n] and a complex response of n bins."""
    xr, xi = planes(seed, (batch, n))
    hr, hi = planes(seed + 1, (n,))
    return xr, xi, hr, hi


# ------------------------------------------------- digit-reversed order


@pytest.mark.parametrize("n", [12, 1000, 4096, 1 << 15, 3 * 5 * 7 * 11 * 13])
def test_digitrev_bins_equal(n):
    factors = plan_factors(n, ss.DEFAULT_LEAF_SPLIT)
    assert np.array_equal(ss.digitrev_bins(factors), jx_ss.digitrev_bins(factors))


@pytest.mark.parametrize("n", [12, 1000, 4096])
def test_permute_response_equal(n):
    _, _, hr, hi = case(n, 1, n)
    ours = ss.permute_response(hr, hi, n)
    theirs = jx_ss.permute_response(hr, hi, n)
    for a, b in zip(ours, theirs):
        assert np.array_equal(a, b)


# ----------------------------------------------- the tensor-op sandwich


@pytest.mark.parametrize("n", [12, 1000, 4096])
def test_spectral_filter_split_matches_jax(n):
    xr, xi, hr, hi = case(n, 2, n)
    got = cplx(*ss.spectral_filter_split(tt(xr), tt(xi), tt(hr), tt(hi)))
    want = cplx(*jx_ss.spectral_filter_split(jnp.asarray(xr), jnp.asarray(xi),
                                             jnp.asarray(hr), jnp.asarray(hi)))
    assert snr_db(got, want) >= 110.0
    assert snr_db(got, sandwich_oracle(xr, xi, hr, hi)) >= 120.0


@pytest.mark.parametrize("n", [12, 1000, 4096])
@pytest.mark.parametrize("form", ["numpy", "tensor", "permuted"])
def test_spectral_filter_split_fused_matches_jax(n, form):
    xr, xi, hr, hi = case(n + 5, 2, n)
    if form == "numpy":
        got = ss.spectral_filter_split_fused(tt(xr), tt(xi), hr, hi)
    elif form == "tensor":
        got = ss.spectral_filter_split_fused(tt(xr), tt(xi), tt(hr), tt(hi))
    else:
        got = ss.spectral_filter_split_fused(
            tt(xr), tt(xi), *ss.permute_response(hr, hi, n), h_permuted=True)
    want = cplx(*jx_ss.spectral_filter_split_fused(
        jnp.asarray(xr), jnp.asarray(xi), hr, hi))
    assert snr_db(cplx(*got), want) >= 110.0
    assert snr_db(cplx(*got), sandwich_oracle(xr, xi, hr, hi)) >= 120.0


def test_digitrev_stages_invert():
    """The forward stages without the final transpose, then the stages
    backwards with conjugated tables, give n times the input."""
    n = 1000
    factors = plan_factors(n, ss.DEFAULT_LEAF_SPLIT)
    xr, xi = planes(3, (2, n))
    yr, yi = ss._fft_split_digitrev(tt(xr), tt(xi), -1, factors)
    want = np.fft.fft(xr + 1j * xi.astype(np.float64))
    bins = ss.digitrev_bins(factors)
    assert snr_db(cplx(yr, yi), want[..., bins]) >= 120.0
    zr, zi = ss._ifft_split_from_digitrev(yr, yi, -1, factors)
    assert snr_db(cplx(zr, zi) / n, xr + 1j * xi.astype(np.float64)) >= 120.0


# ---------------------------------------- kernels' plain versions vs JAX


@pytest.mark.parametrize("n", [1024, 2048])
def test_rows_sandwich_plain_matches_pallas(n):
    xr, xi, hr, hi = case(n, 2, n)
    got = cplx(*fft_vmem.pallas_spectral_filter(tt(xr), tt(xi), hr, hi))
    want = cplx(*jx_rows.pallas_spectral_filter(
        jnp.asarray(xr), jnp.asarray(xi), jnp.asarray(hr), jnp.asarray(hi),
        interpret=True))
    assert snr_db(got, want) >= 110.0
    assert snr_db(got, sandwich_oracle(xr, xi, hr, hi)) >= 110.0


def test_rows_sandwich_plain_is_its_parts():
    """The plain row sandwich is the plain forward, the multiply and the
    plain inverse of fft_rows, so the kernel is held to the same pieces."""
    n = 8192
    xr, xi, hr, hi = case(1, 3, n)
    got = fft_vmem.spectral_filter_rows_plain(tt(xr), tt(xi), tt(hr), tt(hi))
    fr, fi = fft_vmem.fft_rows_plain(tt(xr), tt(xi), -1, 1.0)
    gr, gi = fr * tt(hr) - fi * tt(hi), fr * tt(hi) + fi * tt(hr)
    want = fft_vmem.fft_rows_plain(gr, gi, 1, 1.0 / n)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert snr_db(cplx(*got), sandwich_oracle(xr, xi, hr, hi)) >= 110.0


def test_large_sandwich_plain_matches_pallas():
    n = 1 << 15
    xr, xi, hr, hi = case(n, 1, n)
    got = cplx(*fourstep_vmem.spectral_filter_large(tt(xr), tt(xi), hr, hi))
    want = cplx(*jx_fs.spectral_filter_large(
        jnp.asarray(xr), jnp.asarray(xi), jnp.asarray(hr), jnp.asarray(hi),
        interpret=True))
    assert snr_db(got, want) >= 110.0
    assert snr_db(got, sandwich_oracle(xr, xi, hr, hi)) >= 120.0


def test_resident_sandwich_matches_pallas():
    n = 1 << 15
    xr, xi, hr, hi = case(n + 1, 1, n)
    got = cplx(*resident_vmem.spectral_filter_resident(tt(xr), tt(xi), hr, hi))
    want = cplx(*jx_res.spectral_filter_resident(
        jnp.asarray(xr), jnp.asarray(xi), jnp.asarray(hr), jnp.asarray(hi),
        interpret=True))
    assert snr_db(got, want) >= 110.0
    assert snr_db(got, sandwich_oracle(xr, xi, hr, hi)) >= 120.0


@pytest.mark.parametrize("name", ["spectral_filter_resident",
                                  "spectral_filter_resident_cio",
                                  "spectral_filter_resident_v5",
                                  "spectral_filter_resident_v7"])
def test_resident_variants_are_the_sandwich(name):
    n = 1 << 15
    xr, xi, hr, hi = case(7, 2, n)
    got = getattr(resident_vmem, name)(tt(xr), tt(xi), hr, hi)
    want = fourstep_vmem.spectral_filter_large(tt(xr), tt(xi), hr, hi)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_large_sandwich_plain_is_its_parts():
    """The plain sandwich is the three launches' plain versions: pass 1,
    the sandwich mode, pass 1 inverse without the twiddle; the kernels are
    held to the same pieces."""
    n = 1 << 16
    xr, xi, hr, hi = case(2, 2, n)
    X, H = (tt(xr), tt(xi)), (tt(hr), tt(hi))
    got = fourstep_vmem.spectral_filter_large_plain(*X, *H)
    mid = fourstep_vmem.fourstep_pass1_plain(*X, -1)
    sr, si = fourstep_vmem.fourstep_pass2_sandwich_plain(*mid, *H)
    want = fourstep_vmem.fourstep_pass1_plain(sr, si, 1, twiddle=False)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert snr_db(cplx(*got), sandwich_oracle(xr, xi, hr, hi)) >= 120.0


def sandwich_mid_model(mr, mi, hr, hi) -> np.ndarray:
    """The sandwich mode in float64 numpy on the (B, L1, L2) intermediate,
    flattened: each row k1's length-L2 FFT, times H[k2*L1 + k1], the
    unscaled inverse FFT, times W_n^{-k1*j2}/n, row k1 at k1*L2 + j2."""
    B, n = mr.shape
    L1, L2 = jx_fs._split_sides(n)
    m = (np.asarray(mr, np.float64) + 1j * np.asarray(mi, np.float64)).reshape(B, L1, L2)
    h = (np.asarray(hr, np.float64) + 1j * np.asarray(hi, np.float64)).reshape(L2, L1).T
    z = np.fft.ifft(np.fft.fft(m, axis=2) * h, axis=2) * L2
    k1, j2 = np.arange(L1)[:, None], np.arange(L2)[None, :]
    return (z * np.exp(2j * np.pi * (k1 * j2 % n) / n) / n).reshape(B, n)


@pytest.mark.parametrize("sides", [(128, 256), (256, 256), (1024, 2048)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_sandwich_mode_plain_matches_float64_model(sides):
    """`fourstep_pass2_sandwich_plain` against the float64 model of the
    middle step, with a random complex H, at the non-square split of 2^15,
    a square one and the widest (2^21 = 1024 x 2048); the inputs are left
    as they are (the kernel writes in place, the plain version does not)."""
    L1, L2 = sides
    n = L1 * L2
    assert fourstep_vmem._split_sides(n) == sides
    mr, mi = planes(n + 3, (2, n))
    hr, hi = planes(n + 4, (n,))
    before = (tt(mr).clone(), tt(mi).clone())
    args = (tt(mr), tt(mi), tt(hr), tt(hi))
    got = fourstep_vmem.fourstep_pass2_sandwich_plain(*args)
    assert torch.equal(args[0], before[0]) and torch.equal(args[1], before[1])
    assert snr_db(cplx(*got), sandwich_mid_model(mr, mi, hr, hi)) >= 120.0


@pytest.mark.parametrize("nh", [9, 129])
def test_os_filter_plain_matches_pallas(nh):
    C, n, fft_size = 2, 10000, 2048
    xr, xi = planes(nh, (C, n))
    h = np.random.default_rng(nh + 1).standard_normal(nh)
    got = os_filter_vmem.pallas_os_filter_split(tt(xr), tt(xi), h, fft_size=fft_size)
    want = jx_os.pallas_os_filter_split(xr, xi, h, fft_size=fft_size,
                                        interpret=True)
    assert snr_db(cplx(*got), cplx(*want)) >= 110.0
    for g, x in zip(got, (xr, xi)):
        w = np.stack([np.convolve(row.astype(np.float64), h)[:n] for row in x])
        scale = max(np.abs(w).max(), 1.0)
        assert np.abs(g.numpy() - w).max() / scale < 1e-5


@pytest.mark.parametrize("nh,fft_size,n", [(1, 1024, 3000), (1025, 2048, 9000),
                                           (1537, 2048, 5000)])
def test_os_filter_plain_edges(nh, fft_size, n):
    """One tap (no halo), a halo near the frame, and a signal shorter than
    some frames: still convolve(x, h)[:n]."""
    xr, xi = planes(nh, (1, n))
    h = np.random.default_rng(nh).standard_normal(nh) / nh
    yr, yi = os_filter_vmem.pallas_os_filter_split(tt(xr), tt(xi), h, fft_size=fft_size)
    w = np.convolve(xr[0].astype(np.float64), h)[:n]
    assert np.abs(yr.numpy()[0] - w).max() / max(np.abs(w).max(), 1.0) < 1e-5


def test_os_filter_channels_independent():
    xr, xi = planes(42, (3, 4000))
    h = np.random.default_rng(42).standard_normal(33)
    yr, yi = os_filter_vmem.pallas_os_filter_split(tt(xr), tt(xi), h, fft_size=2048)
    for c in range(3):
        sr, si = os_filter_vmem.pallas_os_filter_split(tt(xr[c]), tt(xi[c]), h,
                                                       fft_size=2048)
        assert torch.equal(yr[c], sr) and torch.equal(yi[c], si)


def test_os_response_is_float64_fft():
    h = np.random.default_rng(0).standard_normal(129)
    hr, hi = os_filter_vmem.os_response_np(h, 2048)
    H = np.fft.fft(np.pad(h, (0, 2048 - 129)))
    assert np.array_equal(hr, H.real.astype(np.float32))
    assert np.array_equal(hi, H.imag.astype(np.float32))


@pytest.mark.parametrize("nh,fft_size", [(2, 1024), (129, 2048), (1025, 2048),
                                         (1921, 2048), (1922, 2048),
                                         (2000, 2048), (16384, 16384)])
def test_taps_fit_is_the_jax_rule(nh, fft_size):
    jax_fits = -(-(nh - 1) // jx_rows.N1) < fft_size // jx_rows.N1
    assert os_filter_vmem.taps_fit(nh, fft_size) == jax_fits


def test_os_filter_refuses_what_jax_refuses():
    """The JAX version's refusals (os_filter_vmem.py:260-284): plane
    shapes that differ, an fft_size the row sandwich does not take, taps
    whose halo fills the frame."""
    z = lambda *s: torch.zeros(*s)
    with pytest.raises(ValueError, match="shapes differ"):
        os_filter_vmem.pallas_os_filter_split(z(2, 8), z(8), np.ones(3))
    with pytest.raises(ValueError, match="fft_size"):
        os_filter_vmem.pallas_os_filter_split(z(100), z(100), np.ones(3), fft_size=1000)
    with pytest.raises(ValueError, match="too long"):
        os_filter_vmem.pallas_os_filter_split(z(5000), z(5000), np.ones(2000),
                                              fft_size=1024)
    with pytest.raises(TypeError, match="float32"):
        x = torch.zeros(100, dtype=torch.float64)
        os_filter_vmem.pallas_os_filter_split(x, x, np.ones(3))


# ------------------------------------------ models of the CUDA sandwiches


def _slots(L, T, R, threads):
    """(thread, slot) -> (j, t) of a radix-R pass under slot mapping 0, the
    mapping of every pass of the filter kernels (csrc/fft_reg.cuh
    `slot_of`): neighbouring threads on neighbouring butterflies of one
    transform."""
    log_j = (L // R).bit_length() - 1
    s = np.arange(threads)[:, None] + np.arange(16 // R)[None, :] * threads
    return s & ((1 << log_j) - 1), s >> log_j


def _plane_at(geo, t, e):
    """Element e of transform t in an exchange plane (fft_reg.cuh `padded`):
    the swizzled row, or stacked swizzled rows."""
    swz = e ^ ((e >> 4) & 31)
    return swz if geo.log_pad == 0 else t * geo.stride + swz


def _engine_model(smem, geo, direction, load, store=None):
    """The register engine's passes on one block, in float64, through the
    exchange planes of `smem` (re plane at 0, im plane at T*stride floats):
    first-pass inputs from load(t, e) (arrays over (thread, slot, r)); each
    pass reads all of its inputs before it writes (the barriers); the last
    pass's outputs go to store(t, e, y), or back into the planes where it
    read them (the in-place hand-off of csrc/filter.cu
    `forward_in_place`) when store is None."""
    L, T, threads = geo.L, geo.T, geo.threads
    im = T * geo.stride
    tw = _common.pass_twiddle_np(L, direction)
    ns, offset, y = 1, 0, None
    for p, R in enumerate(geo.schedule):
        j, t = _slots(L, T, R, threads)
        r = np.arange(R)
        e_in = j[..., None] + r * (L // R)
        t_in = np.broadcast_to(t[..., None], e_in.shape)
        if p == 0:
            a = load(t_in, e_in)
        else:
            a = smem[_plane_at(geo, t_in, e_in)] + 1j * smem[im + _plane_at(geo, t_in, e_in)]
            a = a * tw[offset + ((r // 2) * ns + (j & (ns - 1))[..., None]) * 2 + r % 2]
            offset += ns * R
        y = a @ np.exp(2j * np.pi * direction * np.outer(r, r) / R).T
        if p < len(geo.schedule) - 1:
            e_out = ((j // ns) * ns * R + j % ns)[..., None] + r * ns
            smem[_plane_at(geo, t_in, e_out)] = y.real
            smem[im + _plane_at(geo, t_in, e_out)] = y.imag
        elif store is None:
            smem[_plane_at(geo, t_in, e_in)] = y.real
            smem[im + _plane_at(geo, t_in, e_in)] = y.imag
        else:
            store(t_in, e_in, y)
        ns *= R
    assert offset == len(tw)


def _sandwich_model(smem, geo, H, load, store):
    """csrc/filter.cu `sandwich`: the forward with its spectrum left in the
    planes, then the inverse whose first pass reads it there times H and
    whose last pass stores with 1/L."""
    L = geo.L
    im = geo.T * geo.stride
    _engine_model(smem, geo, -1, load)
    spectrum = lambda t, e: (smem[_plane_at(geo, t, e)] + 1j * smem[im + _plane_at(geo, t, e)]) * H[e]
    _engine_model(smem, geo, 1, spectrum, lambda t, e, y: store(t, e, y / L))


SANDWICH_MODELS = ([("filter_rows", 1 << e, 1) for e in range(9, 15)]
                   + [("os_filter", 1 << e, os_filter_vmem.frames_per_block(1 << e))
                      for e in range(9, 15)] + [("os_filter", 1024, 2), ("os_filter", 1024, 8)])


@pytest.mark.parametrize("kernel,L,T", SANDWICH_MODELS,
                         ids=[f"{k}-L{L}-T{T}" for k, L, T in SANDWICH_MODELS])
def test_sandwich_schedule_model(kernel, L, T):
    """The sandwich as the CUDA kernels run it (slot mapping 0 in every
    pass of both transforms, the spectrum handed over in place in the
    planes, H on the inverse's first-pass reads, 1/L on its last pass's
    stores), modelled in float64 at every length, at every T the wrappers
    pick and the other T of the A/B at 1K frames: ifft(fft(x) * H) to
    float64 rounding."""
    geo = (fft_vmem.rows_geometry(L) if kernel == "filter_rows"
           else os_filter_vmem.os_geometry(L, T))
    assert geo.T == T
    rng = np.random.default_rng(L + T)
    x = rng.standard_normal((T, L)) + 1j * rng.standard_normal((T, L))
    H = rng.standard_normal(L) + 1j * rng.standard_normal(L)
    smem = np.full(geo.smem // 4, np.nan)  # poison: a read of an unwritten float shows
    out = np.full((T, L), np.nan, complex)

    def store(t, e, y):
        out[t, e] = y

    _sandwich_model(smem, geo, H, lambda t, e: x[t, e], store)
    want = np.fft.ifft(np.fft.fft(x) * H)
    assert np.max(np.abs(out - want)) <= 1e-12 * np.max(np.abs(want))


def _os_block_model(xr, xi, h, fft_size):
    """csrc/filter.cu `os_filter_kernel` on [C, n] float32 planes, in
    float64: block (c, g) takes frames f0 = g*T .. f0+T-1 (T =
    `frames_per_block`); its first pass reads frame t's element e from
    x[s0 + t*hop + e], s0 = f0*hop - halo, zero outside [0, n); outputs
    e >= halo of frame t go to y[f0*hop + t*hop + e - halo] below n.
    Returns y and how many times each output was written."""
    C, n = xr.shape
    nh = len(h)
    halo, hop = nh - 1, fft_size - (nh - 1)
    T = os_filter_vmem.frames_per_block(fft_size)
    geo = os_filter_vmem.os_geometry(fft_size, T)
    H = np.fft.fft(np.pad(np.asarray(h, np.float64), (0, fft_size - nh)))
    H = H.real.astype(np.float32) + 1j * H.imag.astype(np.float32)
    n_groups = -(-(-(-n // hop)) // T)
    y = np.zeros((C, n), complex)
    written = np.zeros((C, n), int)
    for c in range(C):
        for g in range(n_groups):
            out0 = g * T * hop
            s0 = out0 - halo

            def load(t, e, c=c, s0=s0):
                k = s0 + t * hop + e
                ok = (k >= 0) & (k < n)
                kk = np.where(ok, k, 0)
                return np.where(ok, xr[c, kk] + 1j * xi[c, kk].astype(np.float64), 0)

            def store(t, e, v, c=c, out0=out0):
                q = out0 + t * hop + e - halo
                keep = (e >= halo) & (q < n)
                np.add.at(written[c], q[keep], 1)
                y[c, q[keep]] = v[keep]

            _sandwich_model(np.full(geo.smem // 4, np.nan), geo, H, load, store)
    return y, written


def _os_model_cases():
    out = []
    for nh in (1, 9, 129, 1025):
        for fft_size in (1024, 2048, 4096):
            if nh - 1 >= fft_size or not os_filter_vmem.taps_fit(nh, fft_size):
                continue
            hop = fft_size - nh + 1
            for n in (1, hop - 1, 3 * hop - 1, 3 * hop + 1):
                if n >= 1:
                    out.append((nh, fft_size, n))
    return out


OS_MODEL_CASES = _os_model_cases()


@pytest.mark.parametrize("nh,fft_size,n", OS_MODEL_CASES,
                         ids=[f"taps{a}-L{b}-n{c}" for a, b, c in OS_MODEL_CASES])
def test_os_layout_model(nh, fft_size, n):
    """The `os_filter` block layout (the T frames of a block and where
    frame t's element e comes from, the output run of each block, ragged
    and zero-padded ends) in float64 on C = 2 channels, against the plain
    version, the JAX kernel in interpret mode and np.convolve: every
    output written exactly once, and the filter's output,
    convolve(x, h)[:n]."""
    C = 2
    xr, xi = planes(nh + n, (C, n))
    h = np.random.default_rng(nh).standard_normal(nh) / nh
    y, written = _os_block_model(xr, xi, h, fft_size)
    assert np.all(written == 1)
    want = np.stack([np.convolve(a.astype(np.float64), h)[:n]
                     + 1j * np.convolve(b.astype(np.float64), h)[:n] for a, b in zip(xr, xi)])
    # H is rounded to float32, as the kernel's table is
    assert np.max(np.abs(y - want)) <= 1e-6 * max(np.max(np.abs(want)), 1.0)
    plain = os_filter_vmem.pallas_os_filter_split(tt(xr), tt(xi), h, fft_size=fft_size)
    assert snr_db(y, cplx(*plain)) >= 110.0
    jax = jx_os.pallas_os_filter_split(xr, xi, h, fft_size=fft_size, interpret=True)
    assert snr_db(y, cplx(*jax)) >= 110.0


# ------------------------------------------------------- the dispatcher


FILTER_ROUTES = [(1024, "smem_rows"), (4096, "smem_rows"), (16384, "smem_rows"),
                 (512, "einsum"), (1000, "einsum"), (1 << 15, "two_pass"),
                 (1 << 20, "two_pass"), (1 << 21, "two_pass"), (1 << 22, "einsum"),
                 (3 << 12, "einsum")]


@pytest.mark.parametrize("n,route", FILTER_ROUTES)
def test_filter_route_table(n, route):
    assert dispatch.select_filter_impl(n) == route


@pytest.mark.parametrize("forced", ["smem_rows", "two_pass"])
def test_filter_route_ignores_other_forced_routes(monkeypatch, forced):
    monkeypatch.setenv("FFTLAB_FORCE_IMPL", forced)
    assert dispatch.select_filter_impl(1000) == "einsum"
    assert dispatch.select_filter_impl(1 << 15) == "two_pass"


@pytest.mark.parametrize("n,seed", [(1024, 1), (1000, 2), (6000, 3), (1 << 15, 4)])
def test_spectral_filter_auto_matches_jax(n, seed):
    """In each window: the row sandwich, the tensor-op sandwich, the
    two-pass sandwich. The JAX dispatcher takes its einsum route on the
    CPU."""
    xr, xi, hr, hi = case(seed, 2, n)
    route = dispatch.select_filter_impl(n)
    got = cplx(*fftlab_torch.spectral_filter_auto(tt(xr), tt(xi), hr, hi))
    want = cplx(*jx_dispatch.spectral_filter_auto(jnp.asarray(xr), jnp.asarray(xi),
                                                  hr, hi))
    assert snr_db(got, want) >= 110.0
    gate = 110.0 if route == "smem_rows" else 120.0
    assert snr_db(got, sandwich_oracle(xr, xi, hr, hi)) >= gate


@pytest.mark.parametrize("n", [1000, 6000])
def test_spectral_filter_auto_permuted(n):
    xr, xi, hr, hi = case(n, 2, n)
    perm = ss.permute_response(hr, hi, n)
    got = fftlab_torch.spectral_filter_auto(tt(xr), tt(xi), hr, hi, permuted=perm)
    want = fftlab_torch.spectral_filter_auto(tt(xr), tt(xi), hr, hi)
    assert snr_db(cplx(*got), cplx(*want)) >= 120.0


@pytest.mark.parametrize("n", [1024, 1 << 15])
def test_force_einsum_pins_the_tensor_op_sandwich(monkeypatch, n):
    xr, xi, hr, hi = case(n, 1, n)
    monkeypatch.setenv("FFTLAB_FORCE_IMPL", "einsum")
    assert dispatch.select_filter_impl(n) == "einsum"
    got = fftlab_torch.spectral_filter_auto(tt(xr), tt(xi), hr, hi)
    want = ss.spectral_filter_split_fused(tt(xr), tt(xi), hr, hi)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("nx,nh", [(200, 17), (900, 33), (30000, 65)])
def test_fft_convolution_split_matches_jax(nx, nh):
    """Padded sizes 256 (einsum), 1024 (row sandwich), 32768 (two-pass)."""
    xr, xi = planes(nx, (2, nx))
    h = np.random.default_rng(nh).standard_normal(nh).astype(np.float32)
    yr, yi = convolution.fft_convolution_split(tt(xr), tt(xi), h)
    jr, ji = jx_conv.fft_convolution_split(xr, xi, h)
    assert yr.shape == (2, nx + nh - 1)
    assert snr_db(cplx(yr, yi), cplx(jr, ji)) >= 110.0
    want = np.stack([np.convolve(a.astype(np.float64) + 1j * b, h.astype(np.float64))
                     for a, b in zip(xr, xi)])
    assert snr_db(cplx(yr, yi), want) >= 110.0


def test_fft_convolution_split_numpy_input_needs_the_card(monkeypatch):
    """A numpy input runs on the card by default, as the JAX function runs
    on its default device; with no CUDA device that raises and names
    `device="cpu"` (it never falls back to the CPU)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    xr, xi = planes(200, (2, 200))
    with pytest.raises(RuntimeError, match='device="cpu"'):
        convolution.fft_convolution_split(xr, xi, np.ones(17, np.float32))


@pytest.mark.parametrize("nx,nh", [(200, 17), (900, 33), (30000, 65)])
def test_fft_convolution_split_numpy_on_cpu_matches_jax(nx, nh):
    """numpy planes with device="cpu": the same result as the JAX function,
    on the CPU."""
    xr, xi = planes(nx, (2, nx))
    h = np.random.default_rng(nh).standard_normal(nh).astype(np.float32)
    yr, yi = convolution.fft_convolution_split(xr, xi, h, device="cpu")
    assert yr.device.type == "cpu" and yr.shape == (2, nx + nh - 1)
    jr, ji = jx_conv.fft_convolution_split(xr, xi, h)
    assert snr_db(cplx(yr, yi), cplx(jr, ji)) >= 110.0


# --------------------------------------------------------- the designs


PARAMS = [
    jx_filt.FilterParams(jx_filt.FilterType.LOWPASS, 0.1),
    jx_filt.FilterParams(jx_filt.FilterType.HIGHPASS, 0.2, transition_width=0.05),
    jx_filt.FilterParams(jx_filt.FilterType.BANDPASS, 50.0, 200.0, sample_rate=1000.0,
                         transition_width=20.0),
    jx_filt.FilterParams(jx_filt.FilterType.BANDSTOP, 0.15, 0.3),
]


def _ours(p):
    return filtering.FilterParams(filtering.FilterType(p.filter_type.value),
                                  p.cutoff_low, p.cutoff_high, p.sample_rate,
                                  p.transition_width)


@pytest.mark.parametrize("i", range(len(PARAMS)))
@pytest.mark.parametrize("n", [64, 1000, 1024])
def test_designs_equal(i, n):
    p = PARAMS[i]
    for name in ("ideal_response", "design_response"):
        a = getattr(filtering, name)(n, _ours(p))
        b = getattr(jx_filt, name)(n, p)
        assert np.max(np.abs(a - b)) <= 1e-12, name
    ideal = jx_filt.ideal_response(n, p)
    assert np.max(np.abs(filtering.apply_transition_band(ideal, n, _ours(p))
                         - jx_filt.apply_transition_band(ideal, n, p))) <= 1e-12


@pytest.mark.parametrize("i", range(len(PARAMS)))
@pytest.mark.parametrize("taps", [33, 64, 129])
def test_design_fir_equal(i, taps):
    a = filtering.design_fir(taps, _ours(PARAMS[i]))
    b = jx_filt.design_fir(taps, PARAMS[i])
    assert a.shape == (taps,) and np.max(np.abs(a - b)) <= 1e-12


def test_custom_response_refused():
    with pytest.raises(ValueError, match="CUSTOM"):
        filtering.ideal_response(16, filtering.FilterParams(filtering.FilterType.CUSTOM, 0.1))


@pytest.mark.parametrize("n", [1000, 1024, 1 << 15])
def test_fft_filter_split_matches_jax(n):
    xr, xi = planes(n, (2, n))
    p = PARAMS[1]
    got = cplx(*fftlab_torch.fft_filter_split(tt(xr), tt(xi), _ours(p)))
    want = cplx(*jx_filt.fft_filter_split(jnp.asarray(xr), jnp.asarray(xi), p))
    assert snr_db(got, want) >= 110.0
    h = jx_filt.design_response(n, p)
    assert snr_db(got, sandwich_oracle(xr, xi, h, np.zeros(n))) >= 110.0


# ------------------------------------------------------------ refusals


@pytest.mark.parametrize("fn,n", [(fft_vmem.pallas_spectral_filter, 1024),
                                  (fourstep_vmem.spectral_filter_large, 1 << 15),
                                  (resident_vmem.spectral_filter_resident, 1 << 15)])
def test_sandwich_wrappers_refuse_other_dtypes(fn, n):
    x = torch.zeros(2, n, dtype=torch.float64)
    h = np.ones(n)
    with pytest.raises(TypeError, match="float32"):
        fn(x, x, h, h)


@pytest.mark.parametrize("fn,n", [(fft_vmem.pallas_spectral_filter, 4096 + 128),
                                  (fft_vmem.pallas_spectral_filter, 512),
                                  (fourstep_vmem.spectral_filter_large, 1 << 14),
                                  (fourstep_vmem.spectral_filter_large, 1 << 22),
                                  (resident_vmem.spectral_filter_resident, 1 << 21),
                                  (resident_vmem.spectral_filter_resident_v7, 1 << 14)])
def test_sandwich_wrappers_refuse_sizes_outside_window(fn, n):
    x = torch.zeros(1, n)
    with pytest.raises(ValueError, match="supports"):
        fn(x, x, np.ones(n), np.zeros(n))


def test_sandwich_keeps_batch_dims():
    for n in (1024, 1 << 15):
        xr, xi, hr, hi = case(n, 6, n)
        yr, yi = fftlab_torch.spectral_filter_auto(tt(xr.reshape(2, 3, n)),
                                                   tt(xi.reshape(2, 3, n)), hr, hi)
        assert yr.shape == (2, 3, n)
        assert snr_db(cplx(yr, yi).reshape(6, n), sandwich_oracle(xr, xi, hr, hi)) >= 110.0
