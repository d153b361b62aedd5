"""The launch geometry that the register-engine wrappers hand their
kernels (csrc/fft_reg.cuh), checked on the CPU for every size of both
windows: `fft_rows` (pow2 n in 512..16384, one row per block) and the
two-pass pair (pow2 n in 2^15..2^21 at the JAX `_split_sides`), and the
three-pass sides that reuse the pair (2^21..2^26). The C side checks what
it is given (`valid_geometry`) and runs it; these are its conditions and
the hardware's: at most 1024 threads in whole warps, at most 232,448
bytes of shared memory a block, a radix schedule whose product is L, and
exchange planes that hold every element of the tile at its own place.

The engine's twiddle table and schedule are also run here as a float64
numpy model of its passes (same slots, same table offsets), which must
give the DFT to float64 rounding; and its shared-memory exchanges as a
model of the banks: every warp's store and load of 32 floats of one
plane must take one wavefront (single rows, and tiles of 8 or 16
transforms at L >= 512) or at most two (tiles at L <= 256).
"""

import dataclasses
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import fftlab.kernels.fourstep_vmem as jx_fs
import fftlab.kernels.threestep_vmem as jx_ts
from fftlab_torch.kernels import (_common, fft_vmem, fourstep_vmem, os_filter_vmem, stft_vmem,
                                  threestep_vmem)

MAX_SMEM = 232448

WINDOWS = ([("rows", 1 << e) for e in range(9, 15)]
           + [("two_pass", 1 << e) for e in range(15, 22)]
           + [("three_pass", 1 << e) for e in range(21, 27)])


def _at(geo, t, e):
    """Where the engine keeps element e of transform t in each exchange
    plane, in floats (csrc/fft_reg.cuh `padded`)."""
    if geo.log_pad == 0:  # a single row: no pad, swizzled
        return e ^ ((e >> 4) & 31)
    if geo.log_pad == _common.FRAME_ROWS:  # stacked rows, each swizzled
        return t * geo.stride + (e ^ ((e >> 4) & 31))
    return t * geo.stride + e + (e >> geo.log_pad)


def _launches(window: str, n: int):
    """(L, geometry, role) of every launch a wrapper makes at size n."""
    if window == "rows":
        return [(n, fft_vmem.rows_geometry(n), "row")]
    if window == "two_pass":
        L1, L2 = fourstep_vmem._split_sides(n)
        assert (L1, L2) == jx_fs._split_sides(n)
        return [(L1, fourstep_vmem.pass1_geometry(L1, L2), "columns"),
                (L2, fourstep_vmem.pass2_geometry(L1, L2), "rows")]
    F1, F2, F3 = threestep_vmem._split_three(n)
    assert (F1, F2, F3) == jx_ts._split_three(n)
    return [(F1, fourstep_vmem.pass1_geometry(F1, F2 * F3), "columns"),
            (F2, fourstep_vmem.pass1_geometry(F2, F3), "columns"),
            (F3, fourstep_vmem.pass2_geometry(F1 * F2, F3), "rows")]


@pytest.mark.parametrize("window,n", WINDOWS,
                         ids=[f"{w}-2^{n.bit_length() - 1}" for w, n in WINDOWS])
def test_launch_geometry(window, n):
    for L, geo, role in _launches(window, n):
        assert geo.L == L
        assert geo.threads <= 1024 and geo.threads % 32 == 0
        assert 16 * geo.threads == geo.T * L
        assert geo.smem <= MAX_SMEM
        assert math.prod(geo.schedule) == L
        assert all(r == 16 for r in geo.schedule[:-1]) and geo.schedule[-1] in (2, 4, 8, 16)
        at = _at(geo, np.arange(geo.T)[:, None], np.arange(L)[None, :])
        assert len(np.unique(at)) == geo.T * L and at.min() >= 0
        assert at.max() < geo.T * geo.stride and geo.smem >= 8 * geo.T * geo.stride
        if role == "row":
            assert geo.T == 1
        elif role == "columns":
            # W columns: runs of 8 or 16 floats, inside the width-16 tables
            assert geo.T in (8, 16)
        else:
            # R rows: the corner-turned store writes runs of 8 k1
            assert geo.T in (8, 16)
        # tiles of up to 8K values let two blocks share an SM
        if geo.T * L <= fourstep_vmem.SHARED_TILE:
            assert 2 * geo.smem <= MAX_SMEM and 2 * geo.threads <= 2048
        # pass 1 (every launch here twiddles) stages its W columns of S
        # from STAGED_MIN_L1
        staged = (8 * geo.T * fourstep_vmem.staged_rows(L)
                  if role == "columns" and L >= fourstep_vmem.STAGED_MIN_L1 else 0)
        assert geo.smem == 8 * geo.T * geo.stride + staged


def _slots(L, T, R, g, threads):
    """(thread, slot) -> (j, t) of a radix-R pass (fft_reg.cuh slot_of)."""
    log_j = (L // R).bit_length() - 1
    s = np.arange(threads)[:, None] + np.arange(16 // R)[None, :] * threads
    hi = s >> g
    return hi & ((1 << log_j) - 1), ((hi >> log_j) << g) | (s & ((1 << g) - 1))


@pytest.mark.parametrize("L", [32, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384])
@pytest.mark.parametrize("direction", [-1, 1])
def test_engine_schedule_computes_the_dft(L, direction):
    """The passes of fft_reg.cuh `fft_tile` in float64 numpy, on T = 2
    transforms with the pass-2 slot mappings (g = 0 first, then g = 1):
    inputs j + r*L/R, twiddle r of butterfly class k from the pass's
    pairs in `pass_twiddle_np` at [offset + ((r//2)*ns + k)*2 + r%2],
    outputs at (j/ns)*ns*R + j mod ns + r*ns."""
    T = 2
    rng = np.random.default_rng(L)
    x = rng.standard_normal((T, L)) + 1j * rng.standard_normal((T, L))
    tw = _common.pass_twiddle_np(L, direction)
    threads = T * L // 16
    cur = x.copy()
    ns, offset = 1, 0
    for p, R in enumerate(_common.radix_schedule(L)):
        j, t = _slots(L, T, R, 0 if p == 0 else 1, threads)
        r = np.arange(R)
        a = cur[t[..., None], j[..., None] + r * (L // R)]  # (threads, slots, R)
        if ns > 1:
            a *= tw[offset + ((r // 2) * ns + (j & (ns - 1))[..., None]) * 2 + r % 2]
            offset += ns * R
        F = np.exp(2j * np.pi * direction * np.outer(r, r) / R)
        y = a @ F.T
        nxt = np.empty_like(cur)
        nxt[t[..., None], ((j // ns) * ns * R + j % ns)[..., None] + r * ns] = y
        cur, ns = nxt, ns * R
    assert offset == len(tw)
    want = np.fft.fft(x) if direction == -1 else np.fft.ifft(x) * L
    assert np.max(np.abs(cur - want)) <= 1e-10 * np.max(np.abs(want))


@pytest.mark.parametrize("L", [2, 4, 8, 16])
@pytest.mark.parametrize("direction", [-1, 1])
def test_engine_short_lengths_compute_the_dft(L, direction):
    """fft_reg.cuh `run_short`, the stages of length 2..16: one pass, no
    twiddle table, thread s holding the 16/L transforms s + i*threads of a
    stage's tile, each transform held by one thread once, its DFT in
    natural order."""
    geo = fourstep_vmem.stage_geometry(L)
    assert geo.schedule == (L,) and geo.smem == 0 and len(_common.pass_twiddle_np(L, direction)) == 0
    rng = np.random.default_rng(L)
    x = rng.standard_normal((geo.T, L)) + 1j * rng.standard_normal((geo.T, L))
    t = np.arange(geo.threads)[:, None] + np.arange(16 // L)[None, :] * geo.threads
    assert np.array_equal(np.sort(t.ravel()), np.arange(geo.T))
    F = np.exp(2j * np.pi * direction * np.outer(np.arange(L), np.arange(L)) / L)
    got = np.empty_like(x)
    got[t] = x[t] @ F.T
    want = np.fft.fft(x) if direction == -1 else np.fft.ifft(x) * L
    assert np.max(np.abs(got - want)) <= 1e-12 * np.max(np.abs(want))


# (role, L, T, slot mapping of the first pass, of the later passes):
# every exchange the kernels run (fft_rows.cu, fourstep.cu): rows, the
# pair's columns and rows, a stage of the stage pipeline (16 columns of
# 256/L rows, slot mapping 4, from L = 32; the shorter stages have no
# exchange) and its leaf (32 rows at 128)
EXCHANGES = ([("row", 1 << e, 1, 0, 0) for e in range(9, 15)]
             + [("columns", 1 << e, T, 3, 3) for e in range(7, 11) for T in (8, 16)]
             + [("rows", 1 << e, T, 0, 3) for e in range(7, 12) for T in (8, 16)
                if T << e <= 16384]
             + [("stage", 1 << e, 4096 >> e, 4, 4) for e in range(1, 8)]
             + [("leaf", 128, 32, 0, 3)])


def _wavefronts(addr):
    """Wavefronts of each warp access: addr is (warps, 32) floats."""
    bank = addr % 32
    worst = np.zeros(addr.shape[0], np.int64)
    for b in range(32):
        hit = np.where(bank == b, addr, -1)
        distinct = np.array([len(set(row[row >= 0])) for row in hit])
        worst = np.maximum(worst, distinct)
    return worst


# (fft_size, hop, T): `stft_frames` at the STFT window's frame sizes, at
# the T of frames_per_block and of chip_smoke.py's A/B
STFT_BANKS = [(128, 128, 32), (256, 128, 16), (256, 128, 32), (512, 256, 8), (1024, 128, 4),
              (1024, 128, 8), (2048, 512, 2), (2048, 512, 4), (4096, 1024, 1), (16384, 4096, 1)]


@pytest.mark.parametrize("fft_size,hop,T", STFT_BANKS,
                         ids=[f"{f}-{h}-T{t}" for f, h, t in STFT_BANKS])
@pytest.mark.parametrize("onesided", [True, False], ids=["onesided", "twosided"])
def test_stft_layout_bank_conflicts(fft_size, hop, T, onesided):
    """csrc/real.cu `stft_frames_kernel`'s own shared-memory accesses: the
    first pass's 8-byte reads of the frames' pairs from the span
    (`span_at`, one frame's lanes and the next one's on the two halves of
    the banks at hop = 128), the unpack's reads of Z[k] and Z[m-k] from
    the planes, its writes of bins k, m-k and the two-sided mirrors into
    the staging rows (at each alignment shift), and the copy-out's 16-byte
    reads of the staging run. An 8-byte access takes at least one
    wavefront per half-warp."""
    m, half = fft_size // 2, fft_size // 4
    bins = m + 1 if onesided else fft_size
    geo = stft_vmem.stft_geometry(fft_size, hop, T, bins)
    lay = stft_vmem.stft_layout(m, hop, T, geo.stride, bins)
    threads = geo.threads
    worst = {}
    # the first pass (g = 0): thread s holds butterfly j of frame t, inputs
    # j + r*m/16; frame t's pairs start at lead + t*hop in one span
    j, t = _slots(m, T, 16, 0, threads)
    for lead in (0, 2):  # x 16-byte aligned, or 8 bytes past
        for r in range(16):
            u = lead + t * hop * (lay.nseg == 1) + 2 * (j + r * (m // 16))
            a = lay.span + (t * lay.seg_pitch if lay.nseg > 1 else 0) + stft_vmem.span_at(u)
            pairs = np.stack([a, a + 1], -1).reshape(-1, 16, 2).reshape(-1, 32)  # half-warps
            key = f"span{lead}"
            worst[key] = max(worst.get(key, 0), int(_wavefronts(pairs).max()))
    # the unpack: pair p = thread + i*threads -> (t, k), k fastest
    p = np.arange(threads)[:, None] + np.arange(8)[None, :] * threads
    t, k = p >> (m.bit_length() - 2), p & (half - 1)
    for e in (k, np.where(k == 0, 0, m - k)):
        worst["planes"] = max(worst.get("planes", 0),
                              int(_wavefronts(_at(geo, t, e).T.reshape(-1, 32)).max()))
    for shift in range(4):
        for b in (k, m - k, 2 * m - k, m + k) if not onesided else (k, m - k):
            ok = (b >= 0) & (b < bins)
            addr = np.where(ok, shift + t * bins + b, -1)
            worst["stage"] = max(worst.get("stage", 0),
                                 int(_wavefronts(addr.T.reshape(-1, 32)).max()))
    words = 4 * np.arange(min(threads, 64))[:, None] + np.arange(4)[None, :]
    worst["copy"] = int(_wavefronts(words.reshape(-1, 8, 4).reshape(-1, 32)).max())
    # an aligned signal's frames take one wavefront per half-warp from
    # m = 128 up (at m = 64 four frames share a half-warp: two); a lead of
    # two floats, or the wrap of a pad in the planes (k = 0..31 spans 33
    # floats, and Z[m-k] starts one past a 32-float boundary), costs one
    # more; the staging rows and the copy-out take one
    assert worst == {"span0": 1 if m >= 128 else 2, "span2": 2, "planes": 2, "stage": 1,
                     "copy": 1}, worst


# and two hops longer than the frame, where each frame has its segment
STFT_LAYOUTS = STFT_BANKS + [(1024, 2048, 4), (8192, 16384, 1)]


@pytest.mark.parametrize("fft_size,hop,T", STFT_LAYOUTS,
                         ids=[f"{f}-{h}-T{t}" for f, h, t in STFT_LAYOUTS])
def test_stft_layout_struct(fft_size, hop, T):
    """`stft_layout` is the layout's one copy: it goes to the kernel as it
    is (`StftLayout.c_struct`), whose launcher only checks it
    (csrc/real.cu `valid_layout`). The C struct has the dataclass's
    fields in order and its values; the layout holds what the kernel
    reads and writes (each segment's words over a lead of up to 3
    floats, the planes, segments, window and staging planes apart, the
    16-byte words aligned) in the geometry's shared memory."""
    m = fft_size // 2
    for bins in (m + 1, fft_size):
        geo = stft_vmem.stft_geometry(fft_size, hop, T, bins)
        lay = stft_vmem.stft_layout(m, hop, T, geo.stride, bins)
        c = lay.c_struct()
        names = [f.name for f in dataclasses.fields(lay)]
        assert [name for name, _ in c._fields_] == names
        assert [getattr(c, name) for name in names] == list(dataclasses.astuple(lay))
        seg_len = (T - 1) * hop + fft_size if lay.nseg == 1 else fft_size
        assert lay.nseg == (1 if hop <= fft_size else T)
        assert 4 * lay.words >= seg_len + 3
        assert lay.seg_pitch % 4 == 0
        assert lay.seg_pitch >= stft_vmem.span_at(4 * (lay.words - 1)) + 4
        assert lay.span % 4 == 0 and lay.span >= 2 * T * geo.stride
        assert lay.window % 2 == 0 and lay.window >= lay.span + lay.nseg * lay.seg_pitch
        assert lay.stage_pitch % 4 == 0 and lay.stage_pitch >= T * bins + 3
        assert lay.total >= max(lay.window + fft_size, 2 * lay.stage_pitch)
        assert geo.smem == 4 * lay.total <= 232448  # a block's shared memory on the H100


@pytest.mark.parametrize("role,L,T,g_first,g", EXCHANGES,
                         ids=[f"{r}-L{L}-T{T}" for r, L, T, _, _ in EXCHANGES])
def test_exchange_layout_bank_conflicts(role, L, T, g_first, g):
    geo = fourstep_vmem.stage_geometry(L) if role == "stage" else _common.tile_geometry(L, T)
    assert geo.T == T
    if L <= 16:  # one pass in registers: no exchange, no shared memory
        assert len(geo.schedule) == 1 and geo.smem == 0
        return
    threads = geo.threads
    worst = 0
    ns = 1
    for p, R in enumerate(geo.schedule):
        j, t = _slots(L, T, R, g_first if p == 0 else g, threads)  # (threads, slots)
        for r in range(R):
            for kind in ("store", "load"):
                if (kind == "store" and p == len(geo.schedule) - 1) or (kind == "load" and p == 0):
                    continue  # the first pass loads and the last stores in device memory
                e = ((j // ns) * ns * R + j % ns + r * ns) if kind == "store" else j + r * (L // R)
                a = _at(geo, t, e)
                worst = max(worst, int(_wavefronts(a.T.reshape(-1, 32)).max()))
        ns *= R
    assert worst <= (1 if T == 1 or L >= 512 or role == "stage" else 2)


# ------------------------------------------------ pass 1's staged twiddle

# A block's shared memory on the H100 is at most 227 KB of an SM's 228 KB,
# with 1 KB reserved for each block.
SM_SMEM = 233472
BLOCK_RESERVE = 1024
# The most a pass-1 block stages of S.
STAGED_BUDGET = 8192
# (L1, W): every pass-1 column length that stages S (from STAGED_MIN_L1)
# at the W of `pass1_geometry` and the other W of chip_smoke.py's geometry
# A/B
STAGED = [(1 << e, W) for e in range(9, 11) for W in (8, 16)]


def _staged_at(q, t, log_w, g):
    """Where a pass-1 block keeps column t of row q of S, in float2s past
    the planes (csrc/fourstep.cu `column_tile`)."""
    return (q << log_w) + (t ^ ((q << g) & ((1 << log_w) - 1)))


@pytest.mark.parametrize("L1,W", STAGED, ids=[f"L{L}-W{W}" for L, W in STAGED])
def test_pass1_staged_twiddle_slots(L1, W):
    """A float64 model of pass 1's twiddled store (csrc/fourstep.cu
    `column_tile`) at a block that is neither the first nor the last: its
    copy of S's rows, by pairs of columns (i -> row i >> (log_w - 1),
    column (2i) mod W), into the staged layout, and the engine's last pass
    (fft_reg.cuh `last`, slot mapping g = run_bits(log_w)): output r of
    butterfly j of transform t is k1 = j + r*L1/R of column j2_0 + t, and
    reads rows k1 mod U and U + k1 div U. Every output reads only what the
    block staged, and the product of the two is W_n^{k1*j2}; the staged
    bytes stay within STAGED_BUDGET, and at W = 8 and L1 = 1024 two blocks
    fit an SM; every half-warp's read of either factor takes one
    wavefront (an 8-byte read takes two a warp at least)."""
    L2 = 2048
    n = L1 * L2
    geo = fourstep_vmem.pass1_geometry(L1, L2, W)
    U, rows = fourstep_vmem.staged_split(L1), fourstep_vmem.staged_rows(L1)
    assert U * U in (L1, 2 * L1) and rows == U + L1 // U
    log_w, g = W.bit_length() - 1, min(3, W.bit_length() - 1)
    assert geo.smem == 8 * W * geo.stride + 8 * W * rows <= MAX_SMEM
    assert 8 * W * rows <= STAGED_BUDGET
    if (L1, W) == (1024, 8):
        assert 2 * (geo.smem + BLOCK_RESERVE) <= SM_SMEM and geo.threads == 512
    S = fourstep_vmem._staged_twiddle_np(L1, L2, -1)
    assert S.shape == (rows, L2)
    j2_0 = 5 * W
    staged = np.full(W * rows, np.nan + 0j)
    for i in range(rows * W // 2):
        q, t = i >> (log_w - 1), (2 * i) % W
        at = _staged_at(q, t, log_w, g)
        assert at % 2 == 0  # a 16-byte store
        staged[at:at + 2] = S[q, j2_0 + t:j2_0 + t + 2]
    assert not np.isnan(staged).any()
    R = geo.schedule[-1]
    j, t = _slots(L1, W, R, g, geo.threads)  # (threads, slots)
    for r in range(R):
        k1 = j + r * (L1 // R)
        b_at, c_at = _staged_at(k1 % U, t, log_w, g), _staged_at(U + k1 // U, t, log_w, g)
        want = np.exp(-2j * np.pi * (k1 * (j2_0 + t) % n) / n)
        assert np.max(np.abs(staged[b_at] * staged[c_at] - want)) <= 1e-12
        for at in (b_at, c_at):
            floats = np.stack([2 * at.T, 2 * at.T + 1], -1).reshape(-1, 32)  # half-warps
            assert _wavefronts(floats).max() == 1


@pytest.mark.parametrize("n", [1 << 18, 1 << 20, 1 << 21], ids=lambda n: f"2^{n.bit_length() - 1}")
@pytest.mark.parametrize("direction", [-1, 1])
def test_pass1_staged_twiddle_rounding(n, direction):
    """The two factors of pass 1's staged twiddle (two-pass sizes with L1 =
    512 and 1024) rounded to float32, as the wrapper's table holds them,
    multiplied as the kernel's `cmul` does (fma(a.x, b.x, -a.y*b.y),
    fma(a.x, b.y, a.y*b.x)): within 2 ulp of float32 below 1 (2^-24, where
    the components of W lie) of the float64 W_n^{k1*j2} at every (k1,
    j2)."""
    L1, L2 = fourstep_vmem._split_sides(n)
    assert L1 >= fourstep_vmem.STAGED_MIN_L1
    U = fourstep_vmem.staged_split(L1)
    S = fourstep_vmem._staged_twiddle_np(L1, L2, direction)
    k1 = np.arange(L1)
    b, c = S[k1 % U], S[U + k1 // U]
    br, bi, cr, ci = (x.astype(np.float32) for x in (b.real, b.imag, c.real, c.imag))
    f64 = np.float64
    re = (f64(br) * f64(cr) - f64(bi * ci)).astype(np.float32)
    im = (f64(br) * f64(ci) + f64(bi * cr)).astype(np.float32)
    want = np.exp(2j * np.pi * direction * ((k1[:, None] * np.arange(L2)[None, :]) % n) / n)
    ulp = 2.0 ** -24
    assert np.abs(re - want.real).max() <= 2 * ulp
    assert np.abs(im - want.imag).max() <= 2 * ulp


# ------------------------------------------------- the filter sandwiches

# (kernel, L, T): `filter_rows` (one row, fft_rows' geometry) at every
# length, and `os_filter` at every frame size at its default T, 1K frames
# also at the other T of chip_smoke.py's A/B
SANDWICHES = ([("filter_rows", 1 << e, 1) for e in range(9, 15)]
              + [("os_filter", 1 << e, os_filter_vmem.frames_per_block(1 << e))
                 for e in range(9, 15)] + [("os_filter", 1024, 2), ("os_filter", 1024, 8)])


def _plane_accesses(geo):
    """(kind, addresses) of every access to the exchange planes of the
    sandwich (csrc/filter.cu `forward_in_place`, then Engine::run): the
    forward's stores after each pass, its last pass's in-place loads and
    stores, the inverse's loads of every pass (its first pass reads the
    forward's spectrum) and its stores before its last pass; slot mapping
    0 in every pass. Addresses are (warps, 32) floats of one plane."""
    L, T, threads = geo.L, geo.T, geo.threads
    out = []
    for transform in ("forward", "inverse"):
        ns = 1
        for p, R in enumerate(geo.schedule):
            j, t = _slots(L, T, R, 0, threads)
            last = p == len(geo.schedule) - 1
            for r in range(R):
                load = j + r * (L // R)
                store = load if last else (j // ns) * ns * R + j % ns + r * ns
                if p > 0 or transform == "inverse":
                    out.append(("load", _at(geo, t, load)))
                if transform == "forward" or not last:
                    out.append(("store", _at(geo, t, store)))
            ns *= R
    return [(kind, a.T.reshape(-1, 32)) for kind, a in out]


@pytest.mark.parametrize("kernel,L,T", SANDWICHES, ids=[f"{k}-L{L}-T{T}" for k, L, T in SANDWICHES])
def test_sandwich_bank_conflicts(kernel, L, T):
    """Every exchange-plane access of both transforms of the filter
    sandwiches, the in-place hand-off included, takes one wavefront per
    32 floats: the swizzled row, and stacked swizzled rows under the slot
    mapping 0 (the padded tile takes two there, which is why the frames
    are rows)."""
    geo = fft_vmem.rows_geometry(L) if kernel == "filter_rows" else os_filter_vmem.os_geometry(L, T)
    worst = {}
    for kind, addr in _plane_accesses(geo):
        worst[kind] = max(worst.get(kind, 0), int(_wavefronts(addr).max()))
    assert worst == {"load": 1, "store": 1}, worst
    if T > 1:  # the padded tile under the same slot mapping
        padded = _common.tile_geometry(L, T)
        assert max(int(_wavefronts(a).max()) for _, a in _plane_accesses(padded)) == 2


OS_LAYOUTS = [(L, T, nh) for e in range(9, 15) for L in [1 << e]
              for T in ([1] if L >= 4096 else [t for t in (1, 2, 4, 8, 16) if t * L <= 8192])
              for nh in (1, 9, 129, 1025, L // 2, L) if nh - 1 < L]


@pytest.mark.parametrize("L,T,nh", OS_LAYOUTS, ids=[f"L{L}-T{T}-taps{nh}" for L, T, nh in OS_LAYOUTS])
def test_os_geometry_struct(L, T, nh):
    """`os_geometry` goes to the kernel as it is (`TileGeometry.c_struct`),
    whose launcher only checks it (csrc/filter.cu fftlab_os_filter,
    fft_reg.cuh `valid_geometry`): the C struct has the fields and values
    the launcher reads; the stacked swizzled rows up to 2K frames (T*L <=
    8192, 512 threads at most, the kernel's launch bounds) and one
    swizzled row from 4K (T = 1); rows 32-float aligned, every element of
    the tile at its own place in the planes, the planes in the block's
    shared memory, two blocks an SM up to 8192 points; every frame's
    samples t*hop + e and outputs t*hop + e - halo inside the block's span
    of T*hop + halo samples, the outputs each once."""
    hop = L - (nh - 1)
    geo = os_filter_vmem.os_geometry(L, T)
    c = geo.c_struct()
    assert [name for name, _ in c._fields_] == ["threads", "smem", "log_last", "log_pad",
                                                "stride"]
    assert (c.threads, c.smem, c.log_pad, c.stride) == (geo.threads, geo.smem, geo.log_pad,
                                                         geo.stride)
    assert c.log_last == (L.bit_length() - 1) % 4
    if L >= os_filter_vmem.ONE_FRAME:
        assert T == 1 and geo.log_pad == 0 and geo.threads == L // 16
    else:
        assert T * L <= 8192 and geo.threads <= 512 and geo.log_pad == _common.FRAME_ROWS
    assert geo.threads == T * L // 16 and geo.threads % 32 == 0
    assert geo.stride >= L and geo.stride % 32 == 0
    assert 8 * T * geo.stride <= geo.smem <= MAX_SMEM
    t, e = np.arange(T)[:, None], np.arange(L)[None, :]
    at = _at(geo, t, e)  # every element of the tile at its own place in the planes
    assert len(np.unique(at)) == T * L and at.min() >= 0 and at.max() < T * geo.stride
    if T * L <= 8192:  # two blocks an SM
        assert 2 * geo.smem <= MAX_SMEM and 2 * geo.threads <= 2048
    assert (t * hop + e).max() < T * hop + (nh - 1)
    q = (t * hop + e - (nh - 1))[:, nh - 1:]
    assert np.array_equal(np.sort(q.ravel()), np.arange(T * hop))


def test_os_geometry_refuses_what_the_launcher_refuses():
    with pytest.raises(ValueError, match="T = 1 from"):
        os_filter_vmem.os_geometry(4096, 2)
    with pytest.raises(ValueError, match="T\\*fft_size"):
        os_filter_vmem.os_geometry(1024, 16)
    assert os_filter_vmem.frames_per_block(1024) == 4
    with pytest.raises(ValueError, match="pow2"):
        os_filter_vmem.os_geometry(1000, 1)


# ------------------------------------- the two-pass sandwich's middle step

# (n, R): pass 2's sandwich mode (csrc/fourstep.cu
# `fourstep_pass2_sandwich_kernel`) at every two-pass size and its default
# R, and the other R of chip_smoke.py's geometry A/B at 2^20 and 2^21
SANDWICH_MODE = ([(1 << e, None) for e in range(15, 22)] + [(1 << 20, 8), (1 << 21, 4)])


def _sandwich_mode_accesses(geo, g):
    """(access, addresses) of every exchange-plane access of the sandwich
    mode (csrc/sandwich.cuh): the forward's first pass with slot mapping 0
    (its loads are in device memory), its later passes and the in-place
    hand-off g; the inverse's first pass (its reads of the spectrum) and
    later passes g, its last pass 0 (its stores are in device memory).
    Addresses are (warps, 32) floats of one plane."""
    L, T, threads = geo.L, geo.T, geo.threads
    n_pass = len(geo.schedule)
    out = []
    for transform, maps in (("forward", [0] + [g] * (n_pass - 1)),
                            ("inverse", [g] * (n_pass - 1) + [0])):
        ns = 1
        for p, R in enumerate(geo.schedule):
            j, t = _slots(L, T, R, maps[p], threads)
            last = p == n_pass - 1
            for r in range(R):
                load = j + r * (L // R)
                store = load if last else (j // ns) * ns * R + j % ns + r * ns
                if p > 0 or transform == "inverse":
                    out.append((f"{transform} {'last' if last else p} load", _at(geo, t, load)))
                if transform == "forward" or not last:
                    out.append((f"{transform} {'last' if last else p} store",
                                _at(geo, t, store)))
            ns *= R
    return [(kind, a.T.reshape(-1, 32)) for kind, a in out]


def _sectors(floats):
    """32-byte sectors each warp's access touches: floats is (warps, 32)
    float offsets of 32-byte-aligned planes."""
    return np.array([len(set(row // 8)) for row in floats])


@pytest.mark.parametrize("n,R", SANDWICH_MODE,
                         ids=[f"2^{n.bit_length() - 1}-R{r or 'default'}" for n, r in SANDWICH_MODE])
def test_sandwich_mode_tile(n, R):
    """The tile of pass 2's sandwich mode (`sandwich_geometry`): R rows of
    L2 in pass 2's padded tile (a row stride of L2 + L2/16 + 32/min(R, 8)),
    4K values up to 2^20, in a block's shared memory, two blocks an SM
    where the tile is at most 8K values (at 2^21 the default R = 8 is a
    16K-value tile of 1024 threads, one block an SM, as pass 2's; the
    A/B's R = 4 is two). H's reads in the inverse's first pass (slot mapping
    run_bits(R)): H[k2*L1 + k1_0 + t], a warp's 32 floats in 4 whole
    32-byte sectors at R >= 8 (8 at R = 4; under slot mapping 0 a float
    or two would take a sector of its own); the last pass's stores (mapping 0)
    32 consecutive floats of one row; every exchange one wavefront per 32
    floats, but two in the forward's first store at L2 <= 256 (pass 2's
    own) and in the inverse's last loads (mapping 0 in the padded tile)."""
    L1, L2 = fourstep_vmem._split_sides(n)
    geo = fourstep_vmem.sandwich_geometry(L1, L2, R)
    assert geo.L == L2 and geo.T == (R or fourstep_vmem.SANDWICH_ROWS[L2]) and geo.T <= L1
    assert geo.T * L2 == (16384 if (n, R) == (1 << 21, None) else 4096) or R
    assert geo.stride == L2 + L2 // 16 + 32 // min(geo.T, 8)
    assert geo.log_pad == 4 and geo.smem == 8 * geo.T * geo.stride <= MAX_SMEM
    assert geo.threads == geo.T * L2 // 16 <= 1024
    two_blocks = 2 * geo.smem <= MAX_SMEM and 2 * geo.threads <= 2048 and geo.threads <= 512
    assert two_blocks == (geo.T * L2 <= fourstep_vmem.SHARED_TILE)
    g = min(3, geo.T.bit_length() - 1)  # csrc/fourstep.cu run_bits(log_r)
    k1_0 = geo.T  # the second block of a batch row
    j, t = _slots(L2, geo.T, 16, g, geo.threads)  # the first pass: slot 0, inputs j + r*L2/16
    for r in range(16):
        h_at = ((j + r * (L2 // 16)) * L1 + k1_0 + t).T.reshape(-1, 32)
        assert _sectors(h_at).max() == (4 if geo.T >= 8 else 8)
    j0, t0 = _slots(L2, geo.T, 16, 0, geo.threads)
    assert _sectors(((j0 * L1) + t0).T.reshape(-1, 32)).min() >= 16  # mapping 0's
    R_last = geo.schedule[-1]
    j, t = _slots(L2, geo.T, R_last, 0, geo.threads)
    for r in range(R_last):
        at = (t * L2 + j + r * (L2 // R_last)).T.reshape(-1, 32)
        assert np.all(_sectors(at) == 4)  # runs of 16 or 32 floats of a row
    worst = {}
    for kind, addr in _sandwich_mode_accesses(geo, g):
        worst[kind] = max(worst.get(kind, 0), int(_wavefronts(addr).max()))
    want = {kind: 1 for kind in worst}
    want["inverse last load"] = 2
    if L2 <= 256:
        want["forward 0 store"] = 2
    assert worst == want, worst
    if geo.T < 8:  # pass 2's stride would take two wavefronts
        pass2 = fourstep_vmem.pass2_geometry(L1, L2, geo.T)
        assert max(int(_wavefronts(a).max()) for _, a in _sandwich_mode_accesses(pass2, g)) == 2


@pytest.mark.parametrize("n", [1 << 15, 1 << 16, 1 << 21], ids=lambda n: f"2^{n.bit_length() - 1}")
def test_sandwich_mode_indexing(n):
    """The sandwich mode's index rules in float64 numpy, block by block as
    the kernel runs them (csrc/fourstep.cu `fourstep_pass2_sandwich_kernel`):
    block b*(L1/R) + c takes rows k1_0 + t (k1_0 = c*R, t < R) at
    row0 + t*L2 + e, reads H at e*L1 + k1_0 + t, and stores element e of
    row t times A[(e >> 4)*L1 + k1_0 + t] * P[(k1_0 + t)*16 + (e & 15)]
    from the wrapper's tables; the result is the middle step
    W_n^{-k1*j2}/n * IFFT(FFT(row) * H[k2*L1 + k1])."""
    L1, L2 = fourstep_vmem._split_sides(n)
    R = fourstep_vmem.sandwich_geometry(L1, L2).T
    rng = np.random.default_rng(n)
    B = 2
    m = rng.standard_normal((B, n)) + 1j * rng.standard_normal((B, n))
    h = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    _, _, a_tab, p_tab = fourstep_vmem._sandwich_tables(L1, L2, torch.device("cpu"))
    A = a_tab.numpy().astype(np.float64) @ np.array([1, 1j])
    P = p_tab.numpy().astype(np.float64) @ np.array([1, 1j])
    assert A.shape == (L2 // 16, L1) and P.shape == (L1, 16)
    A, P = A.ravel(), P.ravel()
    out = m.copy()  # in place
    e = np.arange(L2)
    for block in range(B * (L1 // R)):
        b, c = divmod(block, L1 // R)
        k1_0 = c * R
        for t in range(R):
            at = b * n + (k1_0 + t) * L2 + e
            row = m.ravel()[at]
            z = np.fft.ifft(np.fft.fft(row) * h[e * L1 + k1_0 + t]) * L2
            out.ravel()[at] = z * A[(e >> 4) * L1 + k1_0 + t] * P[(k1_0 + t) * 16 + (e & 15)]
    k1, j2 = np.arange(L1)[:, None], np.arange(L2)[None, :]
    z = np.fft.ifft(np.fft.fft(m.reshape(B, L1, L2), axis=2) * h.reshape(L2, L1).T, axis=2) * L2
    want = (z * np.exp(2j * np.pi * (k1 * j2 % n) / n) / n).reshape(B, n)
    assert np.max(np.abs(out - want)) <= 1e-6 * np.max(np.abs(want))  # float32 tables


# ----------------------------------- pass 2's unpack mode (the fused r2c)

# (L1, L2) of every half size m = 2^15..2^20 of the fused r2c, and each R
# the unpack mode takes
UNPACK_SIDES = [fourstep_vmem._split_sides(1 << e) for e in range(15, 21)]
UNPACK_MODE = [(L1, L2, R) for L1, L2 in UNPACK_SIDES for R in (None, 8, 16)]
RUN = fourstep_vmem.UNPACK_RUN


def _unpack_rows(L1, R, c):
    """The rows of block c of a batch row in the unpack mode, in the order
    of its tile's transforms (csrc/fourstep.cu
    `fourstep_pass2_unpack_kernel`): the R/2 rows k1 = c*R/2 + u below
    L1/2, then their mirrors L1 - k1, row L1/2 in the place of row 0's."""
    lo = c * (R // 2) + np.arange(R // 2)
    return np.concatenate([lo, np.where(lo == 0, L1 // 2, L1 - lo)])


def _unpack_cluster(L2, R):
    """(C, kr, S): blocks a cluster of the unpack mode, elements k2 each
    block stores, and the staging area's row pitch (a multiple of 4: every
    row starts on 16 bytes)."""
    C = RUN // (R // 2)
    return C, L2 // C, L2 // C + 4


def _unpack_sends(L1, L2, R, cl, spec=None, utw=None, h=0.5):
    """Every asynchronous store (st.async) that the blocks of cluster cl of
    one batch row make in the unpack mode, group by group as the kernel
    makes them (csrc/fourstep.cu `fourstep_pass2_unpack_kernel`): thread s
    takes pairs p = 4*(s + j*threads) + r, r < 4, of row u = p / L2 at
    elements k2 + r, k2 = p mod L2. A list of (area, to, v, k2, values):
    staging area 0 (low) or 1 (high) of cluster block `to`, row v, first
    element k2 (the block's own elements from `to`*L2/C), width w = 4 (a
    float4 of re and one of im, elements k2 .. k2 + 3) or 1 (a float of
    each, block 0's row-0 mirrors and bin m/2), and values (n, w); n sends
    of one shape. `values` are the unpacked bins when `spec` (the row spectra,
    (L1, L2)) and `utw` (the float32 table as complex) are given, else
    None. Also returns the Nyquist bin (None without `spec`)."""
    C, kr, _ = _unpack_cluster(L2, R)
    half, threads = R // 2, R * L2 // 16
    s = np.arange(threads)
    r4 = np.arange(4)
    sends, nyquist = [], None

    def unpack(tile, t_lo, k2, k1, t_hi, e_hi):
        if spec is None:
            return None
        k = k2[:, None] + r4
        zl = tile[t_lo, k] if np.ndim(t_lo) == 0 else tile[t_lo[:, None], k]
        e = (e_hi[:, None] - r4) % L2
        zh = tile[t_hi, e] if np.ndim(t_hi) == 0 else tile[t_hi[:, None], e]
        w = (utw[L2 + k1][:, None] if np.ndim(k1) else utw[L2 + k1]) * utw[k]
        ev, od = h * (zl + np.conj(zh)), -1j * h * (zl - np.conj(zh))
        return ev + w * od, np.conj(ev - w * od)

    def send(area, k2, v, vals, rev=False, width=4):
        vals = None if vals is None else (vals[:, ::-1] if rev else vals)
        sends.append((area, k2 // kr, v, k2, width, vals))

    for rank in range(C):
        c = cl * C + rank
        tile = None if spec is None else spec[_unpack_rows(L1, R, c)]
        for j in range(2):
            p = 4 * (s + j * threads)
            u, k2 = p // L2, p % L2
            gen = c * half + u != 0
            lo, hi = unpack(tile, u[gen], k2[gen], c * half + u[gen], half + u[gen],
                            L2 - 1 - k2[gen]) or (None, None)
            v = rank * half + u[gen]
            send(0, k2[gen], v, lo)
            send(1, L2 - 4 - k2[gen], v, hi, rev=True)
            if c:
                continue
            r0 = ~gen & (k2 < L2 // 2)
            if r0.any():
                lo, hi = unpack(tile, 0, k2[r0], 0, 0, L2 - k2[r0]) or (None, None)
                send(0, k2[r0], 0 * k2[r0], lo)
                k = (k2[r0][:, None] + r4).ravel()
                out = k != 0  # X[0]'s mirror is the Nyquist bin, straight out
                send(0, (L2 - k)[out], 0 * k[out], None if hi is None else hi.ravel()[out, None],
                     width=1)
                if hi is not None:
                    nyquist = hi.ravel()[~out]
            rh = ~gen & (k2 >= L2 // 2)
            if rh.any():
                kh = k2[rh] - L2 // 2
                lo, hi = unpack(tile, half, kh, L1 // 2, half, L2 - 1 - kh) or (None, None)
                send(1, kh, 0 * kh, lo)
                send(1, L2 - 4 - kh, 0 * kh, hi, rev=True)
        if c == 0:  # bin m/2 by thread 0: row 0's element L2/2, its own mirror
            mid = None
            if spec is not None:
                zm = tile[0, L2 // 2]
                ev, od = h * (zm + np.conj(zm)), -1j * h * (zm - np.conj(zm))
                mid = np.array([[ev + utw[L2] * utw[L2 // 2] * od]])
            send(0, np.array([L2 // 2]), np.array([0]), mid, width=1)
    return sends, nyquist


@pytest.mark.parametrize("L1,L2,R", UNPACK_MODE,
                         ids=[f"L{a}x{b}-R{r or 'default'}" for a, b, r in UNPACK_MODE])
def test_pass2_unpack_rows(L1, L2, R):
    """The unpack mode's geometry (`pass2_unpack_geometry`) and its block
    -> rows map: R in (8, 16), by default 16 at L2 = 256 and 8 above, pass
    2's tile; L1/R blocks a
    batch row, as pass 2's grid, in clusters of C = 32/(R/2) consecutive
    blocks (at most the 8 an H100 takes without asking) that hold 32
    consecutive rows below L1/2 and their mirrors; every row of the
    intermediate in exactly one block, the low rows below L1/2; every pair
    of rows (k1, (L1 - k1) mod L1) in one block, so every pair of bins
    (k, m - k); the tile in a block's 227 KB of shared memory, two blocks
    an SM where it is at most SHARED_TILE values (with the low staging
    area and the transaction barrier: at most 113 KB at R = 8), the high
    staging area (2 planes of 32 rows of S = L2/C + 4 floats, S a
    multiple of 4: every row on 16 bytes) within the tile's planes and the
    low one past them, from a multiple of 32 floats, then the two 8-byte
    transaction barriers (one an area) on 8 bytes."""
    geo = fourstep_vmem.pass2_unpack_geometry(L1, L2, R)
    assert geo.T == (R or fourstep_vmem.UNPACK_ROWS[L2]) == (R or (16 if L2 == 256 else 8))
    R = geo.T
    C, kr, S = _unpack_cluster(L2, R)
    assert S == fourstep_vmem.unpack_pitch(L2, R)
    barrier_at = 8 * R * geo.stride + 8 * RUN * S  # bytes
    assert geo == dataclasses.replace(_common.tile_geometry(L2, R), smem=barrier_at + 16)
    assert fourstep_vmem.UNPACK_BARRIER_BYTES == 16 and barrier_at % 8 == 0
    assert geo.L == L2 and geo.threads == R * L2 // 16 <= 1024 and geo.threads % 32 == 0
    assert geo.smem <= MAX_SMEM
    if R * L2 <= fourstep_vmem.SHARED_TILE:
        assert 2 * geo.smem <= MAX_SMEM and 2 * geo.threads <= 2048
    if R == 8:
        assert geo.smem <= 113 * 1024
    assert C <= 8 and (L1 // R) % C == 0 and kr >= 32 and S % 4 == 0 and S % 32 == 4
    assert 2 * RUN * S <= 2 * R * geo.stride and (2 * R * geo.stride) % 32 == 0
    assert geo.stride % 4 == 0  # the low area and each of its planes on 16 bytes
    blocks = [_unpack_rows(L1, R, c) for c in range(L1 // R)]
    assert all(len(rows) == R for rows in blocks)
    assert all(np.all(rows[: R // 2] < L1 // 2) for rows in blocks)
    assert np.array_equal(np.sort(np.concatenate(blocks)), np.arange(L1))
    for q in range(L1 // R // C):  # a cluster's low rows: 32 consecutive k1
        low = np.concatenate([blocks[q * C + r][: R // 2] for r in range(C)])
        assert np.array_equal(low, q * RUN + np.arange(RUN))
    home = {int(k1): c for c, rows in enumerate(blocks) for k1 in rows}
    assert all(home[k1] == home[(L1 - k1) % L1] for k1 in range(L1))
    # bins: row k1 holds k = k2*L1 + k1, whose mirror (m - k) % m lies in
    # row (L1 - k1) % L1
    m = L1 * L2
    k = np.arange(m)
    assert np.array_equal(np.vectorize(home.get)(((m - k) % m) % L1),
                          np.vectorize(home.get)(k % L1))


def test_pass2_unpack_geometry_refuses_what_the_launcher_refuses():
    with pytest.raises(ValueError, match="R in"):
        fourstep_vmem.pass2_unpack_geometry(1024, 1024, 4)
    with pytest.raises(ValueError, match="R in"):
        fourstep_vmem.pass2_unpack_geometry(1024, 1024, 32)
    with pytest.raises(ValueError, match="L1 >="):
        fourstep_vmem.pass2_unpack_geometry(32, 1024)
    with pytest.raises(ValueError, match="L2 in"):
        fourstep_vmem.pass2_unpack_geometry(1024, 2048)  # m = 2^21: past the fused r2c
    assert fourstep_vmem.pass2_unpack_geometry(128, 256).T == 16
    assert fourstep_vmem.pass2_unpack_geometry(1024, 1024).T == 8


def test_pass2_unpack_run_is_the_kernels():
    """UNPACK_RUN, from which Python sizes the unpack mode's shared memory,
    is the kernel's own run of rows a cluster (csrc/fourstep.cu
    kLogUnpackRun, from which the kernel and its launcher take the cluster
    and the staging areas' pitch); the pitch's pad past L2/C is the
    kernel's; and UNPACK_BIN_BYTES, from which `unpack_tx_bytes` counts the
    bytes of a block's staging area, is the kernel's kUnpackBinBytes, from
    which it arms the area's transaction barrier."""
    src = (Path(fourstep_vmem.__file__).parents[1] / "csrc" / "fourstep.cu").read_text()
    found = re.findall(r"constexpr int kLogUnpackRun = (\d+);", src)
    assert len(found) == 1 and 1 << int(found[0]) == RUN
    pad = re.findall(r"return \(1 << \(log_l2 - unpack_log_cluster\(log_r\)\)\) \+ (\d+);", src)
    assert len(pad) == 1 and int(pad[0]) == fourstep_vmem.unpack_pitch(1024, 8) - 1024 * 8 // 64
    found = re.findall(r"constexpr int kUnpackBinBytes = (\d+);", src)
    assert len(found) == 1 and int(found[0]) == fourstep_vmem.UNPACK_BIN_BYTES
    assert len(re.findall(
        r"return kUnpackBinBytes << \(kLogUnpackRun \+ log_l2 - unpack_log_cluster\(log_r\)\);",
        src)) == 1
    assert src.count("arm_barrier(bar, unpack_tx_bytes(log_l2, log_r));") == 1
    assert src.count("arm_barrier(bar + 1, unpack_tx_bytes(log_l2, log_r));") == 1


def _unpack_accesses(geo):
    """(access, addresses) of every shared-memory access of the unpack
    mode: the forward's passes (csrc/sandwich.cuh `forward_in_place`: the
    first with slot mapping 0, its loads in device memory, the later ones
    and the in-place last pass with run_bits(R) = 3), the unpack's reads
    of Z[k] (transform u, elements k2 + r) and Z[m-k] (transform R/2 + u,
    elements L2-1-k2-r) by group p = 4*(s + j*threads) (u = p / L2, k2 = p
    mod L2), a float each r < 4; its 16-byte asynchronous writes into the
    staging of the block that stores k2 (v*S + k2 mod L2/C, the low bins
    of elements k2 .. k2 + 3 and the high ones of L2-4-k2 .. L2-1-k2); and
    the store's 16-byte reads of the staging (v = s mod 32, elements i ..
    i + 3, i = 4*(s/32 + j*threads/32)). Addresses are (warps, 32) floats
    of one plane, the first float of each lane's 16 bytes for the
    accesses whose name starts with "stage"."""
    L, T, threads = geo.L, geo.T, geo.threads
    g = 3
    out = []
    ns = 1
    n_pass = len(geo.schedule)
    for p, R in enumerate(geo.schedule):
        j, t = _slots(L, T, R, 0 if p == 0 else g, threads)
        last = p == n_pass - 1
        for r in range(R):
            load = j + r * (L // R)
            store = load if last else (j // ns) * ns * R + j % ns + r * ns
            if p > 0:
                out.append((f"{'last' if last else p} load", _at(geo, t, load)))
            out.append((f"{'last' if last else p} store", _at(geo, t, store)))
        ns *= R
    group = 4 * (np.arange(threads)[:, None] + np.arange(2)[None, :] * threads)
    u, k2 = group // L, group % L
    for r in range(4):
        out.append(("unpack Z[k]", _at(geo, u, k2 + r)))
        out.append(("unpack Z[m-k]", _at(geo, T // 2 + u, L - 1 - k2 - r)))
    _, kr, S = _unpack_cluster(L, T)
    v = u  # rank 0's rows
    out.append(("stage write", v * S + k2 % kr))
    out.append(("stage write mirror", v * S + (L - 4 - k2) % kr))
    s = np.arange(threads)[:, None]
    i = 4 * (s // RUN + np.arange(2)[None, :] * (threads // RUN))
    assert np.array_equal(np.unique(i), 4 * np.arange(kr // 4))  # each group of 4 k2 once
    out.append(("stage read", (s % RUN) * S + i))
    return [(kind, a.T.reshape(-1, 32)) for kind, a in out]


def _wavefronts16(addr):
    """Wavefronts of each quarter warp of 16-byte accesses: addr is (warps,
    32) floats, each lane's first of 4 (a multiple of 4). 8 lanes at a time,
    each group of 4 banks serves one 16-byte piece a wavefront."""
    assert np.all(addr % 4 == 0)
    quarters = addr.reshape(-1, 8)
    bank4 = (quarters // 4) % 8
    worst = np.zeros(quarters.shape[0], np.int64)
    for b in range(8):
        hit = np.where(bank4 == b, quarters, -1)
        worst = np.maximum(worst, [len(set(row[row >= 0])) for row in hit])
    return worst


@pytest.mark.parametrize("L1,L2,R", UNPACK_MODE,
                         ids=[f"L{a}x{b}-R{r or 'default'}" for a, b, r in UNPACK_MODE])
def test_pass2_unpack_bank_conflicts(L1, L2, R):
    """Every shared-memory access of the unpack mode takes one wavefront
    per 32 floats: the FFT's exchanges, but the forward's first store at
    L2 = 256 (pass 2's own, two); and one wavefront per quarter warp of its
    16-byte accesses: the asynchronous writes into the staging (8 lanes on
    32 consecutive floats of one row) and the store's reads of the staging
    (8 rows v of one k2, a pitch of 4 more than a multiple of 32 apart).
    The unpack's reads take two: a warp on 128 consecutive k2 of one row,
    a float of each of its 4 at a time, spans 34 floats' banks of the
    padded row twice over. The store puts a warp on 32 consecutive k1 of
    one k2."""
    geo = fourstep_vmem.pass2_unpack_geometry(L1, L2, R)
    worst = {}
    for kind, addr in _unpack_accesses(geo):
        count = _wavefronts16 if kind.startswith("stage") else _wavefronts
        worst[kind] = max(worst.get(kind, 0), int(count(addr).max()))
    want = {**dict.fromkeys(worst, 1), "unpack Z[k]": 2, "unpack Z[m-k]": 2}
    if L2 <= 256:
        want["0 store"] = 2
    assert worst == want, worst
    s = np.arange(geo.threads)
    i = 4 * (s // RUN)
    for r in range(4):
        k = ((i + r) * L1 + s % RUN).reshape(-1, 32)  # rank 0 of the first cluster
        assert np.all(np.diff(k, axis=1) == 1)


@pytest.mark.parametrize("m,R", [(1 << e, R) for e in range(15, 21) for R in (8, 16)],
                         ids=lambda a: f"m2^{a.bit_length() - 1}" if a > 16 else f"R{a}")
def test_pass2_unpack_indexing(m, R):
    """The unpack mode's epilogue in float64 numpy, cluster by cluster and
    group by group as the kernel runs it: the length-L2 spectra of each
    block's rows (`_unpack_rows`); a thread's groups of 4 pairs of one row
    (`_unpack_sends`: row k1 = c*R/2 + u at elements k2 .. k2 + 3 with its
    mirror at L2-1-k2 .. L2-4-k2 of transform R/2 + u; in block 0 row 0
    with its own elements (L2 - k2) mod L2 for k2 < L2/2 and row L1/2 with
    its own elements L2-1-k2 after), w = W_n^{k1} * W_{2*L2}^{k2} from the
    wrapper's float32 table; its outputs sent into the staging of the
    cluster's block that stores their k2 (low bins of cluster row v, high
    bins of its mirror reversed, row L1/2's as the high bins of v = 0), a
    float4 a plane on 16 bytes within the block's elements, block 0's
    row-0 mirrors and bin m/2 a float at a time, the Nyquist bin straight
    out; every staged bin once; then each block's store, a thread reading
    4 consecutive k2 of its row v: every bin 0..m once, equal to
    np.fft.rfft."""
    L1, L2 = fourstep_vmem._split_sides(m)
    C, kr, S = _unpack_cluster(L2, R)
    rng = np.random.default_rng(m + R)
    x = rng.standard_normal(2 * m)
    zc = x[0::2] + 1j * x[1::2]
    # pass 1's rows k1 (the column FFTs over j1, times W_m^{k1*j2}), then
    # each row's length-L2 spectrum: Z[k2*L1 + k1] = spec[k1, k2]
    k1, j2 = np.arange(L1)[:, None], np.arange(L2)[None, :]
    inter = np.fft.fft(zc.reshape(L1, L2), axis=0) * np.exp(-2j * np.pi * k1 * j2 / m)
    spec = np.fft.fft(inter, axis=1)
    assert np.allclose(spec.T.ravel(), np.fft.fft(zc))
    _, utw = fourstep_vmem._unpack_tables(L1, L2, torch.device("cpu"))
    utw = utw.numpy().astype(np.float64) @ np.array([1, 1j])
    assert utw.shape == (L2 + L1 // 2 + 1,)
    out = np.full(m + 1, np.nan, complex)
    hits = np.zeros(m + 1, int)
    threads = R * L2 // 16
    s = np.arange(threads)
    vv = s % RUN
    for cl in range(L1 // R // C):
        # each block's staging: (low, high) x 32 rows v x its L2/C elements,
        # re and im as one value
        stage = np.full((C, 2, RUN, kr), np.nan, complex)
        staged = np.zeros(stage.shape, int)
        sends, nyquist = _unpack_sends(L1, L2, R, cl, spec, utw)
        for area, to, v, k2, width, vals in sends:
            e = k2 % kr
            assert np.all(e + width <= kr)  # within the receiving block's elements
            if width == 4:
                assert np.all((v * S + e) % 4 == 0)  # 16 bytes on 16 bytes
            at = (to[:, None], area, v[:, None], e[:, None] + np.arange(width))
            np.add.at(staged, at, 1)
            stage[at] = vals
        assert np.all(staged == 1)  # every staged bin once
        if cl == 0:
            assert nyquist.shape == (1,)
            out[m] = nyquist[0]  # the Nyquist bin, straight out
            np.add.at(hits, m, 1)
        k1_c = cl * RUN
        hi_k1 = np.where((k1_c == 0) & (vv == 0), L1 // 2, L1 - k1_c - vv)
        for rank in range(C):
            for j in range(2):
                i = 4 * (s // RUN + j * (threads // RUN))
                for r in range(4):
                    kk = (rank * kr + i + r) * L1
                    for hi, at in ((0, kk + k1_c + vv), (1, kk + hi_k1)):
                        np.add.at(hits, at, 1)
                        out[at] = stage[rank, hi, vv, i + r]
    assert np.all(hits == 1)
    want = np.fft.rfft(x)  # h = 0.5: scale 1
    assert np.max(np.abs(out - want)) <= 1e-6 * np.max(np.abs(want))  # float32 tables


@pytest.mark.parametrize("L1,L2,R", UNPACK_MODE,
                         ids=[f"L{a}x{b}-R{r or 'default'}" for a, b, r in UNPACK_MODE])
def test_pass2_unpack_transaction_bytes(L1, L2, R):
    """Every block of the unpack mode arms the transaction barrier of each
    of its staging areas for exactly the bytes that the asynchronous
    stores of its cluster bring that area (`unpack_tx_bytes`, which the
    kernel's `unpack_tx_bytes` mirrors; `test_pass2_unpack_run_is_the_kernels`):
    a float of re and one of im for each element of each send
    (`_unpack_sends`), in every cluster of a batch row, block 0's row-0
    mirrors, row L1/2 and bin m/2 included. A count too high never
    completes and hangs the kernel; one too low lets a block read an area
    before its last bins land. The count stays within an mbarrier's
    transaction range (2^20 - 1)."""
    R = R or fourstep_vmem.UNPACK_ROWS[L2]
    C, kr, _ = _unpack_cluster(L2, R)
    want = fourstep_vmem.unpack_tx_bytes(L2, R)
    assert want == fourstep_vmem.UNPACK_BIN_BYTES * RUN * kr < 1 << 20
    for cl in range(L1 // R // C):
        got = np.zeros((C, 2), int)
        sends, nyquist = _unpack_sends(L1, L2, R, cl)
        assert nyquist is None
        for area, to, _, _, width, vals in sends:
            assert vals is None and np.all((0 <= to) & (to < C))
            np.add.at(got, (to, area), 2 * 4 * width)
        assert np.all(got == want), (cl, got, want)


@pytest.mark.parametrize("m", [1 << e for e in range(15, 21)],
                         ids=lambda m: f"m2^{m.bit_length() - 1}")
def test_rfft_resident_plain_matches_numpy(m):
    """The fused r2c's plain version (pass 1 packed, then the unpack
    mode's plain version) against float64 np.fft.rfft at every half size
    of its window."""
    from fftlab_torch.kernels import rfft_resident

    x = torch.from_numpy(np.random.default_rng(m + 1).standard_normal((2, 2 * m))
                         .astype(np.float32))
    Xr, Xi = rfft_resident.rfft_resident_plain(x, 0.5)
    got = Xr.double().numpy() + 1j * Xi.double().numpy()
    want = 0.5 * np.fft.rfft(x.double().numpy(), axis=-1)
    err = np.sum(np.abs(got - want) ** 2) / np.sum(np.abs(want) ** 2)
    assert 10 * np.log10(1 / err) >= 120.0
