"""D4C's coarse group-delay aperiodicity (world_tpu_torch/ops/d4c_spectra.py):
K6 (the centroid spectra) and K7 (the band aperiodicity), on the CPU.

  * the plain sub-stages, ``static_centroid_half``,
    ``smoothed_power_spectrum_half``, ``static_group_delay_half`` and
    ``coarse_aperiodicity``, and the whole ``coarse_ap_frames``, against the
    same JAX functions (world_tpu/aperiodicity/common.py) on harvest_small's
    frames at fft_size 1,024 and 2,048, and at 192 kHz (classic D4C,
    fft_size 16,384, 13 frames of a glide) the whole against the JAX
    package's last two sub-stages fed by the port's first two, in float64;
  * a PyTorch model of the kernels' FFT, op for op (radix-2 decimation in
    time on bit-reversed input, the twiddles of ``fft_twiddles``), of K6's
    two real FFTs in one (xn + i xn t_true sigma, unpacked) and of K7's real
    FFT as one complex FFT of half the size, against ``torch.fft.rfft`` at
    256-32,768 points, rows cut (longer than fft_size) and zero-padded; and
    the same FFT split over a cluster's C = 2, 4 and 8 ranks (each rank's
    local stages on its block of the bit-reversed input, then the radix-C
    crossing pass), bitwise the one-block model, at 16,384 and 32,768;
  * a model of the smoothing's float64 running sum spread over ranks (each
    rank's block scan, then the lower ranks' totals in rank order) against
    the one-rank sum;
  * models of K7's top-(boundary + 1) selection (a bitwise search over the
    ordered keys, and the search by 8-bit digits) against ``torch.topk``'s
    sum, with ties and NaN;
  * the wrappers: the geometry check raises ``KernelGeometryError`` naming
    the shapes before anything touches the device, and the dispatchers send
    CPU and ``meta`` tensors to the plain versions without counting a
    launch.
The kernels themselves are held to the plain versions on the card
(chip_smoke.py phase 22, and the ``gpu`` test at the end of this file).
"""
from pathlib import Path

import numpy as np
import pytest
import torch

from world_tpu_torch._backend import KernelGeometryError
from world_tpu_torch.aperiodicity import common as C
from world_tpu_torch.ops import d4c_spectra as K

GOLDEN = Path(__file__).resolve().parent / "golden"
FS = 16000
FP_MS = 5.0
MAX_HALF = int(2.0 * FS / 47.0 + 0.5)
MARGIN = int(np.ceil(FS / (4 * 47.0))) + 3
FI = 3000.0


def _small():
    g = np.load(GOLDEN / "harvest_small.npz")
    x = np.asarray(g["x"], np.float64)
    f0 = np.maximum(np.asarray(g["f0"], np.float64), 47.0)
    tp = np.asarray(g["temporal_positions"], np.float64)
    return x, f0, tp


def _port_operands(x, f0, dtype=torch.float64):
    F = f0.shape[0]
    slab = C.frame_slabs(torch.tensor(x, dtype=dtype)[None], FS, FP_MS, F,
                         MAX_HALF + MARGIN)
    return (slab, torch.tensor(f0, dtype=dtype),
            C.frame_times(FP_MS, F, None, "cpu"))


def _rel(a, b):
    """max |a - b| of each row over the row's largest |b|, over all rows."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float((np.abs(a - b).max(-1) / np.abs(b).max(-1)).max())


# ---------------------------------------------------------------------------
# the plain versions against the JAX package
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_stages():
    """The JAX sub-stages on harvest_small at fft_size 1,024 and 2,048."""
    import jax.numpy as jnp

    from world_tpu.aperiodicity import common as J

    x, f0, tp = _small()
    out = {}
    for N in (1024, 2048):
        cen = np.asarray(J.static_centroid_half(jnp.asarray(x), FS, jnp.asarray(f0),
                                                jnp.asarray(tp), MAX_HALF, N,
                                                jnp.float64, FP_MS))
        sps = np.asarray(J.smoothed_power_spectrum_half(
            jnp.asarray(x), FS, jnp.asarray(f0), jnp.asarray(tp), MAX_HALF, N,
            jnp.float64, FP_MS))
        gd = np.asarray(J.static_group_delay_half(jnp.asarray(cen), jnp.asarray(sps),
                                                  FS, jnp.asarray(f0), N,
                                                  jnp.float64))
        window = J.band_window(FS, N, FI)
        ap = np.asarray(J.coarse_aperiodicity(jnp.asarray(gd), float(FS), N, FI, 1,
                                              window, jnp.float64))
        whole = np.asarray(J.coarse_ap_frames(jnp.asarray(x), FS, jnp.asarray(f0),
                                              jnp.asarray(tp), FI, N, 1, window,
                                              MAX_HALF, jnp.float64, FP_MS))
        out[N] = {"centroid": cen, "spsh": sps, "gd": gd, "window": window,
                  "ap": ap, "whole": whole}
    return out


# Float64 tolerances against the JAX package, relative to each row's
# largest value.  The centroid: PyTorch's CPU FFT (MKL) rounds a row that
# the FFT cuts (1,363 samples at 1,024 points) by its memory alignment, so
# the same call moves by up to ~3e-9 from one call to the next (measured
# 7.7e-10 and 2.6e-9 on harvest_small); the rows the FFT pads agree to
# 1e-15.  The smoothed power (measured 4e-14) and, on the JAX package's own
# inputs, the group delay (1e-12) and the band aperiodicity (2e-13 dB) are
# held near their rounding; the whole coarse_ap_frames moves with the
# centroid's rounding through the group delay's division by weak bins of
# the smoothed power (7e-8 dB).
CENTROID_RTOL, SPSH_RTOL, GD_RTOL = 1e-8, 1e-12, 1e-10
AP_DB, WHOLE_DB = 1e-10, 1e-6


@pytest.mark.parametrize("N", [1024, 2048])
def test_static_centroid_half_matches_jax(jax_stages, N):
    x, f0, _ = _small()
    slab, f0t, t = _port_operands(x, f0)
    got = K.static_centroid_half(slab, MARGIN, FS, f0t, t, MAX_HALF, N)
    assert got.shape == (f0.shape[0], N // 2 + 1)
    assert _rel(got, jax_stages[N]["centroid"]) < CENTROID_RTOL


@pytest.mark.parametrize("N", [1024, 2048])
def test_smoothed_power_spectrum_half_matches_jax(jax_stages, N):
    x, f0, _ = _small()
    slab, f0t, t = _port_operands(x, f0)
    seg = slab[:, MARGIN:slab.shape[1] - MARGIN]
    got = K.smoothed_power_spectrum_half(seg, FS, f0t, t, MAX_HALF, N)
    assert _rel(got, jax_stages[N]["spsh"]) < SPSH_RTOL


@pytest.mark.parametrize("N", [1024, 2048])
def test_static_group_delay_half_matches_jax(jax_stages, N):
    """On the JAX package's own centroid and smoothed power."""
    _, f0, _ = _small()
    st = jax_stages[N]
    got = K.static_group_delay_half(torch.tensor(st["centroid"]),
                                    torch.tensor(st["spsh"]),
                                    FS, torch.tensor(f0), N)
    assert _rel(got, st["gd"]) < GD_RTOL


@pytest.mark.parametrize("N", [1024, 2048])
def test_coarse_aperiodicity_matches_jax(jax_stages, N):
    """On the JAX package's own group delay."""
    st = jax_stages[N]
    got = K.coarse_aperiodicity(torch.tensor(st["gd"]), float(FS), N, FI, 1,
                                torch.tensor(st["window"]))
    assert np.abs(got.numpy() - st["ap"]).max() < AP_DB


@pytest.mark.parametrize("N", [1024, 2048])
def test_coarse_ap_frames_matches_jax(jax_stages, N):
    """The slice as a whole: the port's coarse_ap_frames (K6's and K7's
    plain versions on the CPU) against the JAX package's."""
    x, f0, _ = _small()
    _, f0t, t = _port_operands(x, f0)
    got = C.coarse_ap_frames(torch.tensor(x)[None], FS, f0t, t, FI, N, 1,
                             torch.tensor(jax_stages[N]["window"]), MAX_HALF,
                             FP_MS)
    assert np.abs(got.numpy() - jax_stages[N]["whole"]).max() < WHOLE_DB


# 192 kHz (classic D4C: fft_size 16,384, 5 bands of 3 kHz) on 13 frames of a
# 110-220 Hz glide.  The JAX package's centroid and smoothed power spectrum
# cost ~26 s and ~22 s for 5 frames at this fft_size on the CPU (a Tier-1
# run has no room for them), so the port's plain coarse_ap_frames is held to
# the JAX package's group delay and band aperiodicity fed by the port's own
# plain centroid and smoothed power (each held to the JAX package at 1,024
# and 2,048 points above).
HIGH_FS, HIGH_N = 192000, 16384


def test_coarse_ap_frames_matches_jax_at_192k():
    import jax.numpy as jnp

    from world_tpu.aperiodicity import common as J

    fs, N = HIGH_FS, HIGH_N
    n = int(0.06 * fs)
    t = np.arange(n) / fs
    phase = 2 * np.pi * np.cumsum(110.0 * 2 ** (t / t[-1])) / fs
    x = (np.sin(phase) + 0.5 * np.sin(2 * phase)
         + 1e-4 * np.random.RandomState(6).randn(n))
    F = int(1000 * n / fs / FP_MS + 1)
    f0 = torch.tensor(110.0 * 2 ** (np.arange(F) * FP_MS / 1000 / t[-1]))
    tt = C.frame_times(FP_MS, F, None, "cpu")
    max_half = int(2.0 * fs / 47.0 + 0.5)
    margin = int(np.ceil(fs / (4 * 47.0))) + 3
    fi, n_ap = 3000.0, int(np.floor(min(15000, fs / 2 - 3000.0) / 3000.0))
    window = J.band_window(fs, N, fi)
    xt = torch.tensor(x)[None]
    got = C.coarse_ap_frames(xt, fs, f0, tt, fi, N, n_ap, torch.tensor(window),
                             max_half, FP_MS)
    slab = C.frame_slabs(xt, fs, FP_MS, F, max_half + margin)
    cen = K.static_centroid_half(slab, margin, fs, f0, tt, max_half, N)
    sps = K.smoothed_power_spectrum_half(slab[:, margin:slab.shape[1] - margin],
                                         fs, f0, tt, max_half, N)
    gd = np.asarray(J.static_group_delay_half(jnp.asarray(cen.numpy()),
                                              jnp.asarray(sps.numpy()), fs,
                                              jnp.asarray(f0.numpy()), N,
                                              jnp.float64))
    assert _rel(K.static_group_delay_half(cen, sps, fs, f0, N), gd) < GD_RTOL
    want = np.asarray(J.coarse_aperiodicity(jnp.asarray(gd), float(fs), N, fi,
                                            n_ap, window, jnp.float64))
    ap = K.coarse_aperiodicity(torch.tensor(gd), float(fs), N, fi, n_ap,
                               torch.tensor(window))
    assert np.abs(ap.numpy() - want).max() < AP_DB
    assert got.shape == (F, n_ap) and np.isfinite(want).all()
    assert np.abs(got.numpy() - want).max() < WHOLE_DB


# ---------------------------------------------------------------------------
# models of the kernels' FFT, op for op
# ---------------------------------------------------------------------------

def bit_reverse(n: int) -> torch.Tensor:
    bits = n.bit_length() - 1
    j = torch.arange(n)
    r = torch.zeros_like(j)
    for b in range(bits):
        r |= ((j >> b) & 1) << (bits - 1 - b)
    return r


def fft_model(re, im, tw, step=1):
    """The kernels' fft(): radix-2 decimation in time of rows (R, n) given
    in natural order (placed in bit-reversed order first); stage s combines
    i and i + 2^(s-1) with twiddle entry pos (n / 2^s) step, in the kernel's
    operations and order."""
    n = re.shape[-1]
    p = bit_reverse(n)
    re, im = re[..., p].clone(), im[..., p].clone()
    b = torch.arange(n // 2)
    for s in range(1, n.bit_length()):
        half = 1 << (s - 1)
        pos = b & (half - 1)
        i = ((b >> (s - 1)) << s) + pos
        j = i + half
        w = tw[pos * (n >> s) * step]
        wr, wi = w[:, 0], w[:, 1]
        xr, xi = re[..., j], im[..., j]
        tr = wr * xr - wi * xi
        ti = wr * xi + wi * xr
        ar, ai = re[..., i], im[..., i]
        re[..., j] = ar - tr
        im[..., j] = ai - ti
        re[..., i] = ar + tr
        im[..., i] = ai + ti
    return re, im


def cut_or_pad(x, n):
    """The first n samples of rows x, zero-padded (rfft(x, n)'s input)."""
    out = torch.zeros(x.shape[:-1] + (n,), dtype=x.dtype)
    w = min(n, x.shape[-1])
    out[..., :w] = x[..., :w]
    return out


def k6_model(xn, t_true, n, e):
    """K6's S = FFT(xn) and U = FFT(xn t_true), n points, from one complex
    FFT of xn + i (xn t_true) 2^-e, as the kernel unpacks it."""
    tw = K.fft_twiddles(n, xn.dtype, "cpu")
    zr = cut_or_pad(xn, n)
    zi = cut_or_pad((xn * t_true) * 2.0 ** -e, n)
    re, im = fft_model(zr, zi, tw)
    k = torch.arange(n // 2 + 1)
    kk = (n - k) & (n - 1)
    yr, yi, zr, zi = re[..., kk], im[..., kk], re[..., k], im[..., k]
    S = torch.complex((zr + yr) * 0.5, (zi - yi) * 0.5)
    U = torch.complex(((zi + yi) * 0.5) * 2.0 ** e, ((yr - zr) * 0.5) * 2.0 ** e)
    return S, U


def k7_power_model(x, n):
    """K7's |X[k]|^2, k <= n/2, of the real rows x at n points, from one
    complex FFT of h = n/2 points (even samples real, odd imaginary) on
    the n-point table (step 2), split as real_power does."""
    tw = K.fft_twiddles(n, x.dtype, "cpu")
    h = n // 2
    z = cut_or_pad(x, n)
    re, im = fft_model(z[..., 0::2].clone(), z[..., 1::2].clone(), tw, step=2)
    k = torch.arange(h + 1)
    k0 = torch.where(k == h, 0, k)
    kk = (h - k0) & (h - 1)
    zr, zi, yr, yi = re[..., k0], im[..., k0], re[..., kk], im[..., kk]
    er, ei = (zr + yr) * 0.5, (zi - yi) * 0.5
    orr, oi = (zi + yi) * 0.5, (yr - zr) * 0.5
    w = tw[torch.where(k == h, 0, k)]
    wr, wi = w[:, 0], w[:, 1]
    xr = torch.where(k == h, er - orr, er + (wr * orr - wi * oi))
    xi = torch.where(k == h, ei - oi, ei + (wr * oi + wi * orr))
    a = torch.hypot(xr, xi)
    return a * a


def split_fft_model(re, im, tw, C, step=1):
    """The kernels' FFT of rows (R, n) split over a cluster of C ranks: rank
    c holds positions [c n / C, (c + 1) n / C) of the bit-reversed input and
    runs stages 1 .. log2(n / C) on them alone; then the radix-C pass runs
    the last log2(C) stages, group o combining position o of every rank's
    block.  The butterflies are fft_model's, stage by stage."""
    n = re.shape[-1]
    chunk = n // C
    p = bit_reverse(n)
    re, im = re[..., p].clone(), im[..., p].clone()

    def stage(s, pos_i):
        half = 1 << (s - 1)
        pos = pos_i & (half - 1)
        i = ((pos_i >> (s - 1)) << s) + pos
        j = i + half
        w = tw[pos * (n >> s) * step]
        wr, wi = w[:, 0], w[:, 1]
        xr, xi = re[..., j], im[..., j]
        tr = wr * xr - wi * xi
        ti = wr * xi + wi * xr
        ar, ai = re[..., i], im[..., i]
        re[..., j] = ar - tr
        im[..., j] = ai - ti
        re[..., i] = ar + tr
        im[..., i] = ai + ti

    lc = chunk.bit_length() - 1
    for c in range(C):                      # each rank's local stages
        for s in range(1, lc + 1):
            stage(s, torch.arange(chunk // 2) + c * chunk // 2)
    for s in range(lc + 1, n.bit_length()):  # the crossing pass
        stage(s, torch.arange(n // 2))
    return re, im


@pytest.fixture
def one_thread():
    """The models' many small tensor ops on one intra-op thread: on a host
    whose cores the test workers share, torch's thread pool made them up to
    100x slower (8 s against 0.07 s for one split FFT of 32,768 points)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# the models against pocketfft, relative to the row's largest value: both
# O(eps log2 n)
FFT_RTOL = {torch.float64: 1e-13, torch.float32: 2e-6}
FFT_SIZES = [256, 512, 1024, 2048, 4096, 8192, 16384, 32768]


def _rows(width, dtype, seed=0):
    """Windowed noisy tones of ``width`` samples, and a frame's t_true."""
    rng = np.random.RandomState(seed)
    n = np.arange(width)
    x = np.stack([np.sin(2 * np.pi * f * n / 16000.0) * np.hanning(width)
                  + 1e-3 * rng.randn(width) for f in (110.0, 433.0, 2950.0)])
    x /= np.sqrt((x ** 2).sum(-1, keepdims=True))
    return torch.tensor(x, dtype=dtype), torch.tensor(n + 1.0, dtype=dtype)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n", FFT_SIZES)
def test_k6_packed_fft_model_matches_rfft(n, dtype, one_thread):
    """Rows longer than n (cut after the sums, as rfft(x, n) cuts) and
    shorter (zero-padded)."""
    for width in (n + n // 3, n - n // 3):
        xn, t_true = _rows(width, dtype)
        e = int(np.floor(np.log2(width / 2 + 1)))
        S, U = k6_model(xn, t_true, n, e)
        S_ref = torch.fft.rfft(xn, n)
        U_ref = torch.fft.rfft(xn * t_true, n)
        for got, ref in ((S, S_ref), (U, U_ref)):
            scale = ref.abs().amax(-1, keepdim=True)
            assert float(((got - ref).abs() / scale).max()) < FFT_RTOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n", FFT_SIZES)
def test_k7_half_size_fft_model_matches_rfft(n, dtype, one_thread):
    for width in (n + n // 3, n - n // 3):
        x, _ = _rows(width, dtype, seed=1)
        got = k7_power_model(x, n)
        ref = torch.abs(torch.fft.rfft(x, n)) ** 2
        scale = ref.amax(-1, keepdim=True)
        assert float(((got - ref).abs() / scale).max()) < 2 * FFT_RTOL[dtype]


@pytest.mark.parametrize("C", [2, 4, 8])
@pytest.mark.parametrize("n", [16384, 32768])
def test_split_fft_model_matches_rfft(n, C, one_thread):
    """K6's packed FFT and K7's half-size real FFT split over C ranks:
    bitwise the one-block model, and within FFT_RTOL of pocketfft (rows cut
    and zero-padded)."""
    dtype = torch.float64
    for width in (n + n // 3, n - n // 3):
        xn, t_true = _rows(width, dtype, seed=2)
        xn = xn[:1]
        tw = K.fft_twiddles(n, dtype, "cpu")
        e = int(np.floor(np.log2(width / 2 + 1)))
        zr, zi = cut_or_pad(xn, n), cut_or_pad((xn * t_true) * 2.0 ** -e, n)
        one = fft_model(zr, zi, tw)
        split = split_fft_model(zr, zi, tw, C)
        assert torch.equal(one[0], split[0]) and torch.equal(one[1], split[1])
        S, _ = k6_model(xn, t_true, n, e)
        ref = torch.fft.rfft(xn, n)
        assert float(((S - ref).abs() / ref.abs().amax(-1, keepdim=True)).max()) \
            < FFT_RTOL[dtype]
        # K7: the half-size FFT on the n-point table (step 2)
        z = cut_or_pad(xn, n)
        h_one = fft_model(z[..., 0::2].clone(), z[..., 1::2].clone(), tw, step=2)
        h_split = split_fft_model(z[..., 0::2].clone(), z[..., 1::2].clone(), tw, C,
                                  step=2)
        assert torch.equal(h_one[0], h_split[0]) and torch.equal(h_one[1], h_split[1])


# ---------------------------------------------------------------------------
# the smoothing's running sum over ranks, modelled
# ---------------------------------------------------------------------------

def block_scan_model(v):
    """frame_exclusive_scan of one block: the threads' totals v (128,) ->
    each thread's exclusive sum (Hillis-Steele in each warp of 32, then the
    lower warps' totals in warp order, then the lane's), float64 numpy."""
    v = np.asarray(v, np.float64)
    inc = v.copy()
    for w in range(4):
        lanes = inc[32 * w:32 * w + 32]
        for off in (1, 2, 4, 8, 16):
            lanes = np.where(np.arange(32) >= off,
                             lanes + np.concatenate([np.zeros(off), lanes[:-off]]),
                             lanes)
        inc[32 * w:32 * w + 32] = lanes
    out = np.zeros(128)
    for t in range(128):
        w, lane = divmod(t, 32)
        base = 0.0
        for i in range(w):
            base = base + inc[32 * i + 31]
        exc = 0.0 if lane == 0 else inc[t - 1]
        out[t] = base + exc
    return out


def running_sum_model(x, C):
    """rect_smooth's running sum P of x (L,) over C ranks: rank c holds
    entries [c Lc, (c + 1) Lc), Lc = ceil(L / C); each of its 128 threads a
    run of ceil(n / 128); the block scan; then the lower ranks' totals
    added in rank order (C = 1: the one-block sum)."""
    L = x.shape[0]
    Lc = -(-L // C)
    P = np.zeros(L)
    totals = []
    for c in range(C):
        own = x[c * Lc:min(L, (c + 1) * Lc)]
        per = -(-own.shape[0] // 128)
        runs, local = np.zeros(128), np.zeros(own.shape[0])
        for t in range(128):
            run = 0.0
            for i in range(t * per, min(t * per + per, own.shape[0])):
                run = run + own[i]
                local[i] = run
            runs[t] = run
        base = block_scan_model(runs)
        totals.append(base[127] + runs[127])
        below = 0.0
        for q in range(c):
            below = below + totals[q]
        for t in range(128):
            for i in range(t * per, min(t * per + per, own.shape[0])):
                P[c * Lc + i] = (below + base[t] if C > 1 else base[t]) + local[i]
    return P


def test_split_running_sum_matches_one_rank():
    """The float64 running sum of a power spectrum's doubled bins (classic
    D4C at 192 kHz: L = 2 span + nb + 1 = 8,533 entries) over 2, 4 and 8
    ranks against the one-rank sum and numpy's cumsum: the orders differ
    only in rounding (at most 1e-13 of the total)."""
    rng = np.random.RandomState(4)
    L = 2 * 170 + 8193 + 1
    x = (rng.rand(L) ** 6) * 10.0 ** rng.uniform(-8, 2, L)
    one = running_sum_model(x, 1)
    total = float(np.sum(x))
    assert np.abs(one - np.cumsum(x)).max() <= 1e-13 * total
    for C in (2, 4, 8):
        split = running_sum_model(x, C)
        assert np.abs(split - one).max() <= 1e-13 * total
        assert split[-1] == pytest.approx(total, rel=1e-14)


# ---------------------------------------------------------------------------
# K7's top-k, modelled
# ---------------------------------------------------------------------------

def ordered_keys(v: torch.Tensor) -> torch.Tensor:
    """Key<float>::of: float32 bits ordered as unsigned integers (held in
    int64), a NaN the largest."""
    b = v.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    key = torch.where(b >= 0x80000000, (~b) & 0xFFFFFFFF, b | 0x80000000)
    return torch.where(torch.isnan(v), torch.full_like(key, 0xFFFFFFFF), key)


def key_value(key: torch.Tensor) -> torch.Tensor:
    bits = torch.where(key >= 0x80000000, key & 0x7FFFFFFF, (~key) & 0xFFFFFFFF)
    return bits.to(torch.int64).to(torch.int32).view(torch.float32)


def topk_sum_model(power: torch.Tensor, k: int) -> torch.Tensor:
    """K7's top_k sum of float32 rows: tau the k-th largest key, bit by bit
    from the top (the largest tau with at least k keys >= tau), then the
    values above tau and (k - their count) times tau's value."""
    key = ordered_keys(power)
    tau = torch.zeros(power.shape[0], dtype=torch.int64)
    for bit in range(31, -1, -1):
        cand = tau | (1 << bit)
        count = (key >= cand[:, None]).sum(-1)
        tau = torch.where(count >= k, cand, tau)
    above = key > tau[:, None]
    s_gt = torch.where(above, power, torch.zeros_like(power)).sum(-1)
    n_gt = above.sum(-1)
    return s_gt + (k - n_gt).to(power.dtype) * key_value(tau)


def digit_topk_model(power: torch.Tensor, k: int):
    """K7's top_k sum of float32 rows by 8-bit digits: in 4 rounds from the
    top, the 256-bin histogram of the keys that match the digits found so
    far, the digit d with at least krem keys at or above it and fewer above
    it, krem less those above.  Returns (sum, tau)."""
    key = ordered_keys(power)
    R = power.shape[0]
    prefix = torch.zeros(R, dtype=torch.int64)
    krem = torch.full((R,), k, dtype=torch.int64)
    for shift in (24, 16, 8, 0):
        match = torch.ones_like(key, dtype=torch.bool) if shift == 24 else \
            (key >> (shift + 8)) == (prefix >> (shift + 8))[:, None]
        digit = (key >> shift) & 255
        hist = torch.zeros((R, 256), dtype=torch.int64)
        hist.scatter_add_(1, digit, match.to(torch.int64))
        at_or_above = hist.flip(-1).cumsum(-1).flip(-1)        # S(d)
        above = at_or_above - hist                              # S(d + 1)
        d = ((at_or_above >= krem[:, None]) & (above < krem[:, None])).to(
            torch.int64).argmax(-1)
        krem = krem - above.gather(1, d[:, None])[:, 0]
        prefix = prefix | (d << shift)
    above = key > prefix[:, None]
    s_gt = torch.where(above, power, torch.zeros_like(power)).sum(-1)
    return s_gt + krem.to(power.dtype) * key_value(prefix), prefix


def test_topk_model_matches_torch_topk():
    rng = np.random.RandomState(3)
    rows = [rng.randint(0, 50, 300).astype(np.float32),          # many ties
            np.full(300, 7.0, np.float32),                        # all tied
            rng.rand(300).astype(np.float32) ** 8,                # spread
            np.r_[np.zeros(290), np.arange(1, 11)].astype(np.float32)]
    nan_row = rng.rand(300).astype(np.float32)
    nan_row[[5, 77]] = np.nan
    power = torch.tensor(np.stack(rows + [nan_row]))
    for k in (1, 17, 22, 65):
        got = topk_sum_model(power, k)
        ref = torch.topk(power, k, dim=-1, sorted=True).values.sum(-1)
        assert torch.isnan(got[-1]) and torch.isnan(ref[-1])
        # integer-valued rows sum exactly in any order
        assert torch.equal(got[[0, 1, 3]], ref[[0, 1, 3]])
        assert torch.allclose(got[:-1], ref[:-1], rtol=1e-6, atol=0)


def test_digit_topk_model_matches_torch_topk(one_thread):
    """The search by 8-bit digits finds the bitwise search's tau exactly,
    and the sum of the k largest, with ties and NaN (the largest key)."""
    rng = np.random.RandomState(5)
    rows = [rng.randint(0, 50, 1025).astype(np.float32),         # many ties
            np.full(1025, 7.0, np.float32),                       # all tied
            rng.rand(1025).astype(np.float32) ** 8,               # spread
            np.r_[np.zeros(1015), np.arange(1, 11)].astype(np.float32),
            (rng.rand(1025) * 1e-30).astype(np.float32)]          # one exponent
    nan_row = rng.rand(1025).astype(np.float32)
    nan_row[[5, 77, 900]] = np.nan
    power = torch.tensor(np.stack(rows + [nan_row]))
    for k in (1, 3, 17, 22, 65, 1025):
        got, tau = digit_topk_model(power, k)
        ref = torch.topk(power, k, dim=-1, sorted=True).values.sum(-1)
        assert torch.equal(got[:-1], topk_sum_model(power, k)[:-1])
        key = ordered_keys(power)
        assert torch.equal(tau, key.sort(-1, descending=True).values[:, k - 1])
        assert torch.isnan(got[-1]) and torch.isnan(ref[-1])
        assert torch.equal(got[[0, 1, 3]], ref[[0, 1, 3]])
        assert torch.allclose(got[:-1], ref[:-1], rtol=1e-6, atol=0)


# ---------------------------------------------------------------------------
# the wrappers
# ---------------------------------------------------------------------------

def _band_args(slab, centroid, f0, t, N=1024, n_ap=1, window=None):
    window = C.band_window_table(FS, N, FI, slab.dtype, slab.device) \
        if window is None else window
    return (slab, MARGIN, centroid, FS, f0, t, MAX_HALF, N, FI, n_ap, window)


def test_wrappers_raise_kernel_geometry_error_naming_the_shapes():
    x, f0, _ = _small()
    slab, f0t, t = _port_operands(x[:4000], f0[:20], torch.float32)
    cen = torch.zeros((slab.shape[0], 513))
    for N in (3000, 65536, 8):
        with pytest.raises(KernelGeometryError, match=str(tuple(slab.shape))):
            K.centroid_cuda(slab, MARGIN, FS, f0t, t, MAX_HALF, N)
    with pytest.raises(KernelGeometryError, match="slab"):
        K.centroid_cuda(slab[:, 1:], MARGIN, FS, f0t, t, MAX_HALF, 1024)
    with pytest.raises(KernelGeometryError, match=str(tuple(slab[:, 2:].shape))):
        K.band_ap_cuda(*_band_args(slab[:, 2:], cen, f0t, t))
    # a band past the spectrum's end, and a window longer than the FFT
    with pytest.raises(KernelGeometryError, match="bands"):
        K.band_ap_cuda(*_band_args(slab, cen, f0t, t, n_ap=6))
    with pytest.raises(KernelGeometryError, match="bands of 1025 bins"):
        K.band_ap_cuda(*_band_args(slab, cen, f0t, t,
                                   window=torch.ones(1025)))
    # a geometry the kernels take, on the CPU: the device is refused, as
    # nothing falls back
    for call in (lambda: K.centroid_cuda(slab, MARGIN, FS, f0t, t, MAX_HALF, 1024),
                 lambda: K.band_ap_cuda(*_band_args(slab, cen, f0t, t))):
        with pytest.raises(ValueError, match="expected a tensor on") as err:
            call()
        assert not isinstance(err.value, KernelGeometryError)


@pytest.mark.parametrize("fs, N, takes", [(96000, 8192, True),
                                           (16000, 8192, True),
                                           (192000, 16384, True),
                                           (384000, 32768, True),
                                           (768000, 65536, False)])
def test_wrappers_take_fft_size_8192(fs, N, takes):
    """Classic D4C's fft_size at 96, 192 and 384 kHz and an explicit 8,192
    at 16 kHz are the kernels' geometries (on the CPU only the device is
    refused; from 8,192 on a frame is a cluster of blocks on the card); 768
    kHz's 65,536 raises KernelGeometryError with the shapes."""
    max_half = int(2.0 * fs / 47.0 + 0.5)
    margin = int(np.ceil(fs / (4 * 47.0))) + 3
    x = torch.tensor(np.random.RandomState(0).randn(1, fs // 10))
    slab = C.frame_slabs(x, fs, FP_MS, 3, max_half + margin)
    f0, t = torch.full((3,), 120.0, dtype=torch.float64), C.frame_times(FP_MS, 3, None, "cpu")
    n_ap = int(np.floor(min(15000, fs / 2 - FI) / FI))
    window = C.band_window_table(fs, N, FI, torch.float64, "cpu")
    cen = torch.zeros((3, N // 2 + 1), dtype=torch.float64)
    calls = (lambda: K.centroid_cuda(slab, margin, fs, f0, t, max_half, N),
             lambda: K.band_ap_cuda(slab, margin, cen, fs, f0, t, max_half, N,
                                    FI, n_ap, window))
    for call in calls:
        if takes:
            with pytest.raises(ValueError, match="expected a tensor on") as err:
                call()
            assert not isinstance(err.value, KernelGeometryError)
        else:
            with pytest.raises(KernelGeometryError, match=str(tuple(slab.shape))):
                call()


def test_dispatchers_take_plain_path_on_cpu_and_meta_without_counting():
    x, f0, _ = _small()
    slab, f0t, t = _port_operands(x[:4000], f0[:20])
    before = (K.centroid_counter.launches, K.band_ap_counter.launches)
    cen = K.d4c_centroid(slab, MARGIN, FS, f0t, t, MAX_HALF, 1024)
    assert torch.equal(cen, K.static_centroid_half(slab, MARGIN, FS, f0t, t, MAX_HALF, 1024))
    ap = K.d4c_band_ap(*_band_args(slab, cen, f0t, t))
    assert torch.equal(ap, K.band_ap_plain(*_band_args(slab, cen, f0t, t)))
    assert ap.shape == (20, 1) and torch.isfinite(ap).all()
    meta = [v.to("meta") for v in (slab, f0t, t)]
    cm = K.d4c_centroid(meta[0], MARGIN, FS, meta[1], meta[2], MAX_HALF, 1024)
    am = K.d4c_band_ap(*_band_args(meta[0], cm, meta[1], meta[2],
                                   window=torch.ones(385, device="meta",
                                                     dtype=torch.float64)))
    assert cm.shape == (20, 513) and am.shape == (20, 1)
    assert (K.centroid_counter.launches, K.band_ap_counter.launches) == before


# ---------------------------------------------------------------------------
# the CUDA kernels (need the card)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are CUDA C++ for sm_90a")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_d4c_kernels_match_plain_on_the_card(cuda, dtype):
    """K6 within chip_smoke's K6 bars of its plain version, K7 on the plain
    centroid within 0.02 dB (float32) or 1e-6 dB (float64) on
    harvest_small, and each launch counted once."""
    x, f0, _ = _small()
    slab, f0t, t = (v.to(cuda) for v in _port_operands(x, f0, dtype))
    before = (K.centroid_counter.launches, K.band_ap_counter.launches)
    c_plain = K.static_centroid_half(slab, MARGIN, FS, f0t, t, MAX_HALF, 1024)
    c_kern = K.d4c_centroid(slab, MARGIN, FS, f0t, t, MAX_HALF, 1024)
    b_plain = K.band_ap_plain(*_band_args(slab, c_plain, f0t, t))
    b_kern = K.d4c_band_ap(*_band_args(slab, c_plain, f0t, t))
    rel = 2e-5 if dtype == torch.float32 else 1e-10
    assert _rel(c_kern.cpu(), c_plain.cpu()) < rel
    bar = 0.02 if dtype == torch.float32 else 1e-6
    assert float((b_kern - b_plain).abs().max()) < bar
    assert (K.centroid_counter.launches - before[0],
            K.band_ap_counter.launches - before[1]) == (1, 1)
