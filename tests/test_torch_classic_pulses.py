"""K8, the classic synthesis' pulses (ops/classic_pulses.py,
csrc/classic_pulses.cu).

On the CPU:

  * the plain version, reached through ``synthesis_core``, bitwise the
    synthesis as it was before the pulses moved into the ops module (a copy
    kept below), on the golden synthesis' parameters (tests/golden, both
    variants, both noise modes, float64 and float32) and on x16 at the
    classic round trip's caps (8,192 slots, fft_size 1,024, float32);
  * a PyTorch model of K8's arithmetic: grid 1's packed FFTs (both log
    amplitudes as one complex FFT, both complex cepstra as one inverse, both
    real inverse transforms as one complex one) and direct convolution,
    through SlotGrid, against the plain version in float64; grid 2's gather
    overlap-add (each slot's first pulse by search, the slots' rank sums
    folded in SlotGrid's order, blocks of pulses last first) bitwise
    SlotGrid on dense synthetic starts, and the crowded flag from the ranks;
  * the tracer's counters ``synth.pulses.slots`` and ``synth.pulses.live``
    under ``tracing()``; the wrapper's geometry errors; the dispatcher's
    plain path on the CPU and on ``meta`` tensors.

On the card (``-m gpu``): K8 against its plain version at fft_size 1,024 to
16,384 in both types (the waveform within twice the plain version's own
card-against-CPU difference, the flags equal, two calls bitwise, the live
counter), synthesis_a and constant noise, a row without pulses, a row past
max_pulses and crowded slots, blocks of pulses bitwise one block, and K8 on
the classic round trip's graph and the facade's decode.
"""
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from world_tpu_torch._backend import F64_EPS, KernelGeometryError
from world_tpu_torch.dsp.minphase import minimum_phase_spectrum, mirror_full
from world_tpu_torch.dsp.ola import SLOT, SlotGrid
from world_tpu_torch.dsp.windows import np_hanning_matlab
from world_tpu_torch.ops import classic_pulses as K
from world_tpu_torch.ops.classic_pulses import cmul, pulse_blocking
from world_tpu_torch.synth import classic as C
from world_tpu_torch.synth.classic import _interp, sample_times, time_base
from world_tpu_torch.tables import table
from world_tpu_torch.utils.profiling import TRACER, tracing

GOLDEN = Path(__file__).parent / "golden"
OPS_KEYS = ("floor_i", "ceil_i", "wa", "wb", "voiced", "shifts",
            "noise_sizes", "n_noise", "starts", "count")


@pytest.fixture
def four_threads():
    """A fixed CPU thread count: float digits of some reductions follow it."""
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(n)


def _parent_synthesis_core(f0, vuv, temporal_positions, spectrogram,
                            aperiodicity, noise, fs, y_length, fft_size,
                            max_pulses, max_noise, noise_mode="gaussian",
                            variant="standard", frame_period_s=None,
                            max_rank=SLOT):
    """synth/classic.py::synthesis_core as it was before the pulses moved
    into ops/classic_pulses.py (batched calls only): every slot computed in
    blocks of pulses, the 2-frame lerp and the voicing gate inside the
    loop, one SlotGrid."""
    dtype, dev = spectrogram.dtype, spectrogram.device
    B = f0.shape[0]
    if noise_mode == "gaussian" and (noise is None or tuple(noise.shape)
                                     != (B, max_pulses, max_noise)):
        raise ValueError(f"gaussian noise_mode needs a ({B}, {max_pulses}, "
                         f"{max_noise}) standard-normal draw")
    if noise_mode not in ("gaussian", "constant"):
        raise ValueError(f"noise_mode {noise_mode!r}")
    time_axis = sample_times(y_length, fs, temporal_positions[0])
    wrap_threshold = math.pi if variant == "standard" else math.pi / 2
    locs, pli, shifts, vuv_i, raw_count = time_base(
        temporal_positions, f0, vuv, float(fs), time_axis, max_pulses,
        wrap_threshold, frame_period_s)
    count = torch.clamp(raw_count, max=max_pulses)
    if variant == "a":
        shifts = torch.zeros_like(shifts)

    pulse_ids = torch.arange(max_pulses, device=dev)
    valid = pulse_ids < count[:, None]
    nxt = torch.clamp(torch.minimum(pulse_ids + 1, count[:, None] - 1), 0,
                      max_pulses - 1)
    noise_sizes = torch.gather(pli, -1, nxt) - pli
    n_noise = torch.clamp(torch.clamp(noise_sizes, max=max_noise), min=3)
    starts = torch.where(valid, pli - fft_size // 2,
                         torch.full_like(pli, y_length + fft_size + 2))

    n_frames = temporal_positions.shape[0]
    frame_ids = torch.arange(1, n_frames + 1, dtype=dtype, device=dev)
    S = spectrogram.transpose(-1, -2)                       # (B, frames, bins)
    AP = (aperiodicity ** 2).transpose(-1, -2)
    PER = torch.clamp(1.0 - AP, min=0.001)
    rows = torch.arange(B, device=dev)[:, None]
    zero = torch.zeros((), dtype=dtype, device=dev)
    half_n = fft_size // 2 + 1
    coefficient = 2.0 * math.pi * fs / fft_size
    half_k = torch.arange(half_n, dtype=dtype, device=dev)
    dc_base = table("classic_dc_base", (int(fft_size),),
                    lambda: np_hanning_matlab(fft_size)
                    / np_hanning_matlab(fft_size).sum(), dtype, dev)
    conv_n = 2 * fft_size
    grid = SlotGrid(starts, y_length, fft_size, dtype)
    block = pulse_blocking(B, max_pulses, fft_size, spectrogram.element_size())
    block = max_pulses if block is None else block
    for p0 in range(0, max_pulses, block):
        cols = slice(p0, p0 + block)
        lc = locs[:, cols]
        tpi = torch.clamp(_interp(frame_ids, temporal_positions, lc,
                                  frame_period_s), 1.0, float(n_frames))
        # 2-frame spectral lerp
        floor_i = torch.floor(tpi).to(torch.int64) - 1
        ceil_i = torch.ceil(tpi).to(torch.int64) - 1
        t1 = temporal_positions[floor_i]
        t2 = temporal_positions[ceil_i]
        xq = torch.maximum(t1, torch.minimum(t2, lc))
        same = t1 == t2
        b = torch.where(same, zero, (xq - t1) / torch.where(
            same, torch.ones_like(t1), t2 - t1))
        a = (1.0 - b)[..., None]
        b = b[..., None]
        spec = a * S[rows, floor_i] + b * S[rows, ceil_i]
        per = a * PER[rows, floor_i] + b * PER[rows, ceil_i]
        aps = a * AP[rows, floor_i] + b * AP[rows, ceil_i]
        voiced = torch.gather(vuv_i, -1, pli[:, cols] - 1)
        if variant == "standard":
            voiced = voiced & (aps[..., 0] <= 0.999)

        # periodic responses (synthesis.py:100-116)
        mp = minimum_phase_spectrum(mirror_full(torch.clamp(spec * per,
                                                            min=F64_EPS)))
        theta = -(coefficient * shifts[:, cols])[..., None] * half_k
        half = cmul(mp[..., :half_n], torch.polar(torch.ones_like(theta), theta))
        full = torch.cat([half, torch.flip(half[..., 1:-1], (-1,)).conj()],
                         dim=-1)
        response = torch.fft.fftshift(torch.fft.ifft(full).real, dim=-1)
        dc_remover = dc_base * (-response.sum(dim=-1, keepdim=True))
        periodic = ((response + dc_remover) * torch.sqrt(torch.clamp(
            noise_sizes[:, cols].to(dtype), min=1.0))[..., None])
        periodic = torch.where(voiced[..., None], periodic, zero)

        # aperiodic responses (synthesis.py:86-96)
        ap_spec = torch.clamp(torch.where(voiced[..., None], spec * aps, spec),
                              min=F64_EPS)
        ap_response = torch.fft.fftshift(
            torch.fft.ifft(minimum_phase_spectrum(mirror_full(ap_spec))).real,
            dim=-1)
        nn_ = n_noise[:, cols]
        noise_mask = torch.arange(max_noise, device=dev) < nn_[..., None]
        if noise_mode == "constant":
            draw = torch.full(noise_mask.shape, 0.1, dtype=dtype, device=dev)
        else:
            draw = noise[:, cols].to(dtype)
        draw = torch.where(noise_mask, draw, zero)
        draw = torch.where(noise_mask, draw - draw.sum(dim=-1, keepdim=True)
                           / nn_[..., None].to(dtype), zero)
        ap_out = torch.fft.irfft(cmul(torch.fft.rfft(draw, conv_n),
                                      torch.fft.rfft(ap_response, conv_n)),
                                 conv_n)[..., :fft_size]
        grid.add(periodic + ap_out, p0, max_rank)
    y, crowded = grid.result(max_rank)
    return y, (raw_count > max_pulses) | crowded



# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

def _golden(dtype=torch.float64):
    """The golden synthesis' parameters (22.05 kHz, fft_size 1,024)."""
    src = np.load(GOLDEN / "source_dio.npz")
    d4 = np.load(GOLDEN / "d4c.npz")
    spec = np.load(GOLDEN / "cheaptrick.npz")["spectrogram"]
    tp, f0, fs = src["temporal_positions"], d4["f0_after_mutation"], 22050
    max_pulses, max_noise = C.default_max_pulses(tp, f0), C.max_noise_length(fs)
    noise = torch.randn((1, max_pulses, max_noise), dtype=torch.float64,
                        generator=torch.Generator().manual_seed(3)).to(dtype)
    t = lambda a: torch.tensor(np.asarray(a), dtype=dtype)    # noqa: E731
    return dict(f0=t(f0)[None], vuv=t(src["vuv"])[None], tp=t(tp),
                spectrogram=t(spec)[None], aperiodicity=t(d4["aperiodicity"])[None],
                noise=noise, fs=fs,
                y_length=len(np.arange(tp[0], tp[-1] + 1 / fs, 1.0 / fs)),
                fft_size=(spec.shape[0] - 1) * 2, max_pulses=max_pulses,
                max_noise=max_noise, fp=0.005,
                max_rank=C.pulse_rank_bound(float(f0.max()), fs))


def _x16(dtype=torch.float32):
    """x16's golden f0, vuv and envelope at 16 kHz with an aperiodicity
    spread from its band aperiodicity, at the classic round trip's caps
    (8,192 pulse slots)."""
    from world_tpu_torch.parallel.batch import classic_caps

    g = np.load(GOLDEN / "harvest_16k.npz")
    fs = int(g["fs"])
    spec = np.asarray(g["spectrogram"])
    bins = spec.shape[0]
    band_db = np.asarray(g["band_aperiodicity"])            # (3, frames)
    centres = np.array([3000.0, 6000.0, 9000.0])
    freqs = np.arange(bins) * fs / (2.0 * (bins - 1))
    ap_db = np.stack([np.interp(freqs, centres, band_db[:, i])
                      for i in range(band_db.shape[1])], axis=1)
    ap = np.clip(10.0 ** (ap_db / 20.0), 1e-3, 1.0)
    tp = np.asarray(g["temporal_positions"])
    y_length, max_pulses, max_noise = classic_caps(g["x16"].shape[0], fs, 5)
    noise = torch.randn((1, max_pulses, max_noise), dtype=torch.float64,
                        generator=torch.Generator().manual_seed(5)).to(dtype)
    t = lambda a: torch.tensor(np.asarray(a), dtype=dtype)    # noqa: E731
    return dict(f0=t(g["f0"])[None], vuv=t(g["vuv"])[None], tp=t(tp),
                spectrogram=t(spec)[None], aperiodicity=t(ap)[None],
                noise=noise, fs=fs, y_length=y_length, fft_size=1024,
                max_pulses=max_pulses, max_noise=max_noise, fp=0.005,
                max_rank=C.pulse_rank_bound(800.0 * 1.2, fs))


def _synthesis(fn, a, variant="standard", noise_mode="gaussian", **over):
    a = dict(a, **over)
    noise = None if noise_mode == "constant" else a["noise"]
    return fn(a["f0"], a["vuv"], a["tp"], a["spectrogram"], a["aperiodicity"],
              noise, a["fs"], a["y_length"], a["fft_size"], a["max_pulses"],
              a["max_noise"], noise_mode, variant, a["fp"], a["max_rank"])


def _operands(a, variant="standard"):
    ops = C.pulse_operands(a["f0"], a["vuv"], a["tp"], a["aperiodicity"],
                           a["fs"], a["y_length"], a["fft_size"],
                           a["max_pulses"], a["max_noise"], variant, a["fp"])
    ops.pop("raw_count")
    return ops


def _pulses(fn, a, ops, noise_mode="gaussian"):
    return fn(a["spectrogram"], a["aperiodicity"],
              None if noise_mode == "constant" else a["noise"],
              *(ops[k] for k in OPS_KEYS), a["fs"], a["y_length"],
              a["fft_size"], a["max_noise"], noise_mode, a["max_rank"])


def _synthetic(fs, N, seconds=0.3, dtype=torch.float64, f0_hi=240.0,
               max_pulses=None):
    """A glide of f0 (110 Hz to f0_hi) with an unvoiced stretch, a smooth
    envelope and aperiodicity at fs on fft_size N, 5 ms frames."""
    n_frames = int(seconds / 0.005) + 1
    tp = np.arange(n_frames) * 0.005
    f0 = np.linspace(110.0, f0_hi, n_frames)
    f0[n_frames // 3:n_frames // 2] = 0.0
    vuv = (f0 > 0).astype(np.float64)
    bins = N // 2 + 1
    k = np.arange(bins)[:, None] / bins
    frames = np.arange(n_frames)[None, :]
    sp = (np.exp(-6.0 * k) * (1.0 + 0.5 * np.sin(40.0 * k + 0.1 * frames))
          + 1e-7) * 1e-3
    ap = np.clip(0.05 + 0.9 * k + 0.02 * np.cos(0.3 * frames), 1e-3, 0.999)
    mp = max_pulses or C.default_max_pulses(tp, f0)
    mn = C.max_noise_length(fs)
    noise = torch.randn((1, mp, mn), dtype=torch.float64,
                        generator=torch.Generator().manual_seed(N)).to(dtype)
    t = lambda v: torch.tensor(v, dtype=dtype)                # noqa: E731
    return dict(f0=t(f0)[None], vuv=t(vuv)[None], tp=t(tp), spectrogram=t(sp)[None],
                aperiodicity=t(ap)[None], noise=noise, fs=fs,
                y_length=len(np.arange(tp[0], tp[-1] + 1 / fs, 1.0 / fs)),
                fft_size=N, max_pulses=mp, max_noise=mn, fp=0.005,
                max_rank=C.pulse_rank_bound(f0_hi, fs))


# ---------------------------------------------------------------------------
# the plain version against the synthesis it was moved from
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,variant,noise_mode", [
    (torch.float64, "standard", "gaussian"), (torch.float64, "standard", "constant"),
    (torch.float64, "a", "gaussian"), (torch.float64, "a", "constant"),
    (torch.float32, "standard", "gaussian"), (torch.float32, "a", "constant")])
def test_plain_pulses_equal_the_parent_synthesis(four_threads, dtype, variant,
                                                 noise_mode):
    """synthesis_core on the CPU (the per-pulse decisions as (B, P) tensors,
    then pulses_plain) is bitwise the synthesis before the move, on the
    golden synthesis' parameters."""
    a = _golden(dtype)
    y, over = _synthesis(C.synthesis_core, a, variant, noise_mode)
    want, want_over = _synthesis(_parent_synthesis_core, a, variant, noise_mode)
    assert torch.equal(y, want) and torch.equal(over, want_over)
    assert over.tolist() == [False] and bool((y.abs() > 0).any())


def test_plain_pulses_equal_the_parent_synthesis_on_x16(four_threads):
    """The same at x16's classic round-trip caps: 8,192 slots, float32."""
    a = _x16()
    y, over = _synthesis(C.synthesis_core, a)
    want, want_over = _synthesis(_parent_synthesis_core, a)
    assert torch.equal(y, want) and torch.equal(over, want_over)
    assert a["max_pulses"] == 8192 and y.shape == (1, a["y_length"])


def _capped_cases():
    """(operands, variant) whose flag is set: the golden parameters with 64
    pulse slots, and a contour dense enough (to 1.5 kHz at 16 kHz) to put
    two pulses in a slot of a one-pass overlap-add (max_rank 1)."""
    a = _golden()
    return [(dict(a, max_pulses=64, noise=a["noise"][:, :64]), "standard"),
            (dict(_synthetic(16000, 1024, f0_hi=1500.0), max_rank=1), "standard"),
            (dict(_synthetic(16000, 1024, f0_hi=1500.0), max_rank=1), "a")]


def test_plain_pulses_flag_the_caps_as_the_parent(four_threads):
    """A pulse count past max_pulses and crowded slots set the same flags
    (and the same waveform) as before the move."""
    for a, variant in _capped_cases():
        y, flag = _synthesis(C.synthesis_core, a, variant)
        want, want_flag = _synthesis(_parent_synthesis_core, a, variant)
        assert torch.equal(y, want) and torch.equal(flag, want_flag)
        assert flag.tolist() == [True]


# ---------------------------------------------------------------------------
# a model of K8's arithmetic
# ---------------------------------------------------------------------------

def _responses_model(a, ops, noise_mode="gaussian"):
    """Grid 1 of csrc/classic_pulses.cu step for step, vectorised over the
    live pulses, with torch.fft in place of the kernel's radix-2 FFT: the
    responses (B, P, fft_size), zero in the slots past each row's count."""
    sp, ap = a["spectrogram"], a["aperiodicity"]
    dtype, N, fs, max_noise = sp.dtype, a["fft_size"], a["fs"], a["max_noise"]
    half, bins = N // 2, N // 2 + 1
    B, P = ops["starts"].shape
    live = torch.arange(P)[None, :] < torch.clamp(ops["count"], max=P)[:, None]
    bb, pp = live.nonzero(as_tuple=True)
    S, A = sp.transpose(-1, -2), ap.transpose(-1, -2)
    f1, f2 = ops["floor_i"][bb, pp], ops["ceil_i"][bb, pp]
    wa, wb = ops["wa"][bb, pp, None], ops["wb"][bb, pp, None]
    v = ops["voiced"][bb, pp, None]
    s = wa * S[bb, f1] + wb * S[bb, f2]
    x1, x2 = A[bb, f1] * A[bb, f1], A[bb, f2] * A[bb, f2]
    aps = wa * x1 + wb * x2
    per = (wa * torch.clamp(1 - x1, min=0.001)
           + wb * torch.clamp(1 - x2, min=0.001))
    l1 = torch.log(torch.clamp(s * per, min=F64_EPS)) / 2
    l2 = torch.log(torch.clamp(torch.where(v, s * aps, s), min=F64_EPS)) / 2
    # both cepstra from one complex FFT of the two real, even sequences
    cep = torch.fft.fft(torch.complex(mirror_full(l1), mirror_full(l2)))
    k = torch.arange(N)
    fold = torch.where(k == 0, 1.0, torch.where(k >= half, 2.0, 0.0)).to(dtype)
    # both inverse FFTs of the complex cepstra from one forward FFT of the
    # conjugate of cc1 + i cc2, split by symmetry
    V = torch.fft.fft(torch.complex(cep.real * fold, -(cep.imag * fold)))
    kk = torch.arange(bins)
    k2 = (N - kk) % N
    vr, vi, ur, ui = V.real[:, kk], V.imag[:, kk], V.real[:, k2], V.imag[:, k2]
    inv_2n = 1.0 / (2 * N)
    a1r, a1i = (vr + ur) * inv_2n, (ui - vi) * inv_2n
    a2r, a2i = -(vi + ui) * inv_2n, (ur - vr) * inv_2n
    e1, e2 = torch.exp(a1r), torch.exp(a2r)
    m1r, m1i = e1 * torch.cos(a1i), e1 * torch.sin(a1i)
    m2r, m2i = e2 * torch.cos(a2i), e2 * torch.sin(a2i)
    theta = -((2.0 * math.pi * fs / N) * ops["shifts"])[bb, pp, None] * kk.to(dtype)
    cr, ci = torch.cos(theta), torch.sin(theta)
    p1r, p1i = m1r * cr - m1i * ci, m1r * ci + m1i * cr
    # both real inverse transforms as one complex FFT of conj(Z),
    # Z = X1 + i X2 made Hermitian
    zr = torch.zeros((len(bb), N), dtype=dtype)
    zi = torch.zeros_like(zr)
    for j in (0, half):
        zr[:, j], zi[:, j] = p1r[:, j], -m2r[:, j]
    mid, up = slice(1, half), N - kk[1:half]
    zr[:, mid], zi[:, mid] = p1r[:, mid] - m2i[:, mid], -(p1i[:, mid] + m2r[:, mid])
    zr[:, up], zi[:, up] = p1r[:, mid] + m2i[:, mid], -(m2r[:, mid] - p1i[:, mid])
    r = torch.fft.fft(torch.complex(zr, zi))
    periodic, aperiodic = r.real / N, -r.imag / N
    shift = (torch.arange(N) + half) % N
    dc = table("classic_dc_base", (int(N),),
               lambda: np_hanning_matlab(N) / np_hanning_matlab(N).sum(),
               dtype, "cpu")
    gain = torch.sqrt(torch.clamp(ops["noise_sizes"].to(dtype), min=1.0))
    periodic = torch.where(v, (periodic[:, shift] + dc * -periodic.sum(-1, keepdim=True))
                           * gain[bb, pp, None], torch.zeros((), dtype=dtype))
    nn_ = ops["n_noise"][bb, pp]
    mask = torch.arange(max_noise)[None, :] < nn_[:, None]
    draw = (torch.full(mask.shape, 0.1, dtype=dtype) if noise_mode == "constant"
            else a["noise"][bb, pp])
    draw = torch.where(mask, draw, torch.zeros((), dtype=dtype))
    draw = torch.where(mask, draw - draw.sum(-1, keepdim=True) / nn_[:, None].to(dtype),
                       torch.zeros((), dtype=dtype))
    # the direct convolution, m ascending
    ap_shifted = aperiodic[:, shift].double()
    conv = torch.zeros((len(bb), N), dtype=torch.float64)
    for m in range(max_noise):
        conv[:, m:] += draw[:, m:m + 1].double() * ap_shifted[:, :N - m]
    resp = torch.zeros((B, P, N), dtype=dtype)
    resp[bb, pp] = periodic + conv.to(dtype)
    return resp


def _gather_ola_model(resp, starts, count, y_length, W, max_rank, block=None):
    """Grid 2 of csrc/classic_pulses.cu: each output sample adds, for its
    chunks c (slot blk - c), the sum in pulse order of the slot's first
    max_rank pulses that reach it, the slot's first pulse found by search;
    blocks of pulses last first, each adding the slots whose first pulse
    it holds to the later blocks' partial sums."""
    B, P, _ = resp.shape
    base = SLOT * (-(-W // SLOT) + 1)
    n_chunks = -(-(W + SLOT) // SLOT)
    t = torch.arange(y_length)
    blk = torch.div(t + base, SLOT, rounding_mode="floor")
    block = P if block is None else block
    y = torch.zeros((B, y_length), dtype=resp.dtype)
    for b in range(B):
        cnt = int(min(int(count[b]), P))
        st = starts[b, :cnt].contiguous()
        for p0 in reversed(range(0, P, block)):
            own = min(P, p0 + block)
            acc = y[b].clone()
            for c in range(n_chunks):
                f = blk - c
                lo = torch.searchsorted(st, f * SLOT - base)
                hi = torch.searchsorted(st, (f + 1) * SLOT - base)
                take = (f >= 0) & (lo < hi) & (lo >= p0) & (lo < own)
                end = torch.minimum(hi, lo + max_rank)
                g = torch.zeros(y_length, dtype=resp.dtype)
                for rank in range(max_rank):
                    p = torch.clamp(lo + rank, max=max(cnt - 1, 0))
                    j = t - (st[p] if cnt else torch.zeros_like(t))
                    ok = take & (lo + rank < end) & (j >= 0) & (j < W)
                    g = torch.where(ok, g + resp[b, p, torch.clamp(j, 0, W - 1)], g)
                acc = torch.where(take, acc + g, acc)
            y[b] = acc
    return y


@pytest.mark.parametrize("variant,noise_mode", [("standard", "gaussian"),
                                                ("a", "constant")])
def test_k8_arithmetic_model_matches_the_plain_version(variant, noise_mode):
    """K8's packed transforms and direct convolution, overlap-added by
    SlotGrid, within 1e-13 of the waveform's scale of the plain version in
    float64 on the golden parameters."""
    a = _golden()
    ops = _operands(a, variant)
    y, crowded = _pulses(K.pulses_plain, a, ops, noise_mode)
    resp = _responses_model(a, ops, noise_mode)
    grid = SlotGrid(ops["starts"], a["y_length"], a["fft_size"], resp.dtype)
    grid.add(resp, 0, a["max_rank"])
    got, got_crowded = grid.result(a["max_rank"])
    scale = float(y.abs().max())
    assert scale > 0.1
    assert float((got - y).abs().max()) < 1e-13 * scale
    assert torch.equal(got_crowded, crowded)


def _dense_starts(B=3, P=48, y_length=400, W=64, seed=0):
    """Nondecreasing starts with runs of equal and near starts (slots of up
    to 6 pulses), parked past the output after each row's count; row 2 has
    no pulse."""
    g = torch.Generator().manual_seed(seed)
    steps = torch.randint(0, 14, (B, P), generator=g)
    steps[:, ::5] = 0
    starts = torch.cumsum(steps, -1) - W // 2
    count = torch.tensor([P - 5, P, 0][:B], dtype=torch.int64)
    valid = torch.arange(P)[None, :] < count[:, None]
    starts = torch.where(valid, starts, torch.full_like(starts, y_length + W + 2))
    resp = torch.randn((B, P, W), dtype=torch.float64, generator=g)
    resp = torch.where(valid[..., None], resp, torch.zeros((), dtype=torch.float64))
    return resp, starts, count


@pytest.mark.parametrize("block", [None, 7, 16, 1])
@pytest.mark.parametrize("max_rank", [1, 3, SLOT])
def test_k8_gather_overlap_add_is_slot_grid_bitwise(block, max_rank):
    """Grid 2's order gives SlotGrid's bits, in one block of pulses or
    several run last first, with crowded slots left out as SlotGrid leaves
    them; the crowded flag from the ranks alone is SlotGrid's."""
    y_length, W = 400, 64
    resp, starts, count = _dense_starts(y_length=y_length, W=W)
    grid = SlotGrid(starts, y_length, W, resp.dtype)
    grid.add(resp, 0, max_rank)
    want, crowded = grid.result(max_rank)
    got = _gather_ola_model(resp, starts, count, y_length, W, max_rank, block)
    assert torch.equal(got, want)
    assert torch.equal(K.slot_crowded(starts, y_length, W, max_rank), crowded)
    assert crowded.tolist() == ([True, True, False] if max_rank < 6
                                else [False, False, False])


# ---------------------------------------------------------------------------
# counters, blocking, geometry, dispatch
# ---------------------------------------------------------------------------

def _live_pulses(a, variant="standard"):
    ops = _operands(a, variant)
    return int(torch.clamp(ops["count"], max=a["max_pulses"]).sum())


def test_pulse_counters_under_tracing():
    """Under tracing(), a call's outermost span gains synth.pulses.slots
    (rows times max_pulses, from the shapes) and synth.pulses.live (the
    rows' kept pulses, which the plain version adds on the CPU as K8 does on
    the card); tracing off, the slots are counted and the live pulses not
    read."""
    from world_tpu_torch.synth.classic import synthesis

    a = _golden()
    src = {"f0": a["f0"][0].numpy(), "vuv": a["vuv"][0].numpy(),
           "temporal_positions": a["tp"].numpy(),
           "aperiodicity": a["aperiodicity"][0].numpy()}
    filt = {"spectrogram": a["spectrogram"][0].numpy(), "fs": a["fs"]}
    want_live = _live_pulses(a)
    assert 0 < want_live < a["max_pulses"]
    with tracing():
        with TRACER.span("world.test.decode", device="cpu") as span:
            synthesis(src, filt, noise=a["noise"][0], device="cpu")
            synthesis(src, filt, noise_mode="constant", device="cpu")
    assert span.counts["synth.pulses.slots"] == 2 * a["max_pulses"]
    assert span.counts["synth.pulses.live"] == 2 * want_live
    before = TRACER.counters()
    synthesis(src, filt, noise=a["noise"][0], device="cpu")
    after = TRACER.counters()
    assert after["synth.pulses.slots"] - before["synth.pulses.slots"] == a["max_pulses"]
    assert after["synth.pulses.live"] == before["synth.pulses.live"]
    # the next traced call gains only its own live pulses
    with tracing():
        with TRACER.span("world.test.decode", device="cpu") as span:
            synthesis(src, filt, noise=a["noise"][0], device="cpu")
    assert span.counts["synth.pulses.live"] == want_live


def test_dio_classic_counts_its_pulse_slots():
    """DioClassic's call counts its rows times the caps' max_pulses, and
    its live pulses under tracing()."""
    from world_tpu_torch import DioClassic
    from world_tpu_torch.parallel.batch import classic_caps

    fs, n = 12000, 3072
    t = np.arange(n) / fs
    x = torch.tensor(np.stack([0.5 * np.sin(2 * np.pi * 140 * t),
                               np.zeros(n)]), dtype=torch.float64)
    _, mp, mn = classic_caps(n, fs, 5)
    model = DioClassic(fs, n, dtype=torch.float64, device="cpu")
    noise = torch.randn((2, mp, mn), dtype=torch.float64,
                        generator=torch.Generator().manual_seed(2))
    with tracing():
        model(x, noise=noise)
    calls = [s for s in TRACER.spans() if s.name == "world.batch.dio_classic"]
    counts = calls[-1].counts
    assert counts["synth.pulses.slots"] == 2 * mp
    assert 0 < counts["synth.pulses.live"] < 2 * mp


def test_k8_blocking_follows_the_budget():
    from world_tpu_torch._backend import STAGE_BYTES_BUDGET

    assert K.k8_blocking(16, 8192, 1024, 4) is None          # the corpus cell
    assert K.k8_blocking(1, 65536, 1024, 4) is None          # the 60 s glide
    assert (K.k8_blocking(4, 65536, 1024, 8)
            == STAGE_BYTES_BUDGET // 2 // (4 * 1024 * 8))


def _cpu_k8_args(a, ops):
    return (a["spectrogram"], a["aperiodicity"], a["noise"],
            *(ops[k] for k in OPS_KEYS), a["fs"], a["y_length"], a["fft_size"],
            a["max_noise"], "gaussian", a["max_rank"])


def test_k8_wrapper_raises_geometry_errors_naming_the_shapes():
    """Shapes K8 does not take raise KernelGeometryError naming them before
    any device check; a geometry it takes, on the CPU, has its device
    refused: nothing falls back."""
    a = _golden(torch.float32)
    ops = _operands(a)
    args = _cpu_k8_args(a, ops)
    for i, v in ((15, 1000), (15, 65536), (16, 2000), (18, 40)):
        bad = list(args)
        bad[i] = v
        with pytest.raises(KernelGeometryError, match="pulse slots"):
            K.pulses_cuda(*bad)
    with pytest.raises(ValueError, match="expected a tensor on") as err:
        K.pulses_cuda(*args)
    assert not isinstance(err.value, KernelGeometryError)


def test_dispatcher_takes_the_plain_version_on_cpu_and_meta_without_launching():
    a = _golden(torch.float32)
    ops = _operands(a)
    launches = K.pulse_counter.launches
    y, crowded = K.pulse_synthesis(*_cpu_k8_args(a, ops))
    want, want_crowded = K.pulses_plain(*_cpu_k8_args(a, ops))
    assert torch.equal(y, want) and torch.equal(crowded, want_crowded)
    meta = {k: (v.to("meta") if isinstance(v, torch.Tensor) else v)
            for k, v in a.items()}
    mops = {k: v.to("meta") for k, v in ops.items()}
    ym, cm = K.pulse_synthesis(*_cpu_k8_args(meta, mops))
    assert ym.shape == (1, a["y_length"]) and cm.shape == (1,)
    assert K.pulse_counter.launches == launches


# ---------------------------------------------------------------------------
# the kernel (needs the card)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K8 is CUDA C++ for sm_90a")
    return torch.device("cuda")


def _to(a, device):
    return {k: (v.to(device) if isinstance(v, torch.Tensor) else v)
            for k, v in a.items()}


def _hold_k8(a, device, variant="standard", noise_mode="gaussian"):
    """K8 against the plain version on the card and on the CPU, on the same
    per-pulse operands; returns the differences and K8's output."""
    g = _to(a, device)
    ops = _operands(g, variant)
    counter = TRACER.device_counter(K.LIVE, device)
    torch.cuda.synchronize()
    before = int(counter.item())
    y1, c1 = _pulses(K.pulses_cuda, g, ops, noise_mode)
    y2, c2 = _pulses(K.pulses_cuda, g, ops, noise_mode)
    torch.cuda.synchronize()
    live = int(torch.clamp(ops["count"], max=g["max_pulses"]).sum())
    assert int(counter.item()) - before == 2 * live
    yp, cp = _pulses(K.pulses_plain, g, ops, noise_mode)
    yc, cc = _pulses(K.pulses_plain, a, _to(ops, "cpu"), noise_mode)
    assert torch.equal(y1, y2) and torch.equal(c1, c2)
    assert torch.equal(c1, cp) and torch.equal(cp.cpu(), cc)
    d_k = float((y1 - yp).abs().max())
    d_p = float((yp.cpu() - yc).abs().max())
    return d_k, d_p, y1, c1


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("fs,N", [(16000, 1024), (32000, 2048), (96000, 4096),
                                  (192000, 8192), (384000, 16384)])
def test_k8_matches_plain_on_the_card(cuda, fs, N, dtype):
    """The waveform within twice the plain version's own card-against-CPU
    difference, flags equal, two calls bitwise, the live pulses counted."""
    a = _synthetic(fs, N, dtype=dtype)
    d_k, d_p, y, _ = _hold_k8(a, cuda)
    assert bool(torch.isfinite(y).all()) and float(y.abs().max()) > 0
    assert d_k <= 2.0 * d_p, (d_k, d_p)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k8_variant_a_and_constant_noise_on_the_card(cuda, dtype):
    a = _golden(dtype)
    for variant, noise_mode in (("a", "gaussian"), ("standard", "constant"),
                                ("a", "constant")):
        d_k, d_p, _, _ = _hold_k8(a, cuda, variant, noise_mode)
        assert d_k <= 2.0 * d_p, (variant, noise_mode, d_k, d_p)


@pytest.mark.gpu
def test_k8_edge_rows_on_the_card(cuda):
    """A row without pulses writes nothing; a row past max_pulses and a row
    with crowded slots set the plain version's flags through
    synthesis_core on both devices."""
    a = _golden()
    g = _to(a, cuda)
    ops = _operands(g)
    ops["count"] = torch.zeros_like(ops["count"])
    y, crowded = _pulses(K.pulses_cuda, g, ops)
    assert not bool(y.abs().max()) and crowded.tolist() == [False]
    for case, variant in _capped_cases():
        want, want_flag = _synthesis(C.synthesis_core, case, variant)
        got, flag = _synthesis(C.synthesis_core, _to(case, cuda), variant)
        assert torch.equal(flag.cpu(), want_flag) and bool(flag.all())
        assert torch.isfinite(got).all()


@pytest.mark.gpu
def test_k8_blocks_of_pulses_equal_one_block_on_the_card(cuda, monkeypatch):
    """Blocks of pulses run last first give one block's bits."""
    a = _to(_golden(torch.float32), cuda)
    ops = _operands(a)
    whole = _pulses(K.pulses_cuda, a, ops)
    launches = K.pulse_counter.launches
    monkeypatch.setattr(K, "k8_blocking", lambda *args: 333)
    blocked = _pulses(K.pulses_cuda, a, ops)
    assert K.pulse_counter.launches - launches == -(-a["max_pulses"] // 333)
    assert torch.equal(blocked[0], whole[0]) and torch.equal(blocked[1], whole[1])


@pytest.mark.gpu
def test_k8_launches_on_the_round_trip_graph_and_the_facade(cuda):
    """DioClassic's replay launches K8 once a call, bitwise its eager call;
    World.decode (classic) launches it once."""
    from world_tpu_torch import DioClassic, World
    from world_tpu_torch.parallel.batch import classic_caps

    fs, n = 16000, 16000
    x16 = np.load(GOLDEN / "harvest_16k.npz")["x16"][:n]
    x = torch.tensor(np.stack([x16, x16[::-1]]), dtype=torch.float32)
    _, mp, mn = classic_caps(n, fs, 5)
    noise = torch.randn((2, mp, mn), generator=torch.Generator(device="cuda").manual_seed(1),
                        device="cuda")
    model = DioClassic(fs, n, dtype=torch.float32, device="cuda")
    eager = model(x, noise=noise)
    model(x, noise=noise)                                     # capture
    launches = K.pulse_counter.launches
    replay = model(x, noise=noise)
    torch.cuda.synchronize()
    assert K.pulse_counter.launches - launches == 1
    assert torch.equal(replay["y"], eager["y"])
    world = World(device="cuda", dtype=torch.float32)
    dat = world.encode(fs, x16.astype(np.float64), f0_method="dio")
    launches = K.pulse_counter.launches
    world.decode(dat)
    assert K.pulse_counter.launches - launches == 1
