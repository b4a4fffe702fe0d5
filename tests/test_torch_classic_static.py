"""The classic DIO -> classic synthesis round trip on the JAX package's static
shapes, in float64 on the CPU unless said.

The port's counterpart of ``jax.jit(_encode_decode_classic_one)`` is one CUDA
graph per shape (``DioClassic``), and a graph captures only code whose shapes
depend on the caps alone and which reads nothing back to the host:

  * K3's plain version (DIO's FixStep3 and FixStep4 scans) against
    ``jax.vmap`` of world_tpu.f0.dio._fix_step3/_fix_step4, bitwise in
    float64 and float32, on dio.npz's step-2 contour, sections of 1-3 frames,
    no voiced frame and a contour voiced to its last frame;
  * classic synthesis on the static pulse axis against the dynamic one it
    replaces (``_dynamic_synthesis`` below: the pulses found by ``nonzero``,
    only those computed), bitwise on the golden parameters, both variants,
    both noise modes, an all-unvoiced contour, and in blocks of pulses;
  * the round trip's rows bitwise their one-row calls;
  * the round trip on ``meta`` tensors with K1 and K3 stubbed by their
    shapes, where a host read raises, and a second call that uploads
    nothing from the host;
  * DioClassic's graph policy with the capture stubbed, its key, and its
    tables written in place;
  * SWIPE′'s, the classic round trip's and World.decode's tables built
    once.
"""
import math
from functools import partial
from pathlib import Path

import numpy as np
import pytest
import torch

GOLDEN = Path(__file__).parent / "golden"
TINY_FS, TINY_N, TINY_FP = 12000, 3072, 10


# ---------------------------------------------------------------------------
# K3: the extension scans
# ---------------------------------------------------------------------------

def _scan_rows(case):
    """(f0_step2 (3, 929), mutated candidates (3, 7, 929))."""
    g = np.load(GOLDEN / "dio.npz")
    step2, cands = g["f0_step2"], g["f0_candidates_mutated"]
    n, C = step2.shape[0], cands.shape[0]
    rng = np.random.RandomState(7)
    near = 180 + rng.rand(C, n) * 20
    near[rng.rand(C, n) < 0.2] = 0.0
    short = np.zeros(n)
    for s, length in ((10, 1), (13, 2), (17, 3), (22, 1), (40, 5), (47, 1),
                      (90, 3), (95, 2), (300, 1), (302, 1)):
        short[s:s + length] = 190.0 + rng.rand(length)
    if case == "dio_short_none":
        return np.stack([step2, short, np.zeros(n)]), np.stack([cands, near, cands])
    to_end = np.where(np.arange(n) >= 700, 185.0 + rng.rand(n), step2)
    from_start = np.where(np.arange(n) < 30, 175.0 + rng.rand(n), 0.0)
    last_only = np.zeros(n)
    last_only[-1] = 200.0
    return (np.stack([to_end, from_start, last_only]),
            np.stack([cands, near, near[::-1]]))


@pytest.mark.parametrize("case", ["dio_short_none", "edges"])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_k3_plain_matches_jax_scans(case, dtype):
    import jax
    import jax.numpy as jnp

    from world_tpu.f0.dio import _fix_step3, _fix_step4
    from world_tpu_torch.f0.dio import fix_step3, fix_step4

    rows, cands = _scan_rows(case)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    w3 = jax.vmap(partial(_fix_step3, allowed_range=0.1))(
        jnp.asarray(rows, jdt), jnp.asarray(cands, jdt))
    w4 = np.asarray(jax.vmap(partial(_fix_step4, allowed_range=0.1))(
        w3, jnp.asarray(rows, jdt), jnp.asarray(cands, jdt)))
    f0, cd = torch.tensor(rows, dtype=tdt), torch.tensor(cands, dtype=tdt)
    got3 = fix_step3(f0, cd, 0.1)
    got4 = fix_step4(got3, f0, cd, 0.1)
    np.testing.assert_array_equal(got3.numpy(), np.asarray(w3))
    np.testing.assert_array_equal(got4.numpy(), w4)
    assert not np.array_equal(w4, rows)                 # the scans extended
    for b in range(3):
        one3 = fix_step3(f0[b:b + 1], cd[b:b + 1], 0.1)
        assert torch.equal(one3[0], got3[b])
        assert torch.equal(fix_step4(one3, f0[b:b + 1], cd[b:b + 1], 0.1)[0],
                           got4[b])


def test_k3_reproduces_the_dio_golden_steps():
    from world_tpu_torch.f0.dio import fix_step3, fix_step4

    g = np.load(GOLDEN / "dio.npz")
    f0 = torch.tensor(g["f0_step2"])[None]
    cands = torch.tensor(g["f0_candidates_mutated"])[None]
    step3 = fix_step3(f0, cands, 0.1)
    np.testing.assert_array_equal(step3[0].numpy(), g["f0_step3"])
    np.testing.assert_array_equal(fix_step4(step3, f0, cands, 0.1)[0].numpy(),
                                  g["f0_step4"])


def test_k3_wrapper_takes_the_plain_version_on_the_cpu_only(monkeypatch):
    from world_tpu_torch.ops import extension_scan as K3

    rows, cands = _scan_rows("dio_short_none")
    base, cd = torch.tensor(rows), torch.tensor(cands)
    flags = base != 0
    limits = torch.full(base.shape, 928, dtype=torch.int64)
    # the kernel's wrapper refuses a tensor that is not on the card
    with pytest.raises(ValueError):
        K3.extension_scan_cuda(base, flags, limits, cd, 0.1)
    launched = []
    monkeypatch.setattr(K3, "extension_scan_cuda",
                        lambda *a, **k: launched.append(1))
    before = K3.counter.launches
    out = K3.extension_scan(base, flags, limits, cd, 0.1, backward=True)
    assert launched == [] and K3.counter.launches == before
    assert torch.equal(out, K3.extension_scan_plain(base, flags, limits, cd, 0.1,
                                                    backward=True))


# ---------------------------------------------------------------------------
# classic synthesis: the static pulse axis against the dynamic one
# ---------------------------------------------------------------------------

def _dynamic_synthesis(f0, vuv, tp, spectrogram, aperiodicity, noise, fs,
                       y_length, fft_size, max_pulses, max_noise, noise_mode,
                       variant, frame_period_s):
    """Classic synthesis of one utterance as the port had it before its
    static form: the pulses found by ``nonzero`` and only those computed,
    the last one's next pulse itself, and the checked ``scatter_ola``.  Its
    complex products are :func:`cmul`'s, as the static form's are."""
    from world_tpu_torch._backend import F64_EPS, sdiv
    from world_tpu_torch.dsp.minphase import minimum_phase_spectrum, mirror_full
    from world_tpu_torch.dsp.ola import scatter_ola
    from world_tpu_torch.dsp.windows import np_hanning_matlab
    from world_tpu_torch.synth.classic import _interp, cmul, sample_times

    dtype = spectrogram.dtype
    time_axis = sample_times(y_length, fs, tp[0])
    queries = time_axis.to(dtype)
    f0_i = _interp(f0, tp, queries, frame_period_s)
    vuv_i = _interp(vuv, tp, queries, frame_period_s) > 0.5
    zero = torch.zeros((), dtype=dtype)
    f0_i = torch.where(vuv_i, f0_i, zero)
    f0_i = torch.where(f0_i == 0, torch.full_like(f0_i, 500.0), f0_i)
    total_phase = torch.cumsum(sdiv(2 * math.pi * f0_i.double(), float(fs)), 0)
    wrap = torch.remainder(total_phase, 2 * math.pi)
    mask = torch.abs(torch.diff(wrap)) > (math.pi if variant == "standard"
                                          else math.pi / 2)
    n = mask.shape[0]
    at = mask.nonzero()[:max_pulses, 0]
    locs = time_axis[at]
    pli = torch.floor(locs * fs + 0.5).to(torch.int64) + 1
    locs = locs.to(dtype)
    y1 = wrap[pli - 1] - 2.0 * math.pi
    y2 = wrap[torch.clamp(pli, max=n)]
    shifts = sdiv(-y1 / (y2 - y1), float(fs)).to(dtype)
    if variant == "a":
        shifts = torch.zeros_like(shifts)
    P = pli.shape[0]
    n_frames = tp.shape[0]
    frame_ids = torch.arange(1, n_frames + 1, dtype=dtype)
    tpi = torch.clamp(_interp(frame_ids, tp, locs, frame_period_s), 1.0,
                      float(n_frames))
    S, AP = spectrogram.T, (aperiodicity ** 2).T
    PER = torch.clamp(1.0 - AP, min=0.001)
    nxt = torch.clamp(torch.arange(1, P + 1), max=P - 1)
    noise_sizes = pli[nxt] - pli
    floor_i = torch.floor(tpi).to(torch.int64) - 1
    ceil_i = torch.ceil(tpi).to(torch.int64) - 1
    t1, t2 = tp[floor_i], tp[ceil_i]
    xq = torch.maximum(t1, torch.minimum(t2, locs))
    same = t1 == t2
    b = torch.where(same, zero, (xq - t1) / torch.where(same, torch.ones_like(t1),
                                                      t2 - t1))
    a, b = (1.0 - b)[:, None], b[:, None]
    spec = a * S[floor_i] + b * S[ceil_i]
    per = a * PER[floor_i] + b * PER[ceil_i]
    aps = a * AP[floor_i] + b * AP[ceil_i]
    voiced = vuv_i[pli - 1]
    if variant == "standard":
        voiced = voiced & (aps[:, 0] <= 0.999)
    half_n = fft_size // 2 + 1
    mp = minimum_phase_spectrum(mirror_full(torch.clamp(spec * per, min=F64_EPS)))
    theta = -(2.0 * math.pi * fs / fft_size * shifts)[:, None] * torch.arange(
        half_n, dtype=dtype)[None, :]
    half = cmul(mp[:, :half_n], torch.polar(torch.ones_like(theta), theta))
    full = torch.cat([half, torch.flip(half[:, 1:-1], (-1,)).conj()], dim=1)
    response = torch.fft.fftshift(torch.fft.ifft(full).real, dim=-1)
    dc_base = np_hanning_matlab(fft_size)
    dc_base = torch.as_tensor(dc_base / dc_base.sum(), dtype=dtype)
    periodic = ((response + dc_base[None, :] * (-response.sum(1, keepdim=True)))
                * torch.sqrt(torch.clamp(noise_sizes.to(dtype), min=1.0))[:, None])
    periodic = torch.where(voiced[:, None], periodic, zero)
    ap_spec = torch.clamp(torch.where(voiced[:, None], spec * aps, spec), min=F64_EPS)
    ap_response = torch.fft.fftshift(
        torch.fft.ifft(minimum_phase_spectrum(mirror_full(ap_spec))).real, dim=-1)
    n_noise = torch.clamp(torch.clamp(noise_sizes, max=max_noise), min=3)
    noise_mask = torch.arange(max_noise)[None, :] < n_noise[:, None]
    draw = (torch.full((P, max_noise), 0.1, dtype=dtype) if noise_mode == "constant"
            else noise[:P].to(dtype))
    draw = torch.where(noise_mask, draw, zero)
    draw = torch.where(noise_mask, draw - draw.sum(1, keepdim=True)
                       / n_noise[:, None].to(dtype), zero)
    conv_n = 2 * fft_size
    ap_out = torch.fft.irfft(cmul(torch.fft.rfft(draw, conv_n),
                                  torch.fft.rfft(ap_response, conv_n)),
                             conv_n)[:, :fft_size]
    return scatter_ola(periodic + ap_out, pli - fft_size // 2, y_length)


@pytest.fixture(scope="module")
def golden_args():
    from world_tpu_torch.synth.classic import default_max_pulses, max_noise_length

    src = np.load(GOLDEN / "source_dio.npz")
    d4 = np.load(GOLDEN / "d4c.npz")
    spec = np.load(GOLDEN / "cheaptrick.npz")["spectrogram"]
    tp, f0, fs = src["temporal_positions"], d4["f0_after_mutation"], 22050
    max_pulses, max_noise = default_max_pulses(tp, f0), max_noise_length(fs)
    noise = torch.randn((max_pulses, max_noise), dtype=torch.float64,
                        generator=torch.Generator().manual_seed(3))
    return dict(f0=torch.tensor(f0), vuv=torch.tensor(src["vuv"]),
                tp=torch.tensor(tp), spectrogram=torch.tensor(spec),
                aperiodicity=torch.tensor(d4["aperiodicity"]), noise=noise,
                fs=fs, y_length=len(np.arange(tp[0], tp[-1] + 1 / fs, 1.0 / fs)),
                fft_size=(spec.shape[0] - 1) * 2, max_pulses=max_pulses,
                max_noise=max_noise, fp=0.005)


def _static(a, variant, noise_mode, vuv):
    from world_tpu_torch.synth.classic import pulse_rank_bound, synthesis_core

    noise = None if noise_mode == "constant" else a["noise"][None]
    return synthesis_core(
        a["f0"][None], vuv[None], a["tp"], a["spectrogram"][None],
        a["aperiodicity"][None], noise, a["fs"], a["y_length"], a["fft_size"],
        a["max_pulses"], a["max_noise"], noise_mode, variant, a["fp"],
        pulse_rank_bound(float(a["f0"].max()), a["fs"], variant))


def _static_and_dynamic(a, variant, noise_mode, vuv=None):
    vuv = a["vuv"] if vuv is None else vuv
    y, over = _static(a, variant, noise_mode, vuv)
    want = _dynamic_synthesis(
        a["f0"], vuv, a["tp"], a["spectrogram"], a["aperiodicity"],
        None if noise_mode == "constant" else a["noise"], a["fs"], a["y_length"],
        a["fft_size"], a["max_pulses"], a["max_noise"], noise_mode, variant,
        a["fp"])
    return y, over, want


@pytest.mark.parametrize("variant,noise_mode", [
    ("standard", "gaussian"), ("standard", "constant"), ("a", "gaussian"),
    ("a", "constant")])
def test_static_synthesis_equals_the_dynamic_one(golden_args, variant,
                                                 noise_mode):
    y, over, want = _static_and_dynamic(golden_args, variant, noise_mode)
    assert y.shape == (1, golden_args["y_length"]) and over.tolist() == [False]
    assert torch.equal(y[0], want)


def test_static_synthesis_of_an_unvoiced_contour(golden_args):
    """Every pulse at the 500 Hz default: the most pulses the golden grid
    makes, and the densest slots."""
    vuv = torch.zeros_like(golden_args["vuv"])
    y, over, want = _static_and_dynamic(golden_args, "standard", "gaussian", vuv)
    assert not over.any() and torch.equal(y[0], want)


def test_static_synthesis_in_blocks_of_pulses(golden_args, monkeypatch):
    """Blocks of pulses fill one slot grid in the unblocked order: any
    blocking gives the same bits, the last block short."""
    from world_tpu_torch.synth import classic

    args = (golden_args, "a", "gaussian", golden_args["vuv"])
    whole, _ = _static(*args)
    monkeypatch.setattr(classic, "pulse_blocking", lambda *a: 333)
    blocked, _ = _static(*args)
    assert torch.equal(blocked, whole)


def test_pulse_blocking_follows_the_budget():
    from world_tpu_torch._backend import STAGE_BYTES_BUDGET
    from world_tpu_torch.parallel.batch import classic_caps
    from world_tpu_torch.synth.classic import (PULSE_ITEMS_PER_SAMPLE,
                                               pulse_blocking)

    assert pulse_blocking(3, 256, 512, 8) is None            # the tiny shape
    _, max_pulses, _ = classic_caps(74304, 16000, 5)          # x16
    assert max_pulses == 8192
    block = pulse_blocking(1, max_pulses, 1024, 4)
    assert block == STAGE_BYTES_BUDGET // 2 // (PULSE_ITEMS_PER_SAMPLE * 1024 * 4)
    assert pulse_blocking(4, max_pulses, 1024, 4) == block // 4


def test_synthesis_flags_a_pulse_count_past_its_cap(golden_args):
    from world_tpu_torch.synth.classic import synthesis_core

    a = golden_args
    y, over = synthesis_core(
        a["f0"][None], a["vuv"][None], a["tp"], a["spectrogram"][None],
        a["aperiodicity"][None], a["noise"][None, :64], a["fs"], a["y_length"],
        a["fft_size"], 64, a["max_noise"], "gaussian", "standard", a["fp"])
    assert over.tolist() == [True] and torch.isfinite(y).all()


# ---------------------------------------------------------------------------
# the round trip
# ---------------------------------------------------------------------------

def _tiny_rows():
    t = np.arange(TINY_N) / TINY_FS
    rng = np.random.RandomState(0)
    x = (0.6 * (np.sin(2 * np.pi * 150 * t) + 0.3 * np.sin(2 * np.pi * 300 * t))
         + 0.01 * rng.randn(TINY_N))
    return np.stack([x, 0.7 * x[::-1] + 1e-3 * rng.randn(TINY_N), np.zeros(TINY_N)])


def _tiny_noise(B, seed=1):
    from world_tpu_torch.parallel.batch import classic_caps

    _, mp, mn = classic_caps(TINY_N, TINY_FS, TINY_FP)
    return torch.randn((B, mp, mn), dtype=torch.float64,
                       generator=torch.Generator().manual_seed(seed))


def test_classic_round_trip_rows_equal_single_calls():
    """Three rows, one silent: every output of each row is bitwise its
    one-row call with the same noise row."""
    from world_tpu_torch import encode_decode_classic_one

    xs = torch.tensor(_tiny_rows())
    noise = _tiny_noise(3)
    batch = encode_decode_classic_one(xs, TINY_FS, TINY_FP, noise=noise)
    assert (batch["vuv"][0] > 0).any() and not (batch["vuv"][2] > 0).any()
    assert batch["y"].shape[0] == 3 and not batch["_overflow"].any()
    for b in range(3):
        one = encode_decode_classic_one(xs[b:b + 1], TINY_FS, TINY_FP,
                                        noise=noise[b:b + 1])
        for key, v in batch.items():
            want = one[key] if key == "temporal_positions" else one[key][0]
            got = v if key == "temporal_positions" else v[b]
            assert torch.equal(got, want), (b, key)


META = torch.device("meta")


def _stub_kernels(monkeypatch):
    """K1 and K3 stand in as shapes: each returns empty outputs of its own
    shape."""
    from world_tpu_torch.ops import edge_interp, extension_scan

    def k1(signals, fs, t_frames, stride):
        return (torch.empty((signals.shape[0], t_frames.shape[0]),
                            dtype=signals.dtype, device=signals.device),
                torch.empty(signals.shape[0], dtype=torch.int32,
                            device=signals.device))

    monkeypatch.setattr(edge_interp, "interval_interp", k1)
    monkeypatch.setattr(extension_scan, "extension_scan",
                        lambda base, *a, **k: torch.empty_like(base))


def test_classic_round_trip_has_static_shapes(monkeypatch):
    """encode_decode_classic_one from the decimator to the waveform on meta
    tensors, batch 2: nothing on the round trip reads the data.  A second
    call finds every table kept and uploads nothing from the host."""
    from world_tpu_torch import encode_decode_classic_one
    from world_tpu_torch.parallel.batch import classic_caps, classic_tables

    _stub_kernels(monkeypatch)
    fs, n = 16000, 8000
    y_length, mp, mn = classic_caps(n, fs, 5)
    x = torch.empty((2, n), dtype=torch.float32, device=META)
    noise = torch.empty((2, mp, mn), dtype=torch.float32, device=META)
    tables = classic_tables(fs, torch.float32, META)
    out = encode_decode_classic_one(x, fs, 5, noise=noise, tables=tables)

    def upload(*args, **kwargs):
        raise AssertionError("a host upload on the round trip")

    for name in ("tensor", "as_tensor", "from_numpy"):
        monkeypatch.setattr(torch, name, upload)
    again = encode_decode_classic_one(x, fs, 5, noise=noise, tables=tables)
    for o in (out, again):
        assert o["y"].shape == (2, y_length) and o["_overflow"].shape == (2,)
        assert o["f0"].shape == o["vuv"].shape == (2, 101)
        assert o["spectrogram"].shape == o["aperiodicity"].shape == (2, 513, 101)
        assert o["y"].device == META


class _FakeGraph:
    """A captured call for the cache's bookkeeping: replays fn eagerly."""

    def __init__(self, fn):
        self.fn, self.pool_bytes = fn, 1

    def replay(self, inputs):
        return self.fn(*inputs)

    def finish(self):
        pass


def test_dio_classic_graph_policy(monkeypatch):
    """With the capture stubbed (the CPU has no graphs): a signature's first
    call runs eagerly, its second captures, its third replays; the key
    changes with the rows, the caps and the tables; the buffers written in
    place are what a replay reads; moving the module drops its graphs."""
    from test_torch_state import jax_dio_state
    from world_tpu_torch import DioClassic
    from world_tpu_torch.parallel import batch, graphs

    captured = []

    def fake_capture(fn, inputs, device):
        captured.append(tuple(inputs[0].shape))
        return _FakeGraph(fn)

    monkeypatch.setattr(graphs, "_capture", fake_capture)
    monkeypatch.setattr(batch, "replays", lambda device: True)
    module = DioClassic(TINY_FS, TINY_N, frame_period=TINY_FP,
                        dtype=torch.float64, device="cpu")
    xs = torch.tensor(_tiny_rows()[:1])
    noise = _tiny_noise(1)
    outs = [module(xs, noise=noise) for _ in range(3)]
    assert captured == [(1, TINY_N)]
    assert module.graphs.calls == {"eager": 1, "captured": 1, "replayed": 2}
    for key, v in outs[0].items():
        assert torch.equal(outs[2][key], v), key
    # other rows, another type or other caps are another signature
    sig = module.signature(xs, noise)
    two = torch.cat([xs, xs])
    assert sig != module.signature(two, torch.cat([noise, noise]))
    assert sig != module.signature(xs.float(), noise)
    assert sig != module.signature(xs, noise[:, :64])
    # the JAX package's tables written in place: the same signature, and a
    # replay reads them
    module.from_numpy_state(jax_dio_state(TINY_FS))
    assert module.signature(xs, noise) == sig
    replayed = module(xs, noise=noise)
    assert module.graphs.calls == {"eager": 1, "captured": 1, "replayed": 3}
    eager = batch.encode_decode_classic_one(
        xs, TINY_FS, TINY_FP, noise=noise, tables=dict(module.named_buffers()))
    for key, v in eager.items():
        assert torch.equal(replayed[key], v), key
    other = DioClassic(TINY_FS, TINY_N, frame_period=TINY_FP,
                       dtype=torch.float64, device="cpu")
    assert other.signature(xs, noise) != sig                  # other buffers
    # moving the module drops its graphs and the signatures it has seen
    module.to("cpu")
    assert module.graphs.graphs() == [] and not module.graphs._seen


def test_dio_classic_draws_its_noise_before_the_round_trip():
    from world_tpu_torch import DioClassic

    module = DioClassic(TINY_FS, TINY_N, frame_period=TINY_FP,
                        dtype=torch.float64, device="cpu")
    x = torch.tensor(_tiny_rows()[0])
    a = module(x, generator=torch.Generator().manual_seed(5))
    b = module(x, noise=_tiny_noise(1, seed=5))
    for key, v in a.items():
        assert torch.equal(b[key], v), key


# ---------------------------------------------------------------------------
# tables built once
# ---------------------------------------------------------------------------

def _cache_state():
    from world_tpu_torch import tables

    with tables._LOCK:
        return {k: id(v) for k, v in tables._CACHE.items()}


def test_swipe_and_classic_tables_are_built_once():
    from world_tpu_torch import encode_decode_classic_one
    from world_tpu_torch.f0.swipe import swipe

    x = torch.tensor(_tiny_rows()[0])
    first = swipe(TINY_FS, x, sTHR=0.3, device="cpu")
    state = _cache_state()
    again = swipe(TINY_FS, x, sTHR=0.3, device="cpu")
    assert _cache_state() == state
    assert torch.equal(first["f0"], again["f0"])
    noise = _tiny_noise(1)
    encode_decode_classic_one(x[None], TINY_FS, TINY_FP, noise=noise)
    state = _cache_state()
    encode_decode_classic_one(x[None], TINY_FS, TINY_FP, noise=noise)
    assert _cache_state() == state


def test_world_requiem_decode_keeps_its_seed_bank():
    from world_tpu_torch import World
    from world_tpu_torch.synth.seeds import get_seeds_signals, seed_tables

    w = World(device="cpu")
    dat = w.encode(TINY_FS, _tiny_rows()[0], f0_method="dio", is_requiem=True)
    y = w.decode(dict(dat))["out"]
    state = _cache_state()
    assert np.array_equal(w.decode(dict(dat))["out"], y)
    assert _cache_state() == state
    banks = seed_tables(TINY_FS, 0, torch.float64, "cpu")
    np.testing.assert_array_equal(banks["pulse"].numpy(),
                                  get_seeds_signals(TINY_FS)["pulse"])
