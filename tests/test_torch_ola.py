"""The syntheses' overlap-add and sample-time axis.

The pulses' overlap-add sums in a fixed order (rank inside a 32-sample slot,
then the slot grid's fold), as world_tpu.dsp.ola.slotted_ola does, so the
waveform is the same bits in every run; the pulse indices come from a
float64 sample-time axis in every working type.
"""
import math

import numpy as np
import pytest
import torch

FS = 22050
# the first sample index at 22.05 kHz whose float32 time n / fs, times fs,
# rounds to another index (256.0013 s): float64 places it exactly
FIRST_F32_MISPLACED = 5_644_828


def _responses(P, W, seed, dtype=np.float64):
    return np.random.RandomState(seed).randn(P, W).astype(dtype)


def _index_add(resp, starts, y_length):
    """The overlap-add as a plain scatter-add, in row order."""
    W = resp.shape[1]
    idx = starts[:, None] + torch.arange(W)
    ok = (idx >= 0) & (idx < y_length)
    return torch.zeros(y_length, dtype=resp.dtype).index_add_(0, idx[ok], resp[ok])


def _requiem_like_starts(rng, n_pulses, P, y_length, W):
    """Nondecreasing pulse starts 20-160 samples apart from -W/2 + 1 on,
    rows past n_pulses parked past the tail, as Requiem synthesis parks
    them."""
    gaps = rng.randint(20, 161, n_pulses)
    starts = np.cumsum(gaps) - W // 2 - 19
    out = np.full(P, y_length + W + 2, np.int64)
    out[:n_pulses] = starts
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_scatter_ola_matches_jax_slotted_ola(seed):
    import jax.numpy as jnp
    from world_tpu.dsp.ola import slotted_ola
    from world_tpu_torch.dsp.ola import scatter_ola

    rng = np.random.RandomState(seed)
    P, W, y_length = 384, 1024, 40000
    resp = _responses(P, W, seed)
    starts = _requiem_like_starts(rng, 330, P, y_length, W)
    want = np.asarray(slotted_ola(jnp.asarray(resp), jnp.asarray(starts, jnp.int32),
                                  y_length, slot=32))
    got = scatter_ola(torch.tensor(resp), torch.tensor(starts), y_length).numpy()
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 1e-12 * scale


@pytest.mark.parametrize("dtype,rel", [(torch.float64, 1e-12),
                                       (torch.float32, 2e-6)])
def test_scatter_ola_ranks_1_to_32_in_one_slot(dtype, rel):
    """Slot k holds k pulses, k = 1..32 (a slot holds at most 32: a phase
    wrap fires at most once a sample), against the plain scatter-add."""
    from world_tpu_torch.dsp.ola import SLOT, scatter_ola

    rng = np.random.RandomState(5)
    W = 256
    starts = np.concatenate([
        (k + 1) * 3 * SLOT + np.sort(rng.choice(SLOT, k, replace=False))
        for k in range(1, SLOT + 1)]) - 40
    y_length = int(starts[-1]) + W // 2
    resp = torch.tensor(_responses(starts.shape[0], W, 6), dtype=dtype)
    st = torch.tensor(starts)
    got = scatter_ola(resp, st, y_length)
    want = _index_add(resp.double(), st, y_length)
    scale = float(want.abs().max())
    assert float((got.double() - want).abs().max()) <= rel * scale
    assert torch.equal(got, scatter_ola(resp, st, y_length))
    crowded = torch.cat([st[:-1], st[-1:].expand(SLOT + 1)])
    with pytest.raises(ValueError, match="more than 32 rows"):
        scatter_ola(resp[:1].expand(crowded.shape[0], W), crowded, y_length)


def test_scatter_ola_drops_rows_outside_the_output():
    from world_tpu_torch.dsp.ola import scatter_ola

    W, y_length = 64, 500
    starts = torch.tensor([-W - 40, -W + 3, 10, 11, 490, 499, 600, 10 ** 6])
    resp = torch.tensor(_responses(starts.shape[0], W, 7))
    want = _index_add(resp, starts, y_length)
    np.testing.assert_allclose(scatter_ola(resp, starts, y_length).numpy(),
                               want.numpy(), rtol=0, atol=1e-13)
    empty = scatter_ola(resp[:0], starts[:0], y_length)
    assert empty.shape == (y_length,) and not empty.any()


def _glide(n_frames, lo=90.0, hi=260.0):
    return np.geomspace(lo, hi, n_frames)


def _contour(seconds, fs, dtype):
    fp = 0.005
    n_frames = int(seconds / fp) + 1
    tp = np.arange(n_frames) * fp
    f0 = _glide(n_frames)
    vuv = np.ones(n_frames)
    vuv[(np.arange(n_frames) // 300) % 5 == 4] = 0.0      # unvoiced stretches
    y_length = len(np.arange(tp[0], tp[-1] + 1 / fs, 1.0 / fs))
    t = lambda a: torch.tensor(a, dtype=dtype)            # noqa: E731
    return t(tp), t(f0), t(vuv), y_length, fp


def _f32_axis(y_length, fs, t0):
    """The sample-time axis as the syntheses built it in float32 before."""
    from world_tpu_torch._backend import sdiv

    return sdiv(torch.arange(y_length, dtype=torch.float32), fs) + t0


@pytest.mark.parametrize("synthesis", ["requiem", "classic"])
@pytest.mark.parametrize("seconds,fs", [(4.644, 16000), (4.644, FS), (60.0, FS)])
def test_pulse_indices_unchanged_in_float32(synthesis, seconds, fs):
    """At 4.644 s and 60 s a float32 run keeps every pulse index and every
    interpolation query it had with the float32 axis."""
    from world_tpu_torch.synth.classic import sample_times, time_base
    from world_tpu_torch.synth.requiem import pulse_locations

    tp, f0, vuv, y_length, fp = _contour(seconds, fs, torch.float32)
    axis = sample_times(y_length, fs, tp[0])
    old = _f32_axis(y_length, fs, tp[0])
    assert axis.dtype == torch.float64
    assert torch.equal(axis.to(torch.float32), old)
    if synthesis == "requiem":
        pli, count, _, _ = pulse_locations(tp, f0, vuv, float(fs), axis, 65536, fp)
        pli = pli[:int(count)]
    else:
        _, pli, _, _, _ = time_base(tp, f0, vuv, float(fs), axis, 65536,
                                    math.pi, fp)
    at = pli - 1
    assert pli.shape[0] > 100 * seconds
    old_pli = torch.floor(old[at] * float(fs) + 0.5).to(torch.int64) + 1
    assert torch.equal(pli, old_pli)


@pytest.mark.parametrize("synthesis", ["requiem", "classic"])
def test_float32_time_axis_misplaces_a_pulse_at_256_s(synthesis):
    """A wrap at sample FIRST_F32_MISPLACED of a 22.05 kHz contour: the
    float32 axis puts its pulse on another sample, the float64 axis on its
    own."""
    from world_tpu_torch.synth.classic import sample_times, time_base
    from world_tpu_torch.synth.requiem import pulse_locations

    i = FIRST_F32_MISPLACED
    y_length = i + 2000
    old = _f32_axis(y_length, FS, torch.zeros((), dtype=torch.float32))
    # a constant f0 whose phase passes 2 pi m half way between samples i
    # and i + 1, so the wrap is at i whatever the float64 sum's rounding
    m = round((i + 1.5) * 150.0 / FS)
    fp = 0.005
    tp = torch.arange(0.0, y_length / FS + 2 * fp, fp, dtype=torch.float64)
    f0 = torch.full_like(tp, m * FS / (i + 1.5))
    vuv = torch.ones_like(tp)
    axis = sample_times(y_length, FS, tp[0])
    if synthesis == "requiem":
        pli, count, _, _ = pulse_locations(tp, f0, vuv, float(FS), axis, 65536, fp)
        pli = pli[:int(count)]
    else:
        _, pli, _, _, _ = time_base(tp, f0, vuv, float(FS), axis, 65536,
                                    math.pi, fp)
    assert int((pli - 1 == i).sum()) == 1
    assert int(torch.floor(old[i] * float(FS) + 0.5)) + 1 != i + 1
