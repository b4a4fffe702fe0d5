"""K8, the classic synthesis' pulses: a wrapper of csrc/classic_pulses.cu
and its plain PyTorch version.

The classic synthesis (synth/classic.py::synthesis_core) keeps every per-
pulse decision in PyTorch, as (B, P) tensors over its static pulse axis:
the pulse positions and shifts (``time_base``), the counts, the noise
lengths, the overlap-add starts, each pulse's frame pair and weights and
its voicing gate.  This module takes them and computes the pulses' vector
arithmetic: each pulse's periodic and aperiodic responses from the lerped
spectra, and their overlap-add.

  * :func:`pulses_plain`, the plain version: every slot of the pulse axis
    in blocks of pulses (:func:`pulse_blocking`), the slots past a row's
    count parked out of one :class:`..dsp.ola.SlotGrid`.  The CPU path, and
    the kernel's yardstick.
  * :func:`pulses_cuda`, K8: two grids a block of pulses.  Grid 1 computes
    the responses of the live pulses only (a slot past its row's count is
    never computed, written or read), grid 2 overlap-adds them by gather,
    in SlotGrid's order: bitwise SlotGrid's of the same responses.  It
    counts the live pulses on the device (:data:`LIVE`).

A CUDA tensor goes to K8, a CPU (or ``meta``) tensor to the plain version;
there is no fallback.  K8 replaces no Pallas kernel (csrc/classic_pulses.cu
says why it exists and what bounds it).
"""
import ctypes
import functools
import math

import torch

from .._backend import (F64_EPS, KernelGeometryError, LaunchCounter,
                        check_kernel_input, chunk_size, kernel_library, launch)
from ..dsp.minphase import minimum_phase_spectrum, mirror_full
from ..dsp.ola import SLOT, SlotGrid
from ..dsp.windows import np_hanning_matlab
from ..tables import table
from ..utils.profiling import TRACER
from .d4c_spectra import fft_twiddles

pulse_counter = LaunchCounter()

# the tracer's counter of the pulses computed (rows' live pulses), which
# K8 adds to on the device (utils/profiling.py::Tracer.device_counter)
LIVE = "synth.pulses.live"

# the largest fft_size K8 takes (a pulse's buffers in device memory from
# 16,384 in float32, 8,192 in float64 at the rates that use them)
MAX_FFT_SIZE = 32768


def cmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The complex product a * b from its real products, each rounded once.
    PyTorch's own product on the CPU fuses a product into an FMA in its
    vector lanes but not in its scalar remainder, so an element's last bit
    would depend on where it lies in the tensor, and a pulse's response on
    the batch and the block of pulses it is computed in."""
    ar, ai, br, bi = a.real, a.imag, b.real, b.imag
    return torch.complex(ar * br - ai * bi, ar * bi + ai * br)


# what the responses of one pulse hold alive at once, in items of the
# working type per sample of fft_size: the spectra and their two minimum-
# phase transforms, the complex spectra and responses, the noise and its
# convolution at twice the size, and the overlap-add's shifted row.  A
# reckoning, as the other stages' are (_backend.chunk_size).
PULSE_ITEMS_PER_SAMPLE = 48


def pulse_blocking(n_rows: int, max_pulses: int, fft_size: int,
                   itemsize: int):
    """The pulses a block of :func:`pulses_plain` computes at once: None
    where all of them fit ``STAGE_BYTES_BUDGET``'s rule."""
    return chunk_size(n_rows * PULSE_ITEMS_PER_SAMPLE * fft_size * itemsize,
                      max_pulses)


def k8_blocking(n_rows: int, max_pulses: int, fft_size: int, itemsize: int):
    """The pulses a block of K8 computes at once: None where the response
    buffer of every slot, a row of fft_size samples a slot, fits
    ``STAGE_BYTES_BUDGET``'s rule (16 rows of 8,192 slots at 1,024 in
    float32: 512 MiB)."""
    return chunk_size(n_rows * fft_size * itemsize, max_pulses)


def _dc_base(fft_size: int, dtype, device) -> torch.Tensor:
    return table("classic_dc_base", (int(fft_size),),
                 lambda: np_hanning_matlab(fft_size)
                 / np_hanning_matlab(fft_size).sum(), dtype, device)


def pulses_plain(spectrogram, aperiodicity, noise, floor_i, ceil_i, wa, wb,
                 voiced, shifts, noise_sizes, n_noise, starts, count, fs: int,
                 y_length: int, fft_size: int, max_noise: int,
                 noise_mode: str = "gaussian", max_rank: int = SLOT):
    """The pulses' responses and overlap-add (synthesis.py:86-116) for
    spectrogram and aperiodicity (B, bins, frames) and the (B, P) pulse
    operands: frame pair ``floor_i``/``ceil_i`` (0-based) with weights
    ``wa``/``wb``, ``voiced`` gate, fractional ``shifts``, ``noise_sizes``,
    ``n_noise``, overlap-add ``starts`` (the slots past a row's count parked
    past the output) and the rows' ``count`` (unused here: the parked
    starts leave those slots out).  noise (B, P, max_noise) is the standard-
    normal draw, None for ``noise_mode="constant"`` (0.1 in its place).
    Every slot is computed, in blocks of pulses (:func:`pulse_blocking`).
    Returns (y (B, y_length), crowded (B,)): a slot of the overlap-add held
    more than ``max_rank`` pulses."""
    dtype, dev = spectrogram.dtype, spectrogram.device
    B, max_pulses = starts.shape
    S = spectrogram.transpose(-1, -2)                       # (B, frames, bins)
    AP = (aperiodicity ** 2).transpose(-1, -2)
    PER = torch.clamp(1.0 - AP, min=0.001)
    rows = torch.arange(B, device=dev)[:, None]
    zero = torch.zeros((), dtype=dtype, device=dev)
    half_n = fft_size // 2 + 1
    coefficient = 2.0 * math.pi * fs / fft_size
    half_k = torch.arange(half_n, dtype=dtype, device=dev)
    dc_base = _dc_base(fft_size, dtype, dev)
    conv_n = 2 * fft_size
    grid = SlotGrid(starts, y_length, fft_size, dtype)
    block = pulse_blocking(B, max_pulses, fft_size, spectrogram.element_size())
    block = max_pulses if block is None else block
    for p0 in range(0, max_pulses, block):
        cols = slice(p0, p0 + block)
        # 2-frame spectral lerp
        f1, f2 = floor_i[:, cols], ceil_i[:, cols]
        a, b = wa[:, cols, None], wb[:, cols, None]
        spec = a * S[rows, f1] + b * S[rows, f2]
        per = a * PER[rows, f1] + b * PER[rows, f2]
        aps = a * AP[rows, f1] + b * AP[rows, f2]
        gate = voiced[:, cols]

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
        periodic = torch.where(gate[..., None], periodic, zero)

        # aperiodic responses (synthesis.py:86-96)
        ap_spec = torch.clamp(torch.where(gate[..., None], spec * aps, spec),
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
    return grid.result(max_rank)


def slot_crowded(starts: torch.Tensor, y_length: int, W: int,
                 max_rank: int) -> torch.Tensor:
    """SlotGrid's ``crowded`` flag (B,) for ``starts`` (B, P), from the
    pulses' slots and ranks alone (:class:`..dsp.ola.SlotGrid`'s reckoning,
    without its grid): a live row of rank ``max_rank`` or more."""
    B, P = starts.shape
    base = SLOT * (-(-W // SLOT) + 1)
    n_slots = (y_length + base) // SLOT + 2
    sid = torch.div(starts.to(torch.int64) + base, SLOT, rounding_mode="floor")
    live = (sid >= 0) & (sid < n_slots)
    p = torch.arange(P, device=starts.device)
    first = torch.ones((B, P), dtype=torch.bool, device=starts.device)
    first[:, 1:] = sid[:, 1:] != sid[:, :-1]
    rank = p - torch.cummax(torch.where(first, p, torch.zeros_like(p)),
                            -1).values
    return (live & (rank >= max_rank)).any(dim=-1)


@functools.lru_cache(maxsize=None)
def _scratch_items(fft_size: int, max_noise: int, dtype: torch.dtype,
                   device_index: int) -> int:
    """Grid 1's device-memory scratch in items of ``dtype``: 0 where a
    pulse's buffers fit one block's shared memory, else 4 fft_size +
    max_noise a block of its grid (csrc/classic_pulses.cu's plan)."""
    lib, _ = kernel_library()
    suffix = {torch.float32: "f32", torch.float64: "f64"}[dtype]
    grid, smem, items = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    with torch.cuda.device(device_index):
        err = getattr(lib, f"world_pulse_plan_{suffix}")(
            int(fft_size), int(max_noise), ctypes.byref(grid),
            ctypes.byref(smem), ctypes.byref(items))
    if err:
        raise KernelGeometryError(f"classic_pulses: fft_size {fft_size} in "
                                  f"{dtype}: cudaError {err}")
    return grid.value * items.value


def _check(sp, ap, noise, pulse_ops, count, y_length, fft_size, max_noise,
           max_rank):
    """Raise unless K8 takes the operands: sp and ap (B, frames, bins)
    contiguous, the (B, P) pulse operands, count (B,), noise (B, P,
    max_noise) or None."""
    dev, dtype = sp.device, sp.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"classic_pulses: unsupported dtype {dtype}")
    B, F, bins = sp.shape
    P = pulse_ops["starts"].shape[1]
    N = int(fft_size)
    if (N & (N - 1) or not 32 <= N <= MAX_FFT_SIZE or bins != N // 2 + 1
            or not 1 <= max_noise <= N or not 1 <= max_rank <= SLOT
            or not 1 <= B <= 65535 or P < 1 or F < 1
            or not 1 <= y_length < 2 ** 31 - 2 * N):
        raise KernelGeometryError(
            f"classic_pulses: {B} rows of {F} frames x {bins} bins, {P} pulse "
            f"slots, fft_size {N}, max_noise {max_noise}, max_rank {max_rank}, "
            f"y_length {y_length}: the kernel takes a power of two fft_size in "
            f"[32, {MAX_FFT_SIZE}] with fft_size // 2 + 1 bins, max_noise <= "
            f"fft_size, max_rank <= {SLOT} and 1-65,535 rows")
    check_kernel_input(sp, "spectrogram", dtype, dev, 3)
    check_kernel_input(ap, "aperiodicity", dtype, dev, 3)
    if ap.shape != sp.shape:
        raise ValueError(f"classic_pulses: aperiodicity {tuple(ap.shape)} for "
                         f"spectrogram {tuple(sp.shape)} (frames, bins)")
    for name, t in pulse_ops.items():
        want = torch.bool if name == "voiced" else (
            torch.int64 if name in ("floor_i", "ceil_i", "n_noise", "starts")
            else dtype)
        check_kernel_input(t, name, want, dev, 2)
        if t.shape != (B, P):
            raise ValueError(f"classic_pulses: {name} {tuple(t.shape)}, "
                             f"expected {(B, P)}")
    check_kernel_input(count, "count", torch.int64, dev, 1)
    if count.shape != (B,):
        raise ValueError(f"classic_pulses: count {tuple(count.shape)} for {B} rows")
    if noise is not None:
        check_kernel_input(noise, "noise", dtype, dev, 3)
        if noise.shape != (B, P, max_noise):
            raise ValueError(f"classic_pulses: noise {tuple(noise.shape)}, "
                             f"expected {(B, P, max_noise)}")


@TRACER.spanned("world.kernel.K8")
def pulses_cuda(spectrogram, aperiodicity, noise, floor_i, ceil_i, wa, wb,
                voiced, shifts, noise_sizes, n_noise, starts, count, fs: int,
                y_length: int, fft_size: int, max_noise: int,
                noise_mode: str = "gaussian", max_rank: int = SLOT):
    """Launch K8: :func:`pulses_plain`'s outputs, its two grids once a block
    of pulses (:func:`k8_blocking`; one block on every path the port runs),
    the blocks last first.  The live pulses are added to the device counter
    :data:`LIVE`."""
    dev, dtype = spectrogram.device, spectrogram.dtype
    B, P, N = starts.shape[0], starts.shape[1], int(fft_size)
    if noise_mode not in ("gaussian", "constant"):
        raise ValueError(f"noise_mode {noise_mode!r}")
    if noise_mode == "constant":
        noise = None
    elif noise is not None and noise.dtype != dtype:
        noise = noise.to(dtype)
    sp = spectrogram.transpose(-1, -2).contiguous()          # (B, frames, bins)
    ap = aperiodicity.transpose(-1, -2).contiguous()
    # the plain version's per-pulse scalars, bit for bit
    phase_step = -((2.0 * math.pi * fs / N) * shifts)
    gain = torch.sqrt(torch.clamp(noise_sizes.to(dtype), min=1.0))
    ops = {"floor_i": floor_i, "ceil_i": ceil_i, "wa": wa, "wb": wb,
           "voiced": voiced, "phase_step": phase_step, "gain": gain,
           "n_noise": n_noise, "starts": starts}
    _check(sp, ap, noise, ops, count, y_length, N, max_noise, max_rank)
    tw = fft_twiddles(N, dtype, dev)
    dc = _dc_base(N, dtype, dev)
    live = TRACER.device_counter(LIVE, dev)
    block = k8_blocking(B, P, N, sp.element_size()) or P
    buf_rows = P if block >= P else min(P, block + SLOT)
    resp = torch.empty((B, buf_rows, N), dtype=dtype, device=dev)
    items = _scratch_items(N, int(max_noise), dtype, dev.index)
    scratch = torch.empty(items, dtype=dtype, device=dev) if items else None
    y = torch.zeros((B, y_length), dtype=dtype, device=dev)
    vu8 = voiced.view(torch.uint8)
    blocks = range(0, P, block)
    try:
        for p0 in reversed(blocks):
            own = min(P, p0 + block)
            hi = P if own >= P else min(P, own + SLOT)
            launch("pulse_responses", dtype, sp.data_ptr(), ap.data_ptr(),
                   count.data_ptr(), floor_i.data_ptr(), ceil_i.data_ptr(),
                   wa.data_ptr(), wb.data_ptr(), vu8.data_ptr(),
                   phase_step.data_ptr(), gain.data_ptr(), n_noise.data_ptr(),
                   None if noise is None else noise.data_ptr(), dc.data_ptr(),
                   tw.data_ptr(), B, P, sp.shape[1], N, int(max_noise), p0, hi,
                   own,
                   resp.data_ptr(), None if scratch is None else scratch.data_ptr(),
                   live.data_ptr())
            launch("pulse_ola", dtype, resp.data_ptr(), starts.data_ptr(),
                   count.data_ptr(), B, P, N, int(y_length), int(max_rank), p0,
                   own, hi - p0, y.data_ptr())
    except KernelGeometryError as e:
        raise KernelGeometryError(
            f"classic_pulses: spectrogram {tuple(spectrogram.shape)} in {dtype}"
            f", {P} pulse slots at fft_size {N} needs more shared memory or "
            f"blocks than the device allows ({e})") from e
    pulse_counter.add(len(blocks))
    return y, slot_crowded(starts, y_length, N, max_rank)


def pulse_synthesis(spectrogram, aperiodicity, noise, floor_i, ceil_i, wa, wb,
                    voiced, shifts, noise_sizes, n_noise, starts, count,
                    fs: int, y_length: int, fft_size: int, max_noise: int,
                    noise_mode: str = "gaussian", max_rank: int = SLOT):
    """The pulses' responses and overlap-add, (y (B, y_length), crowded
    (B,)): K8 on the card, :func:`pulses_plain` on the CPU (which adds the
    rows' live pulses to the counter :data:`LIVE` itself)."""
    args = (spectrogram, aperiodicity, noise, floor_i, ceil_i, wa, wb, voiced,
            shifts, noise_sizes, n_noise, starts, count, fs, y_length,
            fft_size, max_noise, noise_mode, max_rank)
    if spectrogram.is_cuda:
        return pulses_cuda(*args)
    out = pulses_plain(*args)
    if spectrogram.device.type == "cpu":
        TRACER.device_counter(LIVE, spectrogram.device).add_(
            torch.clamp(count, max=starts.shape[1]).sum())
    return out
