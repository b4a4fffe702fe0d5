"""The Harvest -> CheapTrick -> D4C-Requiem -> Requiem round-trip
(port of world_tpu/parallel/batch.py::_encode_decode_one) with an explicit
leading batch axis of equal-length utterances."""
import numpy as np
import torch
from torch import nn

from ..aperiodicity.d4c_requiem import d4c_requiem_core, n_bands_ap, requiem_fft_size
from ..f0.harvest import (default_max_candidates, default_max_sections,
                          harvest_core, harvest_tables)
from ..spectral.cheaptrick import cheaptrick_core, default_fft_size
from ..synth.requiem import excitation_core, waveform_core
from ..synth.seeds import get_seeds_signals

F0_FLOOR, F0_CEIL = 71.0, 800.0


def output_length(signal_length: int, fs: int, frame_period: int) -> int:
    n_frames = int(1000 * signal_length / fs / frame_period + 1)
    return int(np.floor((n_frames - 1) * frame_period / 1000 * fs)) + 1


def analyze(x: torch.Tensor, fs: int, frame_period: float, max_candidates: int,
            max_sections: int, f0_floor: float = F0_FLOOR,
            f0_ceil: float = F0_CEIL, tables: dict = None) -> dict:
    """Harvest -> CheapTrick -> D4C-Requiem for rows x (B, n).

    Returns f0 (B, F) zeroed where unvoiced, vuv (B, F), temporal_positions
    (F,), spectrogram (B, F, bins), ps_spectrogram (B, F, fft),
    band_aperiodicity (B, F, n_ap+2) and Harvest's capacity flags (B,)."""
    hv = harvest_core(x, fs, f0_floor, f0_ceil, float(frame_period),
                      max_candidates, max_sections, tables=tables)
    f0, vuv = hv["f0"], hv["vuv"]
    # CheapTrick analyses unvoiced frames at 500 Hz; D4C sees them as 0
    f0_ct = torch.where(vuv == 0, torch.full_like(f0, 500.0), f0)
    env, ps_spec, f0_eff = cheaptrick_core(x, fs, f0_ct, default_fft_size(fs),
                                           -0.15, float(frame_period))
    f0_d4c = torch.where(vuv == 0, torch.zeros_like(f0_eff), f0_eff)
    band_ap = d4c_requiem_core(x, fs, f0_d4c, hv["temporal_positions"],
                               requiem_fft_size(fs), 0.85, 3000.0,
                               n_bands_ap(fs), float(frame_period))
    return {"f0": f0_d4c, "vuv": vuv,
            "temporal_positions": hv["temporal_positions"],
            "spectrogram": env, "ps_spectrogram": ps_spec,
            "band_aperiodicity": band_ap,
            "_refine_overflow": hv["_refine_overflow"],
            "_section_overflow": hv["_section_overflow"]}


def synthesize(temporal_positions, f0, vuv, band_ap_db, spectrogram,
               pulse_seed, noise_seed, noise_offsets, fs: int, y_length: int,
               max_pulses: int, fps: int, frame_period_s=None):
    """Requiem synthesis of one utterance: band_ap_db (bands, frames),
    spectrogram (bins, frames).  Returns (y (y_length,), pulse overflow)."""
    excitation, overflow = excitation_core(
        temporal_positions, f0, vuv, band_ap_db, pulse_seed, noise_seed,
        noise_offsets, fs, y_length, max_pulses, frame_period_s)
    fft_size = (spectrogram.shape[0] - 1) * 2
    return waveform_core(excitation, spectrogram, fs, fft_size, fps), overflow


def encode_decode_one(x: torch.Tensor, pulse_seed: torch.Tensor,
                      noise_seed: torch.Tensor, fs: int, frame_period: int,
                      max_pulses: int, max_candidates: int, max_sections: int,
                      noise_offsets: torch.Tensor = None,
                      tables: dict = None) -> dict:
    """Full round-trip for rows x (B, n).  Returns f0, vuv (B, F),
    spectrogram (B, F, bins), band_aperiodicity (B, F, n_ap+2), y
    (B, y_length) and the per-row capacity flag _overflow (B,)."""
    B, sig_len = x.shape
    an = analyze(x, fs, frame_period, max_candidates, max_sections,
                 tables=tables)
    if noise_offsets is None:
        noise_offsets = torch.zeros(pulse_seed.shape[1], dtype=torch.int64,
                                    device=x.device)
    y_length = output_length(sig_len, fs, frame_period)
    fps = int(frame_period / 1000 * fs)
    ys, pulse_overflow = [], []
    for b in range(B):
        y, over = synthesize(an["temporal_positions"], an["f0"][b], an["vuv"][b],
                             an["band_aperiodicity"][b].T, an["spectrogram"][b].T,
                             pulse_seed, noise_seed, noise_offsets, fs, y_length,
                             max_pulses, fps, float(frame_period) / 1000.0)
        ys.append(y)
        pulse_overflow.append(over)
    return {"f0": an["f0"], "vuv": an["vuv"], "spectrogram": an["spectrogram"],
            "band_aperiodicity": an["band_aperiodicity"], "y": torch.stack(ys),
            "_overflow": (an["_refine_overflow"] | an["_section_overflow"]
                          | torch.stack(pulse_overflow))}


class HarvestRequiem(nn.Module):
    """The round-trip as a module whose buffers are its static tables: the
    band FIR bank and offsets, the decimator impulse response, the
    refinement DFT table, the smoothing kernel and the Requiem seed banks.

    ``forward(x)`` takes (B, n_samples) or (n_samples,) signals of the length
    the module was built for."""

    def __init__(self, fs: int, n_samples: int, frame_period: int = 5,
                 seed: int = 0, max_pulses: int = None,
                 max_candidates: int = None, max_sections: int = None,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.fs = int(fs)
        self.n_samples = int(n_samples)
        self.frame_period = int(frame_period)
        duration = n_samples / fs
        self.max_pulses = (max_pulses if max_pulses is not None
                           else int(2 ** np.ceil(np.log2(duration * 1000 + 8))))
        self.max_candidates = (max_candidates if max_candidates is not None
                               else default_max_candidates(F0_FLOOR, F0_CEIL))
        self.max_sections = (max_sections if max_sections is not None
                             else default_max_sections(n_samples, fs))
        tables = harvest_tables(self.fs, F0_FLOOR, F0_CEIL, dtype, device)
        seeds = get_seeds_signals(self.fs, seed=seed)
        tables["pulse_seed"] = torch.tensor(seeds["pulse"], dtype=dtype,
                                               device=device)
        tables["noise_seed"] = torch.tensor(seeds["noise"], dtype=dtype,
                                               device=device)
        for name, t in tables.items():
            self.register_buffer(name, t.clone())

    _HARVEST_KEYS = ("band_bank", "band_bias", "decimator_ir", "refine_cos",
                     "refine_sin", "smooth_kernel")

    def from_numpy_state(self, state: dict) -> "HarvestRequiem":
        """Load tables given as numpy arrays (e.g. the JAX package's) into
        the buffers of the same names; shapes must match."""
        for name, arr in state.items():
            buf = getattr(self, name)
            src = torch.tensor(np.asarray(arr), dtype=buf.dtype)
            if src.shape != buf.shape:
                raise ValueError(f"{name}: shape {tuple(src.shape)} != "
                                 f"{tuple(buf.shape)}")
            buf.copy_(src)
        return self

    def forward(self, x: torch.Tensor, noise_offsets: torch.Tensor = None) -> dict:
        xb = x[None] if x.dim() == 1 else x
        if xb.shape[1] != self.n_samples:
            raise ValueError(f"expected {self.n_samples} samples, got "
                             f"{xb.shape[1]}")
        tables = {k: getattr(self, k) for k in self._HARVEST_KEYS}
        return encode_decode_one(xb, self.pulse_seed, self.noise_seed, self.fs,
                                 self.frame_period, self.max_pulses,
                                 self.max_candidates, self.max_sections,
                                 noise_offsets=noise_offsets, tables=tables)
