"""Public facade: a ``World`` with world_tpu.World's dict contract (numpy
in, numpy out) for the ported path, ``encode(..., f0_method="harvest",
is_requiem=True)`` and Requiem ``decode``.  Everything else raises
NotImplementedError naming the ROADMAP item that brings it."""
import logging
import warnings

import numpy as np
import torch

from ._backend import torch_dtype
from .f0.harvest import default_max_candidates, default_max_sections, warn_capacity
from .parallel.batch import analyze, synthesize
from .synth.requiem import default_max_pulses
from .synth.seeds import get_seeds_signals

logger = logging.getLogger(__name__)


def _not_ported(what: str, item: str):
    raise NotImplementedError(f"{what} is not ported yet: ROADMAP.md, "
                              f"Queue 1, {item}")


def _uniform_frame_period_ms(tp: np.ndarray):
    """Frame period in ms if tp is the uniform grid arange * fp / 1000."""
    if tp.ndim != 1 or tp.shape[0] < 3:
        return None
    fp_ms = float(tp[1] - tp[0]) * 1000.0
    if fp_ms <= 0:
        return None
    grid = np.arange(tp.shape[0]) * fp_ms / 1000.0
    return fp_ms if np.allclose(tp, grid, rtol=0, atol=1e-9) else None


class World:
    """WORLD vocoder on PyTorch: the Harvest + CheapTrick + D4C-Requiem
    analysis and Requiem synthesis."""

    def __init__(self, device=None, dtype=torch.float64):
        self.device = torch.device(device) if device is not None else torch.device("cpu")
        self.dtype = torch_dtype(dtype)

    def _tensor(self, a):
        return torch.tensor(np.asarray(a), dtype=self.dtype, device=self.device)

    def encode(self, fs, x, f0_method="harvest", f0_floor=71, f0_ceil=800,
               channels_in_octave=2, target_fs=4000, frame_period=5,
               allowed_range=0.1, fft_size=None, is_requiem=False):
        """Speech -> {f0, vuv, spectrogram, aperiodicity, ...} (main.py:106-152)."""
        del channels_in_octave, target_fs, allowed_range   # DIO's parameters
        if f0_method != "harvest":
            _not_ported(f"f0_method={f0_method!r}",
                        "item 11 (DIO, StoneMask) / item 12 (SWIPE')")
        if not is_requiem:
            _not_ported("classic D4C (is_requiem=False)", "item 11 (D4C)")
        if fft_size is not None:
            _not_ported("an explicit fft_size", "item 13 (World facade)")
        fs = int(fs)
        xt = self._tensor(x)[None]
        max_sections = default_max_sections(xt.shape[1], fs)
        an = analyze(xt, fs, frame_period,
                     default_max_candidates(f0_floor, f0_ceil), max_sections,
                     float(f0_floor), float(f0_ceil))
        warn_capacity(bool(an["_refine_overflow"][0]),
                      bool(an["_section_overflow"][0]), max_sections)
        host = lambda t: t.detach().cpu().numpy()   # noqa: E731
        return {
            "temporal_positions": host(an["temporal_positions"]),
            "vuv": host(an["vuv"][0]),
            "fs": fs,
            "f0": host(an["f0"][0]),
            "aperiodicity": host(an["band_aperiodicity"][0].T),
            "ps spectrogram": host(an["ps_spectrogram"][0].T),
            "spectrogram": host(an["spectrogram"][0].T),
            "is_requiem": True,
        }

    def decode(self, dat, key=None, seed=0, noise_offsets=None):
        """WORLD components -> waveform (main.py:198-214), Requiem synthesis.
        ``seed`` selects the excitation seed bank and ``noise_offsets`` (one
        int per band) the velvet-noise read cursors."""
        if not dat.get("is_requiem"):
            _not_ported("classic synthesis (is_requiem=False)",
                        "item 12 (classic synthesis)")
        del key                                     # classic synthesis's noise
        fs = int(dat["fs"])
        tp = np.asarray(dat["temporal_positions"], dtype=np.float64)
        f0 = np.asarray(dat["f0"], dtype=np.float64)
        seeds = get_seeds_signals(fs, seed=seed)
        pulse_seed = self._tensor(seeds["pulse"])
        noise_seed = self._tensor(seeds["noise"])
        if noise_offsets is None:
            noise_offsets = np.zeros(pulse_seed.shape[1], np.int64)
        offsets = torch.as_tensor(np.asarray(noise_offsets, np.int64),
                                  device=self.device)
        y_length = len(np.arange(tp[0], tp[-1] + 1 / fs, 1.0 / fs))
        fp_ms = _uniform_frame_period_ms(tp)
        max_pulses = default_max_pulses(tp, f0)
        y, overflow = synthesize(
            self._tensor(tp), self._tensor(f0), self._tensor(dat["vuv"]),
            self._tensor(dat["aperiodicity"]), self._tensor(dat["spectrogram"]),
            pulse_seed, noise_seed, offsets, fs, y_length, max_pulses,
            int((tp[1] - tp[0]) * fs), None if fp_ms is None else fp_ms / 1000.0)
        if bool(overflow):
            warnings.warn(f"synthesis_requiem: pulse count exceeded max_pulses="
                          f"{max_pulses}; trailing pulses were dropped",
                          RuntimeWarning, stacklevel=2)
        y = y.detach().cpu().numpy()
        m = np.max(np.abs(y))
        if m > 1.0:
            logger.info("rescaling waveform")
            y = y / m
        dat["out"] = y
        return dat

    def get_f0(self, *args, **kwargs):
        _not_ported("World.get_f0", "item 13 (World facade)")

    def get_spectrum(self, *args, **kwargs):
        _not_ported("World.get_spectrum", "item 13 (World facade)")

    def encode_w_gvn_f0(self, *args, **kwargs):
        _not_ported("World.encode_w_gvn_f0", "item 13 (World facade)")

    def scale_pitch(self, *args, **kwargs):
        _not_ported("World.scale_pitch", "item 13 (World facade)")

    def scale_duration(self, *args, **kwargs):
        _not_ported("World.scale_duration", "item 13 (World facade)")

    def modify_duration(self, *args, **kwargs):
        _not_ported("World.modify_duration", "item 13 (World facade)")

    def warp_spectrum(self, *args, **kwargs):
        _not_ported("World.warp_spectrum", "item 13 (World facade)")

    def save(self, *args, **kwargs):
        _not_ported("World.save", "item 13 (World facade)")

    def load(self, *args, **kwargs):
        _not_ported("World.load", "item 13 (World facade)")

    def draw(self, *args, **kwargs):
        _not_ported("World.draw", "item 13 (World facade)")

    def hz2mel(self, *args, **kwargs):
        _not_ported("World.hz2mel", "item 13 (codecs)")

    def mel2hz(self, *args, **kwargs):
        _not_ported("World.mel2hz", "item 13 (codecs)")

    def get_filterbanks(self, *args, **kwargs):
        _not_ported("World.get_filterbanks", "item 13 (codecs)")

    def encode_lfbank(self, *args, **kwargs):
        _not_ported("World.encode_lfbank", "item 13 (codecs)")

    def encode_mcep(self, *args, **kwargs):
        _not_ported("World.encode_mcep", "item 13 (codecs)")

    def decode_mcep(self, *args, **kwargs):
        _not_ported("World.decode_mcep", "item 13 (codecs)")

    def get_context(self, *args, **kwargs):
        _not_ported("World.get_context", "item 13 (codecs)")

    def encode_vae(self, *args, **kwargs):
        _not_ported("World.encode_vae", "item 13 (codecs)")
