"""Public facade: a ``World`` with world_tpu.World's dict contract (numpy
in, numpy out).  Analysis is parallel/batch.py's (Harvest or DIO +
StoneMask, then CheapTrick, then classic D4C or D4C-Requiem) on a batch of
one; synthesis is classic or Requiem.
Everything else raises NotImplementedError naming the ROADMAP item that
brings it."""
import logging
import warnings

import numpy as np
import torch

from ._backend import resolve_device, torch_dtype
from .f0.harvest import default_max_sections, warn_capacity
from .frames import uniform_frame_period_ms
from .parallel.batch import (analyze_contour, f0_contour, spectral_envelope,
                             synthesize)
from .synth.classic import default_max_pulses, synthesis
from .synth.seeds import get_seeds_signals

logger = logging.getLogger(__name__)


def _not_ported(what: str, item: str):
    raise NotImplementedError(f"{what} is not ported yet: ROADMAP.md, "
                              f"Queue 1, {item}")


_FACADE = "item 16 (the rest of the World facade, and the codecs)"


class World:
    """WORLD vocoder on PyTorch.  Runs on the GPU unless ``device`` names
    another; without a GPU, ``device="cpu"`` must be asked for."""

    def __init__(self, device=None, dtype=torch.float64):
        self.device = resolve_device(device)
        self.dtype = torch_dtype(dtype)

    def _tensor(self, a):
        return torch.tensor(np.asarray(a), dtype=self.dtype, device=self.device)

    @staticmethod
    def _host(t):
        return t.detach().cpu().numpy()

    # ------------------------------------------------------------------ F0
    def _f0_contour(self, fs, xt, f0_method, f0_floor, f0_ceil,
                    channels_in_octave, target_fs, frame_period,
                    allowed_range) -> dict:
        """:func:`f0_contour` of rows xt (1, n), warning when Harvest's
        static tables saturate."""
        src = f0_contour(xt, fs, frame_period, f0_method, float(f0_floor),
                         float(f0_ceil), int(channels_in_octave), int(target_fs),
                         float(allowed_range))
        if f0_method == "harvest":
            warn_capacity(bool(src["_refine_overflow"][0]),
                          bool(src["_section_overflow"][0]),
                          default_max_sections(xt.shape[1], fs))
        return src

    def get_f0(self, fs, x, f0_method="harvest", f0_floor=71, f0_ceil=800,
               channels_in_octave=2, target_fs=4000, frame_period=5):
        """(temporal_positions, f0, vuv) as numpy arrays."""
        src = self._f0_contour(int(fs), self._tensor(x)[None], f0_method,
                               f0_floor, f0_ceil, channels_in_octave, target_fs,
                               frame_period, 0.1)
        return (self._host(src["temporal_positions"]), self._host(src["f0"][0]),
                self._host(src["vuv"][0]))

    # ------------------------------------------------------------- analysis
    def get_spectrum(self, fs, x, f0_method="harvest", f0_floor=71, f0_ceil=800,
                     channels_in_octave=2, target_fs=4000, frame_period=5,
                     fft_size=None):
        """{f0, temporal_positions, fs, ps spectrogram, spectrogram}."""
        if fft_size is not None:
            _not_ported("an explicit fft_size", _FACADE)
        fs = int(fs)
        xt = self._tensor(x)[None]
        src = self._f0_contour(fs, xt, f0_method, f0_floor, f0_ceil,
                               channels_in_octave, target_fs, frame_period, 0.1)
        env, ps_spec, _ = spectral_envelope(xt, fs, src, frame_period)
        return {"f0": self._host(src["f0"][0]),
                "temporal_positions": self._host(src["temporal_positions"]),
                "fs": fs,
                "ps spectrogram": self._host(ps_spec[0].T),
                "spectrogram": self._host(env[0].T)}

    def encode(self, fs, x, f0_method="harvest", f0_floor=71, f0_ceil=800,
               channels_in_octave=2, target_fs=4000, frame_period=5,
               allowed_range=0.1, fft_size=None, is_requiem=False):
        """Speech -> {f0, vuv, spectrogram, aperiodicity, ...} (main.py:106-152):
        :func:`f0_contour`, then :func:`analyze_contour`."""
        if fft_size is not None:
            _not_ported("an explicit fft_size", _FACADE)
        fs = int(fs)
        xt = self._tensor(x)[None]
        src = self._f0_contour(fs, xt, f0_method, f0_floor, f0_ceil,
                               channels_in_octave, target_fs, frame_period,
                               allowed_range)
        an = analyze_contour(xt, fs, src, frame_period, is_requiem)
        return {
            "temporal_positions": self._host(an["temporal_positions"]),
            "vuv": self._host(an["vuv"][0]),
            "fs": fs,
            "f0": self._host(an["f0"][0]),
            "aperiodicity": self._host(an["aperiodicity"][0].T),
            "ps spectrogram": self._host(an["ps_spectrogram"][0].T),
            "spectrogram": self._host(an["spectrogram"][0].T),
            "is_requiem": bool(is_requiem),
        }

    def encode_w_gvn_f0(self, *args, **kwargs):
        _not_ported("World.encode_w_gvn_f0", _FACADE)

    # ---------------------------------------------------------- modification
    def scale_pitch(self, *args, **kwargs):
        _not_ported("World.scale_pitch", _FACADE)

    def set_pitch(self, *args, **kwargs):
        _not_ported("World.set_pitch", _FACADE)

    def scale_duration(self, *args, **kwargs):
        _not_ported("World.scale_duration", _FACADE)

    def modify_duration(self, *args, **kwargs):
        _not_ported("World.modify_duration", _FACADE)

    def warp_spectrum(self, *args, **kwargs):
        _not_ported("World.warp_spectrum", _FACADE)

    # -------------------------------------------------------------- synthesis
    def decode(self, dat, key=None, seed=0, noise_offsets=None):
        """WORLD components -> waveform (main.py:198-214).

        Classic synthesis draws its noise from ``key``, a ``torch.Generator``
        on the World's device (seeded 0 when None).  Requiem synthesis takes
        ``seed``, its excitation seed bank, and ``noise_offsets``, one
        velvet-noise read cursor per band."""
        if dat.get("is_requiem"):
            y = self._requiem(dat, seed, noise_offsets)
        else:
            y = synthesis(dat, dat, generator=key, dtype=self.dtype,
                          device=self.device)
        y = self._host(y)
        m = np.max(np.abs(y))
        if m > 1.0:
            logger.info("rescaling waveform")
            y = y / m
        dat["out"] = y
        return dat

    def _requiem(self, dat, seed, noise_offsets):
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
        fp_ms = uniform_frame_period_ms(tp)
        max_pulses = default_max_pulses(tp, f0)
        y, overflow = synthesize(
            self._tensor(tp), self._tensor(f0), self._tensor(dat["vuv"]),
            self._tensor(dat["aperiodicity"]), self._tensor(dat["spectrogram"]),
            pulse_seed, noise_seed, offsets, fs, y_length, max_pulses,
            int((tp[1] - tp[0]) * fs), None if fp_ms is None else fp_ms / 1000.0)
        if bool(overflow):
            warnings.warn(f"synthesis_requiem: pulse count exceeded max_pulses="
                          f"{max_pulses}; trailing pulses were dropped",
                          RuntimeWarning, stacklevel=3)
        return y

    # ------------------------------------------------------- persistence
    def save(self, *args, **kwargs):
        _not_ported("World.save", _FACADE)

    def load(self, *args, **kwargs):
        _not_ported("World.load", _FACADE)

    def draw(self, *args, **kwargs):
        _not_ported("World.draw", _FACADE)

    # ------------------------------------------------------------- codecs
    def hz2mel(self, *args, **kwargs):
        _not_ported("World.hz2mel", _FACADE)

    def mel2hz(self, *args, **kwargs):
        _not_ported("World.mel2hz", _FACADE)

    def get_filterbanks(self, *args, **kwargs):
        _not_ported("World.get_filterbanks", _FACADE)

    def encode_lfbank(self, *args, **kwargs):
        _not_ported("World.encode_lfbank", _FACADE)

    def encode_mcep(self, *args, **kwargs):
        _not_ported("World.encode_mcep", _FACADE)

    def decode_mcep(self, *args, **kwargs):
        _not_ported("World.decode_mcep", _FACADE)

    def get_context(self, *args, **kwargs):
        _not_ported("World.get_context", _FACADE)

    def encode_vae(self, *args, **kwargs):
        _not_ported("World.encode_vae", _FACADE)
