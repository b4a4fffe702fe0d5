"""Public facade: a ``World`` with world_tpu.World's methods and dict
contract (numpy in, numpy out).  Analysis is parallel/batch.py's (Harvest,
DIO + StoneMask or SWIPE', then CheapTrick, then classic D4C or
D4C-Requiem) on a batch of one; synthesis is classic or Requiem, on any
ascending frame grid; the feature codecs run on the World's device."""
import ast
import logging
import sys

import numpy as np
import torch

from ._backend import resolve_device, torch_dtype
from .aperiodicity.d4c import d4c
from .aperiodicity.d4c_requiem import d4c_requiem
from .dsp.interp import interp_rows
from .f0.harvest import default_max_sections, warn_capacity
from .features import codecs
from .frames import host
from .parallel.batch import (analyze, f0_contour, floor_of_fft_size,
                             frame_period_of, spectral_envelope)
from .spectral.cheaptrick import cheaptrick, default_fft_size
from .synth.classic import synthesis
from .synth.requiem import synthesis_requiem
from .synth.seeds import seed_tables

logger = logging.getLogger(__name__)


class World:
    """WORLD vocoder on PyTorch: analysis, modification, synthesis and
    feature codecs.  Runs on the GPU unless ``device`` names another;
    without a GPU, ``device="cpu"`` must be asked for."""

    def __init__(self, device=None, dtype=torch.float64):
        self.device = resolve_device(device)
        self.dtype = torch_dtype(dtype)

    def _tensor(self, a):
        return torch.tensor(np.asarray(a), dtype=self.dtype, device=self.device)

    _host = staticmethod(host)

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
        fs = int(fs)
        xt = self._tensor(x)[None]
        src = self._f0_contour(fs, xt, f0_method, f0_floor, f0_ceil,
                               channels_in_octave, target_fs, frame_period, 0.1)
        env, ps_spec, _ = spectral_envelope(
            xt, fs, src, frame_period_of(f0_method, frame_period), fft_size)
        return {"f0": self._host(src["f0"][0]),
                "temporal_positions": self._host(src["temporal_positions"]),
                "fs": fs,
                "ps spectrogram": self._host(ps_spec[0].T),
                "spectrogram": self._host(env[0].T)}

    def encode_w_gvn_f0(self, fs, x, source, fft_size=None, is_requiem=False):
        """The analysis on a given contour ``source`` {f0, vuv,
        temporal_positions} on any ascending frame grid.  ``fft_size``
        defaults to CheapTrick's size; voiced f0 below the floor it implies
        raises ValueError."""
        fs = int(fs)
        if fft_size is None:
            fft_size = default_fft_size(fs)
        f0 = np.asarray(source["f0"])
        f0_floor = floor_of_fft_size(fs, fft_size)
        voiced = f0[f0 > 0]
        if voiced.size and voiced.min() < f0_floor:
            raise ValueError(
                f"given f0 has voiced frames below the floor implied by "
                f"fft_size={fft_size} (3*fs/fft_size = {f0_floor:.2f} Hz; "
                f"min voiced f0 = {voiced.min():.2f} Hz); use a larger "
                f"fft_size")
        xt = self._tensor(x)
        filt = cheaptrick(xt, fs, source, fft_size=fft_size)
        # D4C takes CheapTrick's effective f0 (unvoiced frames at 500 Hz)
        # and zeroes it again by vuv
        src2 = dict(source, f0=filt["f0_effective"])
        if is_requiem:
            src2 = d4c_requiem(xt, fs, src2, fft_size=fft_size)
        else:
            src2 = d4c(xt, fs, src2, fft_size_for_spectrum=fft_size)
        coarse = src2.get("coarse_ap")
        return {"temporal_positions": source["temporal_positions"],
                "vuv": source["vuv"],
                "f0": self._host(src2["f0"]),
                "fs": fs,
                "spectrogram": self._host(filt["spectrogram"]),
                "aperiodicity": self._host(src2["aperiodicity"]),
                "coarse_ap": None if coarse is None else self._host(coarse),
                "is_requiem": is_requiem}

    def encode(self, fs, x, f0_method="harvest", f0_floor=71, f0_ceil=800,
               channels_in_octave=2, target_fs=4000, frame_period=5,
               allowed_range=0.1, fft_size=None, is_requiem=False):
        """Speech -> {f0, vuv, spectrogram, aperiodicity, ...} (main.py:106-152):
        parallel/batch.py's :func:`analyze` of a batch of one.  An explicit
        ``fft_size`` sets f0_floor to 3 fs / fft_size before the F0
        estimation."""
        fs = int(fs)
        xt = self._tensor(x)[None]
        an = analyze(xt, fs, frame_period, f0_method, is_requiem,
                     fft_size=fft_size, f0_floor=float(f0_floor),
                     f0_ceil=float(f0_ceil),
                     channels_in_octave=int(channels_in_octave),
                     target_fs=int(target_fs), allowed_range=float(allowed_range))
        if f0_method == "harvest":
            warn_capacity(bool(an["_refine_overflow"][0]),
                          bool(an["_section_overflow"][0]),
                          default_max_sections(xt.shape[1], fs))
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

    # ---------------------------------------------------------- modification
    def scale_pitch(self, dat, factor):
        dat["f0"] = np.asarray(dat["f0"]) * factor
        return dat

    def set_pitch(self, dat, time, value):
        raise NotImplementedError  # unimplemented in the reference
        # (main.py:164-168) and in world_tpu.World

    def scale_duration(self, dat, factor):
        dat["temporal_positions"] = np.asarray(dat["temporal_positions"]) * factor
        return dat

    def modify_duration(self, dat, from_time, to_time):
        """Piecewise-linear time warping (main.py:180-189), as world_tpu.World
        defines it: the anchors are 0 -> 0 and each ``from_time[i]`` ->
        ``to_time[i]``, and the warp continues at unit rate after the last
        anchor.  A trailing ``-1`` in ``to_time`` pins the last anchor to the
        identity, so that the total duration is preserved.  Changes ``dat``
        in place and returns None."""
        tp = np.asarray(dat["temporal_positions"])
        end = tp[-1]
        from_time = np.asarray(from_time, dtype=np.float64)
        to_time = np.array(to_time, dtype=np.float64)
        if to_time[-1] == -1:
            to_time[-1] = from_time[-1]
        assert np.all(np.diff(from_time) > 0)
        assert np.all(np.diff(to_time) > 0)
        assert from_time[0] > 0 and to_time[0] > 0
        assert from_time[-1] < end
        xp = np.r_[0.0, from_time, end]
        fp = np.r_[0.0, to_time, to_time[-1] + (end - from_time[-1])]
        dat["temporal_positions"] = np.interp(tp, xp, fp)

    def warp_spectrum(self, dat, factor):
        """Frequency-warp each frame's envelope (main.py:191-196)."""
        spec = self._tensor(dat["spectrogram"]).T            # (frames, bins)
        n = spec.shape[1]
        grid = torch.arange(n, dtype=self.dtype, device=self.device) / n
        dat["spectrogram"] = self._host(interp_rows(grid ** factor, grid, spec).T)
        return dat

    # -------------------------------------------------------------- synthesis
    def decode(self, dat, key=None, seed=0, noise_offsets=None):
        """WORLD components -> waveform (main.py:198-214).

        Classic synthesis draws its noise from ``key``, a ``torch.Generator``
        on the World's device (seeded 0 when None).  Requiem synthesis takes
        ``seed``, its excitation seed bank, and ``noise_offsets``, one
        velvet-noise read cursor per band."""
        if dat.get("is_requiem"):
            y = synthesis_requiem(dat, dat, seed_tables(int(dat["fs"]), seed,
                                                        self.dtype, self.device),
                                  noise_offsets=noise_offsets, dtype=self.dtype,
                                  device=self.device)
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

    # ------------------------------------------------------- persistence
    @staticmethod
    def save(dat, path):
        """Serialize an analysis dict: its arrays as they are, everything
        else as a literal.  The file is the one world_tpu.World.save writes;
        either package loads the other's."""
        is_array = lambda v: isinstance(v, (np.ndarray, torch.Tensor))   # noqa: E731
        arrays = {k: World._host(v) for k, v in dat.items() if is_array(v)}
        scalars = {k: v for k, v in dat.items() if not is_array(v)}
        np.savez_compressed(path, __scalars__=np.asarray([repr(scalars)]),
                            **arrays)

    @staticmethod
    def load(path):
        g = np.load(path, allow_pickle=False)
        out = {k: g[k] for k in g.files if k != "__scalars__"}
        out.update(ast.literal_eval(str(g["__scalars__"][0])))
        return out

    # ------------------------------------------------------------------ viz
    def draw(self, x, dat):
        """Visualize WORLD components (main.py:216-257)."""
        from matplotlib import pyplot as plt

        fs = dat["fs"]
        y = dat["out"]
        eps = sys.float_info.epsilon
        extent = [0, len(x) / fs, 0, fs / 2]
        image = dict(cmap=plt.cm.gray_r, origin="lower", extent=extent,
                     aspect="auto")
        fig, ax = plt.subplots(nrows=5, figsize=(8, 6), sharex=True)
        ax[0].set_title("input signal and resynthesized-signal")
        ax[0].plot(np.arange(len(x)) / fs, x, alpha=0.5)
        ax[0].plot(np.arange(len(y)) / fs, y, alpha=0.5)
        ax[0].legend(["original", "synthesis"])
        X = np.asarray(dat["ps spectrogram"])
        X = np.where(X == 0, eps, X)
        half = X[: X.shape[0] // 2, :]
        ax[1].set_title("pitch-synchronous spectrogram")
        ax[1].imshow(20 * np.log10(np.abs(half)), **image)
        ax[2].set_title("phase spectrogram")
        ax[2].imshow(np.diff(np.unwrap(np.angle(half), axis=1), axis=1), **image)
        ax[3].set_title("WORLD spectrogram")
        Y = np.asarray(dat["spectrogram"])
        ax[3].imshow(20 * np.log10(np.where(Y < eps, eps, Y)), **image)
        ax[4].set_title("WORLD fundamental frequency")
        ax[4].plot(dat["temporal_positions"], dat["f0"])
        plt.show()

    # --------------------------------------------------------- feature codecs
    def hz2mel(self, hz):
        return self._host(codecs.hz2mel(self._tensor(hz)))

    def mel2hz(self, mel):
        return self._host(codecs.mel2hz(self._tensor(mel)))

    def get_filterbanks(self, nfilt=20, nfft=512, samplerate=16000, lowfreq=0,
                        highfreq=None):
        return codecs.filterbank_matrix(nfilt, nfft, samplerate, lowfreq, highfreq)

    def encode_lfbank(self, spec, prefac=0.97, fs=16000, nfilt=32, lowfreq=0,
                      highfreq=None):
        return self._host(codecs.encode_lfbank(self._tensor(spec), prefac, fs,
                                               nfilt, lowfreq, highfreq))

    def encode_mcep(self, spec, n0=12, fs=16000, lowhz=0, highhz=8000):
        return self._host(codecs.encode_mcep(self._tensor(spec), n0, fs, lowhz,
                                             highhz))

    def decode_mcep(self, cepstrum, fft_size):
        return self._host(codecs.decode_mcep(self._tensor(cepstrum), fft_size))

    def get_context(self, X, w=5):
        return self._host(codecs.get_context(self._tensor(X), w))

    def encode_vae(self, Xc, energy, encoder, decoder, window, n0, batch_size,
                   mean):
        return codecs.encode_vae(Xc, energy, encoder, decoder, window, n0,
                                 batch_size, mean, device=self.device)
