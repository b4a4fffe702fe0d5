"""Whether what the timed path produced is right: each sampled request's
outputs against the frozen plain reference (benchmark/reference) run in
float64, after the window, along the reference path the configuration
names (``references``; benchmark/paths/<name>.py, :func:`path_of`).

Two comparisons, each of a stage by itself:

  * the analysis (f0, vuv, envelope, aperiodicity) against the reference's
    round trip of the same input.  The reference works out again everything
    the program derived: the zero padding of the request's bucket, the
    tables and Requiem seed banks from fs and the seed, the classic
    synthesis' noise from the benchmark's own draw;
  * the synthesis (the waveform y) against the reference's synthesis of the
    program's own analysis, with the same seed banks or noise rows: the
    reference follows the program from its analysis, so that a decision
    the analysis breaks apart in float32 does not hide the synthesis.
    Frames past the request's own (its bucket's zero padding, which the
    entry strips) take the reference's analysis of that padding.

The numbers of a request:

  * ``vuv_flips``: the share of frames whose voicing differs;
  * ``f0_gross``: the share of the frames voiced in both whose f0 differs by
    more than 1% (the others are ``agreeing frames``);
  * ``f0_med_hz``: the median f0 error over the frames voiced in both;
  * ``f0_rmse_hz``: the RMS f0 error over the frames voiced in both;
  * ``sp_lsd_db``: the log-spectral distance of the envelope over the
    agreeing frames and the frames unvoiced in both;
  * ``ap_err_db``: the largest aperiodicity error over the same frames
    (D4C-Requiem's band dB as a difference, classic D4C's linear amplitude
    as 20 log10 of the ratio);
  * ``y_ltas_db``: the RMS over 24 mel bands of the difference of the
    long-term spectra of y and the reference's synthesis;
  * ``y_band_db``: the RMS over short-time frames and the 24 bands of the
    difference of their band powers;
  * ``y_rel``: the relative L2 distance of y from the reference's synthesis.

Where the reference voices frames and none is voiced in both, the f0
numbers are infinite; where no frame agrees, so are the envelope's and the
aperiodicity's.  A run's numbers are each number's largest over the
sample, and ``flip_share``: the share of the sampled requests with a whole
section off (``f0_rmse_hz`` over FLIP_HZ).

A limits file (benchmark/limits/<cell>.json) names the numbers a cell
compares and the limit of each; a run is correct where every compared
number is at most its limit.
"""
import contextlib
import json
from pathlib import Path

import numpy as np
import torch

from . import load_module

BENCH = Path(__file__).resolve().parent.parent
LIMITS = BENCH / "limits"
PATH_DIR = BENCH / "paths"
NUMBERS = ("vuv_flips", "f0_gross", "f0_med_hz", "f0_rmse_hz", "sp_lsd_db",
           "ap_err_db", "y_ltas_db", "y_band_db", "y_rel")
AGREE = 0.01            # the relative f0 error of an agreeing frame
FLIP_HZ = 1.0           # a request's f0 RMSE past which a section is off
N_BANDS = 24
STFT_SIZE, STFT_HOP = 1024, 256
# the power a bin of the short-time spectrum is floored at: a sinusoid of
# amplitude 1e-4 (-80 dB of full scale) under the Hann window
SPEC_FLOOR = (1e-4 * np.hanning(STFT_SIZE).sum() / 2) ** 2
# the controls a path may name (its ``CONTROL``): the reference in the
# program's place one precision below the configuration's float32, with
# TF32 on (``tf32``), and so on its input rounded to bfloat16 (``bf16``),
# for a path that TF32 does not reach (torch.fft has no bfloat16 kernels)
CONTROLS = ("tf32", "bf16")


def limits_file(cell: str) -> dict:
    """The cell's limits file: ``limits`` {number: limit} and the readings
    they were set from; empty where none has been set."""
    path = LIMITS / f"{cell}.json"
    return json.loads(path.read_text()) if path.exists() else {}


def limits_of(cell: str) -> dict:
    """{number: limit} of a cell; empty where none has been set."""
    return limits_file(cell).get("limits", {})


@contextlib.contextmanager
def tf32(on: bool):
    """TF32 in float32 matrix products and convolutions, on or off, for the
    block (the control computes the reference with it on)."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    torch.set_float32_matmul_precision("high" if on else "highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]
        torch.set_float32_matmul_precision(saved[2])


def path_of(name: str):
    """The reference path ``name``: the module benchmark/paths/<name>.py
    (``outputs`` and ``CONTROL``, benchmark/paths/__init__.py)."""
    path = PATH_DIR / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no reference path {name!r}: {path} is missing")
    return load_module(path)


def control_input(x32: np.ndarray, kind: str) -> np.ndarray:
    """The input a control computes on: x32 as it is (``tf32``), or rounded
    to bfloat16 (``bf16``)."""
    if kind not in CONTROLS:
        raise ValueError(f"no control {kind!r}: one of {CONTROLS}")
    if kind == "bf16":
        return torch.from_numpy(x32).to(torch.bfloat16).float().numpy()
    return x32


def _numpy(v):
    if isinstance(v, list):
        return [_numpy(a) for a in v]
    return np.asarray(v.double().cpu().numpy() if isinstance(v, torch.Tensor)
                      else v, np.float64)


def reference(cfg, x32, items, dtype=torch.float64, device=None,
              gots=()) -> list:
    """The reference's outputs for each sampled request, as numpy float64,
    with ``y_syn``: for each of ``gots`` (a list of each request's outputs),
    the reference's synthesis of that analysis."""
    device = device or ("cuda" if torch.cuda.is_available() else "cpu")
    x32 = np.asarray(x32)
    path = path_of(cfg["reference"])
    with torch.no_grad():
        outs = path.outputs(cfg, x32, items, dtype, device, gots)
    return [{k: _numpy(v) for k, v in o.items()} for o in outs]


def control(cfg, x32, items, device=None, kind=None) -> list:
    """The control's outputs of the sampled requests: the reference put in
    the program's place, in float32 with TF32 on, on the input of ``kind``
    (:func:`control_input`; the path's own ``CONTROL`` unless given)."""
    kind = kind or path_of(cfg["reference"]).CONTROL
    with tf32(True):
        return reference(cfg, control_input(np.asarray(x32), kind), items,
                         dtype=torch.float32, device=device)


# ------------------------------------------------------------------ numbers
def spec_db(y: np.ndarray) -> np.ndarray:
    """The waveform's short-time power spectrum in dB (frames, bins): Hann
    frames of STFT_SIZE every STFT_HOP samples."""
    y = np.asarray(y, np.float64)
    if y.shape[0] < STFT_SIZE:
        y = np.pad(y, (0, STFT_SIZE - y.shape[0]))
    n = 1 + (y.shape[0] - STFT_SIZE) // STFT_HOP
    idx = np.arange(STFT_SIZE)[None, :] + STFT_HOP * np.arange(n)[:, None]
    p = np.abs(np.fft.rfft(y[idx] * np.hanning(STFT_SIZE), axis=-1)) ** 2
    return 10 * np.log10(p + SPEC_FLOOR)


def band_power(y: np.ndarray, fs: int) -> np.ndarray:
    """The short-time power summed in N_BANDS bands equally spaced on the mel
    scale from 0 to fs / 2 (frames, bands), each bin floored as in
    :func:`spec_db`."""
    p = 10 ** (spec_db(y) / 10)
    mel = 2595 * np.log10(1 + np.fft.rfftfreq(STFT_SIZE, 1 / fs) / 700)
    band = np.minimum((mel / mel[-1] * N_BANDS).astype(int), N_BANDS - 1)
    return np.stack([p[:, band == b].sum(axis=1) for b in range(N_BANDS)], 1)


def analysis_numbers(got: dict, ref: dict, requiem: bool) -> dict:
    """One request's analysis numbers (module docstring) of the program's
    outputs ``got`` against the reference's ``ref``."""
    vuv, rvuv = np.asarray(got["vuv"]) > 0, ref["vuv"] > 0
    both = vuv & rvuv
    err = np.abs(np.asarray(got["f0"], np.float64)[both] - ref["f0"][both])
    agree = both.copy()
    agree[both] = err <= AGREE * ref["f0"][both]
    same = agree | (~vuv & ~rvuv)
    sp = np.asarray(got["sp"], np.float64)[same]
    d_sp = 10 * np.log10(sp + 1e-12) - 10 * np.log10(ref["sp"][same] + 1e-12)
    ap = np.asarray(got["ap"], np.float64)[same]
    rap = ref["ap"][same]
    ap_err = np.abs(ap - rap) if requiem else np.abs(20 * np.log10(ap / rap))
    # nothing to compare where the reference has something is no agreement
    none_f0 = np.inf if rvuv.any() else 0.0
    some = err.size > 0
    return {"vuv_flips": float(np.mean(vuv != rvuv)),
            "f0_gross": float(np.mean(~agree[both])) if some else none_f0,
            "f0_med_hz": float(np.median(err)) if some else none_f0,
            "f0_rmse_hz": float(np.sqrt(np.mean(err ** 2))) if some else none_f0,
            "sp_lsd_db": float(np.sqrt(np.mean(d_sp ** 2))) if same.any() else np.inf,
            "ap_err_db": float(np.max(ap_err)) if same.any() else np.inf}


def synthesis_numbers(y: np.ndarray, y_syn: np.ndarray, fs: int) -> dict:
    """One request's synthesis numbers (module docstring) of the program's
    waveform ``y`` against the reference's synthesis ``y_syn`` of the
    program's own analysis."""
    y = np.asarray(y, np.float64)
    if y.shape != y_syn.shape or not np.all(np.isfinite(y)):
        return {"y_ltas_db": np.inf, "y_band_db": np.inf, "y_rel": np.inf}
    a, b = band_power(y, fs), band_power(y_syn, fs)
    return {"y_ltas_db": float(np.sqrt(np.mean(
                (10 * np.log10(a.mean(axis=0) / b.mean(axis=0))) ** 2))),
            "y_band_db": float(np.sqrt(np.mean((10 * np.log10(a / b)) ** 2))),
            "y_rel": float(np.linalg.norm(y - y_syn)
                           / max(np.linalg.norm(y_syn), 1e-30))}


def summary(per_request: list) -> dict:
    """A run's numbers: each number's largest value over the requests, and
    ``flip_share``, the share of requests with a whole section off."""
    keys = [k for k in NUMBERS if any(k in p for p in per_request)]
    out = {k: max(p[k] for p in per_request if k in p) for k in keys}
    out["flip_share"] = float(np.mean([p["f0_rmse_hz"] > FLIP_HZ
                                       for p in per_request]))
    return out


def judge(cfg, got: list, ref: list, k: int = 0) -> tuple:
    """(run's numbers, per-request numbers) of the outputs ``got`` (each
    request's) against the reference's ``ref`` (:func:`reference`, whose
    ``y_syn[k]`` is its synthesis of ``got``'s analysis)."""
    requiem = cfg["d4c"] == "requiem"
    per = [dict(analysis_numbers(g, r, requiem),
                **synthesis_numbers(g["y"], r["y_syn"][k], cfg["fs"]))
           for g, r in zip(got, ref)]
    return summary(per), per


def check(cfg, x32, samples, device=None) -> tuple:
    """(run's numbers, per-request numbers) of the sampled requests'
    outputs (samples: (request, call, row, outputs))."""
    got = [s[3] for s in samples]
    ref = reference(cfg, x32, samples, device=device, gots=[got])
    return judge(cfg, got, ref)


def verdict(values: dict, limits: dict) -> tuple:
    """(correct, [(name, value, limit)] of the compared numbers).  A cell
    without limits, or a number missing, is not correct."""
    rows = [(k, values.get(k), lim) for k, lim in sorted(limits.items())]
    ok = bool(limits) and all(v is not None and np.isfinite(v) and v <= lim
                              for _, v, lim in rows)
    return ok, rows
