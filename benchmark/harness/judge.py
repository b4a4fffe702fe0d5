"""Whether what the timed path produced is right: each sampled request's
outputs against the frozen plain reference (benchmark/reference) run in
float64, after the window.

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

from reference import facade as RF
from reference import roundtrip as R
from reference.synth import classic as RC

LIMITS = Path(__file__).resolve().parent.parent / "limits"
NUMBERS = ("vuv_flips", "f0_gross", "f0_med_hz", "f0_rmse_hz", "sp_lsd_db",
           "ap_err_db", "y_ltas_db", "y_band_db", "y_rel")
AGREE = 0.01            # the relative f0 error of an agreeing frame
FLIP_HZ = 1.0           # a request's f0 RMSE past which a section is off
N_BANDS = 24
STFT_SIZE, STFT_HOP = 1024, 256
# the power a bin of the short-time spectrum is floored at: a sinusoid of
# amplitude 1e-4 (-80 dB of full scale) under the Hann window
SPEC_FLOOR = (1e-4 * np.hanning(STFT_SIZE).sum() / 2) ** 2
# the control of each path: the reference in the program's place one
# precision below the configuration's float32.  TF32 reaches the Harvest
# path (the FIR banks' convolution and the Requiem synthesis' matrix
# product); it reaches nothing of the classic path, whose control also
# rounds its input to bfloat16 (torch.fft has no bfloat16 kernels)
CONTROL = {"harvest_requiem": "tf32", "dio_classic": "bf16",
           "world_dio_classic": "bf16"}


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


def n_frames(n: int, fs: int, fp: int) -> int:
    return int(1000 * n / fs / fp + 1)


def cut_of(x32: np.ndarray, req) -> np.ndarray:
    return x32[req.offset:req.offset + req.n]


def classic_noise(seed: int, shape: tuple, device) -> torch.Tensor:
    """The benchmark's standard-normal draw for a classic synthesis: float32
    on the card from a generator seeded with ``seed``."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return torch.randn(shape, generator=g, dtype=torch.float32, device=device)


def control_input(x32: np.ndarray, kind: str) -> np.ndarray:
    """The input a control computes on: x32 as it is (``tf32``), or rounded
    to bfloat16 (``bf16``)."""
    if kind == "bf16":
        return torch.from_numpy(x32).to(torch.bfloat16).float().numpy()
    return x32


# ---------------------------------------------------------------- reference
def _rows(x32, items, L):
    xb = np.zeros((len(items), L), np.float64)
    for r, (req, *_rest) in enumerate(items):
        xb[r, :req.n] = cut_of(x32, req)
    return xb


def _by_bucket(items) -> dict:
    groups = {}
    for i, it in enumerate(items):
        groups.setdefault(it[0].bucket, []).append(i)
    return groups


def _own_frames(full, got, items, idx, key, fs, fp):
    """The reference's rows ``full`` (B, F, ...) with each request's own
    frames replaced by its output ``key`` in ``got``."""
    rows = full.clone()
    for r, i in enumerate(idx):
        nf = n_frames(items[i][0].n, fs, fp)
        rows[r, :nf] = torch.as_tensor(np.asarray(got[i][key]),
                                       device=full.device).to(full.dtype)
    return rows


def harvest_requiem(cfg, x32, items, dtype, device, gots=()) -> list:
    """The Harvest/Requiem round trip of the requests ``items`` (request,
    call, row, ...) at their bucket's length, rows stripped to each
    utterance; and for each of ``gots`` (a list of each request's outputs:
    the program's, a control's), the Requiem synthesis of its own analysis,
    in ``y_syn``."""
    fs, fp = cfg["fs"], cfg["frame_period_ms"]
    out = [None] * len(items)
    for L, idx in _by_bucket(items).items():
        xb = torch.tensor(_rows(x32, [items[i] for i in idx], L), dtype=dtype,
                          device=device)
        t = R.harvest_requiem_tables(fs, cfg["seed_bank"], dtype, device)
        max_pulses = R.default_batch_max_pulses(L, fs)
        rt = R.encode_decode_one(xb, t["pulse_seed"], t["noise_seed"], fs, fp,
                                 max_pulses,
                                 R.default_max_candidates(R.F0_FLOOR, R.F0_CEIL),
                                 R.default_max_sections(L, fs),
                                 tables={k: t[k] for k in R.HARVEST_TABLE_KEYS})
        y_syns = []
        for got in gots:
            own = {k: _own_frames(rt[src], got, items, idx, k, fs, fp)
                   for k, src in (("f0", "f0"), ("vuv", "vuv"),
                                  ("sp", "spectrogram"),
                                  ("ap", "band_aperiodicity"))}
            y_syns.append(R.synthesize(
                rt["temporal_positions"], own["f0"], own["vuv"],
                own["ap"].transpose(-1, -2), own["sp"].transpose(-1, -2),
                t["pulse_seed"], t["noise_seed"],
                torch.zeros(t["pulse_seed"].shape[1], dtype=torch.int64,
                            device=device),
                fs, R.output_length(L, fs, fp), max_pulses, int(fp / 1000 * fs),
                float(fp) / 1000.0, R.round_trip_rank_bound(fs))[0])
        for r, i in enumerate(idx):
            n = items[i][0].n
            nf, ny = n_frames(n, fs, fp), R.output_length(n, fs, fp)
            out[i] = {"f0": rt["f0"][r, :nf], "vuv": rt["vuv"][r, :nf],
                      "sp": rt["spectrogram"][r, :nf],
                      "ap": rt["band_aperiodicity"][r, :nf], "y": rt["y"][r, :ny]}
            out[i]["y_syn"] = [y[r, :ny] for y in y_syns]
    return out


def dio_classic(cfg, x32, items, dtype, device, gots=()) -> list:
    """The classic round trip of the requests ``items`` at their bucket's
    length with each request's rows of the benchmark's noise draw (redrawn
    from the call's seed), rows stripped; and for each of ``gots``, the
    classic synthesis of its own analysis on the same noise rows, in
    ``y_syn``."""
    fs, fp = cfg["fs"], cfg["frame_period_ms"]
    out = [None] * len(items)
    for L, idx in _by_bucket(items).items():
        xb = torch.tensor(_rows(x32, [items[i] for i in idx], L), dtype=dtype,
                          device=device)
        _, P, N = R.classic_caps(L, fs, fp)
        noise = torch.stack([
            classic_noise(items[i][1].noise_seed, (items[i][1].rows, P, N),
                          device)[items[i][2]] for i in idx]).to(dtype)
        tables = R.classic_tables(fs, dtype, device)
        rt = R.encode_decode_classic_one(xb, fs, fp, noise=noise, tables=tables)
        y_syns = []
        for got in gots:
            own = {"temporal_positions": rt["temporal_positions"]}
            for k, src in (("f0", "f0"), ("vuv", "vuv")):
                own[k] = _own_frames(rt[src], got, items, idx, k, fs, fp)
            for k, src in (("sp", "spectrogram"), ("ap", "aperiodicity")):
                own[src] = _own_frames(rt[src].transpose(1, 2), got, items, idx,
                                       k, fs, fp).transpose(1, 2)
            y_syns.append(R.synthesize_classic(own, noise, fs, L, fp)[0])
        for r, i in enumerate(idx):
            n = items[i][0].n
            nf, ny = n_frames(n, fs, fp), R.output_length(n, fs, fp)
            out[i] = {"f0": rt["f0"][r, :nf], "vuv": rt["vuv"][r, :nf],
                      "sp": rt["spectrogram"][r, :, :nf].T,
                      "ap": rt["aperiodicity"][r, :, :nf].T, "y": rt["y"][r, :ny]}
            out[i]["y_syn"] = [y[r, :ny] for y in y_syns]
    return out


def world_facade(cfg, x32, items, dtype, device, gots=()) -> list:
    """``World.encode`` (DIO, classic D4C) and ``decode`` of each request at
    its own length, the classic synthesis' noise drawn as the program's
    ``decode(dat, key=generator)`` draws it (float32 on the card, the
    request's seed); and for each of ``gots``, ``decode`` of its own
    analysis on the same draw, in ``y_syn``."""
    fs, fp = cfg["fs"], cfg["frame_period_ms"]

    def decode(d, seed):
        tp = np.asarray(d["temporal_positions"], np.float64)
        f0 = np.asarray(d["f0"], np.float64)
        noise = classic_noise(seed, (RC.default_max_pulses(tp, f0),
                                     RC.max_noise_length(fs)), device).to(dtype)
        y = RC.synthesis(d, d, noise=noise, dtype=dtype, device=device)
        y = y.double().cpu().numpy()
        m = np.max(np.abs(y))
        return y / m if m > 1.0 else y

    out = []
    for i, (req, call, _row, *_rest) in enumerate(items):
        dat = RF.encode(fs, cut_of(x32, req).astype(np.float64), dtype, device,
                        f0_method=cfg["f0_method"], f0_floor=cfg["f0_floor"],
                        f0_ceil=cfg["f0_ceil"],
                        channels_in_octave=cfg["channels_in_octave"],
                        target_fs=cfg["target_fs"], frame_period=fp)
        o = {"f0": dat["f0"], "vuv": dat["vuv"], "sp": dat["spectrogram"].T,
             "ap": dat["aperiodicity"].T, "y": decode(dat, call.noise_seed),
             "tp": dat["temporal_positions"]}
        # each analysis' own frame times, which set its waveform's length
        o["y_syn"] = [decode({"f0": g[i]["f0"], "vuv": g[i]["vuv"], "fs": fs,
                              "temporal_positions": g[i]["tp"],
                              "spectrogram": np.asarray(g[i]["sp"]).T,
                              "aperiodicity": np.asarray(g[i]["ap"]).T},
                             call.noise_seed) for g in gots]
        out.append(o)
    return out


PATHS = {"harvest_requiem": harvest_requiem, "dio_classic": dio_classic,
         "world_dio_classic": world_facade}


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
    with torch.no_grad():
        outs = PATHS[cfg["reference"]](cfg, x32, items, dtype, device, gots)
    return [{k: _numpy(v) for k, v in o.items()} for o in outs]


def control(cfg, x32, items, device=None, kind=None) -> list:
    """The control's outputs of the sampled requests: the reference put in
    the program's place, in float32 with TF32 on, on the input of ``kind``
    (:func:`control_input`; the path's own, :data:`CONTROL`, unless
    given)."""
    kind = kind or CONTROL[cfg["reference"]]
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
    requiem = cfg["reference"] == "harvest_requiem"
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
