"""The Harvest/Requiem round trip (Harvest -> CheapTrick -> D4C-Requiem ->
Requiem synthesis) of the ragged batch entry, at each request's bucket's
zero-padded length with the Requiem seed banks of the configuration's
``seed_bank``.  TF32 reaches it (the FIR banks' convolution and the
Requiem synthesis' matrix product), so its control is TF32."""
import torch

from paths._lib import by_bucket, n_frames, own_frames, rows_of
from reference import roundtrip as R

CONTROL = "tf32"


def outputs(cfg, x32, items, dtype, device, gots=()) -> list:
    """The Harvest/Requiem round trip of the requests ``items`` (request,
    call, row, ...) at their bucket's length, rows stripped to each
    utterance; and for each of ``gots`` (a list of each request's outputs:
    the program's, a control's), the Requiem synthesis of its own analysis,
    in ``y_syn``."""
    fs, fp = cfg["fs"], cfg["frame_period_ms"]
    out = [None] * len(items)
    for L, idx in by_bucket(items).items():
        xb = torch.tensor(rows_of(x32, [items[i] for i in idx], L), dtype=dtype,
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
            own = {k: own_frames(rt[src], got, items, idx, k, fs, fp)
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
