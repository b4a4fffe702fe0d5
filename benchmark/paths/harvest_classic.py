"""pyworld's default chain (Harvest -> CheapTrick -> classic D4C -> classic
synthesis) of one ``HarvestClassic`` module a bucket, at each request's
bucket's zero-padded length, with the rows of the benchmark's noise draw
that the request's call took.  TF32 reaches
it (Harvest's FIR bank: a convolution lowered to a matrix product), so its
control is TF32."""
import torch

from paths._lib import by_bucket, classic_noise, n_frames, own_frames, rows_of
from reference import harvest_classic as R
from reference.roundtrip import output_length

CONTROL = "tf32"


def outputs(cfg, x32, items, dtype, device, gots=()) -> list:
    """The Harvest/classic round trip of the requests ``items`` at their
    bucket's length with each request's rows of the benchmark's noise draw
    (redrawn from the call's seed, in the shape of the Harvest caps), rows
    stripped; and for each of ``gots``, the classic synthesis of its own
    analysis on the same noise rows, in ``y_syn``."""
    fs, fp = cfg["fs"], cfg["frame_period_ms"]
    out = [None] * len(items)
    for L, idx in by_bucket(items).items():
        xb = torch.tensor(rows_of(x32, [items[i] for i in idx], L), dtype=dtype,
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
            for k in ("f0", "vuv"):
                own[k] = own_frames(rt[k], got, items, idx, k, fs, fp)
            for k, src in (("sp", "spectrogram"), ("ap", "aperiodicity")):
                own[src] = own_frames(rt[src].transpose(1, 2), got, items, idx,
                                      k, fs, fp).transpose(1, 2)
            y_syns.append(R.synthesize_classic(own, noise, fs, L, fp)[0])
        for r, i in enumerate(idx):
            n = items[i][0].n
            nf, ny = n_frames(n, fs, fp), output_length(n, fs, fp)
            out[i] = {"f0": rt["f0"][r, :nf], "vuv": rt["vuv"][r, :nf],
                      "sp": rt["spectrogram"][r, :, :nf].T,
                      "ap": rt["aperiodicity"][r, :, :nf].T, "y": rt["y"][r, :ny]}
            out[i]["y_syn"] = [y[r, :ny] for y in y_syns]
    return out
