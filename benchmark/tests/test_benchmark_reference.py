"""The frozen reference against the program in float64 on the CPU at a tiny
size, on both paths: the copy computes what the port's plain code
computes."""
import numpy as np
import pytest
import torch

from reference import facade as RF
from reference import roundtrip as R
from traffic import cuts

FS = 16000


@pytest.fixture(scope="module")
def rows():
    x = cuts.load("x16").x
    return np.stack([x[20000:28000], x[40000:48000]]).astype(np.float32)


def close(a, b, what):
    a = np.asarray(a.detach().cpu() if isinstance(a, torch.Tensor) else a, np.float64)
    b = np.asarray(b.detach().cpu() if isinstance(b, torch.Tensor) else b, np.float64)
    assert a.shape == b.shape, what
    scale = max(np.abs(b).max(), 1e-30)
    assert np.abs(a - b).max() <= 1e-9 * scale, (what, np.abs(a - b).max(), scale)


def test_harvest_requiem_round_trip_matches_the_port(rows):
    from world_tpu_torch.parallel import batch as PB
    xb = torch.tensor(rows, dtype=torch.float64)
    L = xb.shape[1]
    out = {}
    for name, M in (("port", PB), ("ref", R)):
        t = M.harvest_requiem_tables(FS, 0, torch.float64, "cpu")
        out[name] = M.encode_decode_one(
            xb, t["pulse_seed"], t["noise_seed"], FS, 5,
            M.default_batch_max_pulses(L, FS),
            M.default_max_candidates(M.F0_FLOOR, M.F0_CEIL),
            M.default_max_sections(L, FS),
            tables={k: t[k] for k in M.HARVEST_TABLE_KEYS})
    for k in ("f0", "vuv", "spectrogram", "band_aperiodicity", "y"):
        close(out["ref"][k], out["port"][k], k)


def test_classic_round_trip_matches_the_port(rows):
    from world_tpu_torch.parallel import batch as PB
    xb = torch.tensor(rows, dtype=torch.float64)
    _, P, N = R.classic_caps(xb.shape[1], FS, 5)
    g = torch.Generator().manual_seed(3)
    noise = torch.randn((2, P, N), generator=g, dtype=torch.float64)
    out = {name: M.encode_decode_classic_one(xb, FS, 5, noise=noise,
                                             tables=M.classic_tables(FS, torch.float64, "cpu"))
           for name, M in (("port", PB), ("ref", R))}
    for k in ("f0", "vuv", "spectrogram", "aperiodicity", "y"):
        close(out["ref"][k], out["port"][k], k)


def test_facade_encode_matches_the_port(rows):
    from world_tpu_torch import World
    w = World(device="cpu", dtype=torch.float64)
    got = w.encode(FS, rows[0], f0_method="dio")
    ref = RF.encode(FS, rows[0].astype(np.float64), torch.float64, "cpu",
                    f0_method="dio")
    for k in ("f0", "vuv", "spectrogram", "aperiodicity", "temporal_positions"):
        close(ref[k], got[k], k)
    noise_seed = 11
    key = torch.Generator().manual_seed(noise_seed)
    y = w.decode(dict(got), key=key)["out"]
    y_ref = RF.decode(dict(ref), torch.float64, "cpu",
                      key=torch.Generator().manual_seed(noise_seed))
    close(y_ref, y, "y")
