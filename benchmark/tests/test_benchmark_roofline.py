"""The copied bound functions reproduce the counts that the port's records
give for x16 (16 kHz, 4.644 s) against the peaks of 3.35 TB/s and
67 TFLOP/s float32: K1 608 x 37,152 -> 0.0303 ms by bytes, K2 (48, 4,645,
341, 1,024) -> 0.0095 ms by operations, K6 / K7 0.00211 / 0.00158 ms by
operations.  The operands come from the frozen reference on the CPU."""
import numpy as np
import pytest
import torch

from reference.aperiodicity import common as C
from reference.aperiodicity.d4c_requiem import n_bands_ap, requiem_fft_size
from reference.f0 import harvest as H
from roofline import bounds as B
from traffic import cuts

FS, F0_FLOOR, F0_CEIL = 16000, 71.0, 800.0


def test_peaks():
    assert B.HBM_BYTES_PER_S == 3.35e12 and B.F32_OPS_PER_S == 67e12


def test_k1_at_harvest_geometry():
    rows = torch.empty((608, 37152), dtype=torch.float32, device="meta")
    tq = torch.empty(4645, dtype=torch.float32, device="meta")
    ms, by = B.k1_bound(rows, tq)
    assert by == "bytes" and round(ms, 4) == 0.0303


@pytest.fixture(scope="module")
def refine_operands():
    x = torch.tensor(cuts.load("x16").x[None])
    tables = H.harvest_tables(FS, F0_FLOOR, F0_CEIL, torch.float32, "cpu")
    y, afs = H.downsample(x, FS, 8000, h=tables["decimator_ir"])
    n_frames = int(1000 * x.shape[1] / FS + 1)
    tq = torch.as_tensor(np.arange(n_frames) / 1000, dtype=torch.float32)
    bfl = H.boundary_f0_list(F0_FLOOR, F0_CEIL)
    raw = H.raw_band_candidates(y, afs, tables["band_bank"], tables["band_bias"],
                                bfl, tq, F0_FLOOR, F0_CEIL, None, None)
    cands0, _ = H.detect_candidates(raw, H.default_max_candidates(F0_FLOOR, F0_CEIL))
    cands1 = H.overlap_candidates(cands0)
    compact, _ = H.compact_rows(cands1.transpose(-1, -2),
                                cands1.transpose(-1, -2) != 0, H.C2_SLOTS)
    max_half, S = H.refinement_geometry(afs, F0_FLOOR)
    seg, _, f0 = H.refinement_inputs(y, afs, tq, compact.transpose(-1, -2), max_half)
    return {"seg": seg, "f0": f0, "afs": afs, "max_half": max_half, "S": S}


def test_k2_at_harvest_geometry(refine_operands):
    ops = refine_operands
    assert (ops["f0"].shape[0], *ops["seg"].shape, ops["S"]) == (48, 4645, 341, 1024)
    ms, by = B.k2_bound(ops)
    assert by == "operations" and round(ms, 4) == 0.0095


def test_k6_k7_at_x16_requiem():
    golden = np.load(cuts.DATA.parent.parent / "tests" / "golden"
                     / "harvest_16k.npz")
    f0 = golden["f0"]
    x = torch.tensor(cuts.load("x16").x[None])
    F = f0.shape[0]
    N, fi, n_ap = requiem_fft_size(FS), 3000.0, n_bands_ap(FS)
    max_half = int(2.0 * FS / 47.0 + 0.5)
    margin = int(np.ceil(FS / (4 * 47.0))) + 3
    a = {"slab": C.frame_slabs(x, FS, 5.0, F, max_half + margin), "margin": margin,
         "fs": FS, "f0": torch.clamp(torch.tensor(f0, dtype=torch.float32), min=47.0),
         "t": C.frame_times(5.0, F, None, "cpu"), "max_half": max_half,
         "fft_size": N, "fi": fi, "n_ap": n_ap,
         "window": C.band_window_table(FS, N, fi, torch.float32, "cpu")}
    b = B.d4c_bounds(a)
    assert b["d4c_centroid"][1] == b["d4c_band_ap"][1] == "operations"
    assert round(b["d4c_centroid"][0], 5) == 0.00211
    assert round(b["d4c_band_ap"][0], 5) == 0.00158
