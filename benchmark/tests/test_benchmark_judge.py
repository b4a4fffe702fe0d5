"""The check's numbers on the CPU, on made-up outputs: what a request's
analysis and synthesis read where they agree, where a fault leaves the
reference nothing to compare with, and where a whole section is off."""
import numpy as np
import pytest

from harness import judge

FS = 16000
F, BINS, N = 200, 513, 16000


def outputs(seed=0):
    g = np.random.default_rng(seed)
    vuv = np.zeros(F)
    vuv[40:160] = 1.0
    t = np.arange(N) / FS
    return {"f0": np.where(vuv > 0, 120.0 + 10 * np.sin(np.arange(F) / 9), 0.0),
            "vuv": vuv, "sp": g.uniform(1e-6, 1e-3, (F, BINS)),
            "ap": g.uniform(-40.0, 0.0, (F, 3)),
            "y": 0.3 * np.sin(2 * np.pi * 150 * t) + 0.01 * g.standard_normal(N)}


def numbers(got, ref):
    return dict(judge.analysis_numbers(got, ref, True),
                **judge.synthesis_numbers(got["y"], ref["y"], FS))


def test_the_same_outputs_read_nought():
    ref = outputs()
    assert all(v == 0.0 for v in numbers(outputs(), ref).values())


def test_nothing_voiced_in_both_is_not_agreement():
    ref, got = outputs(), outputs()
    got["vuv"], got["f0"] = np.zeros(F), np.zeros(F)
    n = numbers(got, ref)
    assert n["f0_med_hz"] == n["f0_gross"] == n["f0_rmse_hz"] == np.inf
    assert n["vuv_flips"] == pytest.approx(0.6)


def test_unvoiced_frames_are_compared():
    ref, got = outputs(), outputs()
    got["sp"] = got["sp"].copy()
    got["sp"][:40] *= 2.0               # unvoiced in both
    got["ap"] = got["ap"].copy()
    got["ap"][170] += 3.0
    n = numbers(got, ref)
    assert n["sp_lsd_db"] > 1.0 and n["ap_err_db"] == pytest.approx(3.0)


@pytest.mark.parametrize("share", [0.25, 0.5])
def test_a_share_of_frames_detuned_reads_as_gross(share):
    ref, got = outputs(), outputs()
    got["f0"] = got["f0"].copy()
    voiced = np.flatnonzero(ref["vuv"] > 0)
    got["f0"][voiced[:int(share * voiced.size)]] *= 1.05
    assert numbers(got, ref)["f0_gross"] == pytest.approx(share, abs=0.01)


@pytest.mark.parametrize("scale", [0.5, 0.0])
def test_a_waveform_scaled_or_silent_reads_far_off(scale):
    ref, got = outputs(), outputs()
    got["y"] = got["y"] * scale
    n = numbers(got, ref)
    if scale:
        # 6 dB less where the bins stand above the spectrum's floor
        assert 5.0 < n["y_ltas_db"] <= 6.03 and n["y_rel"] == pytest.approx(0.5)
    else:
        assert n["y_ltas_db"] > 20.0 and n["y_rel"] == pytest.approx(1.0)


def test_a_run_reads_the_worst_request_and_the_share_of_sections_off():
    per = [{"f0_rmse_hz": 0.01, "sp_lsd_db": 0.1},
           {"f0_rmse_hz": 5.0, "sp_lsd_db": 0.2},
           {"f0_rmse_hz": 0.02, "sp_lsd_db": 0.05},
           {"f0_rmse_hz": 0.03, "sp_lsd_db": 0.0}]
    s = judge.summary(per)
    assert s["sp_lsd_db"] == 0.2 and s["f0_rmse_hz"] == 5.0
    assert s["flip_share"] == 0.25


def test_a_number_missing_or_past_its_limit_is_not_correct():
    limits = {"f0_med_hz": 1e-3, "y_ltas_db": 1.0}
    assert judge.verdict({"f0_med_hz": 1e-4, "y_ltas_db": 0.5}, limits)[0]
    assert not judge.verdict({"f0_med_hz": 1e-4}, limits)[0]
    assert not judge.verdict({"f0_med_hz": np.inf, "y_ltas_db": 0.5}, limits)[0]
    assert not judge.verdict({"f0_med_hz": 1e-4, "y_ltas_db": 2.0}, limits)[0]
    assert not judge.verdict({"f0_med_hz": 1e-4}, {})[0]
