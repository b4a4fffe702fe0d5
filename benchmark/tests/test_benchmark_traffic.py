"""The traffic drivers, the metric readers of shapes and spans, the plans
of every cell pinned, and the harness finding a new cell, mix, driver and
metric by name."""
import hashlib
import importlib
import itertools
import json
import shutil
import time

import numpy as np
import pytest

from harness import core
from traffic import closed_batch, closed_single, common, cuts, open_poisson

AUDIO = cuts.load("x16")
X = AUDIO.x
CORPUS = {"rows": 16, "quantum_s": 1.0, "min_s": 0.9, "max_s": 4.644,
          "calls_per_pass": 37, "keep_share": 0.004}
SERVE = {"rate": 150.0, "quantum_s": 1.0, "min_s": 0.9, "max_s": 4.644,
         "keep_share": 0.01}
SINGLE = {"lengths_per_pass": 24, "min_s": 0.9, "max_s": 4.644, "keep_share": 0.1}
BIG_SEED = 2 ** 33 + 12345


def requests(driver, params, seed, n=100):
    plan = driver.plan(params, seed, AUDIO, 10.0)
    return [(c.length, c.rows, c.noise_seed, [(r.offset, r.n, r.due) for r in c.requests])
            for c in itertools.islice(plan.calls(), n)]


@pytest.mark.parametrize("driver,params", [(closed_batch, CORPUS),
                                           (open_poisson, SERVE),
                                           (closed_single, SINGLE)])
def test_same_seed_same_requests(driver, params):
    assert requests(driver, params, BIG_SEED) == requests(driver, params, BIG_SEED)
    assert requests(driver, params, BIG_SEED) != requests(driver, params, BIG_SEED + 1)
    assert requests(driver, params, -7) != requests(driver, params, 7)


@pytest.mark.parametrize("driver,params", [(closed_batch, CORPUS),
                                           (open_poisson, SERVE),
                                           (closed_single, SINGLE)])
def test_lengths_stay_in_range(driver, params):
    for seed in (1, BIG_SEED):
        plan = driver.plan(params, seed, AUDIO, 10.0)
        for c in itertools.chain(itertools.islice(plan.calls(), 400), plan.warm_calls()):
            for r in c.requests:
                assert 0.9 * AUDIO.fs <= r.n <= min(4.644 * AUDIO.fs, X.shape[0])
                assert 0 <= r.offset and r.offset + r.n <= X.shape[0]
                assert r.audio_s == r.n / 16000
                if r.bucket:
                    assert (cuts.bucket_of(r.n, params["quantum_s"], AUDIO.fs)
                            == c.length == r.bucket)


def test_corpus_calls_are_the_entrys_signatures():
    plan = closed_batch.plan(CORPUS, BIG_SEED, AUDIO, 10.0)
    calls = list(itertools.islice(plan.calls(), 37 * 3))
    sigs = {c.signature for c in calls}
    assert sigs == {c.signature for c in plan.warm_calls()}
    assert sigs == {(16, L) for L in (16000, 32000, 48000, 64000, 80000)}
    per_pass = [sum(r.n for c in calls[k * 37:(k + 1) * 37] for r in c.requests)
                for k in range(3)]
    assert max(per_pass) / min(per_pass) < 1.01     # seeds and passes alike


# Each cell's plans at three seeds, pinned to what the drivers of commit
# b5d73c28642d320b72be40a203a1980cbd0a5fb9 planned (16 kHz, a fixed rate,
# x16 for every cell): the window's first PINNED_CALLS calls (every call of
# the open loop's) at BENCHMARK.json's run_seconds, a traced run's profiled
# window (core.PROFILE_S), the warm-up calls and the request ids a run keeps
# for its check, each as the first 16 hex digits of the SHA-256 of
# plan_rows' JSON.  A single offset, length, bucket, due time or noise seed
# that moves changes a digest.
PINNED_CALLS = 120
PINNED_SEEDS = (3, 2 ** 31 + 17, 7190000003)
PINNED = {
    "harvest_requiem.corpus_b16": {
        3: ("61f513bfc8e651e3", "61f513bfc8e651e3", "0043008b7a6d8199", "af955873563fd1b5"),
        2 ** 31 + 17: ("397fd93ccf200893", "397fd93ccf200893", "c51727856fbfe601", "64370b82360dec90"),
        7190000003: ("f4c20437342cf5ac", "f4c20437342cf5ac", "81d4d81136bda3cc", "4c7af40bcaf47a27"),
    },
    "dio_classic.corpus_b16": {
        3: ("61f513bfc8e651e3", "61f513bfc8e651e3", "0043008b7a6d8199", "af955873563fd1b5"),
        2 ** 31 + 17: ("397fd93ccf200893", "397fd93ccf200893", "c51727856fbfe601", "64370b82360dec90"),
        7190000003: ("f4c20437342cf5ac", "f4c20437342cf5ac", "81d4d81136bda3cc", "4c7af40bcaf47a27"),
    },
    "harvest_requiem.serve_open": {
        3: ("4db2bc2e857d50a1", "2c15280949b61b93", "67ffbd652a272f9c", "cefce6ca291f672f"),
        2 ** 31 + 17: ("77092aa93103539b", "e6eafc0f0964533f", "70769ad903eb496c", "1a3d3b9c9f07f741"),
        7190000003: ("c16d1d85e6820aaf", "f685d6cfa53033ff", "c28b89d80d77f4e6", "ee80a63afaf59be1"),
    },
    "dio_classic.world_api": {
        3: ("bc9b036805ed2b2f", "bc9b036805ed2b2f", "a47ce2008ab74fbf", "b02d98739af590b1"),
        2 ** 31 + 17: ("6530ee5520deff2a", "6530ee5520deff2a", "af59b380bfbe758c", "d05834bd46c09ea4"),
        7190000003: ("2044ffd0c2745f73", "2044ffd0c2745f73", "9f2511c47f226a15", "759fed4bc2a92955"),
    },
}


def plan_rows(calls) -> list:
    return [[int(c.index), int(c.rows), int(c.length), int(c.noise_seed),
             [[int(r.id), int(r.offset), int(r.n), int(r.bucket), float(r.due),
               int(r.noise_seed)] for r in c.requests]] for c in calls]


def digest(obj) -> str:
    return hashlib.sha256(json.dumps(obj).encode()).hexdigest()[:16]


def plan_digests(cell: str, seed: int) -> tuple:
    """(window, profiled window, warm-up, kept ids) digests of a cell's plan
    at ``seed``, its audio and mix found as a run finds them."""
    bench, _, cfg, mix = core.cell_of(cell)
    audio = core.audio_of(cfg, mix)
    driver = importlib.import_module("traffic." + mix["driver"])
    p = mix["params"]

    def window(seconds):
        calls = driver.plan(p, seed, audio, seconds).calls()
        if mix["driver"] != "open_poisson":
            calls = itertools.islice(calls, PINNED_CALLS)
        return digest(plan_rows(calls))

    warm = driver.plan(p, seed, audio, bench["run_seconds"]).warm_calls()
    return (window(bench["run_seconds"]), window(core.PROFILE_S),
            digest(plan_rows(warm)),
            digest(sorted(common.keep_ids(core.KEEP_UNTIL, seed, p["keep_share"]))))


@pytest.mark.parametrize("cell,seed", [(c, s) for c in PINNED for s in PINNED_SEEDS])
def test_plans_are_pinned(cell, seed):
    assert plan_digests(cell, seed) == PINNED[cell][seed]


def fake_run(calls, window=1.0, spans=None):
    rec = common.Record()
    rec.open()
    for i, c in enumerate(calls):
        rec.done(c, 0.01 * i, 0.01 * i + 0.005, [None] * len(c.requests))
    rec.close(window)
    return core.Run(record=rec, setup_s=1.0, spans=spans)


def test_padding_share_is_counted_from_the_shapes():
    reader = core.load_module(core.BENCH / "metrics" / "padding_share.corpus.py")
    calls = [common.Call(0, [common.Request(0, 0, 12000, 16000, fs=16000),
                             common.Request(1, 0, 16000, 16000, fs=16000)], 4, 16000),
             common.Call(1, [common.Request(2, 0, 30000, 32000, fs=16000)], 1, 32000)]
    expect = 100 * (1 - (12000 + 16000 + 30000) / (4 * 16000 + 32000))
    assert reader.read(fake_run(calls)) == pytest.approx(expect)
    plan = closed_batch.plan(CORPUS, 3, AUDIO, 10.0)
    share = reader.read(fake_run(list(itertools.islice(plan.calls(), 370))))
    assert 14.0 < share < 18.0


def test_span_readers():
    calls = [common.Call(i, [common.Request(i, 0, 16000, 16000, fs=16000)], 1, 16000)
             for i in range(4)]
    run = fake_run(calls, window=0.04, spans={0: 2.0, 1: 2.0, 2: 2.0, 3: 2.0})
    idle = core.load_module(core.BENCH / "metrics" / "device_idle.serve.py")
    host = core.load_module(core.BENCH / "metrics" / "host_ms_per_request.serve.py")
    assert idle.read(run) == pytest.approx(100 * (1 - 8.0 / 40.0))
    assert host.read(run) == pytest.approx(3.0)
    assert idle.read(fake_run(calls)) is None


class SleepySystem:
    def __init__(self, seconds):
        self.seconds = seconds

    def call(self, call):
        time.sleep(self.seconds)
        return [{"n": r.n} for r in call.requests]


def test_open_loop_times_from_the_due_time():
    params = dict(SERVE, rate=400.0)
    plan = open_poisson.plan(params, 5, AUDIO, 0.5)
    rec = common.Record()
    open_poisson.run(SleepySystem(0.004), plan, 0.5, rec)
    assert len(rec.requests) == plan.n == 200
    lat = rec.latencies_ms()
    starts = np.array([s for _, _, s, _, _ in rec.requests])
    dues = np.array([d for _, d, _, _, _ in rec.requests])
    assert np.all(starts >= dues - 1e-9)
    assert np.all(lat >= 4.0)                       # service included
    assert lat.max() > 8.0                          # waits behind others count
    assert rec.lateness and max(rec.lateness) < 0.05
    assert rec.window_s() >= plan.due[-1]


def test_closed_loop_window_holds_all_its_time():
    plan = closed_batch.plan(dict(CORPUS, rows=2), 5, AUDIO, 0.2)
    rec = common.Record(keep={0, 1})
    closed_batch.run(SleepySystem(0.02), plan, 0.2, rec)
    assert rec.window_s() >= 0.2 and rec.window_s() == rec.calls[-1][2]
    assert set(rec.outputs) == {0, 1} and rec.longest is not None


@pytest.fixture
def copied_bench(tmp_path, monkeypatch):
    """A copy of BENCHMARK.json and benchmark/ in which a test adds files."""
    root = tmp_path / "checkout"
    shutil.copytree(core.BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(core.ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    monkeypatch.setattr(core, "ROOT", root)
    monkeypatch.setattr(core, "BENCH", root / "benchmark")
    return root


def test_a_new_cell_is_found_by_name(copied_bench):
    root = copied_bench
    bench = json.loads((root / "BENCHMARK.json").read_text())
    (root / "benchmark" / "mixes" / "serve_burst.json").write_text(json.dumps(
        {"driver": "open_poisson", "api": "batch", "warm_repeats": 2,
         "params": SERVE}))
    (root / "benchmark" / "metrics" / "queue_ms.serve_burst.py").write_text(
        "def read(run):\n    return 1.5\n")
    bench["workloads"].append({"name": "harvest_requiem.serve_burst",
                               "config": "arctic16k_harvest_requiem",
                               "traffic": "serve_burst", "chips": 1, "why": "test"})
    p95 = next(m for m in bench["end_to_end"] if m["name"] == "latency_p95_ms")
    p95["workloads"].append("harvest_requiem.serve_burst")
    bench["per_layer"].append({"name": "queue_ms.serve_burst", "unit": "ms",
                               "better": "lower", "source": "host_clock",
                               "layer": "parallel.batch", "moves": "latency_p95_ms",
                               "workloads": ["harvest_requiem.serve_burst"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    b, cell, cfg, mix = core.cell_of("harvest_requiem.serve_burst")
    assert cfg["entry"] == "batch_encode_decode_ragged" and mix["driver"] == "open_poisson"
    assert [m["name"] for m in core.metrics_of(b, cell, 0)] == ["latency_p95_ms", "setup_s"]
    names = [m["name"] for m in core.metrics_of(b, cell, 1)]
    assert names == ["queue_ms.serve_burst"]
    assert core.load_module(core.BENCH / "metrics" / f"{names[0]}.py").read(None) == 1.5


def test_a_new_driver_is_found_by_name(copied_bench):
    import importlib
    import sys
    path = copied_bench / "benchmark" / "traffic" / "closed_twice.py"
    path.write_text("from .closed_batch import plan, run  # noqa: F401\n")
    monkeypatch_path = str(copied_bench / "benchmark")
    saved = dict(sys.modules)
    sys.path.insert(0, monkeypatch_path)
    try:
        for name in [m for m in sys.modules if m == "traffic" or m.startswith("traffic.")]:
            del sys.modules[name]
        mod = importlib.import_module("traffic.closed_twice")
        assert callable(mod.plan) and callable(mod.run)
    finally:
        sys.path.remove(monkeypatch_path)
        sys.modules.clear()
        sys.modules.update(saved)
