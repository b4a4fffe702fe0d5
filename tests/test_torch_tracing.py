"""The port's tracer (world_tpu_torch/utils/profiling.py): spans at the
layer boundaries, stage stamps, counters, and the benchmark's readers of
them (benchmark/metrics/stage_ms.*.corpus.py, copy_back_ms.corpus.py,
host_syncs_per_call.world_api.py).

On the CPU: tracing off records nothing, opens no profiler range and makes
no CUDA event; under ``tracing()`` one call's spans share a call id and
nest by parent; a ``torch.profiler`` session switches the tracer on and its
events hold the program's range names; the counters of one facade call;
each reader on a tracer filled by hand, and None on an empty one.  Marked
``gpu``: a graph replay's outputs are bitwise equal with tracing on and
off, its four stage spans sum to its launch span's device ms and its
outputs' copy back has a device span, for both graph entries (``python -m
pytest --noconftest tests/test_torch_tracing.py -m gpu -q`` on the card).
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from world_tpu_torch.utils import profiling
from world_tpu_torch.utils.profiling import TRACER, Tracer, tracing

ROOT = Path(__file__).resolve().parent.parent
FS, FP = 12000, 10
QUANTUM = 3072 / FS
STAGES = ["world.stage.f0", "world.stage.envelope", "world.stage.aperiodicity",
          "world.stage.synthesis"]


def _chirp(n, f_lo, scale, seed=0):
    rng = np.random.RandomState(seed)
    t = np.arange(n) / FS
    ph = 2 * np.pi * np.cumsum(f_lo + 40.0 * t / t[-1]) / FS
    base = sum((0.6 ** k) * np.sin((k + 1) * ph) for k in range(4))
    return (base * scale + 0.01 * rng.randn(n)).astype(np.float32)


def _facade_call(x):
    from world_tpu_torch import World

    world = World(device="cpu", dtype=torch.float32)
    dat = world.encode(FS, x, f0_method="dio", frame_period=FP)
    return world.decode(dat)


def _ragged_call(xs):
    from world_tpu_torch import batch_encode_decode_ragged

    return batch_encode_decode_ragged(xs, FS, devices="cpu", frame_period=FP,
                                      bucket_quantum_s=QUANTUM)


@pytest.fixture
def no_range_no_event(monkeypatch):
    """A profiler range or a torch.cuda.Event raises if anything makes
    one."""
    def refuse(*args, **kwargs):
        raise AssertionError("made while the tracer is off")

    monkeypatch.setattr(profiling, "_RANGE", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)


def test_off_records_nothing_and_opens_nothing(no_range_no_event):
    TRACER.clear()
    assert not TRACER.on()
    out = _facade_call(_chirp(3000, 130.0, 0.8))
    assert np.isfinite(out["out"]).all()
    cuda = torch.device("cuda")
    with TRACER.span("world.test.off", device=cuda, rows=1) as span:
        assert span is None
    TRACER.stamp("start", cuda)
    TRACER.stamp("f0", cuda)
    assert TRACER.spans() == [] and TRACER.dropped == 0
    # counters are always on
    assert TRACER.counters()["host.syncs"] == 8


def test_tracing_one_call_shares_its_id_and_nests():
    xs = [_chirp(2500, 130.0, 0.8), _chirp(2000, 150.0, 0.7, seed=1)]
    TRACER.clear()
    with tracing():
        out = _ragged_call(xs)
    spans = TRACER.spans()
    TRACER.clear()
    by_id = {s.id: s for s in spans}
    (root,) = [s for s in spans if s.parent is None]
    assert root.name == "world.batch.ragged" and root.attrs == {"fs": FS}
    assert {s.call for s in spans} == {root.id}
    for s in spans:
        if s is not root:
            parent = by_id[s.parent]
            assert parent.t0 <= s.t0 <= s.t1 <= parent.t1
    names = [s.name for s in spans]
    for name in ("world.batch.bucket", "world.batch.pad",
                 "world.batch.encode_decode", "world.batch.overflow",
                 "world.batch.copy_back", "world.batch.strip"):
        assert names.count(name) == 1, name
    # the overflow flag read alone; the five outputs in one copy back
    assert names.count("world.host.read") == 1
    stages = [s for s in spans if s.name.startswith("world.stage.")]
    assert [s.name for s in sorted(stages, key=lambda s: s.t0)] == STAGES
    (call,) = [s for s in spans if s.name == "world.batch.encode_decode"]
    assert all(s.parent == call.id for s in stages)
    assert root.counts["samples.computed"] == 2 * 3072
    assert root.counts["samples.true"] == 4500
    assert root.counts["host.syncs"] == 2
    # the bucket's two padded rows of 3072 samples, float32
    from world_tpu_torch.parallel.batch import output_length
    bins, bands = (out[0][k].shape[1] for k in ("spectrogram",
                                                "band_aperiodicity"))
    n_frames = int(1000 * 3072 / FS / FP + 1)
    copied = 4 * 2 * (n_frames * (2 + bins + bands) + output_length(3072, FS, FP))
    assert root.counts["copy_back.bytes"] == copied
    assert root.counts["bytes.d2h"] == copied + 2           # and the two flags
    assert root.counts["copy_back.fresh_bytes"] == 0        # on the host already


def test_a_profiler_session_turns_the_tracer_on():
    from torch.profiler import ProfilerActivity, profile

    from world_tpu_torch.frames import host

    TRACER.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert TRACER.on()
        with TRACER.span("world.test.outer"):
            host(torch.arange(4.0))
    names = {e.name for e in prof.events()}
    assert {"world.test.outer", "world.host.read"} <= names
    spans = TRACER.spans()
    TRACER.clear()
    assert [s.name for s in spans] == ["world.host.read", "world.test.outer"]
    assert spans[0].parent == spans[1].id


def test_facade_counters():
    x = _chirp(3000, 130.0, 0.8)
    TRACER.clear()
    with tracing():
        out = _facade_call(x)
    spans = TRACER.spans()
    TRACER.clear()
    enc, dec = (s for s in spans if s.parent is None)
    assert (enc.name, dec.name) == ("world.api.encode", "world.api.decode")
    # encode: six outputs read; decode: the synthesis' overflow flag and y
    assert (enc.counts["host.syncs"], dec.counts["host.syncs"]) == (6, 2)
    assert enc.counts["samples.computed"] == enc.counts["samples.true"] == 3000
    assert dec.counts["samples.computed"] == 0
    assert enc.counts["bytes.h2d"] == 4 * 3000
    assert dec.counts["bytes.d2h"] == 4 * out["out"].shape[0] + 1
    assert enc.counts["bytes.d2h"] == sum(
        np.asarray(out[k]).nbytes for k in ("temporal_positions", "vuv", "f0",
                                            "aperiodicity", "ps spectrogram",
                                            "spectrogram"))
    assert [s.name for s in spans if s.name.startswith("world.stage.")] == STAGES


def _reader(name):
    path = ROOT / "benchmark" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


READERS = ["stage_ms.f0.corpus", "stage_ms.envelope.corpus",
           "stage_ms.aperiodicity.corpus", "stage_ms.synthesis.corpus",
           "copy_back_ms.corpus", "host_syncs_per_call.world_api"]


def _filled() -> Tracer:
    """Two ragged calls of 16,000 samples at 16 kHz (2 s computed) with
    stage and copy spans, and two facade calls of 6 + 2 syncs each."""
    tr = Tracer()
    cpu = torch.device("cpu")
    with tr.tracing():
        for _ in range(2):
            with tr.span("world.batch.ragged", fs=16000):
                tr.count("samples.computed", 16000)
                with tr.span("world.batch.run", kind="replay"):
                    for stage in ("start", "f0", "envelope", "aperiodicity",
                                  "synthesis"):
                        tr.stamp(stage, cpu)
                with tr.span("world.batch.copy_back"):
                    pass
        for _ in range(2):
            with tr.span("world.api.encode", fs=16000):
                tr.count("host.syncs", 6)
            with tr.span("world.api.decode", fs=16000):
                tr.count("host.syncs", 2)
    ms = {"world.stage.f0": 1.0, "world.stage.envelope": 0.25,
          "world.stage.aperiodicity": 0.5, "world.stage.synthesis": 2.0,
          "world.batch.copy_back": 0.1}
    for s in tr.spans():
        s.device_ms = ms.get(s.name)
    return tr


def test_metric_readers(monkeypatch):
    monkeypatch.setattr(profiling, "TRACER", Tracer())
    assert [_reader(n)(None) for n in READERS] == [None] * 6
    monkeypatch.setattr(profiling, "TRACER", _filled())
    got = [_reader(n)(None) for n in READERS]
    assert got == pytest.approx([1.0, 0.25, 0.5, 2.0, 0.1, 8.0])


def test_stamps_pair_only_in_order():
    tr = Tracer()
    cpu = torch.device("cpu")
    with tr.tracing():
        with tr.span("world.test.call"):
            tr.stamp("f0", cpu)              # no start: nothing
            tr.stamp("start", cpu)
            tr.stamp("envelope", cpu)        # a start, then any stage
            tr.stamp("synthesis", cpu)       # not the stage after envelope
        tr.stamp("aperiodicity", cpu)        # another parent
    assert [s.name for s in tr.spans()] == ["world.stage.envelope",
                                            "world.test.call"]
    small = Tracer()
    small.capacity = 1
    with small.tracing():
        for _ in range(3):
            with small.span("world.test.one"):
                pass
    assert len(small.spans()) == 1 and small.dropped == 2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the graph's event nodes")
    return torch.device("cuda", 0)


def _x16():
    return np.load(ROOT / "tests" / "golden" / "harvest_16k.npz")["x16"]


@pytest.fixture
def spun(monkeypatch):
    """Each graph replay starts behind a spin of the device, so that the
    device does not wait for the host to launch the graph inside the launch
    span's events."""
    from world_tpu_torch.parallel import graphs

    replay = graphs.Graph.replay

    def spun_replay(graph, inputs):
        torch.cuda._sleep(50_000_000)
        return replay(graph, inputs)

    monkeypatch.setattr(graphs.Graph, "replay", spun_replay)


def _traced_replay(call, repeats=3):
    """``call()`` until its graph replays, then once more with tracing off
    and once on; returns (outputs off, outputs on, spans)."""
    for _ in range(repeats):
        call()
    TRACER.clear()
    off = call()
    with tracing():
        on = call()
    spans = TRACER.spans()
    TRACER.clear()
    return off, on, spans


def _stages_against_launch(spans):
    (launch,) = [s for s in spans if s.name == "world.batch.launch"]
    stages = [s for s in spans if s.name.startswith("world.stage.")]
    assert sorted(s.name for s in stages) == sorted(STAGES)
    assert all(s.parent == launch.id and s.device_ms > 0 for s in stages)
    total = sum(s.device_ms for s in stages)
    assert abs(total - launch.device_ms) <= 0.03 * launch.device_ms, (
        total, launch.device_ms)


@pytest.mark.gpu
def test_ragged_replay_traced_on_the_card(cuda, spun):
    from world_tpu_torch import batch_encode_decode_ragged

    x = _x16().astype(np.float32)
    xs = [x[:16000], x[20000:34400]]
    off, on, spans = _traced_replay(lambda: batch_encode_decode_ragged(
        xs, 16000, devices=cuda, dtype=torch.float32))
    for a, b in zip(off, on):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    assert [s.attrs["kind"] for s in spans
            if s.name == "world.batch.run"] == ["replay"]
    _stages_against_launch(spans)
    (copy,) = [s for s in spans if s.name == "world.batch.copy_back"]
    assert copy.device_ms > 0


@pytest.mark.gpu
def test_dio_classic_replay_traced_on_the_card(cuda, spun):
    from world_tpu_torch import DioClassic
    from world_tpu_torch.parallel.batch import classic_caps

    x = _x16().astype(np.float32)
    rows = torch.tensor(np.stack([x[:16000], x[30000:46000]]), device=cuda)
    _, P, N = classic_caps(16000, 16000, 5)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(7)
    noise = torch.randn((2, P, N), generator=gen, device=cuda)
    module = DioClassic(16000, 16000, 5, dtype=torch.float32, device=cuda)
    off, on, spans = _traced_replay(lambda: module(rows, noise=noise))
    for k in off:
        assert on[k].is_pinned() and torch.equal(off[k], on[k]), k
    _stages_against_launch(spans)
    # the outputs' copies to the host, after the replay's clone
    (copy,) = [s for s in spans if s.name == "world.batch.copy_back"]
    assert copy.device_ms > 0
