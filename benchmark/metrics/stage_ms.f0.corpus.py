"""stage_ms.f0.corpus: the device ms of the F0 stage (Harvest, or DIO and
StoneMask) per second of samples computed, over the traced run's profiled
window.  The program's tracer (world_tpu_torch.utils.profiling.TRACER)
records, while a profiler records, the device ms between the event nodes
its graphs hold at the stage's boundaries (spans ``world.stage.f0``); a
second of samples computed is rows times padded length over fs, from the
counters of the calls that hold those spans.  None where the tracer holds
no such span (on the CPU, or a program without the tracer)."""


def ms_per_computed_s(name: str):
    """The device ms of the program's spans called ``name`` over the
    seconds of samples computed by the calls they belong to."""
    try:
        from world_tpu_torch.utils.profiling import TRACER
    except ImportError:
        return None
    spans = TRACER.spans()
    ms, calls = 0.0, set()
    for s in spans:
        if s.name == name and s.device_ms is not None:
            ms += s.device_ms
            calls.add(s.call)
    computed_s = sum(s.counts["samples.computed"] / s.attrs["fs"]
                     for s in spans if s.parent is None and s.id in calls
                     and s.counts and s.attrs.get("fs"))
    return ms / computed_s if computed_s > 0 else None


def read(run):
    return ms_per_computed_s("world.stage.f0")
