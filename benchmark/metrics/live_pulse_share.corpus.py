"""live_pulse_share.corpus: the share of the classic synthesis' pulse slots
that hold a live pulse, over the traced run's profiled window, in percent:
the program's counters ``synth.pulses.live`` (the pulses its synthesis
computes, which it reads off the card at a traced call's end) over
``synth.pulses.slots`` (rows times the static pulse axis) of the window's
calls (world_tpu_torch.utils.profiling.TRACER).  None where the calls hold
no such counter (a program without them, or the Harvest cells)."""


def read(run):
    try:
        from world_tpu_torch.utils.profiling import TRACER
    except ImportError:
        return None
    live = slots = 0
    for s in TRACER.spans():
        if s.parent is None and s.counts:
            live += s.counts.get("synth.pulses.live", 0)
            slots += s.counts.get("synth.pulses.slots", 0)
    if not slots or "synth.pulses.live" not in TRACER.counters():
        return None
    return 100.0 * live / slots
