"""host_syncs_per_call.world_api: the program's reads of tensors on the
host (each a wait for the card: its counter ``host.syncs``) during the
traced run's profiled window's ``World.encode`` and ``World.decode`` calls,
over the ``World.decode`` calls, from the tracer's call spans
(world_tpu_torch.utils.profiling.TRACER).  None where the tracer holds no
such call (on the CPU, or a program without the tracer)."""


def read(run):
    try:
        from world_tpu_torch.utils.profiling import TRACER
    except ImportError:
        return None
    calls = [s for s in TRACER.spans() if s.parent is None and s.counts
             and s.name in ("world.api.encode", "world.api.decode")]
    decodes = sum(s.name == "world.api.decode" for s in calls)
    if not decodes:
        return None
    return sum(s.counts["host.syncs"] for s in calls) / decodes
