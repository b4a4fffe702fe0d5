"""launches_per_call.world_api: the kernels the card runs for one
encode + decode call of the facade, over the profiled window's calls: the
kernels torch.profiler lists, and for K1-K7 where it lists none of a
kernel's, its launch counter's launches times its grids."""
from harness.trace import GRIDS


def read(run):
    p = run.profile
    if not p or not p["calls"]:
        return None
    extra = sum(n * GRIDS[k] for k, n in p["launches"].items()
                if k not in p["kernels_seen"])
    return (p["kernels"] + extra) / p["calls"]
