"""Faults planted in the program's timed path, for the tests that see a
broken run come out not correct: answers altered where they are produced
(the analysis' f0 detuned by 1% where voiced; every frame unvoiced, as an
analysis that finds no candidate; every other frame's f0 5% high; the
synthesis' waveform scaled by one half), and half of a call's rows
answered with the other half's outputs."""
import torch


def analysis_fault(alter):
    def plant(fn):
        def wrapped(*args, **kw):
            out = dict(fn(*args, **kw))
            out["f0"], out["vuv"] = alter(out["f0"], out["vuv"])
            return out
        return wrapped
    return plant


def detune(f0, vuv):
    return f0 * 1.01, vuv


def unvoiced(f0, vuv):
    return torch.zeros_like(f0), torch.zeros_like(vuv)


def half_detuned(f0, vuv):
    f0 = f0.clone()
    f0[..., ::2] *= 1.05
    return f0, vuv


def scale_y(fn):
    def wrapped(*args, **kw):
        out = fn(*args, **kw)
        if isinstance(out, tuple):
            return (out[0] * 0.5,) + tuple(out[1:])
        return out * 0.5
    return wrapped


def half_rows(fn):
    def wrapped(*args, **kw):
        out = dict(fn(*args, **kw))
        for k, v in out.items():
            if isinstance(v, torch.Tensor) and v.dim() >= 1 and v.shape[0] >= 2:
                h = v.shape[0] // 2
                out[k] = torch.cat([v[:h], v[:v.shape[0] - h]])
        return out
    return wrapped


ANALYZE = (("batch", "analyze"), ("api", "analyze"))
# fault: (plant, [(module, attribute)] it is planted in)
FAULTS = {
    "answer_altered": (analysis_fault(detune), ANALYZE),
    "all_unvoiced": (analysis_fault(unvoiced), ANALYZE),
    "half_detuned": (analysis_fault(half_detuned), ANALYZE),
    "synthesis_scaled": (scale_y, (("batch", "synthesize"),
                                   ("batch", "synthesize_classic"),
                                   ("api", "synthesis"))),
    "half_rows": (half_rows, (("batch", "encode_decode_one"),
                              ("batch", "encode_decode_classic_one"))),
}


def plant_fault(monkeypatch, fault: str):
    """Plant ``fault`` in the program for the test (before its set-up, so
    that its graphs capture it)."""
    from world_tpu_torch import api
    from world_tpu_torch.parallel import batch
    modules = {"api": api, "batch": batch}
    plant, targets = FAULTS[fault]
    for mod, attr in targets:
        monkeypatch.setattr(modules[mod], attr, plant(getattr(modules[mod], attr)))
