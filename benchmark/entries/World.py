"""``world_tpu_torch.World``: the facade a Python-WORLD user calls, one
utterance at a time at its own length, eagerly: ``encode(fs, x,
f0_method)`` then ``decode(dat, key=generator)``, the generator on the card
seeded from the request."""
import numpy as np
import torch


class System:
    def __init__(self, cfg: dict, x32: np.ndarray, device):
        from world_tpu_torch import World
        self.cfg, self.x32, self.device = cfg, x32, torch.device(device)
        self.world = World(device=self.device, dtype=torch.float32)

    def call(self, call) -> list:
        c, q = self.cfg, call.requests[0]
        x = self.x32[q.offset:q.offset + q.n]
        dat = self.world.encode(c["fs"], x, f0_method=c["f0_method"],
                                f0_floor=c["f0_floor"], f0_ceil=c["f0_ceil"],
                                channels_in_octave=c["channels_in_octave"],
                                target_fs=c["target_fs"],
                                frame_period=c["frame_period_ms"],
                                is_requiem=c["d4c"] == "requiem")
        key = torch.Generator(device=self.device)
        key.manual_seed(call.noise_seed)
        dat = self.world.decode(dat, key=key)
        return [{"f0": dat["f0"], "vuv": dat["vuv"], "sp": dat["spectrogram"].T,
                 "ap": dat["aperiodicity"].T, "y": dat["out"],
                 "tp": dat["temporal_positions"]}]

    def caches(self) -> list:
        return []

    def close(self):
        pass
