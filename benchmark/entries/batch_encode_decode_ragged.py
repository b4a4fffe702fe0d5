"""``world_tpu_torch.batch_encode_decode_ragged``: the Harvest/Requiem round
trip of a list of utterances, grouped into length buckets, one CUDA graph
replay a bucket once its signature is hot."""
import numpy as np
import torch


class System:
    def __init__(self, cfg: dict, x32: np.ndarray, device):
        from world_tpu_torch import batch_encode_decode_ragged
        self.cfg, self.x32, self.device = cfg, x32, torch.device(device)
        self.fn = batch_encode_decode_ragged
        self.kw = dict(frame_period=cfg["frame_period_ms"], seed=cfg["seed_bank"],
                       bucket_quantum_s=cfg["bucket_quantum_s"],
                       dtype=torch.float32, devices=self.device)

    def inputs(self, call) -> list:
        return [self.x32[r.offset:r.offset + r.n] for r in call.requests]

    def call(self, call) -> list:
        outs = self.fn(self.inputs(call), self.cfg["fs"], **self.kw)
        return [{"f0": o["f0"], "vuv": o["vuv"], "sp": o["spectrogram"],
                 "ap": o["band_aperiodicity"], "y": o["y"]} for o in outs]

    def caches(self) -> list:
        from world_tpu_torch.parallel import batch as PB
        return [PB.BATCH_GRAPHS]

    def close(self):
        for c in self.caches():
            c.clear()
