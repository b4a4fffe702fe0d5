"""``world_tpu_torch.DioClassic``: the classic round trip (DIO -> StoneMask ->
CheapTrick -> D4C -> classic synthesis) as one module a padded length, a
CUDA graph replay a call once its signature is hot.  The benchmark pads a
call's rows to its bucket, draws the synthesis' noise on the card from the
call's seed and passes it as ``noise=``, and copies the outputs to the host,
each utterance's frames and samples, as a caller of the module does."""
import numpy as np
import torch


class System:
    def __init__(self, cfg: dict, x32: np.ndarray, device):
        self.cfg, self.x32, self.device = cfg, x32, torch.device(device)
        self.modules = {}
        self.gen = torch.Generator(device=self.device)

    def module(self, L: int):
        if L not in self.modules:
            from world_tpu_torch import DioClassic
            self.modules[L] = DioClassic(self.cfg["fs"], L,
                                         self.cfg["frame_period_ms"],
                                         dtype=torch.float32, device=self.device)
        return self.modules[L]

    def rows(self, call) -> torch.Tensor:
        xb = np.zeros((call.rows, call.length), np.float32)
        for r, q in enumerate(call.requests):
            xb[r, :q.n] = self.x32[q.offset:q.offset + q.n]
        return torch.from_numpy(xb).to(self.device)

    def noise(self, call) -> torch.Tensor:
        from world_tpu_torch.parallel.batch import classic_caps
        _, P, N = classic_caps(call.length, self.cfg["fs"],
                               self.cfg["frame_period_ms"])
        self.gen.manual_seed(call.noise_seed)
        return torch.randn((call.rows, P, N), generator=self.gen,
                           dtype=torch.float32, device=self.device)

    def call(self, call) -> list:
        fs, fp = self.cfg["fs"], self.cfg["frame_period_ms"]
        out = self.module(call.length)(self.rows(call), noise=self.noise(call))
        host = {k: out[k].cpu().numpy()
                for k in ("f0", "vuv", "spectrogram", "aperiodicity", "y")}
        res = []
        for r, q in enumerate(call.requests):
            nf = int(1000 * q.n / fs / fp + 1)
            ny = int(np.floor((nf - 1) * fp / 1000 * fs)) + 1
            res.append({"f0": host["f0"][r, :nf], "vuv": host["vuv"][r, :nf],
                        "sp": host["spectrogram"][r, :, :nf].T,
                        "ap": host["aperiodicity"][r, :, :nf].T,
                        "y": host["y"][r, :ny]})
        return res

    def caches(self) -> list:
        return [m.graphs for m in self.modules.values()]

    def close(self):
        for c in self.caches():
            c.clear()
        self.modules.clear()
