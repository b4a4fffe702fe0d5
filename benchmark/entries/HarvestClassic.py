"""``world_tpu_torch.HarvestClassic``: pyworld's default chain (Harvest ->
CheapTrick -> classic D4C -> classic synthesis) as one module a padded
length, a CUDA graph replay a call once its signature is hot.  Driven as
entries/DioClassic.py drives its module: the benchmark pads a call's rows
to its bucket, draws the synthesis' noise of the module's caps on the card
from the call's seed and passes it as ``noise=``, and copies the outputs
to the host, each utterance's frames and samples."""
import torch

from entries import DioClassic


class System(DioClassic.System):
    def module(self, L: int):
        if L not in self.modules:
            from world_tpu_torch import HarvestClassic
            self.modules[L] = HarvestClassic(
                self.cfg["fs"], L, self.cfg["frame_period_ms"],
                dtype=torch.float32, device=self.device)
        return self.modules[L]

    def noise(self, call) -> torch.Tensor:
        _, P, N = self.module(call.length).caps()
        self.gen.manual_seed(call.noise_seed)
        return torch.randn((call.rows, P, N), generator=self.gen,
                           dtype=torch.float32, device=self.device)
