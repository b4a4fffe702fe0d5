"""The hand-written CUDA kernels' wrappers: K1 (edge_interp, the event
engine), K2 (refine_dft, Harvest refinement), K3 (extension_scan, DIO's
FixStep3 and FixStep4), K4 and K5 (fix_step3, Harvest's FixStep3: the
extension chains and the merge), K6 and K7 (d4c_spectra, D4C's centroid
spectra and band aperiodicity), K8 (classic_pulses, the classic synthesis'
pulse responses and overlap-add), and the arithmetic their plain versions
share with the rest of the package."""
import torch


def prod_diff(a, b, c, d):
    """a*b - c*d; float32 inputs are evaluated in float64 (the compensated
    instantaneous-frequency numerator of world_tpu/ops/__init__.py::prod_diff,
    used by Harvest's refinement and by StoneMask)."""
    if a.dtype == torch.float32:
        return (a.double() * b.double() - c.double() * d.double()).float()
    return a * b - c * d
