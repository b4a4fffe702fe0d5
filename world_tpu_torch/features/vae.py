"""The voice-conversion VAE's dense networks (port of
world_tpu/features/vae.py): an ``nn.Module`` of ``nn.Linear`` layers with a
Keras-like ``predict``, loaded from Keras h5 weight files by h5py alone or
from a list of numpy weights."""
import json

import numpy as np
import torch
from torch import nn

from .._backend import resolve_device, torch_dtype

_ACTIVATIONS = {
    "relu": torch.relu,
    "linear": lambda x: x,
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "softplus": nn.functional.softplus,
    "elu": nn.functional.elu,
}


class MLP(nn.Module):
    """A dense MLP with a Keras-like ``predict`` API.

    ``weights`` is a list of (kernel (in, out), bias (out,)) numpy pairs in
    Keras's layout; each kernel is transposed into its ``nn.Linear``.  The
    working type is ``dtype``, or the first kernel's when None.  The module
    lives on ``device`` (the GPU unless the CPU is asked for)."""

    def __init__(self, weights, activations, dtype=None, device=None):
        super().__init__()
        weights = [(np.asarray(w), np.asarray(b)) for w, b in weights]
        self.activations = list(activations)
        for act in self.activations:
            if act not in _ACTIVATIONS:
                raise ValueError(f"unknown activation {act!r}")
        if dtype is None:
            dtype = torch_dtype(weights[0][0].dtype)
        dev = resolve_device(device)
        self.layers = nn.ModuleList()
        for w, b in weights:
            layer = nn.Linear(w.shape[0], w.shape[1], dtype=dtype, device=dev)
            with torch.no_grad():
                layer.weight.copy_(torch.tensor(w.T))
                layer.bias.copy_(torch.tensor(b))
            self.layers.append(layer)

    @classmethod
    def from_numpy_state(cls, weights, activations, dtype=None, device=None):
        """An MLP from the (kernel, bias) list of another package's MLP
        (world_tpu.features.vae.MLP.weights, as numpy) and its activations."""
        return cls(weights, activations, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer, act in zip(self.layers, self.activations):
            x = _ACTIVATIONS[act](layer(x))
        return x

    @torch.no_grad()
    def predict(self, X, batch_size=None) -> np.ndarray:
        """Numpy in, numpy out; the whole batch goes through at once."""
        del batch_size
        p = self.layers[0].weight
        x = torch.as_tensor(np.asarray(X), dtype=p.dtype, device=p.device)
        return self.forward(x).cpu().numpy()

    @classmethod
    def from_keras_h5(cls, path, dtype=None, device=None):
        """Load a sequential Dense Keras model saved in h5 format."""
        import h5py

        with h5py.File(path, "r") as f:
            cfg = json.loads(f.attrs["model_config"])
            layer_cfgs = cfg["config"]["layers"] if isinstance(
                cfg["config"], dict) else cfg["config"]
            weights, acts = [], []
            mw = f["model_weights"]
            for layer in layer_cfgs:
                if layer["class_name"] != "Dense":
                    continue
                name = layer["config"]["name"]
                g = mw[name][name]
                weights.append((np.asarray(g["kernel:0"]),
                                np.asarray(g["bias:0"])))
                acts.append(layer["config"]["activation"])
        return cls.from_numpy_state(weights, acts, dtype=dtype, device=device)


def load_manifold_vae(encoder_path, decoder_path, dtype=None, device=None):
    """(encoder, decoder) MLPs for World.encode_vae."""
    return (MLP.from_keras_h5(encoder_path, dtype, device),
            MLP.from_keras_h5(decoder_path, dtype, device))
