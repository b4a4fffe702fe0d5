"""What several reference paths share: a request's frames and cut, the
benchmark's noise draw for a classic synthesis, and the sampled requests
grouped into their buckets' zero-padded rows."""
import numpy as np
import torch


def n_frames(n: int, fs: int, fp: int) -> int:
    return int(1000 * n / fs / fp + 1)


def cut_of(x32: np.ndarray, req) -> np.ndarray:
    return x32[req.offset:req.offset + req.n]


def classic_noise(seed: int, shape: tuple, device) -> torch.Tensor:
    """The benchmark's standard-normal draw for a classic synthesis: float32
    on the card from a generator seeded with ``seed``."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return torch.randn(shape, generator=g, dtype=torch.float32, device=device)


def rows_of(x32, items, L):
    xb = np.zeros((len(items), L), np.float64)
    for r, (req, *_rest) in enumerate(items):
        xb[r, :req.n] = cut_of(x32, req)
    return xb


def by_bucket(items) -> dict:
    groups = {}
    for i, it in enumerate(items):
        groups.setdefault(it[0].bucket, []).append(i)
    return groups


def own_frames(full, got, items, idx, key, fs, fp):
    """The reference's rows ``full`` (B, F, ...) with each request's own
    frames replaced by its output ``key`` in ``got``."""
    rows = full.clone()
    for r, i in enumerate(idx):
        nf = n_frames(items[i][0].n, fs, fp)
        rows[r, :nf] = torch.as_tensor(np.asarray(got[i][key]),
                                       device=full.device).to(full.dtype)
    return rows
