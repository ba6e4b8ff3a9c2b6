"""Seeded rows of the benchmark's deployments, made in a few large torch
calls on the device that scores them.

Each generator is a rewrite of the JAX package's synthetic set of the same
name (``isoforest_tpu/data.py``), kept independent of it: the same mixture
and the same outlier share, drawn from a ``torch.Generator`` instead of
NumPy's, so that ten million rows take milliseconds on the card. A stream
name (``"train"``, ``"score"``, ``"basis"``) separates the draws of one seed,
so the training table and the scored rows never share a draw.
"""

from __future__ import annotations

import zlib

import numpy as np
import torch


def sub_seed(seed: int, *stream: str) -> int:
    """A 63-bit seed for one named stream of ``seed`` (any whole number)."""
    words = [int(seed) & 0xFFFFFFFF, (int(seed) >> 32) & 0xFFFFFFFF, *(zlib.crc32(s.encode()) for s in stream)]
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0] >> np.uint64(1))


def generator(seed: int, stream: str, device) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` for one stream of ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, stream))
    return gen


def _mixture(parts, gen: torch.Generator, device) -> torch.Tensor:
    """Rows of a Gaussian mixture with fixed counts: ``parts`` is a list of
    ``(count, mean [F], cholesky factor [F, F] or scale)``; the rows are
    shuffled by one permutation."""
    chunks = []
    for count, mean, factor in parts:
        if count == 0:
            continue
        z = torch.randn((count, len(mean)), generator=gen, device=device, dtype=torch.float64)
        factor = torch.as_tensor(factor, dtype=torch.float64, device=device)
        z = z @ factor.T if factor.dim() == 2 else z * factor
        chunks.append(z + torch.as_tensor(mean, dtype=torch.float64, device=device))
    rows = torch.cat(chunks).to(torch.float32)
    return rows[torch.randperm(rows.shape[0], generator=gen, device=device)]


# the KDDCup99-HTTP mixture of isoforest_tpu/data.py::kddcup_http_hard:
# log-scaled duration, source bytes and destination bytes
_HTTP_COV = np.array([[0.6, 0.1, 0.0], [0.1, 1.2, 0.3], [0.0, 0.3, 1.5]])


def kddcup_http_hard(n: int, *, seed: int, stream: str, device, contamination: float = 0.004) -> torch.Tensor:
    """KDDCup99-HTTP-like rows ``f32[n, 3]``: 1 - contamination of them in
    the normal cloud, half the attacks loud (far off, wide) and half
    stealthy (the normal covariance at about two sigma), so that no forest
    separates them perfectly."""
    gen = generator(seed, stream, device)
    n_out = int(n * contamination)
    n_loud = n_out // 2
    chol = np.linalg.cholesky(_HTTP_COV)
    return _mixture([
        (n - n_out, [0.0, 5.2, 8.0], chol),
        (n_loud, [4.5, 9.5, 2.0], np.sqrt(2.0)),
        (n_out - n_loud, [1.4, 6.9, 9.9], chol),
    ], gen, device)


def high_dim_blobs(n: int, *, seed: int, stream: str, device, num_features: int = 274,
                   contamination: float = 0.02, latent: int = 16, outlier_scale: float = 1.8,
                   noise: float = 0.1) -> torch.Tensor:
    """Correlated wide rows ``f32[n, num_features]`` (the Arrhythmia shape of
    ``isoforest_tpu/data.py::high_dim_blobs``): ``latent`` normal factors
    through one basis shared by every stream of ``seed``, the outliers' factors
    ``outlier_scale`` times wider, plus independent noise."""
    basis = torch.randn((latent, num_features), generator=generator(seed, "basis", device), device=device)
    gen = generator(seed, stream, device)
    n_out = int(n * contamination)
    z = torch.randn((n, latent), generator=gen, device=device)
    z[n - n_out:] *= outlier_scale
    rows = torch.zeros((n, num_features), dtype=torch.float32, device=device)
    # float32 products without TF32, in row blocks that bound the temporaries
    block = 1 << 18
    for start in range(0, n, block):
        stop = min(start + block, n)
        rows[start:stop] = torch.mm(z[start:stop].double(), basis.double()).float()
    rows += noise * torch.randn((n, num_features), generator=gen, device=device)
    return rows[torch.randperm(n, generator=gen, device=device)]


GENERATORS = {"kddcup_http_hard": kddcup_http_hard, "high_dim_blobs": high_dim_blobs}


def make_rows(data: dict, n: int, *, seed: int, stream: str, device) -> torch.Tensor:
    """``n`` rows of the configuration's ``data`` block (``{"generator":
    name, **parameters}``) for one stream of ``seed``, on ``device``."""
    params = {k: v for k, v in data.items() if k != "generator"}
    return GENERATORS[data["generator"]](int(n), seed=seed, stream=stream, device=device, **params)
