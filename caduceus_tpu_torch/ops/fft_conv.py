"""FFT long convolution of the Hyena operator.

Port of `caduceus_tpu/ops/fft_conv.py`: the causal (linear, not circular)
convolution of u with a per-channel filter k through zero-padded real FFTs
of length 2L in fp32, plus the residual term ``u * D`` and an optional
GELU. The JAX package runs this FFT in XLA, outside any Pallas kernel; here
it is `torch.fft` (cuFFT on the card), as a plain product is
`torch.matmul`. Layout: (..., L, d) channels last.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def fft_conv(u: torch.Tensor, k: torch.Tensor,
             D: Optional[torch.Tensor] = None,
             gelu: bool = False) -> torch.Tensor:
    """y[t, c] = sum_{s <= t} k[t - s, c] u[s, c] (+ D[c] u[t, c]), with
    u (..., L, d), k (L, d) and D (d,); returned in u's dtype."""
    dtype = u.dtype
    L = u.shape[-2]
    n = 2 * L
    uf = torch.fft.rfft(u.float(), n=n, dim=-2)
    kf = torch.fft.rfft(k.float(), n=n, dim=-2)
    y = torch.fft.irfft(uf * kf, n=n, dim=-2)[..., :L, :]
    if D is not None:
        y = y + u.float() * D.float()
    if gelu:
        y = F.gelu(y, approximate="tanh")   # jax.nn.gelu's default
    return y.to(dtype)
