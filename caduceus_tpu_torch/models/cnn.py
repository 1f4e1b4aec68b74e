"""GenomicsBenchmark CNN baseline.

Port of `caduceus_tpu/models/cnn.py` (`GenomicsBenchmarkCNN`, `:17`):
embed(100) -> 3 x [valid Conv1d(width 8) + BatchNorm (+ ReLU on the first)
+ MaxPool(2)] -> flatten -> Linear(512) -> Linear(classes), channels last,
with the flax parameter names (``embeddings/embedding``, ``conv_<i>/
kernel`` (K, in, out) and ``bias``, ``bn_<i>/scale``, ``bias`` and the
running ``mean`` / ``var``, ``fc1``, ``fc2``). The convolutions are
shifted products summed over the 8 taps (plain matmuls, fp32 in full
precision on the card; a cuDNN convolution would run fp32 in TF32). The
width of fc1 follows from the sequence length, as flax infers it at init.

BatchNorm as flax's: in training the batch's statistics (mean and the
biased variance E[x²] - E[x]², clipped at 0, in fp32) normalize, and the
running ones move by ``1 - momentum`` (momentum 0.99); in eval the running
statistics normalize.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from caduceus_tpu_torch.models.caduceus import _Embedding

_SPEC = ((16, True), (8, False), (4, False))   # (out channels, relu)
KERNEL = 8


def flat_width(seq_len: int) -> int:
    """fc1's input width for sequences of ``seq_len``."""
    L = seq_len
    for _ in _SPEC:
        L = (L - KERNEL + 1) // 2
    if L < 1:
        raise ValueError(f"sequence length {seq_len} is too short for the "
                         "CNN's three conv + pool stages")
    return L * _SPEC[-1][0]


def _lecun_normal(shape, fan_in, g):
    # flax's default kernel init: variance 1 / fan_in, truncated at 2 std
    std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
    t = torch.empty(shape)
    nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=g)
    return t * std


class BatchNorm(nn.Module):
    def __init__(self, c: int, momentum: float = 0.99, eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("mean", torch.zeros(c))
        self.register_buffer("var", torch.ones(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            xf = x.float()
            axes = tuple(range(x.dim() - 1))
            mean = xf.mean(axes)
            var = torch.clamp((xf * xf).mean(axes) - mean * mean, min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.mean.copy_(m * self.mean + (1 - m) * mean.detach())
                self.var.copy_(m * self.var + (1 - m) * var.detach())
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + self.eps) * self.scale
        return ((x - mean) * mul + self.bias).to(x.dtype)


class Conv(nn.Module):
    """flax `nn.Conv(features, (K,), padding="VALID")` on (B, L, C)."""

    def __init__(self, c_in: int, c_out: int, g: torch.Generator):
        super().__init__()
        self.weight = nn.Parameter(_lecun_normal((KERNEL, c_in, c_out),
                                                 KERNEL * c_in, g))
        self.bias = nn.Parameter(torch.zeros(c_out))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        Lo = x.shape[1] - KERNEL + 1
        y = self.bias
        for k in range(KERNEL):
            y = y + x[:, k:k + Lo] @ self.weight[k]
        return y


class GenomicsBenchmarkCNN(nn.Module):
    """(B, L) ids -> (B, num_classes) fp32 scores."""

    def __init__(self, num_classes: int, seq_len: int, vocab_size: int = 12,
                 embedding_dim: int = 100,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator if generator is not None else torch.Generator()
        self.embeddings = nn.Module()
        self.embeddings.embedding = nn.Parameter(_lecun_normal(
            (vocab_size, embedding_dim), embedding_dim, g))
        c_in = embedding_dim
        for i, (c, _) in enumerate(_SPEC):
            self.add_module(f"conv_{i}", Conv(c_in, c, g))
            self.add_module(f"bn_{i}", BatchNorm(c))
            c_in = c
        width = flat_width(seq_len)
        self.fc1 = nn.Linear(width, 512)
        self.fc2 = nn.Linear(512, num_classes)
        for fc, fan_in in ((self.fc1, width), (self.fc2, 512)):
            with torch.no_grad():
                fc.weight.copy_(_lecun_normal(fc.weight.shape, fan_in, g))
                fc.bias.zero_()

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        x = _Embedding.apply(input_ids, self.embeddings.embedding)
        for i, (_, relu) in enumerate(_SPEC):
            x = getattr(self, f"bn_{i}")(getattr(self, f"conv_{i}")(x))
            if relu:
                x = F.relu(x)
            Lp = x.shape[1] // 2
            x = x[:, :2 * Lp].reshape(x.shape[0], Lp, 2, x.shape[2]).amax(2)
        x = x.reshape(x.shape[0], -1)
        return self.fc2(self.fc1(x)).float()
