"""Short causal depthwise convolution (the Mamba conv prologue).

Port of `caduceus_tpu/ops/conv.py`, written as explicit shifted sums: a
cuDNN convolution would run fp32 in TF32 by default
(`torch.backends.cudnn.allow_tf32`), and at width 4 the sum is K
multiply-adds anyway. This is the conv stage of the plain SSD version
(`ops/ssd.py ssd_chunked_fused`; on the card the v2 conv runs inside the
`ssd_fused_fwd` kernel) and the v1 mixer's conv on both devices
(`models/mamba.py`), where JAX too runs it outside the scan kernel.

Layout: (..., L, d) with channels last.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def causal_conv1d(
    x: torch.Tensor,                       # (..., L, d)
    weight: torch.Tensor,                  # (K, d): tap K-1 is the current row
    bias: Optional[torch.Tensor] = None,   # (d,)
    activation: Optional[str] = "silu",
    reverse: bool = False,
    halo: Optional[torch.Tensor] = None,   # (..., K-1, d)
) -> torch.Tensor:
    """y[t] = sum_k w[k] * x[t - (K-1-k)] (+ bias), zeros before the start.

    ``reverse=True`` is the anti-causal conv ``flip(causal(flip(x)))``:
    tap k reads x[t + (K-1-k)], zeros past the end.

    ``halo``: the K-1 rows before x (after it when ``reverse``) in place of
    those zeros: a context-parallel shard's neighbour rows
    (`parallel/comm.py halo_shift`), so that each shard's conv equals its
    rows of the conv of the whole sequence (the JAX package's global conv
    on sequence-sharded activations, whose halo XLA exchanges). Autograd
    carries the halo rows' gradient back.
    """
    K = weight.shape[0]
    if halo is not None and K > 1:
        L = x.shape[-2]
        ext = torch.cat([x, halo] if reverse else [halo, x], dim=-2)
        y = causal_conv1d(ext, weight, bias, activation, reverse)
        return y[..., :L, :] if reverse else y[..., K - 1:, :]
    L = x.shape[-2]
    acc = x * weight[K - 1]
    for k in range(K - 1):
        shift = K - 1 - k
        if shift >= L:
            continue
        if reverse:
            shifted = F.pad(x[..., shift:, :], (0, 0, 0, shift))
        else:
            shifted = F.pad(x[..., :L - shift, :], (0, 0, shift, 0))
        acc = acc + shifted * weight[k]
    if bias is not None:
        acc = acc + bias
    if activation == "silu":
        acc = F.silu(acc)
    elif activation is not None:
        raise NotImplementedError(activation)
    return acc
