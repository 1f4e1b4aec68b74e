"""Weights made from the seed, on the device, in fp32: one uniform and one
normal draw of every parameter's size from a `torch.Generator` on the
device, cut by parameter name into the published initialisations (torch's
linear default U(±1/sqrt(fan_in)), the GPT-2 rescale of the output
projections, mamba-ssm's dt bias and dt_proj, S4D-real A for Mamba-1 and
A in U(1, 16) for Mamba-2, ones for norms and D, N(0, 0.02) for the
embedding). The same dict is handed to the program and to the reference.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, Tuple

import torch


def _fan_bound(name: str, shape, cfg: dict) -> float:
    s = cfg["ssm_cfg"]
    leaf = name.rsplit(".", 1)[-1]
    if name.endswith("in_proj.weight") or name.endswith("out_proj.weight"):
        b = 1 / math.sqrt(shape[1])
        if name.endswith("out_proj.weight"):
            b /= math.sqrt(cfg["n_layer"])
        return b
    if leaf in ("conv_w", "conv_b"):
        return 1 / math.sqrt(s.get("d_conv", 4))
    if leaf == "x_proj_w":
        return 1 / math.sqrt(shape[0])
    if leaf == "dt_proj_w":
        return shape[0] ** -0.5
    if name.startswith("decoder.output_transform."):
        return 1 / math.sqrt(cfg["d_model"])
    raise KeyError(f"no initialisation rule for {name}")


def make_weights(named_shapes: Iterable[Tuple[str, tuple]], cfg: dict,
                 seed: int, device) -> Dict[str, torch.Tensor]:
    """{name: fp32 tensor on ``device``} for the parameters ``named_shapes``
    of a model of configuration ``cfg``, drawn from ``seed``."""
    named = [(n, tuple(s)) for n, s in named_shapes]
    total = sum(math.prod(s) for _, s in named)
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (2 ** 63))
    uni = torch.rand(total, generator=g, device=device)
    nor = torch.randn(total, generator=g, device=device)
    s = cfg["ssm_cfg"]
    out, off = {}, 0
    for name, shape in named:
        n = math.prod(shape)
        u = uni[off:off + n].view(shape)
        z = nor[off:off + n].view(shape)
        off += n
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "embedding":
            w = 0.02 * z
        elif leaf in ("norm_w", "norm_f_w", "D"):
            w = torch.ones(shape, device=device)
        elif leaf in ("dt_proj_b", "dt_bias"):
            lo, hi = math.log(s.get("dt_min", 1e-3)), math.log(
                s.get("dt_max", 0.1))
            dt = torch.exp(u * (hi - lo) + lo).clamp(
                min=s.get("dt_init_floor", 1e-4))
            w = dt + torch.log(-torch.expm1(-dt))
        elif leaf == "A_log":
            if s["version"] == 1:
                w = torch.log(torch.arange(1, shape[1] + 1, device=device,
                                           dtype=torch.float32)).expand(
                    shape).clone()
            else:
                w = torch.log(1 + 15 * u)
        else:
            b = _fan_bound(name, shape, cfg)
            w = (2 * u - 1) * b
        out[name] = w.contiguous()
    return out
