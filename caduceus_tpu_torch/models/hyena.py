"""The Hyena family: HyenaDNA's long-convolution LM with hybrid attention.

Port of `caduceus_tpu/models/hyena.py`: `HyenaFilter` (`:33`),
`HyenaOperator` (`:106`), `Mlp` (`:178`), `MHA` (`:198`),
`HyenaLMBackbone` (`:229`) and `HyenaLMHeadModel` (`:299`), with the flax
parameter names as module and parameter names (`params.py` maps them:
``backbone/mixer_1/Wqkv/kernel`` is ``backbone.mixer_1.Wqkv.weight``,
transposed). Layout (B, L, d) channels last; the FFT long convolution is
`ops/fft_conv.py`, the short causal conv `ops/conv.py causal_conv1d`, and
the MHA layers run `ops/attention.py mha_attention` (the flash-attention
kernels on a CUDA tensor). Dense layers compute in the model's ``dtype``
over fp32 parameters, LayerNorm takes its statistics in fp32, GELU is the
tanh approximation (`jax.nn.gelu(approximate=True)`).

Dropout. The forward takes a ``dropout_key`` (a tuple of ints, e.g. (seed,
step, micro-batch) from the train step); without one nothing is dropped.
Each dropout site draws its mask from a `torch.Generator` seeded at the
call from the key, the layer and the site (`dropout`), so that a
``checkpoint_mixer`` / ``checkpoint_mlp`` recompute (`torch.utils.
checkpoint`, which restores the global RNG, not an explicit generator)
draws the same mask, and a resumed run draws the masks it drew before. The
bits are not JAX's: keep rate and scaling are (flax `Dropout`: keep with
probability 1 - p, scale by 1 / (1 - p)).

Tensor parallelism (`parallel/sharding.py shard_module_`, which cuts the
parameters and sets ``tp_axis_name`` on the operator, MHA and MLP modules;
the JAX package's Megatron specs through `Trainer(tensor_parallel=True)`):
each rank runs its d / M channels of the operator (``in_proj``'s
``order + 1`` blocks column-parallel, the short filter, the long-conv
filter and its bias, whose MLP runs whole on every rank with its
parameters entering through `comm.copy_to_axis`, and the FFT conv on its
channels), its H / M heads of an MHA (``Wqkv`` cut by heads, the
flash-attention kernels at H / M heads) and its slice of the MLP's hidden
units (``fc1`` column-, ``fc2`` row-parallel); ``out_proj`` and ``fc2``
sum the ranks' partial products (`comm.row_parallel_linear`). A dropout
site inside the operator draws the mask of the whole tensor and keeps its
channels, so a rank drops what one rank drops.
"""

from __future__ import annotations

import hashlib
import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from caduceus_tpu_torch import resolve_device
from caduceus_tpu_torch.models.activations import get_activation
from caduceus_tpu_torch.models.caduceus import _Embedding
from caduceus_tpu_torch.models.mamba import torch_linear_init
from caduceus_tpu_torch.ops.attention import mha_attention
from caduceus_tpu_torch.ops.conv import causal_conv1d
from caduceus_tpu_torch.ops.fft_conv import fft_conv
from caduceus_tpu_torch.ops.norms import layer_norm
from caduceus_tpu_torch.parallel.comm import copy_to_axis, row_parallel_linear
from caduceus_tpu_torch.parallel.mesh import mesh_axis

# the dropout sites of a layer (the last element of a site's key)
SITE_MIXER, SITE_RESID1, SITE_RESID2 = 0, 1, 2
EMBED_LAYER = -1


def dropout_generator(key: Tuple[int, ...], device) -> torch.Generator:
    """A generator on ``device`` seeded from the ints of ``key``."""
    digest = hashlib.blake2b(repr(tuple(int(k) for k in key)).encode(),
                             digest_size=8).digest()
    seed = int.from_bytes(digest, "little") & ((1 << 63) - 1)
    return torch.Generator(device=device).manual_seed(seed)


def dropout(x: torch.Tensor, p: float,
            key: Optional[Tuple[int, ...]],
            part: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Keep each element with probability 1 - p and scale it by 1 / (1 - p)
    (flax `Dropout`), the mask drawn from `dropout_generator(key)`; x
    itself when ``key`` is None or p is 0. ``part`` = (the whole last
    dimension, this tensor's first column in it): ``x`` is a slice of the
    last dimension, and takes its columns of the whole tensor's mask."""
    if key is None or p == 0.0:
        return x
    if p >= 1.0:
        return torch.zeros_like(x)
    g = dropout_generator(key, x.device)
    if part is None:
        keep = torch.rand(x.shape, generator=g, device=x.device) >= p
    else:
        whole, start = part
        keep = (torch.rand((*x.shape[:-1], whole), generator=g,
                           device=x.device)
                [..., start:start + x.shape[-1]] >= p)
    return torch.where(keep, x / (1.0 - p), torch.zeros((), dtype=x.dtype,
                                                        device=x.device))


def _sub(key, *more):
    return None if key is None else (*key, *more)


class Dense(nn.Module):
    """flax `nn.Dense` with ``torch_linear_init`` kernel and bias: ``y = x
    @ Wᵀ + b`` in ``dtype``; ``weight`` (out, in), the transposed flax
    kernel."""

    def __init__(self, in_features: int, out_features: int, bias: bool,
                 generator: torch.Generator):
        super().__init__()
        self.weight = nn.Parameter(torch_linear_init(
            torch.empty(out_features, in_features), in_features, generator))
        self.bias = (nn.Parameter(torch_linear_init(
            torch.empty(out_features), in_features, generator))
            if bias else None)

    def forward(self, x: torch.Tensor,
                dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        dtype = x.dtype if dtype is None else dtype
        y = x.to(dtype) @ self.weight.to(dtype).t()
        if self.bias is not None:
            y = y + self.bias.to(dtype)
        return y

    def row_parallel(self, x: torch.Tensor, dtype: torch.dtype, axis):
        """The layer with its input features cut over ``axis`` (this rank's
        weight columns; the bias whole)."""
        return row_parallel_linear(x, self.weight, self.bias, dtype, axis)


def _tp(module):
    """The tensor-parallel axis of a module (`shard_module_`), or None."""
    return mesh_axis(module.tp_axis_name, "tp_axis_name")


def _out(dense: Dense, x, dtype, tp):
    return dense(x, dtype) if tp is None else dense.row_parallel(x, dtype, tp)


class LayerNorm(nn.Module):
    """flax `nn.LayerNorm`: ``scale`` and ``bias``, statistics in fp32, the
    output in the input's dtype."""

    def __init__(self, d: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(d))
        self.bias = nn.Parameter(torch.zeros(d))

    def forward(self, x):
        return layer_norm(x, self.scale, self.bias, eps=self.eps)


def _pos_features(L: int, emb_dim: int):
    """(z, t): the (L, emb_dim) complex-exponential features and the (L,
    1) normalized time of `caduceus_tpu/models/hyena.py:49-59`."""
    t = torch.linspace(0.0, 1.0, L, dtype=torch.float64)[:, None]
    bands = (emb_dim - 1) // 2
    t_rescaled = torch.linspace(0.0, L - 1, L, dtype=torch.float64)[:, None]
    w = 2 * math.pi * t_rescaled / L
    f = torch.linspace(1e-4, bands - 1, bands, dtype=torch.float64)[None, :]
    angle = f * w
    z = torch.cat([t, torch.cos(-angle), torch.sin(-angle)], dim=-1)
    return z.float(), t.float()


class HyenaFilter(nn.Module):
    """Implicit filter: a sin-activated MLP over positional features with
    exponential decay modulation. ``forward(L)`` returns (k (L, d_output),
    bias (d_output,)); only the first L rows are computed (the rows are
    independent)."""

    def __init__(self, d_output: int, seq_len: int, emb_dim: int = 3,
                 filter_order: int = 64, num_inner_mlps: int = 2,
                 w: float = 1.0, modulate: bool = True,
                 normalized: bool = False, fast_decay_pct: float = 0.3,
                 slow_decay_pct: float = 1.5, target: float = 1e-2,
                 shift: float = 0.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if emb_dim % 2 != 1 or emb_dim < 3:
            raise ValueError(f"emb_dim={emb_dim}: odd and at least 3")
        g = generator if generator is not None else torch.Generator()
        self.num_inner_mlps = num_inner_mlps
        self.modulate, self.normalized, self.shift = modulate, normalized, shift
        z, t = _pos_features(seq_len, emb_dim)
        self.pos_emb_z = nn.Parameter(z)   # trainable in the reference
        self.register_buffer("t", t, persistent=False)
        self.sin_freq = nn.Parameter(torch.full((filter_order,), float(w)))
        self.mlp_in = Dense(emb_dim, filter_order, True, g)
        for i in range(num_inner_mlps):
            self.add_module(f"mlp_{i}", Dense(filter_order, filter_order,
                                              True, g))
        self.mlp_out = Dense(filter_order, d_output, False, g)
        if modulate:
            max_decay = math.log(target) / fast_decay_pct
            min_decay = math.log(target) / slow_decay_pct
            self.deltas = nn.Parameter(torch.linspace(
                min_decay, max_decay, d_output, dtype=torch.float64)
                .float()[None, :])
        self.bias = nn.Parameter(torch.randn(d_output, generator=g))

    def forward(self, L: int) -> Tuple[torch.Tensor, torch.Tensor]:
        h = torch.sin(self.sin_freq * self.mlp_in(self.pos_emb_z[:L]))
        for i in range(self.num_inner_mlps):
            h = torch.sin(self.sin_freq * getattr(self, f"mlp_{i}")(h))
        h = self.mlp_out(h)
        if self.modulate:
            decay = torch.exp(-self.t[:L] * torch.abs(self.deltas))
            h = h * (decay + self.shift)
        if self.normalized:
            h = h / torch.sum(torch.abs(h), dim=-1, keepdim=True)
        return h, self.bias


class HyenaOperator(nn.Module):
    """The Hyena mixer (order 2 by default): in_proj, the short causal conv
    (width ``short_filter_order``, no activation), the implicit long filter
    through `fft_conv` with recurrence dropout, out_proj. The projection's
    channels split "l (v o)": x_0 .. x_{order-1}, v; the filter's channels
    are (d, order - 1), channel-major."""

    def __init__(self, d_model: int, l_max: int, order: int = 2,
                 filter_order: int = 64, short_filter_order: int = 3,
                 emb_dim: int = 3, filter_w: float = 1.0,
                 modulate: bool = True, activation: str = "id",
                 dropout: float = 0.0, filter_dropout: float = 0.0,
                 dtype: str = "float32",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator if generator is not None else torch.Generator()
        d = d_model
        self.d_model, self.l_max, self.order = d, l_max, order
        self.activation, self.dropout = activation, dropout
        self.dtype = getattr(torch, dtype)
        width = (order + 1) * d
        K = short_filter_order
        self.in_proj = Dense(d, width, True, g)
        self.short_filter_w = nn.Parameter(torch_linear_init(
            torch.empty(K, width), K, g))
        self.short_filter_b = nn.Parameter(torch_linear_init(
            torch.empty(width), K, g))
        self.filter_fn = HyenaFilter(d * (order - 1), l_max, emb_dim=emb_dim,
                                     filter_order=filter_order, w=filter_w,
                                     modulate=modulate, generator=g)
        self.out_proj = Dense(d, d, True, g)
        self.tp_axis_name: Optional[str] = None

    def forward(self, u: torch.Tensor, key=None) -> torch.Tensor:
        d, order, dt = self.d_model, self.order, self.dtype
        tp = _tp(self)
        u = u.to(dt)
        lf = min(u.shape[-2], self.l_max)
        u_proj = self.in_proj(u if tp is None else copy_to_axis(u, tp), dt)
        uc = causal_conv1d(u_proj, self.short_filter_w.to(dt),
                           self.short_filter_b.to(dt), activation=None)
        dl = u_proj.shape[-1] // (order + 1)      # this rank's channels
        *xs, v = torch.split(uc[..., :lf, :], dl, dim=-1)
        if tp is None:
            k_all, bias_all = self.filter_fn(lf)
        else:
            # the filter MLP whole on every rank, its parameters' gradients
            # (partial: each rank uses its channels) summed over the axis
            params = {n: copy_to_axis(p, tp)
                      for n, p in self.filter_fn.named_parameters()}
            k_all, bias_all = torch.func.functional_call(
                self.filter_fn, params, (lf,))
        c0 = 0 if tp is None else tp.rank * dl
        k_all = k_all.reshape(lf, d, order - 1)[:, c0:c0 + dl]
        bias_all = bias_all.reshape(d, order - 1)[c0:c0 + dl]
        part = None if tp is None else (d, c0)
        for o, x_i in enumerate(reversed(xs[1:])):
            v = dropout(v * x_i, self.dropout, _sub(key, SITE_MIXER, o), part)
            v = fft_conv(v, k_all[:, :, o].float(), bias_all[:, o]).to(dt)
        y = get_activation(self.activation)(v * xs[0])
        return _out(self.out_proj, y, dt, tp)


class Mlp(nn.Module):
    """GPT-2 MLP: fc1 (expand x) -> tanh GELU -> fc2."""

    def __init__(self, d_model: int, expand: int = 4, dtype: str = "float32",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator if generator is not None else torch.Generator()
        self.dtype = getattr(torch, dtype)
        self.fc1 = Dense(d_model, expand * d_model, True, g)
        self.fc2 = Dense(expand * d_model, d_model, True, g)
        self.tp_axis_name: Optional[str] = None

    def forward(self, x):
        tp = _tp(self)
        h = F.gelu(self.fc1(x if tp is None else copy_to_axis(x, tp),
                            self.dtype), approximate="tanh")
        return _out(self.fc2, h, self.dtype, tp)


class MHA(nn.Module):
    """Multi-head attention of the hybrid layers: Wqkv, `mha_attention`
    (the flash-attention kernels on a CUDA tensor), output dropout, out_proj.
    The output dropout rate is the JAX field's default, which
    `HyenaLMBackbone` never overrides (`caduceus_tpu/models/hyena.py:279`),
    so the site draws nothing."""

    dropout = 0.0

    def __init__(self, d_model: int, num_heads: int = 8, causal: bool = True,
                 dtype: str = "float32",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if d_model % num_heads:
            raise ValueError(f"d_model {d_model} not divisible by "
                             f"num_heads {num_heads}")
        g = generator if generator is not None else torch.Generator()
        self.num_heads, self.causal = num_heads, causal
        self.dtype = getattr(torch, dtype)
        self.Wqkv = Dense(d_model, 3 * d_model, True, g)
        self.out_proj = Dense(d_model, d_model, True, g)
        self.tp_axis_name: Optional[str] = None

    def forward(self, x: torch.Tensor, key=None) -> torch.Tensor:
        B, L, d = x.shape
        tp = _tp(self)
        hd = d // self.num_heads
        qkv = self.Wqkv(x if tp is None else copy_to_axis(x, tp), self.dtype)
        dl = qkv.shape[-1] // 3                   # this rank's heads
        q, k, v = qkv.split(dl, dim=-1)
        H = dl // hd
        out = mha_attention(q.reshape(B, L, H, hd), k.reshape(B, L, H, hd),
                            v.reshape(B, L, H, hd), causal=self.causal)
        out = dropout(out.reshape(B, L, dl), self.dropout,
                      _sub(key, SITE_MIXER),
                      None if tp is None else (d, tp.rank * dl))
        return _out(self.out_proj, out, self.dtype, tp)


class HyenaLMBackbone(nn.Module):
    """GPT-2-style backbone: token (and optional learned positional)
    embeddings, embedding dropout, prenorm blocks ``h + drop(mixer(ln1 h))``,
    ``h + drop(mlp(ln2 h))`` with a Hyena or (at ``attn_layer_idx``) MHA
    mixer, final LayerNorm. ``checkpoint_mixer`` / ``checkpoint_mlp``
    recompute the branch in the backward (`torch.utils.checkpoint`, as
    flax `nn.remat`). ``forward(ids, dropout_key)`` returns (h, embedding
    table)."""

    def __init__(self, d_model: int, n_layer: int, vocab_size: int,
                 l_max: int, attn_layer_idx: Sequence[int] = (),
                 num_heads: int = 8, max_position_embeddings: int = 0,
                 layer_norm_epsilon: float = 1e-5,
                 hyena_kwargs: Optional[dict] = None,
                 embed_dropout: float = 0.1, resid_dropout: float = 0.0,
                 checkpoint_mixer: bool = False, checkpoint_mlp: bool = False,
                 dtype: str = "float32",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator if generator is not None else torch.Generator()
        self.n_layer = n_layer
        self.embed_dropout, self.resid_dropout = embed_dropout, resid_dropout
        self.checkpoint_mixer, self.checkpoint_mlp = (checkpoint_mixer,
                                                      checkpoint_mlp)
        self.dtype = getattr(torch, dtype)
        self.embedding = nn.Parameter(
            torch.empty(vocab_size, d_model).normal_(0.0, 0.02, generator=g))
        self.pos_embedding = (nn.Parameter(
            torch.empty(max_position_embeddings, d_model).normal_(
                0.0, 0.02, generator=g))
            if max_position_embeddings > 0 else None)
        hk = hyena_kwargs or {}
        attn = set(int(i) for i in attn_layer_idx)
        for i in range(n_layer):
            self.add_module(f"ln1_{i}", LayerNorm(d_model, layer_norm_epsilon))
            self.add_module(f"ln2_{i}", LayerNorm(d_model, layer_norm_epsilon))
            mixer = (MHA(d_model, num_heads, dtype=dtype, generator=g)
                     if i in attn else
                     HyenaOperator(d_model, l_max, dtype=dtype, generator=g,
                                   **hk))
            self.add_module(f"mixer_{i}", mixer)
            self.add_module(f"mlp_{i}", Mlp(d_model, dtype=dtype,
                                            generator=g))
        self.ln_f = LayerNorm(d_model, layer_norm_epsilon)

    def forward(self, input_ids: torch.Tensor, dropout_key=None):
        dt = self.dtype
        h = _Embedding.apply(input_ids, self.embedding.to(dt))
        if self.pos_embedding is not None:
            h = h + self.pos_embedding.to(dt)[None, :h.shape[1]]
        h = dropout(h, self.embed_dropout, _sub(dropout_key, EMBED_LAYER, 0))
        grad = torch.is_grad_enabled()
        for i in range(self.n_layer):
            mixer, mlp = getattr(self, f"mixer_{i}"), getattr(self, f"mlp_{i}")
            x = getattr(self, f"ln1_{i}")(h)
            key = _sub(dropout_key, i)
            y = (checkpoint(mixer, x, key, use_reentrant=False)
                 if self.checkpoint_mixer and grad else mixer(x, key))
            h = h + dropout(y, self.resid_dropout, _sub(key, SITE_RESID1))
            x = getattr(self, f"ln2_{i}")(h)
            y = (checkpoint(mlp, x, use_reentrant=False)
                 if self.checkpoint_mlp and grad else mlp(x))
            h = h + dropout(y, self.resid_dropout, _sub(key, SITE_RESID2))
        return self.ln_f(h), self.embedding


class HyenaLMHeadModel(nn.Module):
    """Backbone + LM head tied to the embedding table; fp32 logits. Takes
    the JAX model's fields as keyword arguments (the ``model_config.json``
    of a Hyena run, less ``model_type``, ``objective`` and ``lr``), plus
    ``device`` and ``generator``."""

    def __init__(self, d_model: int, n_layer: int, vocab_size: int,
                 l_max: int, device="cuda",
                 generator: Optional[torch.Generator] = None, **kw):
        super().__init__()
        dev = resolve_device(device)
        self.backbone = HyenaLMBackbone(d_model, n_layer, vocab_size, l_max,
                                        generator=generator, **kw)
        self.to(dev)

    def forward(self, input_ids: torch.Tensor, dropout_key=None):
        h, embed = self.backbone(input_ids, dropout_key)
        return (h @ embed.to(h.dtype).t()).float()


# the JAX run dir's model_config.json keys that are not model fields
RUN_KEYS = ("model_type", "objective", "lr")


def hyena_kwargs(raw: dict) -> dict:
    """The model's keyword arguments from a Hyena run's
    ``model_config.json`` (or a fine-tuned export's ``model_cfg``)."""
    out = {k: v for k, v in raw.items() if k not in RUN_KEYS}
    out["attn_layer_idx"] = tuple(out.get("attn_layer_idx", ()))
    return out
