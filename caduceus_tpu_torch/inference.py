"""Recurrent (O(1)-per-token) inference: caches, the decode step, prefill and
generation.

Port of `caduceus_tpu/inference.py`, with the same function names. Where
the JAX functions take a flax params dict and the config, these take the
port's modules, which carry both: `CaduceusForMaskedLM` (`lm_step`,
`prefill`, `generate`), a `CaduceusBlock` (`block_step`), a mixer
`BiMamba` / `BiMamba2` (`bimamba_step`, `mamba2_step`, `mixer_prefill`) or
a direction's parameters `_DirectionParams` / `_DirectionParamsV2`
(`*_direction_step`, `*_direction_prefill`). The caches are plain dicts of
tensors in the JAX layouts, ``{"layers_<i>": {"fwd": {"conv", "ssm"}}}``:

  v1 conv (B, d_conv, d_inner)            ring buffer of the last d_conv
                                          pre-conv inputs, newest last, in
                                          the compute dtype
  v1 ssm  (B, d_inner, N) fp32            the scan state: the layout of
                                          `ops/scan.py`'s h_init / hN
  v2 conv (B, d_conv, d_inner + 2·NG·N)   ring buffer over the pre-conv xBC
  v2 ssm  (B, H, N, P) fp32               `ssd_step` / `ssd_batched_chained`

- The **prefill** runs the prompt through the parallel kernels, chained
  from the cache: the conv over the prompt with the ring buffer's K-1 rows
  in front (`_conv_with_history`), then one launch per layer of
  `selective_scan_fwd` (v1, TPU kernel #7) or, for v2, of the unfused SSD
  forward kernel through the chained function that ``use_kernel`` selects
  (`_resolved_infer_kernel`, `ops/ssd_head.py resolve_ssd_kernel`: #2
  through `ops/ssd_batched.py ssd_batched_chained`, or #5 through
  `ops/ssd_head.py ssd_head_chained` for "pallas"), with h_init = the
  cached state; on the CPU their plain versions. As in the JAX prefill,
  the conv's taps run in the compute dtype and its fp32 bias promotes the
  sum, so a bf16 model's prefill scans in fp32 (the fp32 kernels, T = 32
  rows per chunk); it agrees with the model's full forward (kernels #1 /
  #9, which convolve in fp32 inside the kernel) within bf16 roundings.
- The **decode step** (`lm_step`) is plain PyTorch, a few small launches
  per layer per token, where JAX runs the whole loop as one `lax.scan`.
- **Sampling** takes an explicit `torch.Generator` on the model's device;
  ``temperature == 0`` is greedy, with optional top-k otherwise.

Causal models only (``bidirectional=False``, ``rcps=False``): the others
raise the JAX package's `NotImplementedError`. Every entry point runs
under `torch.inference_mode()`.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from caduceus_tpu_torch import resolve_device
from caduceus_tpu_torch.config import CaduceusConfig
from caduceus_tpu_torch.models.mamba2 import _split_zxbcdt, rms_norm_gated
from caduceus_tpu_torch.ops.conv import causal_conv1d
from caduceus_tpu_torch.ops.norms import add_norm, layer_norm, rms_norm
from caduceus_tpu_torch.ops.scan import selective_scan_chained
from caduceus_tpu_torch.ops.ssd import ssd_step
from caduceus_tpu_torch.ops.ssd_head import resolve_ssd_kernel

Cache = Dict[str, Any]

_CAUSAL_ONLY = ("requires a causal config (bidirectional=False, "
                "rcps=False)")


def _dtype(cfg: CaduceusConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


@torch.inference_mode()
def init_cache(cfg: CaduceusConfig, batch_size: int,
               device="cuda") -> Cache:
    """The zeroed inference cache (the reference's
    ``allocate_inference_cache``), per direction of every layer."""
    dev = resolve_device(device)
    s = cfg.ssm_cfg
    dirs = ["fwd", "rev"] if cfg.bidirectional else ["fwd"]
    if s.version == 2:
        conv_dim = cfg.d_inner + 2 * s.ngroups * s.d_state
        ssm_shape = (batch_size, cfg.nheads, s.d_state, s.headdim)
    else:
        conv_dim = cfg.d_inner
        ssm_shape = (batch_size, cfg.d_inner, s.d_state)
    return {f"layers_{i}": {d: {
        "conv": torch.zeros(batch_size, s.d_conv, conv_dim,
                            dtype=_dtype(cfg), device=dev),
        "ssm": torch.zeros(ssm_shape, dtype=torch.float32, device=dev)}
        for d in dirs} for i in range(cfg.n_layer)}


@torch.inference_mode()
def mamba_direction_step(dparams, xi_t: torch.Tensor,
                         cache: Cache) -> Tuple[torch.Tensor, Cache]:
    """One step of the v1 inner branch (conv -> projections -> state
    update), mamba-ssm ``Mamba.step``: h = exp(Δ·A)·h + Δ·u·B, y = C·h +
    D·u. ``dparams`` is a `_DirectionParams`; ``xi_t`` (B, d_inner) is the
    pre-conv in_proj output."""
    c = dparams.cfg
    N = c.ssm_cfg.d_state
    dtype = xi_t.dtype
    conv = torch.cat([cache["conv"][:, 1:], xi_t[:, None]], dim=1)
    xc = (conv * dparams.conv_w.to(dtype)[None]).sum(dim=1)
    if dparams.conv_b is not None:
        xc = xc + dparams.conv_b.to(dtype)
    xc = F.silu(xc)
    dt, Bv, Cv = (xc @ dparams.x_proj_w.to(dtype)).split(
        [c.dt_rank, N, N], dim=-1)
    delta = F.softplus((dt @ dparams.dt_proj_w.to(dtype)).float()
                       + dparams.dt_proj_b.float())
    dA = torch.exp(delta[..., None] * dparams.A()[None])   # (B, d_inner, N)
    xf = xc.float()
    ssm = cache["ssm"] * dA + (delta * xf)[..., None] * Bv.float()[:, None]
    y = (ssm * Cv.float()[:, None]).sum(dim=-1) + dparams.D.float() * xf
    return y.to(dtype), {"conv": conv, "ssm": ssm}


@torch.inference_mode()
def mamba2_direction_step(dparams, xBC_t: torch.Tensor, dt_t: torch.Tensor,
                          cache: Cache) -> Tuple[torch.Tensor, Cache]:
    """One step of the v2 (SSD) inner branch: conv -> x/B/C split ->
    `ssd_step` (fp32 conv accumulation, fp32 state; mamba-ssm 2.x
    ``Mamba2.step``). ``dparams`` is a `_DirectionParamsV2`; ``xBC_t`` (B,
    d_inner + 2·NG·N) pre-conv, ``dt_t`` (B, H) raw."""
    c = dparams.cfg
    s = c.ssm_cfg
    H, P, NG, N = c.nheads, s.headdim, s.ngroups, s.d_state
    Bsz = xBC_t.shape[0]
    conv = torch.cat([cache["conv"][:, 1:], xBC_t[:, None]], dim=1)
    xc = (conv.float()
          * dparams.conv_w.to(xBC_t.dtype).float()[None]).sum(dim=1)
    if dparams.conv_b is not None:
        xc = xc + dparams.conv_b.float()
    xc = F.silu(xc)                                     # (B, conv_dim) fp32
    ssm, y = ssd_step(
        cache["ssm"], xc[:, :H * P].reshape(Bsz, H, P), dt_t.float(),
        -torch.exp(dparams.A_log.float()),
        xc[:, H * P:H * P + NG * N].reshape(Bsz, NG, N),
        xc[:, H * P + NG * N:].reshape(Bsz, NG, N),
        D=dparams.D, dt_bias=dparams.dt_bias, dt_softplus=True)
    return y.reshape(Bsz, c.d_inner).to(xBC_t.dtype), {
        "conv": conv.to(cache["conv"].dtype), "ssm": ssm}


@torch.inference_mode()
def mamba2_step(mparams, x_t: torch.Tensor,
                cache: Cache) -> Tuple[torch.Tensor, Cache]:
    """One v2 mixer step of a `BiMamba2` (its causal `Mamba2Mixer`):
    in_proj -> conv/SSD step -> gated norm -> out_proj."""
    sub = mparams.mamba_fwd
    c = sub.cfg
    z, xBC_t, dt_t = _split_zxbcdt(c, sub.in_proj(x_t, x_t.dtype))
    y, new_fwd = mamba2_direction_step(sub.fwd, xBC_t, dt_t, cache["fwd"])
    y = rms_norm_gated(y, z, sub.norm_w, c.ssm_cfg.ngroups, c.norm_epsilon)
    return sub.out_proj(y, y.dtype), {"fwd": new_fwd}


@torch.inference_mode()
def bimamba_step(mparams, x_t: torch.Tensor,
                 cache: Cache) -> Tuple[torch.Tensor, Cache]:
    """One mixer step of a `BiMamba` / `BiMamba2`. Causal models only: the
    reverse direction of a bidirectional layer has no stepwise form."""
    c = mparams.cfg
    if c.bidirectional:
        raise NotImplementedError(
            "stepwise decoding requires bidirectional=False (the reference "
            "generates only through unidirectional backbones, "
            "`src/models/sequence/long_conv_lm.py:391-493`)")
    if c.ssm_cfg.version == 2:
        return mamba2_step(mparams, x_t, cache)
    sub = mparams.mamba_fwd
    xi, z = sub.in_proj(x_t, x_t.dtype).chunk(2, dim=-1)
    y, new_fwd = mamba_direction_step(sub.fwd, xi, cache["fwd"])
    y = y * F.silu(z)
    return sub.out_proj(y, y.dtype), {"fwd": new_fwd}


def _add_norm(block, x, residual):
    c = block.cfg
    return add_norm(x, block.norm_w, block.norm_b, residual=residual,
                    eps=c.norm_epsilon, use_rms=c.rms_norm,
                    residual_in_fp32=c.residual_in_fp32, prenorm=True)


@torch.inference_mode()
def block_step(lparams, x_t: torch.Tensor, residual: Optional[torch.Tensor],
               cache: Cache):
    """One `CaduceusBlock` step, (add -> norm) -> mixer: returns (mixer
    output, residual, cache)."""
    normed, residual = _add_norm(lparams, x_t, residual)
    out, cache = bimamba_step(lparams.mixer, normed, cache)
    return out, residual, cache


def _logits(model, h: torch.Tensor, residual: Optional[torch.Tensor]):
    """Final add + norm and the LM head, fp32 logits."""
    c = model.cfg
    bb = model.backbone
    dtype = _dtype(c)
    final = h if residual is None else residual + h.to(residual.dtype)
    if c.residual_in_fp32:
        final = final.float()
    if c.rms_norm:
        hn = rms_norm(final, bb.norm_f_w, eps=c.norm_epsilon)
    else:
        hn = layer_norm(final, bb.norm_f_w, bb.norm_f_b, eps=c.norm_epsilon)
    W = bb.embedding if model.lm_head is None else model.lm_head
    return (hn.to(dtype) @ W.to(dtype).t()).float()


@torch.inference_mode()
def lm_step(model, token_t: torch.Tensor,
            caches: Cache) -> Tuple[torch.Tensor, Cache]:
    """One full-model step of a `CaduceusForMaskedLM`: token ids (B,) ->
    next-token logits (B, V) fp32 and the updated caches. Equals position
    t of the model's full forward."""
    bb = model.backbone
    h = bb.embedding.to(_dtype(model.cfg))[token_t]
    residual = None
    new = {}
    for i, block in enumerate(bb.layers):
        key = f"layers_{i}"
        h, residual, new[key] = block_step(block, h, residual, caches[key])
    return _logits(model, h, residual), new


def _conv_with_history(xi: torch.Tensor, cache_conv: torch.Tensor):
    """Prepend the cached K-1 pre-conv rows so that the parallel conv
    continues the stepwise ring buffer exactly. Returns (the extended input,
    whose conv outputs from row K-1 on are the continuation; the new ring
    buffer, its last K rows)."""
    K = cache_conv.shape[1]
    xi_ext = torch.cat([cache_conv[:, 1:].to(xi.dtype), xi], dim=1)
    return xi_ext, xi_ext[:, -K:].clone()


def _conv_tail(dparams, x_ext: torch.Tensor) -> torch.Tensor:
    """silu(conv) of the extended input, rows K-1 on: the taps in the
    input's dtype, then the conv bias as stored (fp32), which promotes the
    sum, and so the scan after it, to fp32 in a bf16 model -- as the JAX
    prefill passes its bias uncast (`caduceus_tpu/inference.py`
    `mamba_direction_prefill`, `mamba2_direction_prefill`)."""
    K = dparams.conv_w.shape[0]
    return causal_conv1d(x_ext, dparams.conv_w.to(x_ext.dtype),
                         dparams.conv_b, activation="silu")[:, K - 1:]


@torch.inference_mode()
def mamba_direction_prefill(dparams, xi: torch.Tensor,
                            cache: Cache) -> Tuple[torch.Tensor, Cache]:
    """The parallel prompt pass of the v1 inner branch: the conv over the
    prompt, then the chained selective scan seeded from and emitting the
    stepwise cache (`selective_scan_chained`: kernel #7 on the card).
    ``xi`` (B, Lp, d_inner) is the pre-conv in_proj output."""
    c = dparams.cfg
    N = c.ssm_cfg.d_state
    xi_ext, new_conv = _conv_with_history(xi, cache["conv"])
    u = _conv_tail(dparams, xi_ext)
    dt, B, C = (u @ dparams.x_proj_w.to(u.dtype)).split(
        [c.dt_rank, N, N], dim=-1)
    y, hN = selective_scan_chained(
        u, dt @ dparams.dt_proj_w.to(u.dtype), dparams.A(), B, C,
        D=dparams.D, delta_bias=dparams.dt_proj_b, h_init=cache["ssm"],
        delta_softplus=True)
    return y, {"conv": new_conv.to(cache["conv"].dtype), "ssm": hN}


def _resolved_infer_kernel(cfg: CaduceusConfig) -> str:
    """The ``use_kernel`` route of the prefill, as the JAX
    `_resolved_infer_kernel` resolves it off the CPU: "auto" is the
    head-batched kernels for v2 and the base kernels for v1. The port has
    no counterpart of "xla" (the JAX package's chunked XLA form) on the
    card, so for v2 it takes the head-batched kernels too; on the CPU every
    route runs its plain version."""
    k = cfg.ssm_cfg.use_kernel
    if k in ("auto", "xla"):
        return "pallas_batched" if cfg.ssm_cfg.version == 2 else "pallas"
    return k


@torch.inference_mode()
def mamba2_direction_prefill(dparams, xBC: torch.Tensor, dt: torch.Tensor,
                             cache: Cache) -> Tuple[torch.Tensor, Cache]:
    """The parallel prompt pass of the v2 (SSD) inner branch: the conv over
    the prompt, then the chained unfused SSD that `resolve_ssd_kernel`
    returns for the config's ``use_kernel`` (on the card TPU kernel #2
    through `ssd_batched_chained`, or #5 through `ssd_head_chained`), which
    reads x, B and C as column views of the conv output and dt as a column
    view of the in_proj output. ``xBC`` (B, Lp, d_inner + 2·NG·N) pre-conv,
    ``dt`` (B, Lp, H) raw."""
    c = dparams.cfg
    s = c.ssm_cfg
    H, P, NG, N = c.nheads, s.headdim, s.ngroups, s.d_state
    Bsz, Lp = xBC.shape[:2]
    xBC_ext, new_conv = _conv_with_history(xBC, cache["conv"])
    xc = _conv_tail(dparams, xBC_ext)
    _, chained_fn = resolve_ssd_kernel(_resolved_infer_kernel(c))
    # dt in the scan's dtype (xc's: fp32 in a model with a conv bias), as
    # the kernels take it; the JAX scan resolves dt in fp32 either way
    y, hN = chained_fn(
        xc[..., :H * P].reshape(Bsz, Lp, H, P), dt.to(xc.dtype),
        -torch.exp(dparams.A_log.float()),
        xc[..., H * P:H * P + NG * N].reshape(Bsz, Lp, NG, N),
        xc[..., H * P + NG * N:].reshape(Bsz, Lp, NG, N),
        D=dparams.D, dt_bias=dparams.dt_bias, h_init=cache["ssm"],
        dt_softplus=True)
    return y.reshape(Bsz, Lp, c.d_inner), {
        "conv": new_conv.to(cache["conv"].dtype), "ssm": hN}


@torch.inference_mode()
def mixer_prefill(mparams, x: torch.Tensor,
                  cache: Cache) -> Tuple[torch.Tensor, Cache]:
    """The parallel prompt pass of one causal mixer (`BiMamba` or
    `BiMamba2` with ``bidirectional=False``)."""
    sub = mparams.mamba_fwd
    c = sub.cfg
    dtype = x.dtype
    if c.ssm_cfg.version == 2:
        z, xBC, dt = _split_zxbcdt(c, sub.in_proj(x, dtype))
        y, new_fwd = mamba2_direction_prefill(sub.fwd, xBC, dt, cache["fwd"])
        y = rms_norm_gated(y, z, sub.norm_w, c.ssm_cfg.ngroups,
                           c.norm_epsilon)
    else:
        xi, z = sub.in_proj(x, dtype).chunk(2, dim=-1)
        y, new_fwd = mamba_direction_prefill(sub.fwd, xi, cache["fwd"])
        y = y.to(dtype) * F.silu(z)
    return sub.out_proj(y.to(dtype), dtype), {"fwd": new_fwd}


def _causal(cfg: CaduceusConfig, what: str):
    if cfg.bidirectional or cfg.rcps:
        raise NotImplementedError(f"{what} {_CAUSAL_ONLY}")


@torch.inference_mode()
def prefill(model, prompt_ids: torch.Tensor, caches: Optional[Cache] = None,
            mode: str = "parallel") -> Tuple[torch.Tensor, Cache]:
    """Process the prompt (B, Lp) and return (last-position logits (B, V)
    fp32, caches).

    ``mode="parallel"`` runs the prompt through the chained parallel
    kernels, one scan launch per layer; ``mode="stepwise"`` runs `lm_step`
    over it token by token (the numerics oracle). Passing the ``caches`` of
    an earlier prefill streams a long sequence through in pieces: the conv
    ring buffer and the scan state carry across calls exactly."""
    c = model.cfg
    _causal(c, "prefill")
    if caches is None:
        caches = init_cache(c, prompt_ids.shape[0],
                            model.backbone.embedding.device)
    if mode == "stepwise":
        logits = None
        for t in range(prompt_ids.shape[1]):
            logits, caches = lm_step(model, prompt_ids[:, t], caches)
        return logits, caches
    if mode != "parallel":
        raise ValueError(f"mode={mode!r}: 'parallel' or 'stepwise'")
    bb = model.backbone
    h = bb.embedding.to(_dtype(c))[prompt_ids]
    residual = None
    new = {}
    for i, block in enumerate(bb.layers):
        key = f"layers_{i}"
        normed, residual = _add_norm(block, h, residual)
        h, new[key] = mixer_prefill(block.mixer, normed, caches[key])
    # the final norm is per position: only the last one is needed
    return _logits(model, h[:, -1],
                   None if residual is None else residual[:, -1]), new


def _sample(logits, temperature, top_k, generator):
    if temperature == 0.0:
        return logits.argmax(dim=-1)
    logits = logits / temperature
    if top_k is not None:
        kth = logits.sort(dim=-1).values[..., -top_k, None]
        logits = torch.where(logits < kth, -torch.inf, logits)
    return torch.multinomial(torch.softmax(logits, dim=-1), 1,
                             generator=generator)[:, 0]


@torch.inference_mode()
def generate(model, prompt_ids: torch.Tensor, max_new_tokens: int,
             generator: Optional[torch.Generator] = None,
             temperature: float = 0.0,
             top_k: Optional[int] = None) -> torch.Tensor:
    """Autoregressive generation with O(1) state per token: the parallel
    prefill, then one `lm_step` per new token. ``temperature == 0`` is
    greedy; otherwise softmax sampling, optionally top-k truncated, drawn
    from ``generator`` (on the model's device; seed 0 when None). Returns
    (B, Lp + max_new_tokens) token ids."""
    _causal(model.cfg, "generation")
    if generator is None:
        generator = torch.Generator(
            device=model.backbone.embedding.device).manual_seed(0)
    logits, caches = prefill(model, prompt_ids)
    new = []
    for i in range(max_new_tokens):
        tok = _sample(logits, temperature, top_k, generator).to(
            prompt_ids.dtype)
        new.append(tok[:, None])
        if i + 1 < max_new_tokens:     # the last token's logits are unused
            logits, caches = lm_step(model, tok, caches)
    return torch.cat([prompt_ids] + new, dim=1)
