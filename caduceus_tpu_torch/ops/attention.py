"""Multi-head attention of the hybrid Hyena layers: the flash-attention
kernels' wrappers, their plain versions and the `torch.autograd.Function`
around them.

Port of `caduceus_tpu/ops/attention.py` (`resolve_attention_kernel`,
`mha_attention`), in the JAX layout (B, L, H, hd). The JAX package runs
the Pallas TPU flash attention that ships with JAX
(`jax.experimental.pallas.ops.tpu.flash_attention`: a forward and two
adjoint `pallas_call`s under a custom VJP) when the route is "pallas"; the
port's counterparts are three hand-written CUDA kernels
(`csrc/attention_fwd.cu`, `csrc/attention_bwd.cu`, built by `_build.py` at
first use):

- `attn_fwd` (counter ``fwd_launches``): O and the per-row logsumexp;
- `attn_bwd_dkv` (``bwd_dkv_launches``): the prologue D = rowsum(dO * O),
  then dK and dV;
- `attn_bwd_dq` (``bwd_dq_launches``): dQ.

Routes. On a CUDA tensor every route ("auto", "xla", "pallas") launches the
kernels, which take any L (the last tile's rows past L are masked) and head
widths 16, 32, 64 and 128, or raise; nothing falls back to the plain
version. On a CPU tensor every route runs the plain versions,
`attention_fwd_plain` (the function of `jax.nn.dot_product_attention`,
which the JAX package's "xla" route calls: fp32 scores and softmax, the
probabilities rounded to the input type before the product with V) and
`attention_bwd_plain` (its adjoint from the saved logsumexp), both in
query-row chunks so that no L x L matrix is built. "pallas" keeps the JAX
shape rule: it raises unless L % 128 == 0.

`mha_attention` runs through `_AttentionFn` on both devices: the forward
saves q, k, v, O and the logsumexp, the backward is `attention_bwd`, the
forward / VJP contract of `flash_attention`'s custom VJP.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from caduceus_tpu_torch import _build

_BLOCK = 128  # the TPU kernel's sequence tiling (the "pallas" shape rule)
HEAD_DIMS = (16, 32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# bytes of fp32 scores a plain-version chunk may hold
_PLAIN_CHUNK_BYTES = 1 << 30

fwd_launches = 0
bwd_dkv_launches = 0
bwd_dq_launches = 0

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_I, _P, _I, _I, _I, _I, _I, ctypes.c_float, _P]
_LIBRARY = {"attn_fwd": "attention_fwd", "attn_bwd_dkv": "attention_bwd",
            "attn_bwd_dq": "attention_bwd"}


def _flash_eligible(L: int) -> bool:
    return L % _BLOCK == 0 and L >= _BLOCK


def resolve_attention_kernel(use_kernel: str, L: int) -> str:
    """The route's name, as the JAX function resolves it: "auto" is
    "pallas" where the TPU kernel's shape rule holds, else "xla";
    "pallas" raises where it does not. Both routes launch the CUDA kernels
    on a CUDA tensor (module docstring)."""
    if use_kernel == "auto":
        return "pallas" if _flash_eligible(L) else "xla"
    if use_kernel == "pallas" and not _flash_eligible(L):
        raise ValueError(
            f"flash attention needs seq_len % {_BLOCK} == 0, got L={L}; "
            "use use_kernel='xla' or pad the sequence")
    if use_kernel not in ("pallas", "xla"):
        raise ValueError(f"use_kernel={use_kernel!r}")
    return use_kernel


def build() -> dict:
    """Build both kernel libraries now, one nvcc each, side by side:
    {library: (path, compile seconds)}."""
    from concurrent.futures import ThreadPoolExecutor

    names = ("attention_fwd", "attention_bwd")
    with ThreadPoolExecutor(len(names)) as pool:
        return dict(zip(names, pool.map(_build.build, names)))


def _fn(name: str, defines=()):
    """The C entry point ``name``, loaded (and built) on first use; from
    the variant library built with ``defines`` when given (the checks'
    planted fault, ``ATTN_DROP``)."""
    fn = getattr(_build.load(_LIBRARY[name], defines), name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = _I
    return fn


def _plain_rows(B: int, H: int, L: int) -> int:
    return max(1, min(L, _PLAIN_CHUNK_BYTES // (4 * B * H * max(L, 1))))


def attention_fwd_plain(q, k, v, causal: bool, sm_scale: float,
                        chunk: Optional[int] = None):
    """(O, lse): ``jax.nn.dot_product_attention`` over (B, L, H, hd) in
    query-row chunks; lse (B, H, L) fp32 is the log of each row's softmax
    denominator."""
    B, L, H, hd = q.shape
    chunk = chunk or _plain_rows(B, H, L)
    kf = k.float().permute(0, 2, 3, 1)          # (B, H, hd, L)
    vf = v.float().transpose(1, 2)              # (B, H, L, hd)
    outs, lses = [], []
    for r0 in range(0, L, chunk):
        r1 = min(L, r0 + chunk)
        n = r1 if causal else L                 # keys any row of the chunk sees
        s = (q[:, r0:r1].float().transpose(1, 2) @ kf[..., :n]) * sm_scale
        if causal:
            rows = torch.arange(r0, r1, device=q.device)[:, None]
            s = s.masked_fill(torch.arange(n, device=q.device)[None] > rows,
                              float("-inf"))
        lse = torch.logsumexp(s, dim=-1)
        p = torch.exp(s - lse[..., None]).to(q.dtype).float()
        outs.append((p @ vf[:, :, :n]).transpose(1, 2).to(q.dtype))
        lses.append(lse)
    return torch.cat(outs, dim=1), torch.cat(lses, dim=-1)


def attention_bwd_plain(q, k, v, o, lse, do, causal: bool, sm_scale: float,
                        chunk: Optional[int] = None):
    """(dq, dk, dv) of `attention_fwd_plain`'s O for the cotangent ``do``,
    from the saved lse, in fp32 over query-row chunks (dk and dv summed
    over the chunks); returned in the input type."""
    B, L, H, hd = q.shape
    chunk = chunk or _plain_rows(B, H, L)
    kf = k.float().transpose(1, 2)              # (B, H, L, hd)
    vf = v.float().transpose(1, 2)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2)  # (B, H, L)
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)
    dqs = []
    for r0 in range(0, L, chunk):
        r1 = min(L, r0 + chunk)
        n = r1 if causal else L
        qc = q[:, r0:r1].float().transpose(1, 2)   # (B, H, c, hd)
        doc = do[:, r0:r1].float().transpose(1, 2)
        s = (qc @ kf[:, :, :n].transpose(-1, -2)) * sm_scale
        if causal:
            rows = torch.arange(r0, r1, device=q.device)[:, None]
            s = s.masked_fill(torch.arange(n, device=q.device)[None] > rows,
                              float("-inf"))
        p = torch.exp(s - lse[:, :, r0:r1, None])
        dv[:, :, :n] += p.transpose(-1, -2) @ doc
        ds = p * (doc @ vf[:, :, :n].transpose(-1, -2)
                  - delta[:, :, r0:r1, None])
        dk[:, :, :n] += ds.transpose(-1, -2) @ qc * sm_scale
        dqs.append((ds @ kf[:, :, :n] * sm_scale).transpose(1, 2))
    dt = q.dtype
    return (torch.cat(dqs, dim=1).to(dt), dk.transpose(1, 2).to(dt),
            dv.transpose(1, 2).to(dt))


def _operand(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A (B, L, H, hd) operand as the kernels take it: of ``like``'s shape,
    dtype and device, head dimension contiguous and every row 16-byte
    aligned, no stride 0 (the bf16 kernels' TMA maps need both; a copy
    when it is not so)."""
    if (t.device, t.dtype, t.shape) != (like.device, like.dtype, like.shape):
        raise ValueError(f"attention operands differ: {tuple(t.shape)} "
                         f"{t.dtype} on {t.device}, expected "
                         f"{tuple(like.shape)} {like.dtype} on {like.device}")
    es = t.element_size()
    if (t.stride(-1) != 1 or t.data_ptr() % 16
            or any(s * es % 16 or s == 0 for s in t.stride()[:3])):
        t = t.contiguous()
    return t


def _words(*ts) -> list:
    out = []
    for t in ts:
        out += [t.data_ptr(), t.stride(0), t.stride(1), t.stride(2)]
    return out


def _check(q, k, v):
    B, L, H, hd = q.shape
    if q.device.type != "cuda":
        raise ValueError(f"the attention kernels run on a CUDA tensor, got "
                         f"{q.device}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"the attention kernels take fp32 or bf16, got "
                         f"{q.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head width {hd}: the kernels are built for "
                         f"{HEAD_DIMS}")
    if B > 65535 or H > 65535:
        raise ValueError(f"B={B}, H={H}: at most 65535 each (grid)")
    return [_operand(t, q) for t in (q, k, v)]


def _rows(t: torch.Tensor, q: torch.Tensor, name: str) -> torch.Tensor:
    """A per-row fp32 operand (lse or D), (B, H, L) on q's device."""
    B, L, H, _ = q.shape
    if tuple(t.shape) != (B, H, L) or t.device != q.device:
        raise ValueError(f"{name} is {tuple(t.shape)} on {t.device}, "
                         f"expected {(B, H, L)} on {q.device}")
    return t.float().contiguous()


def _launch(name, words, dtype, B, L, H, hd, causal, sm_scale):
    arr = (ctypes.c_longlong * len(words))(*words)
    err = _fn(name)(
        _DTYPES[dtype], arr, B, L, H, hd, int(causal), float(sm_scale),
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def attention_fwd(q, k, v, causal: bool, sm_scale: float
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(O (B, L, H, hd) in the input type, lse (B, H, L) fp32): the
    `attn_fwd` kernel on a CUDA tensor, `attention_fwd_plain` on a CPU
    one."""
    global fwd_launches
    if q.device.type == "cpu":
        return attention_fwd_plain(q, k, v, causal, sm_scale)
    q, k, v = _check(q, k, v)
    B, L, H, hd = q.shape
    o = torch.empty(B, L, H, hd, device=q.device, dtype=q.dtype)
    lse = torch.empty(B, H, L, device=q.device, dtype=torch.float32)
    _launch("attn_fwd", _words(q, k, v, o) + [lse.data_ptr()], q.dtype,
            B, L, H, hd, causal, sm_scale)
    fwd_launches += 1
    return o, lse


def attention_bwd_dkv(q, k, v, o, lse, do, causal: bool, sm_scale: float):
    """(dk, dv, D) on a CUDA tensor: the `attn_bwd_dkv` kernel (its
    prologue writes D (B, H, L) fp32, which `attention_bwd_dq` reads)."""
    global bwd_dkv_launches
    q, k, v = _check(q, k, v)
    o, do = (_operand(t, q) for t in (o, do))
    lse = _rows(lse, q, "lse")
    B, L, H, hd = q.shape
    dk, dv = (torch.empty(B, L, H, hd, device=q.device, dtype=q.dtype)
              for _ in range(2))
    delta = torch.empty(B, H, L, device=q.device, dtype=torch.float32)
    # the dq slot of the words is not read by this entry
    words = _words(q, k, v, o, do, dk, dk, dv) + [lse.data_ptr(),
                                                  delta.data_ptr()]
    _launch("attn_bwd_dkv", words, q.dtype, B, L, H, hd, causal, sm_scale)
    bwd_dkv_launches += 1
    return dk, dv, delta


def attention_bwd_dq(q, k, v, o, lse, do, delta, causal: bool,
                     sm_scale: float):
    """dq on a CUDA tensor: the `attn_bwd_dq` kernel, from the D that
    `attention_bwd_dkv` wrote."""
    global bwd_dq_launches
    q, k, v = _check(q, k, v)
    o, do = (_operand(t, q) for t in (o, do))
    lse, delta = _rows(lse, q, "lse"), _rows(delta, q, "D")
    B, L, H, hd = q.shape
    dq = torch.empty(B, L, H, hd, device=q.device, dtype=q.dtype)
    # the dk and dv slots of the words are not read by this entry
    words = _words(q, k, v, o, do, dq, dq, dq) + [lse.data_ptr(),
                                                  delta.data_ptr()]
    _launch("attn_bwd_dq", words, q.dtype, B, L, H, hd, causal, sm_scale)
    bwd_dq_launches += 1
    return dq


def attention_bwd(q, k, v, o, lse, do, causal: bool, sm_scale: float):
    """(dq, dk, dv): the two adjoint kernels on a CUDA tensor,
    `attention_bwd_plain` on a CPU one."""
    if q.device.type == "cpu":
        return attention_bwd_plain(q, k, v, o, lse, do, causal, sm_scale)
    dk, dv, delta = attention_bwd_dkv(q, k, v, o, lse, do, causal, sm_scale)
    dq = attention_bwd_dq(q, k, v, o, lse, do, delta, causal, sm_scale)
    return dq, dk, dv


class _AttentionFn(torch.autograd.Function):
    """O = attention(q, k, v); backward: `attention_bwd` from the saved
    q, k, v, O and lse."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale):
        o, lse = attention_fwd(q, k, v, causal, sm_scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = attention_bwd(q, k, v, o, lse, do, ctx.causal,
                                   ctx.sm_scale)
        return dq, dk, dv, None, None


def mha_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, sm_scale: Optional[float] = None,
                  use_kernel: str = "auto") -> torch.Tensor:
    """Scaled dot-product attention over (B, L, H, hd) tensors; returns
    (B, L, H, hd). ``sm_scale`` defaults to 1/sqrt(hd)."""
    B, L, H, hd = q.shape
    if sm_scale is None:
        sm_scale = float(hd) ** -0.5
    resolve_attention_kernel(use_kernel, L)
    return _AttentionFn.apply(q, k, v, causal, float(sm_scale))
