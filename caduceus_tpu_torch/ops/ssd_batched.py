"""Head-batched SSD: the Python wrappers of the `ssd_fused_fwd`, `ssd_fwd`,
`ssd_fused_bwd` and `ssd_bwd` kernels, and the `torch.autograd.Function`s
around the fused pair and the unfused pair.

Port of `caduceus_tpu/ops/ssd_pallas_batched.py` `ssd_pallas_batched_fused`
(`ssd_pallas_batched_fused_chained` and its `custom_vjp`). Same signature
and layouts: ``xBC`` is the PRE-conv (G, L, H·P + 2·NG·N) tensor, the
depthwise conv + SiLU + x/B/C split run inside the kernels, so the
post-conv tensor never exists in device memory.

Also the unfused SSD, `ssd_batched_chained` (the port of
`ssd_pallas_batched_chained`: forward TPU kernel #2, adjoint #4) and
`ssd_batched` (of `ssd_pallas_batched`): post-conv x (G, L, H, P), B and C
(G, L, NG, N), h_init -> (y, hN). The prefill runs it. On a CPU tensor it
is `ops/ssd.py ssd_chunked`, which autograd differentiates; on a CUDA
tensor `ssd_fwd`, and under grad `_SSDFn`: forward = `ssd_fwd` saving the
chunk carries, backward = one launch of `ssd_bwd`, differentiable in x,
dt, A, B, C, D, dt_bias and h_init, with a cotangent for hN. The per-head
entry `ops/ssd_head.py` runs the same two kernels under its own counters.

- On a CPU tensor `ssd_batched_fused` runs the plain version, `ops/ssd.py
  ssd_chunked_fused`, which autograd differentiates.
- On a CUDA tensor it launches the hand-written CUDA kernels
  (`csrc/ssd_fused_fwd.cu`, `csrc/ssd_fused_bwd.cu`, built by `_build.py`
  at first use) or raises; it never falls back to the plain version. With
  grad enabled and an input that requires grad it goes through
  `_SSDFusedFn`: forward = `ssd_fused_fwd` saving the chunk carries,
  backward = `ssd_fused_bwd`. Differentiable in xBC, dt, A, conv_w,
  conv_b, D, dt_bias and h_init, with a cotangent for hN.

Launch counters (one per kernel launch on a CUDA tensor): ``launches``
(`ssd_fused_fwd`), ``unfused_launches`` (`ssd_fwd`), ``bwd_launches``
(`ssd_fused_bwd_kernel`), ``conv_bwd_launches`` (`ssd_conv_bwd_kernel`)
and ``unfused_bwd_launches`` (`ssd_bwd`).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from caduceus_tpu_torch import _build
from caduceus_tpu_torch.ops.ssd import carry_dtype
from caduceus_tpu_torch.ops.ssd import conv_silu_bwd as plain_conv_silu_bwd
from caduceus_tpu_torch.ops.ssd import ssd_adjoint_xc as plain_adjoint_xc
from caduceus_tpu_torch.ops.ssd import ssd_chunked as plain_chunked
from caduceus_tpu_torch.ops.ssd import ssd_chunked_bwd as plain_chunked_bwd
from caduceus_tpu_torch.ops.ssd import ssd_chunked_fused

# chunk rows of the CUDA kernels (`Chunk<S>::T` in csrc/ssd_common.cuh):
# fp32 tiles take twice the shared memory, so fp32 chunks are half as long.
# The plain version takes the same T on the CPU so both sides chunk alike.
KERNEL_CHUNK = {torch.float32: 32, torch.bfloat16: 64}
MAX_CONV_WIDTH = 4
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0
unfused_launches = 0
bwd_launches = 0
conv_bwd_launches = 0
unfused_bwd_launches = 0

_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_ARGTYPES = {
    "ssd_fused_fwd": [_I, _P, _LL, _LL, _P, _LL, _LL, _P, _P, _P, _P, _P, _P,
                      _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "ssd_fwd": [_I] + [_P, _LL, _LL] * 4 + [_P] * 7 + [_I] * 8 + [_P],
    "ssd_fused_bwd": [_I, _P, _LL, _LL, _P, _LL, _LL, _P, _P, _P, _P, _P,
                      _P, _P, _P, _P, _P, _P, _P,
                      _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "ssd_conv_bwd": [_I, _P, _LL, _LL, _P, _P, _P, _P, _P,
                     _I, _I, _I, _I, _I, _P],
    "ssd_bwd": [_I] + [_P, _LL, _LL] * 4 + [_P] * 11 + [_I] * 8 + [_P],
}
_LIBRARY = {"ssd_fused_fwd": "ssd_fused_fwd", "ssd_fwd": "ssd_fused_fwd",
            "ssd_fused_bwd": "ssd_fused_bwd", "ssd_conv_bwd": "ssd_fused_bwd",
            "ssd_bwd": "ssd_fused_bwd"}


def _fn(name: str):
    """The C entry point ``name``, loaded (and built) on first use."""
    fn = getattr(_build.load(_LIBRARY[name]), name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name]
        fn.restype = _I
    return fn


def build() -> dict:
    """Build both kernel libraries now, one nvcc each, side by side:
    {library: (path, compile seconds)}. `ssd_fused_fwd.cu` holds both
    forward entry points, `ssd_fused_fwd` and `ssd_fwd`; `ssd_fused_bwd.cu`
    the backward ones, `ssd_fused_bwd`, `ssd_conv_bwd` and `ssd_bwd`."""
    from concurrent.futures import ThreadPoolExecutor

    names = ("ssd_fused_fwd", "ssd_fused_bwd")
    with ThreadPoolExecutor(len(names)) as pool:
        return dict(zip(names, pool.map(_build.build, names)))


def _small(t: Optional[torch.Tensor], shape, name: str, dev):
    """A parameter vector/matrix as the fp32 contiguous copy the kernel
    reads (these are weights: a few KB)."""
    if t is None:
        return None
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, xBC on {dev}")
    return t.detach().float().contiguous()


def _conv_width(conv_w: torch.Tensor) -> int:
    """K of a (K, Wc) conv weight the kernels take (K <= MAX_CONV_WIDTH)."""
    K = conv_w.shape[0] if conv_w.dim() == 2 else -1
    if not 1 <= K <= MAX_CONV_WIDTH:
        raise ValueError(f"conv_w shape {tuple(conv_w.shape)}: the kernel "
                         f"takes (K, Wc) with K <= {MAX_CONV_WIDTH}")
    return K


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _check(err: int, what: str, G, L, dims, dtype):
    if err != 0:
        raise RuntimeError(f"{what} launch failed with CUDA error {err} "
                           f"(G={G}, L={L}, dims={dims}, dtype={dtype})")


def _head_args(first, dt, A, D, dt_bias, dims, chunk_size, name):
    """Check what every forward and backward kernel takes of the tensor
    ``first`` (xBC or x), dt and the per-head parameters; returns the fp32
    copies of (A, D, dt_bias)."""
    H, P, NG, N = dims
    dev = first.device
    if first.dtype not in _DTYPES:
        raise TypeError(f"{name} dtype {first.dtype}: the kernel takes "
                        "float32 or bfloat16")
    if chunk_size != KERNEL_CHUNK[first.dtype]:
        raise ValueError(f"the CUDA kernel chunks {first.dtype} by "
                         f"{KERNEL_CHUNK[first.dtype]} rows, got "
                         f"chunk_size={chunk_size}")
    if dt.dtype != first.dtype or dt.device != dev:
        raise TypeError(f"dt is {dt.dtype} on {dt.device}; the kernel takes "
                        f"{name}'s {first.dtype} on {dev}")
    if dt.stride(2) != 1:
        raise ValueError("dt needs a unit column stride")
    if P % 16 or N % 16:
        raise ValueError(f"headdim {P} and d_state {N} must be multiples of "
                         "16 (the tensor-core tile)")
    return (_small(A, (H,), "A", dev), _small(D, (H,), "D", dev),
            _small(dt_bias, (H,), "dt_bias", dev))


def _kernel_args(xBC, dt, A, conv_w, conv_b, D, dt_bias, dims, chunk_size):
    """Check what the fused kernels take; returns (K, fp32 copies of the
    parameters (A, D, dt_bias, conv_w, conv_b))."""
    Wc = xBC.shape[2]
    heads = _head_args(xBC, dt, A, D, dt_bias, dims, chunk_size, "xBC")
    if xBC.stride(2) != 1:
        raise ValueError("xBC needs a unit column stride")
    K = _conv_width(conv_w)
    return K, heads + (_small(conv_w, (K, Wc), "conv_w", xBC.device),
                       _small(conv_b, (Wc,), "conv_b", xBC.device))


def ssd_fused_fwd(xBC, dt, A, conv_w, conv_b, D, dt_bias, dims, dt_softplus,
                  reverse, chunk_size, h_init, save_carries: bool):
    """One launch of the forward kernel on CUDA tensors: (y, hN, carries),
    carries = the state entering every chunk, (G, nc, H, N, P) in
    `carry_dtype`, when ``save_carries`` (else None)."""
    H, P, NG, N = dims
    G, L, Wc = xBC.shape
    dev = xBC.device
    K, (A_, D_, bias_, w_, b_) = _kernel_args(
        xBC, dt, A, conv_w, conv_b, D, dt_bias, dims, chunk_size)
    h0 = _small(h_init, (G, H, N, P), "h_init", dev)
    y = torch.empty(G, L, H, P, dtype=xBC.dtype, device=dev)
    hN = torch.empty(G, H, N, P, dtype=torch.float32, device=dev)
    nc = -(-L // chunk_size)
    carries = (torch.empty(G, nc, H, N, P, dtype=carry_dtype(xBC.dtype),
                           device=dev) if save_carries else None)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _fn("ssd_fused_fwd")(
            _DTYPES[xBC.dtype],
            xBC.data_ptr(), xBC.stride(0), xBC.stride(1),
            dt.data_ptr(), dt.stride(0), dt.stride(1),
            _ptr(A_), _ptr(D_), _ptr(bias_), _ptr(w_), _ptr(b_), _ptr(h0),
            y.data_ptr(), hN.data_ptr(), _ptr(carries),
            G, L, H, P, NG, N, K, int(dt_softplus), int(reverse), stream)
    _check(err, "ssd_fused_fwd", G, L, dims, xBC.dtype)
    global launches
    launches += 1
    return y, hN, carries


def _unfused_views(x, B_mat, C, dt, A, D, dt_bias, chunk_size):
    """Check what both unfused kernels take of x, B, C (each row's values
    contiguous: they may be views into wider tensors), dt and the per-head
    parameters; returns the fp32 copies of (A, D, dt_bias)."""
    G, L, H, P = x.shape
    NG, N = B_mat.shape[-2:]
    dev = x.device
    out = _head_args(x, dt, A, D, dt_bias, (H, P, NG, N), chunk_size, "x")
    for name, t, row in (("x", x, (H, P)), ("B", B_mat, (NG, N)),
                         ("C", C, (NG, N))):
        if t.dtype != x.dtype or t.device != dev:
            raise TypeError(f"{name} is {t.dtype} on {t.device}; the kernel "
                            f"takes x's {x.dtype} on {dev}")
        if t.stride(3) != 1 or t.stride(2) != row[1]:
            raise ValueError(f"{name} {tuple(t.shape)} with strides "
                             f"{t.stride()}: each row's {row[0]}x{row[1]} "
                             "values must be contiguous")
    return out


def _strided(*ts):
    """Each tensor's (pointer, batch stride, row stride), flattened."""
    return [v for t in ts for v in (t.data_ptr(), t.stride(0), t.stride(1))]


def launch_fwd(x, dt, A, B_mat, C, D, dt_bias, dt_softplus, reverse,
               chunk_size, h_init, save_carries: bool):
    """One launch of the unfused forward kernel (`ssd_fwd`) on CUDA tensors,
    counted by the caller: (y, hN, carries), carries as `ssd_fused_fwd`'s.
    x (G, L, H, P), B_mat and C (G, L, NG, N) and dt (G, L, H) may be views
    into wider tensors (a conv output and an in_proj output): the kernel
    takes each one's batch and row strides and needs each row's columns
    contiguous."""
    G, L, H, P = x.shape
    NG, N = B_mat.shape[-2:]
    dims = (H, P, NG, N)
    dev = x.device
    A_, D_, bias_ = _unfused_views(x, B_mat, C, dt, A, D, dt_bias, chunk_size)
    h0 = _small(h_init, (G, H, N, P), "h_init", dev)
    y = torch.empty(G, L, H, P, dtype=x.dtype, device=dev)
    hN = torch.empty(G, H, N, P, dtype=torch.float32, device=dev)
    nc = -(-L // chunk_size)
    carries = (torch.empty(G, nc, H, N, P, dtype=carry_dtype(x.dtype),
                           device=dev) if save_carries else None)
    with torch.cuda.device(dev):
        err = _fn("ssd_fwd")(
            _DTYPES[x.dtype], *_strided(x, B_mat, C, dt),
            _ptr(A_), _ptr(D_), _ptr(bias_), _ptr(h0),
            y.data_ptr(), hN.data_ptr(), _ptr(carries),
            G, L, H, P, NG, N, int(dt_softplus), int(reverse),
            torch.cuda.current_stream(dev).cuda_stream)
    _check(err, "ssd_fwd", G, L, dims, x.dtype)
    return y, hN, carries


def launch_bwd(x, dt, A, B_mat, C, D, dt_bias, g_y, carries, g_hN,
               dt_softplus, reverse, chunk_size):
    """One launch of the unfused backward kernel (`ssd_bwd`) on CUDA
    tensors, counted by the caller: `ops/ssd.py ssd_chunked_bwd`'s
    ``(g_x, g_dt, g_A, g_B, g_C, g_D, g_dt_bias, g_h0)``, g_B and g_C the
    kernel's fp32 sums over each group's heads. x, B, C and dt as
    `launch_fwd` takes them; carries from `launch_fwd(save_carries=True)`."""
    G, L, H, P = x.shape
    NG, N = B_mat.shape[-2:]
    dims = (H, P, NG, N)
    dev = x.device
    A_, D_, bias_ = _unfused_views(x, B_mat, C, dt, A, D, dt_bias, chunk_size)
    want = (G, -(-L // chunk_size), H, N, P)
    if (tuple(carries.shape) != want or carries.device != dev
            or carries.dtype != carry_dtype(x.dtype)):
        raise ValueError(f"carries {tuple(carries.shape)} {carries.dtype} on "
                         f"{carries.device}; expected {want} "
                         f"{carry_dtype(x.dtype)} on {dev}")
    g_y = g_y.to(x.dtype).contiguous()
    carries = carries.contiguous()
    ghN = _small(g_hN, (G, H, N, P), "g_hN", dev)
    g_x = torch.empty(G, L, H, P, dtype=x.dtype, device=dev)
    g_BC = torch.empty(2, G, L, NG, N, dtype=torch.float32, device=dev)
    g_dt = torch.empty(G, L, H, dtype=x.dtype, device=dev)
    g_h0 = torch.empty(G, H, N, P, dtype=torch.float32, device=dev)
    g_heads = torch.empty(3, H, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _fn("ssd_bwd")(
            _DTYPES[x.dtype], *_strided(x, B_mat, C, dt),
            _ptr(A_), _ptr(D_), _ptr(bias_), g_y.data_ptr(),
            carries.data_ptr(), _ptr(ghN), g_x.data_ptr(), g_BC.data_ptr(),
            g_dt.data_ptr(), g_h0.data_ptr(), g_heads.data_ptr(),
            G, L, H, P, NG, N, int(dt_softplus), int(reverse),
            torch.cuda.current_stream(dev).cuda_stream)
    _check(err, "ssd_bwd", G, L, dims, x.dtype)
    return (g_x, g_dt, g_heads[0], g_BC[0], g_BC[1], g_heads[2], g_heads[1],
            g_h0)


def ssd_fwd(x, dt, A, B_mat, C, D, dt_bias, dt_softplus, reverse, chunk_size,
            h_init, save_carries: bool):
    """One launch of the unfused forward kernel on CUDA tensors (TPU kernel
    #2; `launch_fwd`), counted in ``unfused_launches``."""
    out = launch_fwd(x, dt, A, B_mat, C, D, dt_bias, dt_softplus, reverse,
                     chunk_size, h_init, save_carries)
    global unfused_launches
    unfused_launches += 1
    return out


def ssd_bwd(x, dt, A, B_mat, C, D, dt_bias, g_y, carries, g_hN,
            dt_softplus=False, reverse=False, chunk_size=None):
    """The unfused adjoint from the forward's carries, `ops/ssd.py
    ssd_chunked_bwd` semantics and tuple. On a CPU tensor that plain
    version; on a CUDA tensor one launch of `ssd_bwd` (TPU kernel #4;
    `launch_bwd`), counted in ``unfused_bwd_launches``, or it raises.
    ``g_y`` is cast to x's dtype, as the JAX package's `_chained_bwd`
    does."""
    if chunk_size is None:
        chunk_size = KERNEL_CHUNK.get(x.dtype, 64)
    if not on_card(x, "ssd_bwd"):
        return plain_chunked_bwd(x, dt, A, B_mat, C, D, dt_bias,
                                 g_y.to(x.dtype), carries, g_hN, dt_softplus,
                                 reverse, chunk_size)
    out = launch_bwd(x, dt, A, B_mat, C, D, dt_bias, g_y, carries, g_hN,
                     dt_softplus, reverse, chunk_size)
    global unfused_bwd_launches
    unfused_bwd_launches += 1
    return out


def on_card(t: torch.Tensor, what: str) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises otherwise."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {t.device}")
    return True


def _like(grad, p):
    return None if p is None else grad.to(p.dtype).reshape(p.shape)


class _SSDFn(torch.autograd.Function):
    """The counterpart of `ssd_pallas_batched_chained`'s (and
    `ssd_pallas_chained`'s) custom_vjp: forward = the unfused forward kernel
    with carries, backward = one launch of the unfused backward kernel.
    ``fwd`` / ``bwd`` are the counting wrappers of the entry that calls it
    (`ssd_fwd` / `ssd_bwd` here, `ops/ssd_head.py`'s for the per-head
    entry)."""

    @staticmethod
    def forward(ctx, x, dt, A, B_mat, C, D, dt_bias, h_init, dt_softplus,
                reverse, chunk_size, fwd, bwd):
        y, hN, carries = fwd(x, dt, A, B_mat, C, D, dt_bias, dt_softplus,
                             reverse, chunk_size, h_init, save_carries=True)
        ctx.save_for_backward(x, dt, A, B_mat, C, D, dt_bias, carries)
        ctx.cfg = (dt_softplus, reverse, chunk_size, h_init is not None, bwd)
        return y, hN

    @staticmethod
    def backward(ctx, g_y, g_hN):
        x, dt, A, B_mat, C, D, dt_bias, carries = ctx.saved_tensors
        dt_softplus, reverse, chunk_size, has_h0, bwd = ctx.cfg
        # autograd materializes a missing cotangent as zeros
        g = bwd(x, dt, A, B_mat, C, D, dt_bias, g_y, carries, g_hN,
                dt_softplus, reverse, chunk_size)
        g_x, g_dt, g_A, g_B, g_C, g_D, g_bias, g_h0 = g
        return (g_x, g_dt.to(dt.dtype), _like(g_A, A), g_B.to(B_mat.dtype),
                g_C.to(C.dtype), _like(g_D, D), _like(g_bias, dt_bias),
                g_h0 if has_h0 else None, None, None, None, None, None)


def chained(x, dt, A, B_mat, C, D, dt_bias, h_init, dt_softplus, reverse,
            chunk_size, fwd, bwd, what):
    """(y, hN) of the unfused SSD through the counting wrappers ``fwd`` /
    ``bwd``: on a CPU tensor `ops/ssd.py ssd_chunked` (autograd
    differentiates it); on a CUDA tensor ``fwd``, or `_SSDFn` when an input
    requires grad; raises on anything else."""
    if x.dim() != 4 or B_mat.dim() != 4:
        raise ValueError(f"x {tuple(x.shape)} and B {tuple(B_mat.shape)}: "
                         "expected (G, L, H, P) and (G, L, NG, N)")
    G, L, H, P = x.shape
    NG, N = B_mat.shape[-2:]
    for name, t, want in (("dt", dt, (G, L, H)), ("B", B_mat, (G, L, NG, N)),
                          ("C", C, (G, L, NG, N))):
        if tuple(t.shape) != want:
            raise ValueError(f"{name} shape {tuple(t.shape)}, expected {want}")
    if H % NG != 0:
        raise ValueError(f"nheads {H} not divisible by ngroups {NG}")
    if chunk_size is None:
        chunk_size = KERNEL_CHUNK.get(x.dtype, 64)
    if not on_card(x, what):
        return plain_chunked(x, dt, A, B_mat, C, D, dt_bias, dt_softplus,
                             reverse, chunk_size, h_init,
                             return_final_state=True)
    inputs = (x, dt, A, B_mat, C, D, dt_bias, h_init)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in inputs):
        return _SSDFn.apply(*inputs, dt_softplus, reverse, chunk_size, fwd,
                            bwd)
    y, hN, _ = fwd(x, dt, A, B_mat, C, D, dt_bias, dt_softplus, reverse,
                   chunk_size, h_init, save_carries=False)
    return y, hN


def ssd_batched_chained(
    x: torch.Tensor,                        # (G, L, H, P) post-conv
    dt: torch.Tensor,                       # (G, L, H) raw
    A: torch.Tensor,                        # (H,)
    B_mat: torch.Tensor,                    # (G, L, NG, N)
    C: torch.Tensor,                        # (G, L, NG, N)
    D: Optional[torch.Tensor] = None,       # (H,)
    dt_bias: Optional[torch.Tensor] = None,  # (H,)
    h_init: Optional[torch.Tensor] = None,  # (G, H, N, P) fp32
    dt_softplus: bool = True,
    reverse: bool = False,
    chunk_size: Optional[int] = None,
):
    """The counterpart of `ssd_pallas_batched_chained`: returns (y (G, L, H,
    P) in x's dtype, hN (G, H, N, P) fp32). ``chunk_size`` defaults to the
    kernel's (`KERNEL_CHUNK`). On a CPU tensor it runs `ops/ssd.py
    ssd_chunked`; on a CUDA tensor one launch of `ssd_fwd` (TPU kernel #2)
    and, under grad, one of `ssd_bwd` (#4) in the backward, or it
    raises."""
    return chained(x, dt, A, B_mat, C, D, dt_bias, h_init, dt_softplus,
                   reverse, chunk_size, ssd_fwd, ssd_bwd,
                   "ssd_batched_chained")


def ssd_batched(x, dt, A, B_mat, C, D=None, dt_bias=None,
                dt_softplus: bool = False, reverse: bool = False,
                chunk_size: Optional[int] = None,
                h_init: Optional[torch.Tensor] = None,
                return_final_state: bool = False):
    """The counterpart of `ssd_pallas_batched`, a drop-in for `ops/ssd.py
    ssd_chunked` on post-conv x, B, C: `ssd_batched_chained` from h_init
    (zeros when None); y, and hN when ``return_final_state``."""
    y, hN = ssd_batched_chained(x, dt, A, B_mat, C, D, dt_bias, h_init,
                                dt_softplus, reverse, chunk_size)
    return (y, hN) if return_final_state else y


def ssd_adjoint_xc(
    xBC: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
    conv_w: torch.Tensor, conv_b: Optional[torch.Tensor],
    D: Optional[torch.Tensor], dt_bias: Optional[torch.Tensor],
    g_y: torch.Tensor, carries: torch.Tensor, g_hN: Optional[torch.Tensor],
    dims: Tuple[int, int, int, int], dt_softplus: bool = False,
    reverse: bool = False, chunk_size: Optional[int] = None,
):
    """The SSD part of the backward, `ops/ssd.py ssd_adjoint_xc` semantics:
    ``(g_xc, g_dt, g_A, g_D, g_dt_bias, g_h0)``. On a CPU tensor that plain
    version; on a CUDA tensor one launch of `ssd_fused_bwd_kernel`, or
    raises. ``g_y`` is cast to xBC's dtype, as the JAX package's
    `_fused_chained_bwd` does."""
    H, P, NG, N = (int(v) for v in dims)
    dims = (H, P, NG, N)
    G, L, Wc = xBC.shape
    if chunk_size is None:
        chunk_size = KERNEL_CHUNK.get(xBC.dtype, 64)
    if tuple(g_y.shape) != (G, L, H, P):
        raise ValueError(f"g_y shape {tuple(g_y.shape)}, expected "
                         f"{(G, L, H, P)}")
    g_y = g_y.to(xBC.dtype)
    if xBC.device.type == "cpu":
        return plain_adjoint_xc(xBC, dt, A, conv_w, conv_b, D, dt_bias, g_y,
                                carries, g_hN, dims, dt_softplus, reverse,
                                chunk_size)
    if xBC.device.type != "cuda":
        raise ValueError(f"ssd_adjoint_xc: unsupported device {xBC.device}")
    dev = xBC.device
    K, (A_, D_, bias_, w_, b_) = _kernel_args(
        xBC, dt, A, conv_w, conv_b, D, dt_bias, dims, chunk_size)
    want = (G, -(-L // chunk_size), H, N, P)
    if (tuple(carries.shape) != want or carries.device != dev
            or carries.dtype != carry_dtype(xBC.dtype)):
        raise ValueError(f"carries {tuple(carries.shape)} {carries.dtype} on "
                         f"{carries.device}; expected {want} "
                         f"{carry_dtype(xBC.dtype)} on {dev}")
    g_y = g_y.contiguous()
    carries = carries.contiguous()
    ghN = _small(g_hN, (G, H, N, P), "g_hN", dev)
    g_xc = torch.empty(G, L, Wc, dtype=torch.float32, device=dev)
    g_dt = torch.empty(G, L, H, dtype=xBC.dtype, device=dev)
    g_h0 = torch.empty(G, H, N, P, dtype=torch.float32, device=dev)
    g_heads = torch.empty(3, H, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _fn("ssd_fused_bwd")(
            _DTYPES[xBC.dtype],
            xBC.data_ptr(), xBC.stride(0), xBC.stride(1),
            dt.data_ptr(), dt.stride(0), dt.stride(1),
            _ptr(A_), _ptr(D_), _ptr(bias_), _ptr(w_), _ptr(b_),
            g_y.data_ptr(), carries.data_ptr(), _ptr(ghN),
            g_xc.data_ptr(), g_dt.data_ptr(), g_h0.data_ptr(),
            g_heads.data_ptr(),
            G, L, H, P, NG, N, K, int(dt_softplus), int(reverse),
            torch.cuda.current_stream(dev).cuda_stream)
    _check(err, "ssd_fused_bwd", G, L, dims, xBC.dtype)
    global bwd_launches
    bwd_launches += 1
    return g_xc, g_dt, g_heads[0], g_heads[2], g_heads[1], g_h0


def conv_silu_bwd(g_xc: torch.Tensor, xBC: torch.Tensor,
                  conv_w: torch.Tensor, conv_b: Optional[torch.Tensor],
                  reverse: bool = False):
    """SiLU and depthwise-conv adjoints, `ops/ssd.py conv_silu_bwd`
    semantics: ``(g_xBC, g_conv_w, g_conv_b)``. On a CPU tensor that plain
    version; on a CUDA tensor one launch of `ssd_conv_bwd_kernel`, or
    raises."""
    if xBC.device.type == "cpu":
        return plain_conv_silu_bwd(g_xc, xBC, conv_w, conv_b, reverse)
    if xBC.device.type != "cuda":
        raise ValueError(f"conv_silu_bwd: unsupported device {xBC.device}")
    G, L, Wc = xBC.shape
    dev = xBC.device
    if xBC.dtype not in _DTYPES or xBC.stride(2) != 1:
        raise TypeError(f"xBC {xBC.dtype} with strides {xBC.stride()}: the "
                        "kernel takes float32 or bfloat16, unit column stride")
    if (g_xc.shape != xBC.shape or g_xc.dtype != torch.float32
            or not g_xc.is_contiguous() or g_xc.device != dev):
        raise ValueError(f"g_xc {tuple(g_xc.shape)} {g_xc.dtype}: expected a "
                         f"contiguous float32 {tuple(xBC.shape)} on {dev}")
    K = _conv_width(conv_w)
    w_ = _small(conv_w, (K, Wc), "conv_w", dev)
    b_ = _small(conv_b, (Wc,), "conv_b", dev)
    g_xBC = torch.empty(G, L, Wc, dtype=xBC.dtype, device=dev)
    g_conv = torch.empty(K + 1, Wc, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _fn("ssd_conv_bwd")(
            _DTYPES[xBC.dtype], xBC.data_ptr(), xBC.stride(0), xBC.stride(1),
            w_.data_ptr(), _ptr(b_), g_xc.data_ptr(), g_xBC.data_ptr(),
            g_conv.data_ptr(), G, L, Wc, K, int(reverse),
            torch.cuda.current_stream(dev).cuda_stream)
    _check(err, "ssd_conv_bwd", G, L, (Wc, K), xBC.dtype)
    global conv_bwd_launches
    conv_bwd_launches += 1
    return g_xBC, g_conv[:K], g_conv[K]


def ssd_fused_bwd(xBC, dt, A, conv_w, conv_b, D, dt_bias, g_y, carries,
                  g_hN, dims, dt_softplus=False, reverse=False,
                  chunk_size=None):
    """Adjoint of the fused forward from its carries: `ssd_adjoint_xc` then
    `conv_silu_bwd` (the two kernels on a CUDA tensor, their plain versions
    on a CPU tensor). Returns the tuple of `ops/ssd.py
    ssd_chunked_fused_bwd`: ``(g_xBC, g_dt, g_A, g_conv_w, g_conv_b, g_D,
    g_dt_bias, g_h0)``."""
    g_xc, g_dt, g_A, g_D, g_bias, g_h0 = ssd_adjoint_xc(
        xBC, dt, A, conv_w, conv_b, D, dt_bias, g_y, carries, g_hN, dims,
        dt_softplus, reverse, chunk_size)
    g_xBC, g_w, g_b = conv_silu_bwd(g_xc, xBC, conv_w, conv_b, reverse)
    return g_xBC, g_dt, g_A, g_w, g_b, g_D, g_bias, g_h0


class _SSDFusedFn(torch.autograd.Function):
    """The counterpart of `ssd_pallas_batched_fused_chained`'s custom_vjp:
    forward = `ssd_fused_fwd` with carries, backward = `ssd_fused_bwd`."""

    @staticmethod
    def forward(ctx, xBC, dt, A, conv_w, conv_b, D, dt_bias, h_init, dims,
                dt_softplus, reverse, chunk_size):
        y, hN, carries = ssd_fused_fwd(
            xBC, dt, A, conv_w, conv_b, D, dt_bias, dims, dt_softplus,
            reverse, chunk_size, h_init, save_carries=True)
        ctx.save_for_backward(xBC, dt, A, conv_w, conv_b, D, dt_bias, carries)
        ctx.cfg = (dims, dt_softplus, reverse, chunk_size, h_init is not None)
        return y, hN

    @staticmethod
    def backward(ctx, g_y, g_hN):
        xBC, dt, A, conv_w, conv_b, D, dt_bias, carries = ctx.saved_tensors
        dims, dt_softplus, reverse, chunk_size, has_h0 = ctx.cfg
        # autograd materializes a missing cotangent as zeros (the default
        # of `ctx.set_materialize_grads`), so g_y and g_hN are tensors
        g = ssd_fused_bwd(xBC, dt, A, conv_w, conv_b, D, dt_bias, g_y,
                          carries, g_hN, dims, dt_softplus, reverse,
                          chunk_size)
        g_xBC, g_dt, g_A, g_w, g_b, g_D, g_bias, g_h0 = g

        def like(grad, p):
            return None if p is None else grad.to(p.dtype).reshape(p.shape)

        return (g_xBC, g_dt.to(dt.dtype), like(g_A, A), like(g_w, conv_w),
                like(g_b, conv_b), like(g_D, D), like(g_bias, dt_bias),
                g_h0 if has_h0 else None, None, None, None, None)


def ssd_batched_fused(
    xBC: torch.Tensor,                      # (G, L, H·P + 2·NG·N) pre-conv
    dt: torch.Tensor,                       # (G, L, H) raw
    A: torch.Tensor,                        # (H,)
    conv_w: torch.Tensor,                   # (K, Wc)
    conv_b: Optional[torch.Tensor] = None,  # (Wc,)
    D: Optional[torch.Tensor] = None,       # (H,)
    dt_bias: Optional[torch.Tensor] = None,  # (H,)
    dims: Tuple[int, int, int, int] = None,  # (H, P, NG, N)
    dt_softplus: bool = False,
    reverse: bool = False,
    chunk_size: Optional[int] = None,
    h_init: Optional[torch.Tensor] = None,  # (G, H, N, P) fp32
    return_final_state: bool = False,
):
    """`ssd_chunked(conv_w=..., dims=...)` semantics: returns y (G, L, H, P)
    in xBC's dtype, and hN (G, H, N, P) fp32 when ``return_final_state``.
    ``chunk_size`` defaults to the kernel's (`KERNEL_CHUNK`).

    xBC and dt may be column slices of a wider tensor (e.g. of the mixer's
    in_proj output): the kernels take their batch and row strides and
    need only a unit column stride."""
    if dims is None:
        raise ValueError("dims=(H, P, NG, N) is required")
    H, P, NG, N = (int(v) for v in dims)
    dims = (H, P, NG, N)
    if xBC.dim() != 3 or xBC.shape[2] != H * P + 2 * NG * N:
        raise ValueError(f"xBC shape {tuple(xBC.shape)} does not match "
                         f"dims {dims}")
    G, L, Wc = xBC.shape
    if tuple(dt.shape) != (G, L, H):
        raise ValueError(f"dt shape {tuple(dt.shape)}, expected {(G, L, H)}")
    if H % NG != 0:
        raise ValueError(f"nheads {H} not divisible by ngroups {NG}")
    if chunk_size is None:
        chunk_size = KERNEL_CHUNK.get(xBC.dtype, 64)
    if xBC.device.type == "cpu":
        return ssd_chunked_fused(
            xBC, dt, A, conv_w, conv_b, D, dt_bias, dims=dims,
            dt_softplus=dt_softplus, reverse=reverse, chunk_size=chunk_size,
            h_init=h_init, return_final_state=return_final_state)
    if xBC.device.type != "cuda":
        raise ValueError(f"ssd_batched_fused: unsupported device {xBC.device}")
    inputs = (xBC, dt, A, conv_w, conv_b, D, dt_bias, h_init)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in inputs):
        y, hN = _SSDFusedFn.apply(*inputs, dims, dt_softplus, reverse,
                                  chunk_size)
    else:
        y, hN, _ = ssd_fused_fwd(xBC, dt, A, conv_w, conv_b, D, dt_bias,
                                 dims, dt_softplus, reverse, chunk_size,
                                 h_init, save_carries=False)
    return (y, hN) if return_final_state else y
