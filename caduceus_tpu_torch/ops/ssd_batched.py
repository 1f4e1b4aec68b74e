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

Launch counters (one per call of a TPU kernel's counterpart on a CUDA
tensor, however many `__global__` launches it makes): ``launches``
(`ssd_fused_fwd`), ``unfused_launches`` (`ssd_fwd`), ``bwd_launches``
(the SSD adjoint of `ssd_fused_bwd`), ``conv_bwd_launches`` (its SiLU + conv
adjoint) and ``unfused_bwd_launches`` (`ssd_bwd`). A forward call is three
launches (the B/C conv and CB per group, the segment pre-pass, the main
pass; `csrc/ssd_fused_fwd.cu`), an adjoint call four (the same three and
the fixed-order g_B / g_C head sum; `csrc/ssd_fused_bwd.cu`), and the
chunks of each (g, h) are cut into `n_segments` segments so that the grid
fills the card.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from caduceus_tpu_torch import _build
from caduceus_tpu_torch.ops.ssd import CONV_TILE_ROWS, carry_dtype
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

# sub-launches of one call (the `parts` argument of the C entry points)
PART_PREP, PART_STATE, PART_MAIN, PART_SUM = 1, 2, 4, 8
ALL_FWD = PART_PREP | PART_STATE | PART_MAIN
ALL_BWD = ALL_FWD | PART_SUM

launches = 0
unfused_launches = 0
bwd_launches = 0
conv_bwd_launches = 0
unfused_bwd_launches = 0

_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_ARGTYPES = {
    "ssd_fused_fwd": [_I] + [_P, _LL, _LL] * 2 + [_P] * 13 + [_I] * 11 + [_P],
    "ssd_fwd": [_I] + [_P, _LL, _LL] * 4 + [_P] * 10 + [_I] * 9 + [_P],
    "ssd_fused_bwd": [_I] + [_P, _LL, _LL] * 2 + [_P] * 19 + [_I] * 11 + [_P],
    "ssd_conv_bwd": [_I, _P, _LL, _LL] + [_P] * 6 + [_I] * 5 + [_P],
    "ssd_bwd": [_I] + [_P, _LL, _LL] * 4 + [_P] * 17 + [_I] * 9 + [_P],
}
_LIBRARY = {"ssd_fused_fwd": "ssd_fused_fwd", "ssd_fwd": "ssd_fused_fwd",
            "ssd_fused_bwd": "ssd_fused_bwd", "ssd_conv_bwd": "ssd_fused_bwd",
            "ssd_bwd": "ssd_fused_bwd"}


def _fn(name: str, defines=()):
    """The C entry point ``name``, loaded (and built) on first use; from
    the variant library built with ``defines`` when they are given (the
    checks' planted faults, `csrc/ssd_fused_bwd.cu` CONV_DROP)."""
    fn = getattr(_build.load(_LIBRARY[name], defines), name)
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


_SM_COUNT: dict = {}


def n_segments(G: int, H: int, nc: int, dev) -> int:
    """Segments per (g, h) sequence of the kernels' chunk-parallel state
    passing: as many as keep G·H·S blocks (one per SM: the main passes use
    more than half an SM's shared memory) within the SMs of the card
    ``dev``, at least 1 and at most nc, then the fewest segments of the same
    whole-chunk length (`ops/ssd.py segment_bounds`), so that none is
    empty. G=4 (training, H=8) on 132 SMs gives 4; a batch-1 prefill 16;
    G=16 1."""
    idx = torch.device(dev).index or 0
    if idx not in _SM_COUNT:
        _SM_COUNT[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    S = max(1, min(nc, _SM_COUNT[idx] // max(1, G * H)))
    sc = -(-nc // S)
    return -(-nc // sc)


def fwd_workspace(G, L, dims, dtype, dev, fused: bool, S: int) -> dict:
    """Scratch of one forward call: ``bc`` (fused only; the post-conv B and C
    rows, (G, L, 2·NG·N) in the storage dtype), ``cb`` (CB per group and
    chunk, (G, NG, nc, T, T) fp32), ``seg`` / ``seg_a`` (each segment's
    state from zero and its sum of a, (G, H, S, N, P) and (G, H, S) fp32)."""
    H, P, NG, N = dims
    T = KERNEL_CHUNK[dtype]
    nc = -(-L // T)
    f32 = dict(dtype=torch.float32, device=dev)
    return {"bc": (torch.empty(G, L, 2 * NG * N, dtype=dtype, device=dev)
                   if fused else None),
            "cb": torch.empty(G, NG, nc, T, T, **f32),
            "seg": torch.empty(G, H, S, N, P, **f32),
            "seg_a": torch.empty(G, H, S, **f32), "S": S}


def bwd_workspace(G, L, dims, dtype, dev, fused: bool, S: int) -> dict:
    """Scratch of one adjoint call: the forward's (``seg``: each segment's
    lambda from zero), ``shares`` (each head's fp32 [g_B | g_C] share,
    (G, L, H, 2·N)), ``partials`` / ``tickets`` (the blocks' g_A, g_dt_bias,
    g_D sums and the per-head ticket that adds them in a fixed order)."""
    H, P, NG, N = dims
    ws = fwd_workspace(G, L, dims, dtype, dev, fused, S)
    ws["shares"] = torch.empty(G, L, H, 2 * N, dtype=torch.float32,
                               device=dev)
    ws["partials"] = torch.empty(H, G * S, 3, dtype=torch.float32,
                                 device=dev)
    ws["tickets"] = torch.empty(H, dtype=torch.int32, device=dev)
    return ws


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


def fused_fwd_call(xBC, dt, A, conv_w, conv_b, D, dt_bias, dims, dt_softplus,
                   reverse, chunk_size, h_init, save_carries: bool,
                   parts: int = ALL_FWD, ws: Optional[dict] = None):
    """One call of the forward kernels on CUDA tensors, not counted: (y, hN,
    carries, ws). ``parts`` picks the sub-launches (`PART_PREP`,
    `PART_STATE`, `PART_MAIN`); ``ws`` (`fwd_workspace`) may be kept from a
    call to the next, so that the sub-launches can run one at a time."""
    H, P, NG, N = dims
    G, L, Wc = xBC.shape
    dev = xBC.device
    K, (A_, D_, bias_, w_, b_) = _kernel_args(
        xBC, dt, A, conv_w, conv_b, D, dt_bias, dims, chunk_size)
    h0 = _small(h_init, (G, H, N, P), "h_init", dev)
    nc = -(-L // chunk_size)
    if ws is None:
        ws = fwd_workspace(G, L, dims, xBC.dtype, dev, True,
                           n_segments(G, H, nc, dev))
    y = torch.empty(G, L, H, P, dtype=xBC.dtype, device=dev)
    hN = torch.empty(G, H, N, P, dtype=torch.float32, device=dev)
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
            _ptr(ws["bc"]), _ptr(ws["cb"]), _ptr(ws["seg"]),
            _ptr(ws["seg_a"]),
            G, L, H, P, NG, N, K, ws["S"], int(dt_softplus), int(reverse),
            parts, stream)
    _check(err, "ssd_fused_fwd", G, L, dims, xBC.dtype)
    return y, hN, carries, ws


def ssd_fused_fwd(xBC, dt, A, conv_w, conv_b, D, dt_bias, dims, dt_softplus,
                  reverse, chunk_size, h_init, save_carries: bool):
    """One call of the forward kernels on CUDA tensors (TPU kernel #1;
    `fused_fwd_call`), counted in ``launches``: (y, hN, carries), carries =
    the state entering every chunk, (G, nc, H, N, P) in `carry_dtype`, when
    ``save_carries`` (else None)."""
    y, hN, carries, _ = fused_fwd_call(
        xBC, dt, A, conv_w, conv_b, D, dt_bias, dims, dt_softplus, reverse,
        chunk_size, h_init, save_carries)
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
    """One call of the unfused forward kernels (`ssd_fwd`) on CUDA tensors,
    counted by the caller: (y, hN, carries), carries as `ssd_fused_fwd`'s.
    x (G, L, H, P), B_mat and C (G, L, NG, N) and dt (G, L, H) may be views
    into wider tensors (a conv output and an in_proj output): the kernels
    take each one's batch and row strides and need each row's columns
    contiguous."""
    G, L, H, P = x.shape
    NG, N = B_mat.shape[-2:]
    dims = (H, P, NG, N)
    dev = x.device
    A_, D_, bias_ = _unfused_views(x, B_mat, C, dt, A, D, dt_bias, chunk_size)
    h0 = _small(h_init, (G, H, N, P), "h_init", dev)
    nc = -(-L // chunk_size)
    ws = fwd_workspace(G, L, dims, x.dtype, dev, False,
                       n_segments(G, H, nc, dev))
    y = torch.empty(G, L, H, P, dtype=x.dtype, device=dev)
    hN = torch.empty(G, H, N, P, dtype=torch.float32, device=dev)
    carries = (torch.empty(G, nc, H, N, P, dtype=carry_dtype(x.dtype),
                           device=dev) if save_carries else None)
    with torch.cuda.device(dev):
        err = _fn("ssd_fwd")(
            _DTYPES[x.dtype], *_strided(x, B_mat, C, dt),
            _ptr(A_), _ptr(D_), _ptr(bias_), _ptr(h0),
            y.data_ptr(), hN.data_ptr(), _ptr(carries),
            _ptr(ws["cb"]), _ptr(ws["seg"]), _ptr(ws["seg_a"]),
            G, L, H, P, NG, N, ws["S"], int(dt_softplus), int(reverse),
            torch.cuda.current_stream(dev).cuda_stream)
    _check(err, "ssd_fwd", G, L, dims, x.dtype)
    return y, hN, carries


def launch_bwd(x, dt, A, B_mat, C, D, dt_bias, g_y, carries, g_hN,
               dt_softplus, reverse, chunk_size):
    """One call of the unfused backward kernels (`ssd_bwd`) on CUDA
    tensors, counted by the caller: `ops/ssd.py ssd_chunked_bwd`'s
    ``(g_x, g_dt, g_A, g_B, g_C, g_D, g_dt_bias, g_h0)``, g_B and g_C the
    fp32 sums over each group's heads, added in head order. x, B, C and dt
    as `launch_fwd` takes them; carries from
    `launch_fwd(save_carries=True)`."""
    G, L, H, P = x.shape
    NG, N = B_mat.shape[-2:]
    dims = (H, P, NG, N)
    dev = x.device
    A_, D_, bias_ = _unfused_views(x, B_mat, C, dt, A, D, dt_bias, chunk_size)
    nc = -(-L // chunk_size)
    want = (G, nc, H, N, P)
    if (tuple(carries.shape) != want or carries.device != dev
            or carries.dtype != carry_dtype(x.dtype)):
        raise ValueError(f"carries {tuple(carries.shape)} {carries.dtype} on "
                         f"{carries.device}; expected {want} "
                         f"{carry_dtype(x.dtype)} on {dev}")
    g_y = g_y.to(x.dtype).contiguous()
    carries = carries.contiguous()
    ghN = _small(g_hN, (G, H, N, P), "g_hN", dev)
    ws = bwd_workspace(G, L, dims, x.dtype, dev, False,
                       n_segments(G, H, nc, dev))
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
            _ptr(ws["cb"]), _ptr(ws["seg"]), _ptr(ws["seg_a"]),
            _ptr(ws["shares"]), _ptr(ws["partials"]), _ptr(ws["tickets"]),
            G, L, H, P, NG, N, ws["S"], int(dt_softplus), int(reverse),
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


def adjoint_xc_call(xBC, dt, A, conv_w, conv_b, D, dt_bias, g_y, carries,
                    g_hN, dims, dt_softplus, reverse, chunk_size,
                    parts: int = ALL_BWD, ws: Optional[dict] = None):
    """One call of the fused SSD adjoint's kernels on CUDA tensors, not
    counted: ``((g_xc, g_dt, g_A, g_D, g_dt_bias, g_h0), ws)``; ``parts``
    and ``ws`` (`bwd_workspace`) as `fused_fwd_call`'s, with `PART_SUM`."""
    H, P, NG, N = dims
    G, L, Wc = xBC.shape
    dev = xBC.device
    K, (A_, D_, bias_, w_, b_) = _kernel_args(
        xBC, dt, A, conv_w, conv_b, D, dt_bias, dims, chunk_size)
    nc = -(-L // chunk_size)
    want = (G, nc, H, N, P)
    if (tuple(carries.shape) != want or carries.device != dev
            or carries.dtype != carry_dtype(xBC.dtype)):
        raise ValueError(f"carries {tuple(carries.shape)} {carries.dtype} on "
                         f"{carries.device}; expected {want} "
                         f"{carry_dtype(xBC.dtype)} on {dev}")
    g_y = g_y.contiguous()
    carries = carries.contiguous()
    ghN = _small(g_hN, (G, H, N, P), "g_hN", dev)
    if ws is None:
        ws = bwd_workspace(G, L, dims, xBC.dtype, dev, True,
                           n_segments(G, H, nc, dev))
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
            g_heads.data_ptr(), _ptr(ws["bc"]), _ptr(ws["cb"]),
            _ptr(ws["seg"]), _ptr(ws["seg_a"]), _ptr(ws["shares"]),
            _ptr(ws["partials"]), _ptr(ws["tickets"]),
            G, L, H, P, NG, N, K, ws["S"], int(dt_softplus), int(reverse),
            parts, torch.cuda.current_stream(dev).cuda_stream)
    _check(err, "ssd_fused_bwd", G, L, dims, xBC.dtype)
    return (g_xc, g_dt, g_heads[0], g_heads[2], g_heads[1], g_h0), ws


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
    version; on a CUDA tensor one call of the adjoint's kernels
    (`adjoint_xc_call`), counted in ``bwd_launches``, or it raises. ``g_y``
    is cast to xBC's dtype, as the JAX package's `_fused_chained_bwd`
    does."""
    H, P, NG, N = (int(v) for v in dims)
    dims = (H, P, NG, N)
    G, L, Wc = xBC.shape
    if chunk_size is None:
        chunk_size = KERNEL_CHUNK.get(xBC.dtype, 64)
    if tuple(g_y.shape) != (G, L, H, P):
        raise ValueError(f"g_y shape {tuple(g_y.shape)}, expected "
                         f"{(G, L, H, P)}")
    g_y = g_y.to(xBC.dtype)
    if not on_card(xBC, "ssd_adjoint_xc"):
        return plain_adjoint_xc(xBC, dt, A, conv_w, conv_b, D, dt_bias, g_y,
                                carries, g_hN, dims, dt_softplus, reverse,
                                chunk_size)
    out, _ = adjoint_xc_call(xBC, dt, A, conv_w, conv_b, D, dt_bias, g_y,
                             carries, g_hN, dims, dt_softplus, reverse,
                             chunk_size)
    global bwd_launches
    bwd_launches += 1
    return out


def conv_silu_bwd(g_xc: torch.Tensor, xBC: torch.Tensor,
                  conv_w: torch.Tensor, conv_b: Optional[torch.Tensor],
                  reverse: bool = False):
    """SiLU and depthwise-conv adjoints, `ops/ssd.py conv_silu_bwd`
    semantics: ``(g_xBC, g_conv_w, g_conv_b)``. On a CPU tensor that plain
    version; on a CUDA tensor one call of `ssd_conv_bwd` (the streaming
    conv-adjoint kernel over 1,024-row tiles and the fixed-order sum of its
    per-tile g_conv_w / g_conv_b partials), counted in
    ``conv_bwd_launches``, or raises."""
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
    # each conv-adjoint tile's g_conv_w / g_conv_b sums, per (g, row tile),
    # added in a fixed order by the second launch
    g_part = torch.empty(G * -(-L // CONV_TILE_ROWS), K + 1, Wc,
                         dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _fn("ssd_conv_bwd")(
            _DTYPES[xBC.dtype], xBC.data_ptr(), xBC.stride(0), xBC.stride(1),
            w_.data_ptr(), _ptr(b_), g_xc.data_ptr(), g_xBC.data_ptr(),
            g_conv.data_ptr(), g_part.data_ptr(), G, L, Wc, K, int(reverse),
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
