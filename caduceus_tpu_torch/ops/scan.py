"""Mamba-1 selective scan: the Python wrappers of the `selective_scan_fwd`,
`bidir_scan_fwd` and `selective_scan_bwd` kernels, and the
`torch.autograd.Function`s around them.

Port of `caduceus_tpu/ops/scan_pallas.py` (`selective_scan_pallas_chained`
and its custom_vjp) and `caduceus_tpu/ops/scan_pallas_bidir.py`
(`bidir_selective_scan_pallas`, whose default backward runs the
single-direction adjoint once per direction). Same operands and layouts:
u and delta (G, L, d), A (d, N), B and C (G, L, N); the states h_init, hN,
g_hN, g_h0 are (G, d, N) fp32 (the JAX kernels' are (G, N, d)).

- On a CPU tensor the wrappers run the plain versions,
  `ops/selective_scan.py` `selective_scan` and `selective_scan_bwd`.
- On a CUDA tensor they launch the hand-written CUDA kernels
  (`csrc/selective_scan_fwd.cu`, `csrc/selective_scan_bwd.cu`, built by
  `_build.py` at first use) or raise; they never fall back to the plain
  versions.
- With grad enabled and an input that requires grad, `selective_scan_chained`
  goes through `_SelectiveScanFn` (forward with carries, backward =
  `selective_scan_bwd`) and `bidir_selective_scan` through `_BidirScanFn`
  (one paired forward, two backward launches), on either device.

Launch counters (one per kernel launch on a CUDA tensor): ``fwd_launches``
(`selective_scan_fwd`, TPU kernel #7), ``bidir_launches``
(`bidir_scan_fwd`, #9) and ``bwd_launches`` (`selective_scan_bwd`, #8).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from caduceus_tpu_torch import _build
from caduceus_tpu_torch.ops.selective_scan import (
    selective_scan as plain_scan,
    selective_scan_bwd,
)

# rows per chunk of the kernels (`T` in csrc/scan_common.cuh): the carries
# sit at chunk boundaries, so the forward, the backward and the plain
# versions on the CPU all chunk by it
KERNEL_CHUNK = 64
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_DIR_WORDS = 20     # `Dir` of csrc/scan_common.cuh in 64-bit words

fwd_launches = 0
bidir_launches = 0
bwd_launches = 0

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    "selective_scan_fwd": [_I, _P, _I, _I, _I, _I, _I, _P],
    "bidir_scan_fwd": [_I, _P, _I, _I, _I, _I, _I, _P],
    "selective_scan_bwd": [_I, _P] + [_P] * 11 + [_I] * 5 + [_P],
}
_LIBRARY = {"selective_scan_fwd": "selective_scan_fwd",
            "bidir_scan_fwd": "selective_scan_fwd",
            "selective_scan_bwd": "selective_scan_bwd"}


def _fn(name: str):
    """The C entry point ``name``, loaded (and built) on first use."""
    fn = getattr(_build.load(_LIBRARY[name]), name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name]
        fn.restype = _I
    return fn


def build() -> dict:
    """Build both kernel libraries now, one nvcc each, side by side:
    {library: (path, compile seconds)}."""
    from concurrent.futures import ThreadPoolExecutor

    names = ("selective_scan_fwd", "selective_scan_bwd")
    with ThreadPoolExecutor(len(names)) as pool:
        return dict(zip(names, pool.map(_build.build, names)))


def _ptr(t: Optional[torch.Tensor]) -> int:
    return 0 if t is None else t.data_ptr()


def _small(t: Optional[torch.Tensor], shape, name: str, dev):
    """A parameter as the fp32 contiguous copy the kernel reads."""
    if t is None:
        return None
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{shape}")
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, u on {dev}")
    return t.detach().float().contiguous()


def _check(u, delta, A, B, C, D, delta_bias, chunk_size, h_init=None):
    """Check what the CUDA kernels take; returns the fp32 copies of (A, D,
    bias, h_init) the kernel reads."""
    G, L, d = u.shape
    N = A.shape[-1]
    dev = u.device
    if u.dtype not in _DTYPES:
        raise TypeError(f"u dtype {u.dtype}: the kernel takes float32 or "
                        "bfloat16")
    for name, t, shape in (("delta", delta, (G, L, d)), ("B", B, (G, L, N)),
                           ("C", C, (G, L, N))):
        if t.dtype != u.dtype or t.device != dev:
            raise TypeError(f"{name} is {t.dtype} on {t.device}; the kernel "
                            f"takes u's {u.dtype} on {dev}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} shape {tuple(t.shape)}, expected "
                             f"{shape}")
        if t.stride(2) != 1:
            raise ValueError(f"{name} needs a unit column stride")
    if u.stride(2) != 1:
        raise ValueError("u needs a unit column stride")
    if N not in (8, 16, 32):
        raise ValueError(f"d_state {N}: the kernel takes 8, 16 or 32")
    if chunk_size != KERNEL_CHUNK:
        raise ValueError(f"the CUDA kernels chunk by {KERNEL_CHUNK} rows, got "
                         f"chunk_size={chunk_size}")
    return (_small(A, (d, N), "A", dev), _small(D, (d,), "D", dev),
            _small(delta_bias, (d,), "delta_bias", dev),
            _small(h_init, (G, d, N), "h_init", dev))


def _dir(u, delta, B, C, A_, D_, bias_, h0, y, hN, carries, reverse):
    """The kernel's `Dir` (csrc/scan_common.cuh) as 64-bit words."""
    words = []
    for t in (u, delta, B, C):
        words += [t.data_ptr(), t.stride(0), t.stride(1)]
    words += [_ptr(t) for t in (A_, D_, bias_, h0, y, hN, carries)]
    words.append(int(reverse))
    assert len(words) == _DIR_WORDS
    return words


def _words(*dirs):
    flat = [w for dw in dirs for w in dw]
    return (ctypes.c_longlong * len(flat))(*flat)


def _raise(err: int, what: str, u, N):
    if err != 0:
        raise RuntimeError(f"{what} launch failed with CUDA error {err} "
                           f"(u {tuple(u.shape)} {u.dtype}, N={N})")


def _on_card(u: torch.Tensor, what: str) -> bool:
    if u.device.type == "cpu":
        return False
    if u.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {u.device}")
    return True


def selective_scan_fwd(u, delta, A, B, C, D=None, delta_bias=None,
                       delta_softplus=False, reverse=False,
                       chunk_size=KERNEL_CHUNK, h_init=None,
                       save_carries=False):
    """One direction: (y, hN, carries). y (G, L, d) in u's dtype, hN (G,
    d, N) fp32, carries (G, nc, d, N) fp32 when ``save_carries`` (else
    None). On a CUDA tensor one launch of `selective_scan_fwd` (TPU kernel
    #7)."""
    if not _on_card(u, "selective_scan_fwd"):
        out = plain_scan(u, delta, A, B, C, D, delta_bias, delta_softplus,
                         reverse, chunk_size, h_init, return_final_state=True,
                         return_carries=save_carries)
        return out if save_carries else out + (None,)
    G, L, d = u.shape
    N = A.shape[-1]
    A_, D_, bias_, h0 = _check(u, delta, A, B, C, D, delta_bias, chunk_size,
                               h_init)
    y = torch.empty(G, L, d, dtype=u.dtype, device=u.device)
    hN = torch.empty(G, d, N, dtype=torch.float32, device=u.device)
    nc = -(-L // chunk_size)
    car = (torch.empty(G, nc, d, N, dtype=torch.float32, device=u.device)
           if save_carries else None)
    words = _words(_dir(u, delta, B, C, A_, D_, bias_, h0, y, hN, car,
                        reverse))
    with torch.cuda.device(u.device):
        err = _fn("selective_scan_fwd")(
            _DTYPES[u.dtype], ctypes.cast(words, _P), G, L, d, N,
            int(delta_softplus), torch.cuda.current_stream().cuda_stream)
    _raise(err, "selective_scan_fwd", u, N)
    global fwd_launches
    fwd_launches += 1
    return y, hN, car


def bidir_scan_fwd(uf, df, Bf, Cf, ur, dr, Br, Cr, Af, Ar, Df=None, Dr=None,
                   biasf=None, biasr=None, delta_softplus=True,
                   chunk_size=KERNEL_CHUNK, save_carries=False):
    """Two parameter sets: set f scanned left to right, set r right to
    left, from zero states: (yf, yr, carf, carr) (carries None unless
    ``save_carries``). On a CUDA tensor one launch of `bidir_scan_fwd`
    (TPU kernel #9)."""
    if not _on_card(uf, "bidir_scan_fwd"):
        yf, _, carf = selective_scan_fwd(uf, df, Af, Bf, Cf, Df, biasf,
                                         delta_softplus, False, chunk_size,
                                         save_carries=save_carries)
        yr, _, carr = selective_scan_fwd(ur, dr, Ar, Br, Cr, Dr, biasr,
                                         delta_softplus, True, chunk_size,
                                         save_carries=save_carries)
        return yf, yr, carf, carr
    G, L, d = uf.shape
    N = Af.shape[-1]
    if ur.shape != uf.shape or ur.dtype != uf.dtype or ur.device != uf.device:
        raise ValueError(f"the two sets differ: u {tuple(uf.shape)} "
                         f"{uf.dtype} vs {tuple(ur.shape)} {ur.dtype}")
    nc = -(-L // chunk_size)
    sets, outs = [], []
    for u, dl, B, C, A, D, bias, rev in (
            (uf, df, Bf, Cf, Af, Df, biasf, False),
            (ur, dr, Br, Cr, Ar, Dr, biasr, True)):
        A_, D_, bias_, _ = _check(u, dl, A, B, C, D, bias, chunk_size)
        y = torch.empty(G, L, d, dtype=u.dtype, device=u.device)
        car = (torch.empty(G, nc, d, N, dtype=torch.float32, device=u.device)
               if save_carries else None)
        # the fp32 copies stay referenced until the launch is queued
        outs.append((y, car, A_, D_, bias_))
        sets.append(_dir(u, dl, B, C, A_, D_, bias_, None, y, None, car, rev))
    words = _words(*sets)
    with torch.cuda.device(uf.device):
        err = _fn("bidir_scan_fwd")(
            _DTYPES[uf.dtype], ctypes.cast(words, _P), G, L, d, N,
            int(delta_softplus), torch.cuda.current_stream().cuda_stream)
    _raise(err, "bidir_scan_fwd", uf, N)
    global bidir_launches
    bidir_launches += 1
    (yf, carf, *_), (yr, carr, *_) = outs
    return yf, yr, carf, carr


def selective_scan_bwd_cuda(u, delta, A, B, C, D, delta_bias, g_y, carries,
                            g_hN=None, delta_softplus=False, reverse=False,
                            chunk_size=KERNEL_CHUNK):
    """The adjoint from the forward's carries, `selective_scan_bwd`
    semantics: ``(g_u, g_delta, g_A, g_B, g_C, g_D, g_bias, g_h0)``.
    ``g_y`` is cast to u's dtype, as the JAX package's `_bwd` does. On a
    CUDA tensor one launch of `selective_scan_bwd` (TPU kernel #8); g_B
    and g_C are summed in an fp32 workspace and cast to B's / C's dtype
    here."""
    G, L, d = u.shape
    N = A.shape[-1]
    if tuple(g_y.shape) != (G, L, d):
        raise ValueError(f"g_y shape {tuple(g_y.shape)}, expected {(G, L, d)}")
    g_y = g_y.to(u.dtype)
    if not _on_card(u, "selective_scan_bwd"):
        return selective_scan_bwd(u, delta, A, B, C, D, delta_bias, g_y,
                                  carries, g_hN, delta_softplus, reverse,
                                  chunk_size)
    dev = u.device
    A_, D_, bias_, _ = _check(u, delta, A, B, C, D, delta_bias, chunk_size)
    want = (G, -(-L // chunk_size), d, N)
    if (tuple(carries.shape) != want or carries.dtype != torch.float32
            or carries.device != dev):
        raise ValueError(f"carries {tuple(carries.shape)} {carries.dtype} on "
                         f"{carries.device}; expected {want} float32 on {dev}")
    carries = carries.contiguous()
    g_y = g_y.contiguous()
    ghN = _small(g_hN, (G, d, N), "g_hN", dev)
    g_u = torch.empty(G, L, d, dtype=u.dtype, device=dev)
    g_delta = torch.empty(G, L, d, dtype=u.dtype, device=dev)
    g_BC = torch.empty(2, G, L, N, dtype=torch.float32, device=dev)
    g_h0 = torch.empty(G, d, N, dtype=torch.float32, device=dev)
    shares = torch.empty(G, d * N + 2 * d, dtype=torch.float32, device=dev)
    tickets = torch.empty(-(-d // (256 // N)), dtype=torch.int32, device=dev)
    g_A = torch.empty(d, N, dtype=torch.float32, device=dev)
    g_Db = torch.empty(2, d, dtype=torch.float32, device=dev)
    words = _words(_dir(u, delta, B, C, A_, D_, bias_, None, None, None,
                        carries, reverse))
    with torch.cuda.device(dev):
        err = _fn("selective_scan_bwd")(
            _DTYPES[u.dtype], ctypes.cast(words, _P), g_y.data_ptr(),
            _ptr(ghN), g_u.data_ptr(), g_delta.data_ptr(), g_BC.data_ptr(),
            g_h0.data_ptr(), shares.data_ptr(), tickets.data_ptr(),
            g_A.data_ptr(), g_Db[0].data_ptr(), g_Db[1].data_ptr(),
            G, L, d, N, int(delta_softplus),
            torch.cuda.current_stream().cuda_stream)
    _raise(err, "selective_scan_bwd", u, N)
    global bwd_launches
    bwd_launches += 1
    return (g_u, g_delta, g_A, g_BC[0].to(B.dtype), g_BC[1].to(C.dtype),
            g_Db[0], g_Db[1], g_h0)


def _like(grad, p):
    return None if p is None else grad.to(p.dtype).reshape(p.shape)


def _grads(g, u, delta, A, B, C, D, bias):
    g_u, g_delta, g_A, g_B, g_C, g_D, g_bias, g_h0 = g
    return (g_u, g_delta.to(delta.dtype), _like(g_A, A), g_B, g_C,
            _like(g_D, D), _like(g_bias, bias), g_h0)


class _SelectiveScanFn(torch.autograd.Function):
    """The counterpart of `selective_scan_pallas_chained`'s custom_vjp:
    forward = `selective_scan_fwd` with carries, backward =
    `selective_scan_bwd`. Differentiable in u, delta, A, B, C, D, bias and
    h_init, with a cotangent for hN."""

    @staticmethod
    def forward(ctx, u, delta, A, B, C, D, bias, h_init, delta_softplus,
                reverse, chunk_size):
        y, hN, car = selective_scan_fwd(u, delta, A, B, C, D, bias,
                                        delta_softplus, reverse, chunk_size,
                                        h_init, save_carries=True)
        ctx.save_for_backward(u, delta, A, B, C, D, bias, car)
        ctx.cfg = (delta_softplus, reverse, chunk_size, h_init is not None)
        return y, hN

    @staticmethod
    def backward(ctx, g_y, g_hN):
        u, delta, A, B, C, D, bias, car = ctx.saved_tensors
        softplus, reverse, chunk_size, has_h0 = ctx.cfg
        g = selective_scan_bwd_cuda(u, delta, A, B, C, D, bias, g_y, car, g_hN,
                                    softplus, reverse, chunk_size)
        *grads, g_h0 = _grads(g, u, delta, A, B, C, D, bias)
        return (*grads, g_h0 if has_h0 else None, None, None, None)


class _BidirScanFn(torch.autograd.Function):
    """The counterpart of `bidir_selective_scan_pallas`'s custom_vjp:
    forward = one `bidir_scan_fwd` with carries, backward = two launches
    of `selective_scan_bwd` (forward, then reverse direction), as the JAX
    default `_bwd` (`scan_pallas_bidir.py:496-506`)."""

    @staticmethod
    def forward(ctx, uf, df, Bf, Cf, ur, dr, Br, Cr, Af, Ar, Df, Dr, bf, br,
                delta_softplus, chunk_size):
        yf, yr, carf, carr = bidir_scan_fwd(
            uf, df, Bf, Cf, ur, dr, Br, Cr, Af, Ar, Df, Dr, bf, br,
            delta_softplus, chunk_size, save_carries=True)
        ctx.save_for_backward(uf, df, Bf, Cf, ur, dr, Br, Cr, Af, Ar, Df, Dr,
                              bf, br, carf, carr)
        ctx.cfg = (delta_softplus, chunk_size)
        return yf, yr

    @staticmethod
    def backward(ctx, gf, gr):
        (uf, df, Bf, Cf, ur, dr, Br, Cr, Af, Ar, Df, Dr, bf, br, carf,
         carr) = ctx.saved_tensors
        softplus, chunk_size = ctx.cfg
        out = []
        for u, dl, B, C, A, D, b, g_y, car, rev in (
                (uf, df, Bf, Cf, Af, Df, bf, gf, carf, False),
                (ur, dr, Br, Cr, Ar, Dr, br, gr, carr, True)):
            g = selective_scan_bwd_cuda(u, dl, A, B, C, D, b, g_y, car, None,
                                        softplus, rev, chunk_size)
            out.append(_grads(g, u, dl, A, B, C, D, b)[:7])
        (guf, gdf, gAf, gBf, gCf, gDf, gbf), (gur, gdr, gAr, gBr, gCr, gDr,
                                              gbr) = out
        return (guf, gdf, gBf, gCf, gur, gdr, gBr, gCr, gAf, gAr, gDf, gDr,
                gbf, gbr, None, None)


def _wants_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in ts)


def selective_scan_chained(
    u: torch.Tensor, delta: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
    C: torch.Tensor, D: Optional[torch.Tensor] = None,
    delta_bias: Optional[torch.Tensor] = None,
    h_init: Optional[torch.Tensor] = None, delta_softplus: bool = True,
    reverse: bool = False, chunk_size: int = KERNEL_CHUNK,
):
    """One direction, (y, hN): the kernel pair on the card, the plain
    versions on the CPU; differentiable on both (`_SelectiveScanFn`)."""
    inputs = (u, delta, A, B, C, D, delta_bias, h_init)
    if _wants_grad(*inputs):
        return _SelectiveScanFn.apply(*inputs, delta_softplus, reverse,
                                      chunk_size)
    y, hN, _ = selective_scan_fwd(u, delta, A, B, C, D, delta_bias,
                                  delta_softplus, reverse, chunk_size, h_init)
    return y, hN


def bidir_selective_scan(uf, df, Bf, Cf, ur, dr, Br, Cr, Af, Ar, Df=None,
                         Dr=None, biasf=None, biasr=None, delta_softplus=True,
                         chunk_size: int = KERNEL_CHUNK):
    """Both directions of a BiMamba layer, (yf, yr): set f left to right,
    set r right to left; `bidir_scan_fwd` on the card (one launch),
    differentiable through `_BidirScanFn`."""
    inputs = (uf, df, Bf, Cf, ur, dr, Br, Cr, Af, Ar, Df, Dr, biasf, biasr)
    if _wants_grad(*inputs):
        return _BidirScanFn.apply(*inputs, delta_softplus, chunk_size)
    yf, yr, _, _ = bidir_scan_fwd(*inputs, delta_softplus, chunk_size)
    return yf, yr
