"""Tensor parallelism: which parameters split over the mesh 'model' axis,
this rank's part of each, and the whole back.

Port of `caduceus_tpu/parallel/sharding.py`. There the Megatron layout is
data, PartitionSpecs that pjit hands to XLA, which inserts the collectives
(`_TP_RULES`: ``in_proj``, ``fc1``, ``Wqkv`` split by output column,
``out_proj``, ``fc2`` by input row, the inner SSM parameters along
d_inner). Here every rank holds its part as a tensor of its own and the
modules call the exchanges of `parallel/comm.py` themselves, so the layout
also fixes what each rank computes:

- `param_partition_specs` decides, per flat flax path, the dimension that
  splits: the JAX rules with their ndim guard, then the port's own for a
  parameter that a rank uses only a slice of (v2's per-head ``A_log``,
  ``dt_bias`` and ``norm_w``, the ``in_proj`` bias, the Hyena short
  filter), which JAX leaves whole and GSPMD slices on use. Everything else
  every rank holds whole.
- The cut follows the blocks of a concatenated output, not contiguous
  columns: a rank holds its slice of each block (v1 ``in_proj`` [x | z],
  v2 [z | x | B | C | dt], the Hyena MHA's ``Wqkv`` [q | k | v] by heads,
  the Hyena operator's ``order + 1`` blocks by channel, the v2 conv over
  [x | B | C]). The v2 B / C blocks are cut by groups when ngroups is a
  multiple of the axis size and held whole otherwise (ngroups 1, or an
  axis that is a multiple of ngroups: each rank slices its group at run
  time, as the JAX ``slice_group`` does).
- `shard_params` gives this rank's flat tree, `gather_params` the whole
  flat tree back, bit for bit (a whole block comes from rank 0: every rank
  holds the same, `train/trainer.py` checks it).

`TPPlan` applies the same layout to a module's parameters (state_dict
keys, `nn.Linear` layouts): `shard_module_` cuts a model built whole in
place, and the plan gathers and cuts state dicts and optimizer moments
for checkpoints and takes the global gradient norm.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from caduceus_tpu_torch.params import flax_path
from caduceus_tpu_torch.parallel.comm import _gather, all_reduce_
from caduceus_tpu_torch.parallel.mesh import MODEL_AXIS, Axis

# the JAX rules (`caduceus_tpu/parallel/sharding.py:37-55`): (path suffix,
# the split dimension of the flax array, the spec's length: the rule
# applies only to arrays of at least that many dimensions); first hit wins
_TP_RULES = (
    (("in_proj", "kernel"), 1, 2),
    (("in_proj_rev", "kernel"), 1, 2),
    (("out_proj", "kernel"), 0, 2),
    (("out_proj_rev", "kernel"), 0, 2),
    (("conv_w",), 1, 2),
    (("conv_b",), 0, 1),
    (("x_proj_w",), 0, 2),
    (("dt_proj_w",), 1, 2),
    (("dt_proj_b",), 0, 1),
    (("A_log",), 0, 2),
    (("D",), 0, 1),
    (("fc1", "kernel"), 1, 2),
    (("fc1", "bias"), 0, 1),
    (("fc2", "kernel"), 0, 2),
    (("Wqkv", "kernel"), 1, 2),
    (("Wqkv", "bias"), 0, 1),
)
# the port's: parameters a rank uses only a slice of, which the JAX specs
# leave whole
_SLICE_RULES = (
    (("A_log",), 0, 1),
    (("dt_bias",), 0, 1),
    # the v2 mixer's gated RMSNorm (not a block's norm_w, over d_model)
    (("mixer", "norm_w"), 0, 1),
    (("mixer", "norm_w_rev"), 0, 1),
    (("mamba_fwd", "norm_w"), 0, 1),
    (("in_proj", "bias"), 0, 1),
    (("in_proj_rev", "bias"), 0, 1),
    (("short_filter_w",), 1, 2),
    (("short_filter_b",), 0, 1),
)


def _match(names, rules, ndim) -> Optional[int]:
    for pattern, dim, need in rules:
        if tuple(names[-len(pattern):]) == pattern and need <= ndim:
            return dim
    return None


def split_dim(path: str, ndim: int) -> Optional[int]:
    """The dimension of the flax array at ``path`` that splits over the
    model axis, or None (every rank holds it whole). A Hyena filter's
    parameters (``filter_fn/...``) stay whole: its MLP runs whole on every
    rank and each takes its channels of the filter."""
    names = tuple(path.split("/"))
    if "filter_fn" in names:
        return None
    dim = _match(names, _TP_RULES, ndim)
    return dim if dim is not None else _match(names, _SLICE_RULES, ndim)


def param_partition_specs(flat: Dict[str, object]) -> Dict[str, Optional[int]]:
    """{flat flax path: the split dimension, or None}."""
    return {k: split_dim(_strip(k), np.ndim(v)) for k, v in flat.items()}


def _strip(path: str) -> str:
    return path[len("params/"):] if path.startswith("params/") else path


@dataclasses.dataclass(frozen=True)
class Layout:
    """What the cut of the blocks needs to know of the model: its family
    (1, 2: the Caduceus mixers; "hyena"), widths and the axis size."""
    family: object
    size: int                       # ranks on the model axis
    d_model: int
    d_inner: int = 0
    nheads: int = 0
    ngroups: int = 1
    d_state: int = 0

    @property
    def groups_cut(self) -> bool:
        """v2: the B / C blocks cut by groups (else whole on every rank)."""
        return self.ngroups > 1 and self.ngroups % self.size == 0


def layout_of(model_or_cfg, size: int) -> Layout:
    """The `Layout` of a `CaduceusConfig`, of a model with a ``cfg``, or of
    a `HyenaLMHeadModel`; checks that the axis divides what it cuts."""
    cfg = getattr(model_or_cfg, "cfg", model_or_cfg)
    if hasattr(cfg, "ssm_cfg"):
        s = cfg.ssm_cfg
        lay = Layout(s.version, size, cfg.d_model, cfg.d_inner,
                     cfg.nheads if s.version == 2 else 0, s.ngroups,
                     s.d_state)
        cut = lay.nheads if s.version == 2 else lay.d_inner
        if cut % size:
            raise ValueError(f"{'nheads' if s.version == 2 else 'd_inner'} "
                             f"{cut} does not split over a model axis of "
                             f"{size}")
        if (s.version == 2 and lay.ngroups > 1 and lay.ngroups % size
                and size % lay.ngroups):
            raise ValueError(
                f"ngroups {lay.ngroups} and a model axis of {size} must "
                "divide one another (group-aligned head shards)")
        return lay
    bb = model_or_cfg.backbone
    d = bb.embedding.shape[1]
    heads = {m.num_heads for m in bb.modules() if hasattr(m, "Wqkv")}
    lay = Layout("hyena", size, d)
    if d % size or any(h % size for h in heads):
        raise ValueError(f"d_model {d} and num_heads {sorted(heads)} must "
                         f"split over a model axis of {size}")
    return lay


# a segment of the split dimension: (its length, cut over the ranks?)
Segments = List[Tuple[int, bool]]


def segments(path: str, n: int, lay: Layout) -> Segments:
    """The blocks of the split dimension (length ``n``) of ``path``."""
    names = _strip(path).split("/")
    last = names[-2] if names[-1] in ("kernel", "bias") else names[-1]
    if lay.family == "hyena":
        if last in ("in_proj", "short_filter_w", "short_filter_b"):
            return [(lay.d_model, True)] * (n // lay.d_model)
        if last == "Wqkv":
            return [(lay.d_model, True)] * 3
        return [(n, True)]
    di = lay.d_inner
    if lay.family == 1:
        if last in ("in_proj", "in_proj_rev"):
            return [(di, True), (di, True)]
        return [(n, True)]
    bc = lay.ngroups * lay.d_state
    if last in ("in_proj", "in_proj_rev"):
        g = lay.groups_cut
        return [(di, True), (di, True), (bc, g), (bc, g), (lay.nheads, True)]
    if last in ("conv_w", "conv_b"):
        g = lay.groups_cut
        return [(di, True), (bc, g), (bc, g)]
    return [(n, True)]


def _cat(parts, dim):
    if isinstance(parts[0], np.ndarray):
        return np.concatenate(parts, axis=dim)
    return torch.cat(parts, dim=dim)


def _narrow(t, dim, start, length):
    if isinstance(t, np.ndarray):
        idx = [slice(None)] * t.ndim
        idx[dim] = slice(start, start + length)
        return t[tuple(idx)]
    return t.narrow(dim, start, length)


def part_of(t, dim: int, segs: Segments, rank: int, size: int):
    """This rank's part of the whole array ``t``: its slice of each cut
    block, each whole block, concatenated along ``dim``."""
    parts, off = [], 0
    for n, cut in segs:
        if cut:
            parts.append(_narrow(t, dim, off + rank * (n // size), n // size))
        else:
            parts.append(_narrow(t, dim, off, n))
        off += n
    if off != t.shape[dim]:
        raise ValueError(f"blocks {segs} of a dimension of {t.shape[dim]}")
    return parts[0] if len(parts) == 1 else _cat(parts, dim)


def whole_of(parts, dim: int, segs: Segments):
    """The whole array from every rank's part (rank order): each cut block
    from every rank, each whole block from rank 0."""
    size = len(parts)
    out, off = [], 0
    for n, cut in segs:
        k = n // size if cut else n
        if cut:
            out += [_narrow(p, dim, off, k) for p in parts]
        else:
            out.append(_narrow(parts[0], dim, off, k))
        off += k
    return out[0] if len(out) == 1 else _cat(out, dim)


Spec = Optional[Tuple[int, Segments]]


def flat_spec(path: str, shape, lay: Layout, local: bool = False) -> Spec:
    """(the split dimension, its blocks) of the flat flax array at ``path``
    of ``shape`` (the whole array's; ``local``: one rank's part, a cut
    block being M times its local length and a whole block's length coming
    from the layout), or None where every rank holds it whole."""
    dim = split_dim(_strip(path), len(shape))
    if dim is None or lay.size == 1:
        return None
    n = shape[dim] * (lay.size if local else 1)
    return dim, segments(path, n, lay)


def _whole(t: torch.Tensor, axis: Axis, spec: Spec) -> torch.Tensor:
    """The whole tensor from every rank's part ``t`` (a collective)."""
    return t if spec is None else whole_of(_gather(t, axis), *spec)


def _shard_flat(flat, lay: Layout, rank: int):
    out = {}
    for k, v in flat.items():
        spec = flat_spec(k, np.shape(v), lay)
        out[k] = v if spec is None else part_of(v, *spec, rank, lay.size)
    return out


def shard_params(mesh, flat: Dict[str, object], cfg) -> Dict[str, object]:
    """This rank's flat flax tree (numpy arrays or tensors, as given) of
    the whole tree ``flat``; ``cfg``: a `CaduceusConfig` or a Hyena model
    (`layout_of`)."""
    ax = mesh.axis(MODEL_AXIS)
    lay = cfg if isinstance(cfg, Layout) else layout_of(cfg, ax.size)
    return _shard_flat(flat, lay, ax.rank)


def gather_params(mesh, shards: Dict[str, object], cfg) -> Dict[str, object]:
    """The whole flat tree from every model rank's `shard_params` part (a
    collective over the model axis: every rank of it calls it, in the same
    key order); numpy in, numpy out."""
    ax = mesh.axis(MODEL_AXIS)
    lay = cfg if isinstance(cfg, Layout) else layout_of(cfg, ax.size)
    out = {}
    for k, v in shards.items():
        t = v if torch.is_tensor(v) else torch.from_numpy(np.array(v))
        whole = _whole(t, ax, flat_spec(k, t.shape, lay, local=True))
        out[k] = whole.numpy() if isinstance(v, np.ndarray) else whole
    return out


class TPPlan:
    """The layout applied to a module's parameters (state_dict keys,
    `nn.Linear` layouts: a Dense weight is the transposed flax kernel)."""

    def __init__(self, model: nn.Module, mesh):
        self.axis: Axis = mesh.axis(MODEL_AXIS)
        self.layout = layout_of(model, self.axis.size)
        self.specs: Dict[str, Spec] = {}
        for name, p in model.named_parameters():
            path = flax_path(name)
            kernel = path.endswith("/kernel") and p.dim() == 2
            shape = tuple(reversed(p.shape)) if kernel else tuple(p.shape)
            spec = flat_spec(path, shape, self.layout)
            if spec is not None and kernel:
                spec = (1 - spec[0], spec[1])
            self.specs[name] = spec

    # -- whole <-> this rank's part ------------------------------------------
    def part(self, name: str, t: torch.Tensor) -> torch.Tensor:
        spec = self.specs.get(name)
        if spec is None:
            return t
        return part_of(t, spec[0], spec[1], self.axis.rank,
                       self.axis.size).contiguous()

    def whole(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """The whole tensor from every model rank's part (collective)."""
        return _whole(t, self.axis, self.specs.get(name))

    def shard_flat(self, flat: Dict[str, object]) -> Dict[str, object]:
        """This rank's part of a whole flat flax tree (`shard_params`)."""
        return _shard_flat(flat, self.layout, self.axis.rank)

    def gather_state(self, sd: Dict[str, torch.Tensor]):
        return {k: self.whole(k, v) for k, v in sd.items()}

    # -- the pieces a rank holds alone and those it shares -------------------
    def _split(self, name: str, t: torch.Tensor):
        """(this rank's own elements, the elements every rank holds) of a
        local tensor, as lists of views."""
        spec = self.specs.get(name)
        if spec is None:
            return [], [t]
        dim, segs = spec
        own, shared, off = [], [], 0
        for n, cut in segs:
            k = n // self.axis.size if cut else n
            (own if cut else shared).append(t.narrow(dim, off, k))
            off += k
        return own, shared

    def global_sq_norm(self, named_grads) -> torch.Tensor:
        """Σ g² of the whole gradient from this rank's (name, gradient)
        pairs: every rank's own elements summed over the model axis, the
        shared ones counted once (fp32)."""
        dev = named_grads[0][1].device
        own = torch.zeros(1, device=dev)
        shared = torch.zeros((), device=dev)
        for name, g in named_grads:
            a, b = self._split(name, g)
            for t in a:
                own = own + t.float().square().sum()
            for t in b:
                shared = shared + t.float().square().sum()
        return all_reduce_(own, self.axis)[0] + shared

    def shared_checksum(self, named) -> torch.Tensor:
        """Float64 sums of the shared elements (per piece: Σ v and Σ v
        times its flat index): equal on every model rank when they hold
        the same."""
        sums = []
        for name, t in named:
            for piece in self._split(name, t)[1]:
                v = piece.detach().reshape(-1).double()
                idx = torch.arange(1, v.numel() + 1, device=v.device,
                                   dtype=torch.float64)
                sums += [v.sum(), (v * idx).sum()]
        return torch.stack(sums)


def shard_module_(model: nn.Module, mesh) -> TPPlan:
    """Cut a model built whole (every rank from the same seed, or loaded
    from the same weights) to this rank's parameters, in place, and mark
    its tensor-parallel modules (``tp_axis_name``); returns the plan. A
    `CaduceusForMaskedLM` must carry ``tensor_parallel_axis = "model"`` in
    its config, as the JAX model does."""
    cfg = getattr(model, "cfg", None)
    if cfg is not None and cfg.tensor_parallel_axis != MODEL_AXIS:
        raise ValueError("tensor parallelism needs the model config's "
                         "tensor_parallel_axis = 'model'")
    if getattr(model, "tp_plan", None) is not None:
        raise ValueError("the model is already cut")
    plan = TPPlan(model, mesh)
    mods = dict(model.named_modules())
    with torch.no_grad():
        for name, spec in plan.specs.items():
            if spec is None:
                continue
            mod_name, _, attr = name.rpartition(".")
            mod = mods[mod_name]
            old = getattr(mod, attr)
            new = nn.Parameter(plan.part(name, old.detach()).clone(),
                               requires_grad=old.requires_grad)
            setattr(mod, attr, new)
    for m in model.modules():
        if hasattr(m, "tp_axis_name"):
            m.tp_axis_name = MODEL_AXIS
    model.tp_plan = plan
    return plan
