"""The (data, model[, seq]) grid of ranks and its process groups.

Port of `caduceus_tpu/parallel/mesh.py` (`make_mesh`, `shard_batch`, the
ambient-mesh registry) and of the JAX CLI's `_maybe_init_distributed`. A
JAX mesh is one program over many devices; here each rank is a process
(or, in the CPU tests, a thread) that holds its own slice of the batch, so
the mesh is that rank's view: its coordinates, the world size along each
axis, and an explicit `ProcessGroup` per axis.

- ``data``: batch sharding (data parallelism). Every rank builds the same
  global batch from the same seed and keeps its rows; gradients are
  all-reduced over every rank.
- ``model``: with context parallelism the sequence axis is sharded over
  it, rank m holding rows [m L/M, (m+1) L/M); with tensor parallelism the
  projections, heads and channels are (`parallel/sharding.py`), and the
  gradients are all-reduced over the data axis only.
- ``seq`` (``make_mesh(seq=S)``): the sequence axis of a model that runs
  tensor parallelism over ``model`` and context parallelism over ``seq``
  at once (``tensor_parallel_axis="model"``, ``context_parallel_axis=
  "seq"``, the v2 family).

Rank r of a D x M x S grid sits at (r // (M S), (r // S) % M, r % S), the
row-major layout of the JAX mesh's device array (S = 1: (r // M, r % M)).
`make_mesh` reads the launcher's environment (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, and ``MASTER_ADDR`` / ``MASTER_PORT`` for the rendezvous,
as `torch.distributed.run` sets them); `Mesh.from_store` builds the same
grid from a shared `torch.distributed.Store`, one `ProcessGroupGloo` per
axis and rank, which is how the CPU tests run ranks as threads.
"""

from __future__ import annotations

import dataclasses
import os
import threading
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"


@dataclasses.dataclass(frozen=True)
class Axis:
    """One rank's view of one mesh axis: the group of the ranks that share
    its other coordinates, its coordinate on the axis and the axis size."""
    group: Optional[object]     # a ProcessGroup; None when size == 1
    rank: int
    size: int


class Mesh:
    """A rank's view of the (data, model, seq) grid."""

    def __init__(self, rank: int, data: int, model: int,
                 groups: Dict[str, object], device: torch.device,
                 backend: str, owns_init: bool = False, seq: int = 1):
        if (data < 1 or model < 1 or seq < 1
                or not 0 <= rank < data * model * seq):
            raise ValueError(f"rank {rank} of a {data} x {model} x {seq} "
                             "mesh")
        self.rank = rank
        self.world = data * model * seq
        self.shape = {DATA_AXIS: data, MODEL_AXIS: model, SEQ_AXIS: seq}
        self.groups = groups
        self.device = torch.device(device)
        self.backend = backend
        # whether making this mesh initialized the default process group
        # (then `close` destroys it; a process group cannot be initialized
        # again in a process the launcher started)
        self.owns_init = owns_init

    def close(self) -> None:
        if self.owns_init and dist.is_initialized():
            dist.destroy_process_group()

    def coord(self, axis: str) -> int:
        m, s = self.shape[MODEL_AXIS], self.shape[SEQ_AXIS]
        if axis == DATA_AXIS:
            return self.rank // (m * s)
        if axis == MODEL_AXIS:
            return (self.rank // s) % m
        if axis == SEQ_AXIS:
            return self.rank % s
        raise KeyError(axis)

    def axis(self, axis: str) -> Axis:
        return Axis(self.groups.get(axis), self.coord(axis), self.shape[axis])

    def world_axis(self) -> Axis:
        return Axis(self.groups.get("world"), self.rank, self.world)

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    # -- construction ------------------------------------------------------
    @staticmethod
    def _axis_ranks(data: int, model: int, seq: int = 1):
        """{axis: [rank lists]}: the groups of each axis, in the order
        every rank creates them (the seq axis only when it is there)."""
        def r(d, m, s):
            return (d * model + m) * seq + s

        out = {
            MODEL_AXIS: [[r(d, m, s) for m in range(model)]
                         for d in range(data) for s in range(seq)],
            DATA_AXIS: [[r(d, m, s) for d in range(data)]
                        for m in range(model) for s in range(seq)],
        }
        if seq > 1:
            out[SEQ_AXIS] = [[r(d, m, s) for s in range(seq)]
                             for d in range(data) for m in range(model)]
        return out

    @classmethod
    def from_store(cls, store, rank: int, data: int, model: int,
                   device="cpu", timeout_s: float = 120.0,
                   seq: int = 1) -> "Mesh":
        """The grid over a shared store with one `ProcessGroupGloo` per axis
        (the threaded ranks of the CPU tests)."""
        from datetime import timedelta

        world = data * model * seq

        def pg(prefix, ranks):
            return dist.ProcessGroupGloo(dist.PrefixStore(prefix, store),
                                         ranks.index(rank), len(ranks),
                                         timedelta(seconds=timeout_s))

        groups = {"world": pg("world", list(range(world)))}
        for axis, lists in cls._axis_ranks(data, model, seq).items():
            for i, ranks in enumerate(lists):
                if rank in ranks and len(ranks) > 1:
                    groups[axis] = (groups["world"] if len(ranks) == world
                                    else pg(f"{axis}{i}", ranks))
        return cls(rank, data, model, groups, torch.device(device), "gloo",
                   seq=seq)


def launch_env():
    """(rank, world size, local rank) from `torch.distributed.run`'s
    environment; (0, 1, 0) in a process it did not start."""
    return (int(os.environ.get("RANK", "0")),
            int(os.environ.get("WORLD_SIZE", "1")),
            int(os.environ.get("LOCAL_RANK", "0")))


def launch_device(local: int) -> str:
    """The card of the launcher's local rank: ``cuda:{local %
    device_count}``."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' (and the "
                           "gloo backend) to run the ranks on the CPU")
    return f"cuda:{local % torch.cuda.device_count()}"


def make_mesh(model: int = 1, backend: str = "nccl",
              device: Optional[str] = None, seq: int = 1) -> Mesh:
    """The grid over the ranks that `torch.distributed.run` started (data =
    WORLD_SIZE / (model seq)): initializes the default process group with
    ``backend`` from the launcher's environment and creates the groups of
    every axis. The device is ``cuda:{LOCAL_RANK % device_count}``, or
    ``device`` when given (e.g. "cpu", with ``backend="gloo"``). Several
    ranks may share one card under gloo (NCCL refuses two ranks on one
    device). An initialized default group is reused, and `Mesh.close` then
    leaves it to its owner."""
    rank, world, local = launch_env()
    if model < 1 or seq < 1 or world % (model * seq):
        raise ValueError(f"{world} ranks do not split into a model axis of "
                         f"{model} and a seq axis of {seq}")
    if device is None:
        device = launch_device(local)
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    owns = not dist.is_initialized()
    if owns:
        dist.init_process_group(backend, init_method="env://", rank=rank,
                                world_size=world)
    data = world // (model * seq)
    default = dist.distributed_c10d._get_default_group()
    groups = {"world": default}
    for axis, lists in Mesh._axis_ranks(data, model, seq).items():
        for ranks in lists:
            # every rank creates every group, in the same order
            g = default if len(ranks) == world else dist.new_group(ranks)
            if rank in ranks and len(ranks) > 1:
                groups[axis] = g
    return Mesh(rank, data, model, groups, dev, backend, owns_init=owns,
                seq=seq)


def shard_batch(mesh: Mesh, batch, cp: bool = False, accum_steps: int = 1,
                keep_full=("input_ids",)):
    """This rank's part of one global batch {key: (rows, L) array}: of
    each of the ``accum_steps`` consecutive micro-batches, the rows of its
    data coordinate (so that every micro-batch is the same set of rows as
    on one device); with ``cp``, of those the sequence columns of its model
    coordinate, except the keys of ``keep_full``: the context-parallel
    model takes the whole ids of its rows (it builds the reverse complement
    strand from them) and returns the logits of its own columns."""
    D, M = mesh.shape[DATA_AXIS], mesh.shape[MODEL_AXIS]
    d, m = mesh.coord(DATA_AXIS), mesh.coord(MODEL_AXIS)
    out = {}
    for k, v in batch.items():
        rows = v.shape[0]
        if rows % (accum_steps * D):
            raise ValueError(
                f"batch axis of '{k}' ({rows}) must split into "
                f"{accum_steps} micro-batches over the mesh 'data' axis "
                f"({D}); set batch_size to a multiple of the data-parallel "
                "degree")
        nb = rows // accum_steps // D
        t = v.reshape(accum_steps, D, nb, *v.shape[1:])[:, d]
        t = t.reshape(accum_steps * nb, *v.shape[1:])
        if cp and M > 1 and v.ndim > 1 and k not in keep_full:
            L = v.shape[1]
            if L % M:
                raise ValueError(
                    f"sequence axis of '{k}' ({L}) must be divisible by the "
                    f"mesh 'model' axis ({M}) under context parallelism")
            t = t[:, m * (L // M):(m + 1) * (L // M)]
        out[k] = (np.ascontiguousarray(t) if isinstance(t, np.ndarray)
                  else t.contiguous())
    return out


# -- the ambient mesh ---------------------------------------------------------
# Model code (the context-parallel mixers) needs the mesh, as the JAX
# package's modules do through `get_global_mesh`. Each thread may set its
# own (the CPU tests run one rank per thread); a thread that set none (the
# autograd engine's device threads, which rerun a checkpointed forward)
# sees the one set last by any thread.

_LOCAL = threading.local()
_GLOBAL: Dict[str, Optional[Mesh]] = {"mesh": None}


def set_global_mesh(mesh: Optional[Mesh]) -> None:
    _LOCAL.mesh = mesh
    _GLOBAL["mesh"] = mesh


def get_global_mesh() -> Optional[Mesh]:
    return getattr(_LOCAL, "mesh", _GLOBAL["mesh"])


class with_mesh:
    """``with with_mesh(mesh): ...`` sets the ambient mesh for the block."""

    def __init__(self, mesh: Optional[Mesh]):
        self.mesh = mesh
        self._prev = None

    def __enter__(self):
        self._prev = get_global_mesh()
        set_global_mesh(self.mesh)
        return self.mesh

    def __exit__(self, *exc):
        set_global_mesh(self._prev)
        return False


def mesh_axis(name: Optional[str], what: str) -> Optional[Axis]:
    """The axis ``name`` of the ambient mesh; None when ``name`` is."""
    if not name:
        return None
    mesh = get_global_mesh()
    if mesh is None:
        raise RuntimeError(
            f"{what} is set but no mesh is registered: call "
            "caduceus_tpu_torch.parallel.mesh.set_global_mesh (or use "
            "with_mesh)")
    return mesh.axis(name)


def cp_axis(cfg) -> Optional[Axis]:
    """The context-parallel axis of a model config under the ambient mesh,
    or None when the config has none."""
    return mesh_axis(getattr(cfg, "context_parallel_axis", None),
                     "context_parallel_axis")


def tp_axis(cfg) -> Optional[Axis]:
    """The tensor-parallel axis of a model config under the ambient mesh,
    or None when the config has none."""
    return mesh_axis(getattr(cfg, "tensor_parallel_axis", None),
                     "tensor_parallel_axis")
