"""Deterministic, checkpointable, host-sharded index sampler.

An owned copy of `caduceus_tpu/data/sampler.py`: the same permutation per
(seed, epoch) and the same ``{"epoch", "counter"}`` state. It replaces
the reference's fault-tolerant samplers
(`src/dataloaders/fault_tolerant_sampler.py`): `RandomFaultTolerantSampler`
(RNG state + counter, `:26-58`) and `FaultTolerantDistributedSampler`
(epoch + counter, rank-strided sharding, `:106-120`).

Design: the permutation for epoch e is a pure function of (seed, e); resume
state is just ``{"epoch": e, "counter": c}`` — restoring replays nothing.
Sharding follows the DistributedSampler contract: rank r of R takes indices
``perm[r::R]`` after padding the permutation to a multiple of R. Counter is
in *global* samples (across ranks), matching how the reference fast-forwards
from Lightning loop state (`src/dataloaders/genomics.py:165-169`).
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np


class ShardedShuffleSampler:
    """Yields dataset indices for one host shard, resumable mid-epoch."""

    def __init__(
        self,
        num_samples: int,
        seed: int = 0,
        shuffle: bool = True,
        rank: int = 0,
        world_size: int = 1,
        drop_last: bool = False,
    ):
        if not 0 <= rank < world_size:
            raise ValueError(f"rank {rank} outside a world of {world_size}")
        self.num_samples = num_samples
        self.seed = seed
        self.shuffle = shuffle
        self.rank = rank
        self.world_size = world_size
        self.drop_last = drop_last
        self.epoch = 0
        self.counter = 0  # samples already consumed this epoch, across ranks

    # -- state -------------------------------------------------------------
    def state_dict(self) -> Dict[str, int]:
        return {"epoch": self.epoch, "counter": self.counter}

    def load_state_dict(self, state: Dict[str, int]) -> None:
        self.epoch = int(state["epoch"])
        self.counter = int(state["counter"])

    # -- iteration ---------------------------------------------------------
    def _epoch_permutation(self, epoch: int) -> np.ndarray:
        if self.shuffle:
            rng = np.random.default_rng((self.seed, epoch))
            perm = rng.permutation(self.num_samples)
        else:
            perm = np.arange(self.num_samples)
        R = self.world_size
        if self.drop_last:
            usable = (self.num_samples // R) * R
            return perm[:usable]
        if self.num_samples % R != 0:
            pad = R - self.num_samples % R
            perm = np.concatenate([perm, perm[:pad]])
        return perm

    def __iter__(self) -> Iterator[int]:
        perm = self._epoch_permutation(self.epoch)
        # rank-strided shard, skipping already-consumed global samples
        local = perm[self.rank :: self.world_size]
        start_local = self.counter // self.world_size
        for i in range(start_local, len(local)):
            self.counter += self.world_size
            yield int(local[i])
        self.epoch += 1
        self.counter = 0

    def __len__(self) -> int:
        return len(self._epoch_permutation(self.epoch)) // self.world_size
