"""MLM masking, deterministic and vectorized.

An owned copy of `caduceus_tpu/data/mlm.py`, equal bit for bit: the same
80/10/10 semantics (`src/dataloaders/utils/mlm.py:4-32`: positions masked
with probability p, unmasked targets set to PAD; of the masked, 80% become
[MASK], 10% a random id, 10% stay) and the same counter-based splitmix64
stream as `native/dataloader.cc`, so a batch is a pure function of
(seed, epoch, index) whichever loader built it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from caduceus_tpu_torch.tokenization import MASK_ID, PAD_ID


def mlm_mask(
    seq: np.ndarray,
    rng: np.random.Generator,
    mlm_probability: float = 0.15,
    vocab_size: int = 12,
    mask_token_id: int = MASK_ID,
    pad_token_id: int = PAD_ID,
    eligible_replacements: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (data, target) int32 arrays of seq.shape."""
    data = seq.astype(np.int32).copy()
    target = data.copy()
    shape = data.shape

    masked = rng.random(shape) < mlm_probability
    target[~masked] = pad_token_id

    replaced = (rng.random(shape) < 0.8) & masked
    data[replaced] = mask_token_id

    randomized = (rng.random(shape) < 0.5) & masked & ~replaced
    if eligible_replacements is not None:
        words = eligible_replacements[
            rng.integers(0, len(eligible_replacements), shape)
        ]
    else:
        # reference default: any id in the full vocab (`mlm.py:28`)
        words = rng.integers(0, vocab_size, shape)
    data[randomized] = words[randomized]
    return data, target


# ---------------------------------------------------------------------------
# Counter-based splitmix64 stream — the SHARED RNG of the python and native
# (C++) loaders. Both sides draw from explicit counters into the same
# finalizer, so a batch is bit-identical regardless of which loader built it
# (fixes the r1 divergence where switching loaders mid-run changed batches).
#
# Layout per item, base = mix3(seed, epoch, idx):
#   draw 0                  rc-aug coin (consumed only when rc_aug)
#   draws 1      .. L       per-position mask uniform
#   draws 1+L    .. 2L      per-position replace-with-[MASK] uniform
#   draws 1+2L   .. 3L      per-position randomize uniform
#   draws 1+3L   .. 4L      per-position random token (uint64 % vocab)
# ---------------------------------------------------------------------------

_GAMMA = np.uint64(0x9E3779B97F4A7C15)
_MIX_B = np.uint64(0xC2B2AE3D27D4EB4F)
_MIX_C = np.uint64(0x165667B19E3779F9)
_F1 = np.uint64(0xBF58476D1CE4E5B9)
_F2 = np.uint64(0x94D049BB133111EB)


def _sm_fin(z: np.ndarray) -> np.ndarray:
    """splitmix64 output finalizer (vectorized; uint64 wraps modularly)."""
    with np.errstate(over="ignore"):
        z = (z ^ (z >> np.uint64(30))) * _F1
        z = (z ^ (z >> np.uint64(27))) * _F2
        return z ^ (z >> np.uint64(31))


def splitmix_base(seed: int, epoch: int, idx: int) -> np.uint64:
    """mix3 of native/dataloader.cc: state ← a·γ ^ b·B ^ (c+C), skip one
    output, return the second."""
    with np.errstate(over="ignore"):
        s0 = (
            np.uint64(seed) * _GAMMA
            ^ np.uint64(epoch) * _MIX_B
            ^ (np.uint64(idx) + _MIX_C)
        )
        return _sm_fin(s0 + np.uint64(2) * _GAMMA)


def splitmix_draws(base: np.uint64, start: int, n: int) -> np.ndarray:
    """Draws [start, start+n) of the stream with state `base` (uint64)."""
    with np.errstate(over="ignore"):
        j = np.arange(start + 1, start + n + 1, dtype=np.uint64)
        return _sm_fin(np.uint64(base) + j * _GAMMA)


def splitmix_u01(bits: np.ndarray) -> np.ndarray:
    """uniform [0,1) doubles from uint64 bits (53-bit mantissa)."""
    return (bits >> np.uint64(11)).astype(np.float64) * (1.0 / 9007199254740992.0)


def mlm_mask_splitmix(
    seq: np.ndarray,
    base: np.uint64,
    mlm_probability: float = 0.15,
    vocab_size: int = 12,
    mask_token_id: int = MASK_ID,
    pad_token_id: int = PAD_ID,
) -> Tuple[np.ndarray, np.ndarray]:
    """mlm_mask semantics on the shared splitmix stream (draw layout above)."""
    data = seq.astype(np.int32).copy()
    target = data.copy()
    L = data.shape[-1]
    if data.ndim != 1:
        raise ValueError(f"one sequence at a time, got shape {data.shape}")

    u = splitmix_u01(splitmix_draws(base, 1, 3 * L)).reshape(3, L)
    masked = u[0] < mlm_probability
    target[~masked] = pad_token_id
    replaced = (u[1] < 0.8) & masked
    data[replaced] = mask_token_id
    randomized = (u[2] < 0.5) & masked & ~replaced
    words = (splitmix_draws(base, 1 + 3 * L, L) % np.uint64(vocab_size)).astype(
        np.int32
    )
    data[randomized] = words[randomized]
    return data, target
