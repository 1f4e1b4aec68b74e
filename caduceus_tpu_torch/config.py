"""Configuration dataclasses for caduceus_tpu_torch.

An owned copy of `caduceus_tpu/config.py`: the same fields, derived
quantities, validation and JSON round trip, so `model_config.json` is one
contract shared by both packages. Fields that only the JAX package reads
(the parallel axes) are kept so a config written by either package loads
in the other. ``ssm_cfg.use_kernel`` selects the v2 SSD route on both
devices, as in the JAX package (`models/mamba2.py`, `inference.py`); the
tensor's device decides between a route's kernels (CUDA) and its plain
version (CPU).

Configs are read and written as JSON; `load_config` imports `yaml` only
for a `.yaml` path.
"""

from __future__ import annotations

import dataclasses
import json
import math
from dataclasses import dataclass, field
from typing import Any, Dict, Optional


@dataclass
class SSMConfig:
    """Mamba (selective SSM) inner configuration.

    Defaults match the reference ssm_cfg (`configs/model/caduceus.yaml:9-21`
    and mamba_ssm 1.2.0 `Mamba.__init__` defaults).
    """

    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: Any = "auto"  # "auto" => ceil(d_model / 16)
    dt_min: float = 0.001
    dt_max: float = 0.1
    dt_init: str = "random"  # "random" | "constant"
    dt_scale: float = 1.0
    dt_init_floor: float = 1e-4
    conv_bias: bool = True
    bias: bool = False
    # The reference's `use_fast_path` selects the fused CUDA kernel; in the
    # JAX package the equivalent switch selects the Pallas kernel vs the XLA
    # chunked scan. "auto" | "pallas" | "xla"; version=2 also takes
    # "pallas_batched" (head-batched SSD kernels), and each Pallas value has
    # an "_interpret" form. The port maps them to its kernels
    # (`models/mamba2.py`): "pallas*" to the per-head SSD entry, the rest
    # to the fused-conv kernels.
    use_kernel: str = "auto"

    # --- Mamba-2 (SSD) — beyond the reference (it pins mamba-ssm 1.2.0,
    # which predates Mamba-2). version=2 swaps the mixer for the MXU-chunked
    # dual form (`ops/ssd.py`, `models/mamba2.py`); the fields below are
    # ignored for version=1. For version=2 the mamba-ssm 2.x defaults are
    # d_state=128 (set it explicitly — this dataclass keeps the v1 default
    # 16), headdim=64, ngroups=1.
    version: int = 1  # 1 = selective scan | 2 = SSD
    headdim: int = 64
    ngroups: int = 1
    a_init_range: Any = (1.0, 16.0)
    ssd_chunk_size: int = 256
    # chunks batched per scan step (MXU batching vs live-memory trade)
    ssd_seg_chunks: int = 8

    def resolved_dt_rank(self, d_model: int) -> int:
        if self.dt_rank == "auto":
            return math.ceil(d_model / 16)
        return int(self.dt_rank)


@dataclass
class CaduceusConfig:
    """Model configuration.

    Capability parity with `caduceus/configuration_caduceus.py:10-55`.
    """

    d_model: int = 256
    n_layer: int = 16
    vocab_size: int = 12
    ssm_cfg: SSMConfig = field(default_factory=SSMConfig)
    rms_norm: bool = True
    residual_in_fp32: bool = True
    # For non-RCPS models this is a pure fusion detail (XLA fuses add+norm
    # natively; both reference paths compute the same function). For RCPS it
    # selects the BLOCK FRAME: the reference's fused path
    # (`modeling_rcps.py:165-200`) normalizes the SECOND channel half
    # unflipped and the flipped FIRST half — swapping the halves at every
    # block relative to its own non-fused RCPSAddNormWrapper. The two frames
    # are different functions of the same weights (both RC-equivariant);
    # released checkpoints are trained with fused_add_norm=true, so True is
    # the checkpoint-parity default. Verified against the reference's own
    # torch code in tests/test_reference_torch_parity.py.
    fused_add_norm: bool = True
    pad_vocab_size_multiple: int = 8
    norm_epsilon: float = 1e-5

    # init (`caduceus/modeling_caduceus.py:304-341`)
    initializer_range: float = 0.02
    rescale_prenorm_residual: bool = True
    n_residuals_per_layer: int = 1

    # Caduceus-specific
    bidirectional: bool = True
    bidirectional_strategy: Optional[str] = "add"  # "add" | "ew_multiply"
    bidirectional_weight_tie: bool = True
    rcps: bool = False
    complement_map: Optional[Dict[int, int]] = None

    # loss / tokenizer interplay
    pad_token_id: int = 4

    # numerics policy (TPU): params fp32, compute bf16
    dtype: str = "bfloat16"
    param_dtype: str = "float32"

    # gradient checkpointing over layers (the reference lacks this for
    # Caduceus — `modeling_caduceus.py:301` — but it is required for 131k
    # sequence training on TPU HBM budgets). remat_span groups consecutive
    # layers under one checkpoint: saved boundary activations shrink by the
    # span factor at unchanged total recompute (each layer recomputed once).
    remat: bool = False
    remat_span: int = 1

    # tensor parallelism: name of the mesh axis the projections, d_inner
    # channels and heads are cut over (`parallel/sharding.py shard_module_`
    # cuts the parameters; the mixers call the exchanges of
    # `parallel/comm.py`, and each rank's scan runs on its slice with no
    # collective inside). Requires a registered global mesh (like
    # context_parallel_axis).
    tensor_parallel_axis: Optional[str] = None

    # context parallelism (beyond the reference, SURVEY.md §5.7 stretch):
    # name of the mesh axis the sequence dimension is sharded over; the
    # selective scans run as the exact two-pass sequence-parallel algorithm
    # (`parallel/seq_scan.py`). Requires the runtime to register its mesh
    # via `parallel.mesh.set_global_mesh`/`with_mesh`.
    context_parallel_axis: Optional[str] = None

    def __post_init__(self):
        if isinstance(self.ssm_cfg, dict):
            self.ssm_cfg = SSMConfig(**self.ssm_cfg)
        if self.complement_map is not None:
            # JSON round-trips dict keys as strings; normalize to int->int
            self.complement_map = {int(k): int(v) for k, v in self.complement_map.items()}
        if self.bidirectional and self.bidirectional_strategy is None:
            self.bidirectional_strategy = "add"
        if self.bidirectional and self.bidirectional_strategy not in ("add", "ew_multiply"):
            raise NotImplementedError(
                f"bidirectional_strategy={self.bidirectional_strategy!r} not implemented"
            )
        s = self.ssm_cfg
        if s.version not in (1, 2):
            raise NotImplementedError(f"ssm_cfg.version={s.version!r}")
        if s.use_kernel.startswith("pallas_batched") and s.version != 2:
            raise ValueError(
                "use_kernel='pallas_batched' selects the head-batched SSD "
                "kernels (ops/ssd_pallas_batched.py), which exist only for "
                "ssm_cfg.version=2"
            )
        if (s.version == 1 and self.tensor_parallel_axis
                and self.context_parallel_axis):
            raise NotImplementedError(
                "version=1 supports tensor_parallel_axis OR "
                "context_parallel_axis, not both (the composed path exists "
                "for version=2)"
            )
        if s.version == 2:
            if isinstance(s.a_init_range, list):
                s.a_init_range = tuple(s.a_init_range)
            if self.d_inner % s.headdim != 0:
                raise ValueError(
                    f"d_inner {self.d_inner} not divisible by headdim {s.headdim}"
                )
            if (self.d_inner // s.headdim) % s.ngroups != 0:
                raise ValueError(
                    f"nheads {self.d_inner // s.headdim} not divisible by "
                    f"ngroups {s.ngroups}"
                )
            if (self.tensor_parallel_axis and self.context_parallel_axis
                    and self.tensor_parallel_axis
                    == self.context_parallel_axis):
                raise ValueError(
                    "version=2 CP+TP composition needs DISTINCT mesh axes "
                    "(e.g. tensor_parallel_axis='model', "
                    "context_parallel_axis='seq' on a make_mesh(model=M, "
                    "seq=S) mesh)"
                )
            # ngroups>1 TP: heads are contiguous per group, so any TP degree
            # that divides (or is divided by) ngroups keeps shard boundaries
            # group-aligned — validated against the actual mesh at run time
            # in `models/mamba2.py _sharded_ssd` / `parallel/seq_scan.py`.

    # -- derived quantities ------------------------------------------------
    @property
    def padded_vocab_size(self) -> int:
        """Vocab padded up to a multiple of `pad_vocab_size_multiple`.

        Matches `caduceus/modeling_caduceus.py:353-354`.
        """
        m = self.pad_vocab_size_multiple
        v = self.vocab_size
        if v % m != 0:
            v += m - (v % m)
        return v

    def padded_complement_map(self) -> Optional[Dict[int, int]]:
        """Complement map extended with identity for vocab-padding ids.

        Matches `caduceus/modeling_caduceus.py:355-357`.
        """
        if self.complement_map is None:
            return None
        cm = dict(self.complement_map)
        for i in range(len(cm), self.padded_vocab_size):
            cm[i] = i
        return cm

    @property
    def d_inner(self) -> int:
        return self.ssm_cfg.expand * self.d_model

    @property
    def nheads(self) -> int:
        """Mamba-2 head count (version=2 only)."""
        return self.d_inner // self.ssm_cfg.headdim

    @property
    def dt_rank(self) -> int:
        return self.ssm_cfg.resolved_dt_rank(self.d_model)

    # -- serialization -----------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "CaduceusConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})

    def save(self, path: str) -> None:
        """Write `model_config.json`-style artifact (cf. `src/utils/train.py:132-138`)."""
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2)

    @classmethod
    def load(cls, path: str) -> "CaduceusConfig":
        with open(path) as f:
            return cls.from_dict(json.load(f))


def _apply_overrides(cfg: Any, overrides: Dict[str, Any]) -> Any:
    """Apply dotted-key overrides to a (possibly nested) dataclass."""
    for key, value in overrides.items():
        obj = cfg
        parts = key.split(".")
        for p in parts[:-1]:
            obj = getattr(obj, p)
        leaf = parts[-1]
        if not hasattr(obj, leaf):
            raise KeyError(f"unknown config key: {key}")
        setattr(obj, leaf, value)
    return cfg


def load_config(path: str, overrides: Optional[Dict[str, Any]] = None) -> CaduceusConfig:
    """Load a model config from YAML or JSON, with dotted overrides."""
    if path.endswith((".yaml", ".yml")):
        import yaml

        with open(path) as f:
            data = yaml.safe_load(f)
    else:
        with open(path) as f:
            data = json.load(f)
    cfg = CaduceusConfig.from_dict(data)
    if overrides:
        _apply_overrides(cfg, overrides)
    return cfg
