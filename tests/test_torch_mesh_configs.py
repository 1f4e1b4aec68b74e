"""Configurations of the JAX step that the port runs under a mesh, on the
CPU: GPN-weighted cross-entropy (``loss_weights``) in the train and the eval
step, the eval's ``last_k`` / ``per_token`` sums under context parallelism,
and ``inputs_embeds`` under context parallelism.

The ranks run as threads (`tests/test_torch_parallel.py run_ranks`). The JAX
side is the unsharded JAX function on one device (``use_kernel="xla"``) on
the same weights (the port's seeded init through `params.py to_jax_params`:
no JAX init to compile) and the same batch, in fp32:

- the train step (accum 2) with loss weights on dp2, dp2 x cp2 and a
  (data 2, model 2) tensor-parallel grid against JAX's `make_train_step`
  and against the port's step on one rank: loss and grad norm within 1e-6
  relative of both; the updated parameters within 1e-6 of one rank's
  under DP and CP (as tests/test_torch_parallel.py holds the unweighted
  step), under TP within 1e-6 (1 + |p|) where one rank's gradient is above
  1e-3 of its largest element and 2 lr elsewhere (as
  tests/test_torch_tensor_parallel.py holds it: an in_proj element whose
  gradient is near Adam's eps moves 1.2e-6 from one rank's), and within
  rtol 1e-4 / atol 1e-6 of JAX's (that file's rule against JAX: one rank's
  update of that element is 2.1e-6 from JAX's);
- the eval step on the same grids with loss weights, ``per_token`` and
  ``last_k`` 40 (spanning both CP ranks), 16 (the last rank's columns only)
  and 80 (>= L: the whole row) against JAX's `make_eval_step`: every sum and
  per-position vector within 1e-5 relative (of its largest element for the
  vectors); only rank 0 writes the per-token curve of `Trainer.evaluate`;
- the v2 and v1 backbones (non-RCPS) with ``inputs_embeds`` on 2 CP ranks
  against the JAX backbone with ``context_parallel_axis`` on the 2-device
  mesh: hidden states within atol 2e-4 / rtol 1e-4, the gradients of
  sum(h R) (R a seeded normal cotangent; sum(h^2) would cancel through the
  final LayerNorm, which makes it nearly constant in the input) for the
  parameters and the embeddings within 5e-4 of their largest value
  (tests/test_torch_parallel.py's CP model tolerances).
"""

import dataclasses
import functools
import os
import warnings

import flax.traverse_util as tu
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_parallel import _mesh2, one_thread, run_ranks  # noqa: F401

from caduceus_tpu.config import CaduceusConfig as JaxConfig
from caduceus_tpu.config import SSMConfig as JaxSSM
from caduceus_tpu.models.caduceus import CaduceusBackbone as JaxBackbone
from caduceus_tpu.models.caduceus import CaduceusForMaskedLM as JaxLM
from caduceus_tpu.parallel.mesh import with_mesh as jax_with_mesh
from caduceus_tpu.tokenization import CaduceusTokenizer
from caduceus_tpu.train import optim as jax_optim
from caduceus_tpu.train.trainer import TrainState as JaxState
from caduceus_tpu.train.trainer import make_eval_step as jax_eval_step
from caduceus_tpu.train.trainer import make_train_step as jax_train_step
from caduceus_tpu_torch.config import CaduceusConfig
from caduceus_tpu_torch.models.caduceus import Caduceus, CaduceusForMaskedLM
from caduceus_tpu_torch.params import from_jax_params, to_jax_params
from caduceus_tpu_torch.parallel.mesh import shard_batch
from caduceus_tpu_torch.parallel.sharding import shard_module_
from caduceus_tpu_torch.train.optim import make_optimizer
from caduceus_tpu_torch.train.trainer import (
    Trainer,
    TrainerConfig,
    TrainState,
    make_eval_step,
    make_train_step,
)

L, ROWS, ACCUM = 64, 4, 2
LAST_KS = (40, 16, 80)      # both CP ranks, the last rank only, >= L
OPT = dict(lr=8e-3, warmup_t=0, t_initial=100, weight_decay=0.1)
# (data, model, what the model axis carries)
GRIDS = {"dp2": (2, 1, None), "dp2xcp2": (2, 2, "cp"), "tp": (2, 2, "tp")}


def _jax_cfg(**over):
    tok = CaduceusTokenizer()
    return JaxConfig(**{**dict(
        d_model=16, n_layer=2, vocab_size=tok.vocab_size, rcps=True,
        complement_map=tok.complement_map, dtype="float32",
        param_dtype="float32",
        ssm_cfg=JaxSSM(version=2, d_state=16, headdim=8, ngroups=1,
                       ssd_chunk_size=16, ssd_seg_chunks=2,
                       use_kernel="xla")), **over})


def _port_cfg(cfg, **over):
    return CaduceusConfig.from_dict({**dataclasses.asdict(cfg), **over})


def _tree(flat):
    return {"params": tu.unflatten_dict(
        {tuple(k.split("/")): jnp.asarray(v) for k, v in flat.items()})}


def _batch():
    """MLM-like ids and targets (every 5th position ignored) with GPN loss
    weights in [0.1, 2)."""
    rng = np.random.default_rng(3)
    b = {"input_ids": rng.integers(7, 11, (ROWS, L)).astype(np.int64),
         "targets": rng.integers(0, 12, (ROWS, L)).astype(np.int64),
         "loss_weights": rng.uniform(0.1, 2.0, (ROWS, L)).astype(np.float32)}
    b["targets"][:, ::5] = 4
    return b


@functools.lru_cache(maxsize=None)
def _init():
    """(JAX config, flat params): the port's seeded init."""
    cfg = _jax_cfg()
    model = CaduceusForMaskedLM(_port_cfg(cfg), device="cpu",
                                generator=torch.Generator().manual_seed(5))
    return cfg, to_jax_params(model.state_dict())


def _jb(batch):
    return {k: jnp.asarray(v if v.dtype == np.float32 else v.astype(np.int32))
            for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def _jax_train():
    """JAX's weighted step (accum 2) on one device: (metrics, flat params
    after)."""
    cfg, flat = _init()
    tx, _ = jax_optim.make_optimizer(**OPT)
    params = _tree(flat)
    state = JaxState(params, tx.init(params), jnp.zeros((), jnp.int32))
    step = jax_train_step(JaxLM(cfg).apply, tx, accum_steps=ACCUM)
    state, m = jax.jit(step)(state, _jb(_batch()))
    return ({k: float(v) for k, v in m.items()},
            {k: np.asarray(v) for k, v in
             tu.flatten_dict(state.params["params"], sep="/").items()})


@functools.lru_cache(maxsize=None)
def _jax_eval():
    """JAX's eval step on the whole batch for each k of `LAST_KS`, with the
    loss weights and per_token, in one jitted program."""
    cfg, flat = _init()
    apply = JaxLM(cfg).apply
    steps = [jax_eval_step(apply, last_k=k, per_token=True) for k in LAST_KS]
    out = jax.jit(lambda p, b: [s(p, b) for s in steps])(
        _tree(flat), _jb(_batch()))
    return [{k: np.asarray(v, np.float64) for k, v in m.items()} for m in out]


@functools.lru_cache(maxsize=None)
def _one_rank_train():
    """The port's weighted step on one rank, no mesh: (metrics, flat params
    after)."""
    cfg, flat = _init()
    model = CaduceusForMaskedLM(_port_cfg(cfg), device="cpu")
    model.load_state_dict(from_jax_params(flat, _port_cfg(cfg)))
    opt, _ = make_optimizer(model.named_parameters(), **OPT)
    _, m = make_train_step(accum_steps=ACCUM)(TrainState(model, opt),
                                              _t(_batch()))
    settled = {k: p.grad.abs() > 1e-3 * p.grad.abs().max()
               for k, p in model.named_parameters()}
    return ({k: float(v) for k, v in m.items()},
            to_jax_params(model.state_dict()), to_jax_params(settled))


def _model(mesh, mode):
    """The port's model on this rank: cut over the model axis (``"tp"``)
    or with context_parallel_axis (``"cp"``); (model, TP plan)."""
    cfg, flat = _init()
    over = ({"context_parallel_axis": "model"} if mode == "cp" else
            {"tensor_parallel_axis": "model"} if mode == "tp" else {})
    pcfg = _port_cfg(cfg, **over)
    model = CaduceusForMaskedLM(pcfg, device="cpu")
    model.load_state_dict(from_jax_params(flat, pcfg))
    plan = shard_module_(model, mesh) if mode == "tp" else None
    return model, plan


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _rel(got, want):
    return abs(got - want) / abs(want)


@pytest.mark.parametrize("grid", list(GRIDS))
def test_weighted_train_step_matches_jax(grid, one_thread):
    """One accum-2 train step with loss weights on the grid against JAX's
    step on one device: JAX normalizes the weights over each micro-batch of
    the global batch, so every rank divides by the all-reduced sum."""
    data, model_axis, mode = GRIDS[grid]
    jm, jp = _jax_train()
    m1, p1, settled = _one_rank_train()

    def rank(mesh):
        model, plan = _model(mesh, mode)
        opt, _ = make_optimizer(model.named_parameters(), **OPT)
        b = shard_batch(mesh, _batch(), cp=mode == "cp", accum_steps=ACCUM)
        _, m = make_train_step(accum_steps=ACCUM, mesh=mesh, tp_plan=plan)(
            TrainState(model, opt), _t(b))
        sd = model.state_dict() if plan is None else plan.gather_state(
            model.state_dict())
        return {k: float(v) for k, v in m.items()}, to_jax_params(sd)

    for m, params in run_ranks(rank, data=data, model=model_axis):
        for want in (jm, m1):
            for k in ("loss", "grad_norm", "loss_sum", "acc"):
                assert _rel(m[k], want[k]) <= 1e-6, (k, m[k], want[k])
            assert m["count"] == want["count"]
        for k, v in jp.items():
            lim = (np.where(settled[k] > 0, 1e-6 * (1 + np.abs(p1[k])),
                            2 * OPT["lr"]) if mode == "tp" else 1e-6)
            assert (np.abs(params[k] - p1[k]) <= lim).all(), k
            np.testing.assert_allclose(params[k], v, rtol=1e-4, atol=1e-6,
                                       err_msg=k)


def _hold_eval(got, want):
    for k in ("loss", "loss_sum", "acc", "last_k_loss_sum"):
        assert _rel(got[k], float(want[k])) <= 1e-5, (k, got[k], want[k])
    for k in ("count", "last_k_count"):
        assert got[k] == float(want[k]), k
    for k in ("pos_nll_sum", "pos_count"):
        g, w = np.asarray(got[k], np.float64), want[k]
        assert g.shape == w.shape == (L,), k
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * np.abs(w).max(),
                                   err_msg=k)


def _rank_evals(mesh, mode):
    model, plan = _model(mesh, mode)
    b = _t(shard_batch(mesh, _batch(), cp=mode == "cp"))
    out = []
    for k in LAST_KS:
        m = make_eval_step(model, last_k=k, per_token=True, mesh=mesh,
                           tp_plan=plan)(None, b)
        out.append({n: (v.numpy() if v.dim() else float(v))
                    for n, v in m.items()})
    return out


@pytest.mark.parametrize("grid", list(GRIDS))
def test_weighted_eval_matches_jax(grid, one_thread):
    """The eval step on the grid with loss weights, per_token and each k of
    `LAST_KS` against JAX's on one device: the weighted loss (its
    denominator all-reduced), loss_sum = loss x count, and the unweighted
    last-k and per-position sums."""
    data, model_axis, mode = GRIDS[grid]
    want = _jax_eval()
    for res in run_ranks(lambda mesh: _rank_evals(mesh, mode), data=data,
                         model=model_axis):
        for got, w in zip(res, want):
            _hold_eval(got, w)


@pytest.mark.parametrize("k", LAST_KS, ids=["spans_both", "last_rank",
                                            "whole_row"])
def test_cp_last_k_and_per_token_match_jax(k, one_thread):
    """Under cp2 alone (data 1): rank m scores its columns' overlap with
    [L - k, L), and its per-position sums land in its columns; every rank
    holds JAX's sums and vectors."""
    want = _jax_eval()[LAST_KS.index(k)]
    for res in run_ranks(lambda mesh: _rank_evals(mesh, "cp"), data=1,
                         model=2):
        _hold_eval(res[LAST_KS.index(k)], want)


def test_cp_trainer_per_token_curve_written_by_rank_0(tmp_path, one_thread):
    """`Trainer.evaluate` under cp2 with eval_per_token and eval_last_k:
    every rank returns the same metrics, and rank 0 alone writes the
    per-token curve, JAX's curve exp(pos_nll / pos_count)."""
    want = _jax_eval()[0]
    batch = {k: v for k, v in _batch().items() if k != "loss_weights"}

    def rank(mesh):
        model, _ = _model(mesh, "cp")
        tr = Trainer(model, TrainerConfig(
            run_dir=str(tmp_path / f"rank{mesh.rank}"), eval_batches=1,
            eval_last_k=LAST_KS[0], eval_per_token=True), None,
            eval_loader=[batch], mesh=mesh, context_parallel=True)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")   # a list has no sampler
            return tr.evaluate()

    res = run_ranks(rank, data=1, model=2)
    assert res[0].keys() == res[1].keys()
    assert all(res[0][k] == res[1][k] for k in res[0]
               if k != "val/per_token_ppl_file")
    path = res[0]["val/per_token_ppl_file"]
    assert path == str(tmp_path / "rank0" / "per_token_ppl_val.npy")
    assert not os.path.exists(tmp_path / "rank1")
    curve = np.exp(want["pos_nll_sum"] / np.maximum(want["pos_count"], 1))
    np.testing.assert_allclose(np.load(path), curve, rtol=1e-5, atol=0)
    assert res[0][f"val/last_{LAST_KS[0]}_ppl"] == pytest.approx(
        np.exp(want["last_k_loss_sum"] / want["last_k_count"]), rel=1e-5)


# -- inputs_embeds under context parallelism -------------------------------------

def _embeds_cfg(version):
    ssm = (JaxSSM(version=2, d_state=16, headdim=16, ngroups=1,
                  ssd_chunk_size=16, ssd_seg_chunks=2, use_kernel="xla")
           if version == 2 else JaxSSM(d_state=4, use_kernel="xla"))
    return _jax_cfg(rcps=False, ssm_cfg=ssm)


@functools.lru_cache(maxsize=None)
def _jax_embeds(version):
    """(flat backbone params, embeddings, cotangent R, hidden states, flat
    parameter gradient, embedding gradient) of the JAX backbone with
    context_parallel_axis on the 2-device mesh, the loss sum(h R)."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    cfg = _embeds_cfg(version)
    init = Caduceus(_port_cfg(cfg), device="cpu",
                    generator=torch.Generator().manual_seed(7))
    flat = {k[len("backbone/"):]: v
            for k, v in to_jax_params(init.state_dict()).items()}
    rng = np.random.default_rng(4)
    emb, cot = rng.normal(size=(2, 2, L, cfg.d_model)).astype(np.float32)
    cp = JaxBackbone(dataclasses.replace(cfg, context_parallel_axis="data"))
    mesh = _mesh2()
    x = jax.device_put(jnp.asarray(emb), NamedSharding(mesh, P(None, "data")))

    def run(p, e):
        h, vjp = jax.vjp(lambda q, f: cp.apply(q, None, inputs_embeds=f)[0],
                         p, e)
        gp, ge = vjp(jnp.asarray(cot))
        return h, gp, ge

    with jax_with_mesh(mesh):
        h, gp, ge = jax.jit(run)(_tree(flat), x)
    return (flat, emb, cot, np.asarray(h),
            {k: np.asarray(v) for k, v in
             tu.flatten_dict(gp["params"], sep="/").items()}, np.asarray(ge))


def _close_scaled(got, want, atol, what):
    s = float(np.abs(want).max()) + 1e-9
    np.testing.assert_allclose(np.asarray(got) / s, np.asarray(want) / s,
                               atol=atol, err_msg=what)


@pytest.mark.parametrize("version", [2, 1])
def test_cp_inputs_embeds_match_jax(version, one_thread):
    """The port's backbone with context_parallel_axis on 2 ranks, each
    given the whole (2, 64, 16) embeddings, against the JAX backbone with
    context_parallel_axis: the ranks' hidden states side by side, the
    parameter gradients and the embeddings' gradient (nonzero in each
    rank's columns only) summed over the ranks."""
    flat, emb, cot, jh, jgp, jge = _jax_embeds(version)
    ccfg = _port_cfg(_embeds_cfg(version), context_parallel_axis="model")
    sd = from_jax_params({"backbone/" + k: v for k, v in flat.items()},
                         ccfg, backbone_only=True)

    def rank(mesh):
        m = Caduceus(ccfg, device="cpu")
        m.load_state_dict(sd)
        e = torch.from_numpy(emb).requires_grad_(True)
        h, _ = m.backbone(None, inputs_embeds=e)
        cols = slice(mesh.rank * n, (mesh.rank + 1) * n)
        (h * torch.from_numpy(cot[:, cols])).sum().backward()
        outside = torch.cat([e.grad[:, :cols.start], e.grad[:, cols.stop:]],
                            1)
        assert not bool(outside.any())
        # the token embedding is not used: no gradient (JAX's is zero)
        return (h.detach(), e.grad,
                {k: torch.zeros_like(p) if p.grad is None else p.grad
                 for k, p in m.named_parameters()})

    n = L // 2

    res = run_ranks(rank)
    h = torch.cat([r[0] for r in res], 1)
    np.testing.assert_allclose(h.numpy(), jh, atol=2e-4, rtol=1e-4)
    _close_scaled(sum(r[1] for r in res).numpy(), jge, 5e-4, "embeddings")
    got = to_jax_params({k: sum(r[2][k] for r in res) for k in res[0][2]})
    assert {k[len("backbone/"):] for k in got} == set(jgp)
    for k, v in got.items():
        _close_scaled(v, jgp[k[len("backbone/"):]], 5e-4, k)
