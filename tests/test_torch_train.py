"""The port's training step (`caduceus_tpu_torch/train`) against
`caduceus_tpu.train`, on the CPU.

The same weights (a JAX init moved through `params.py`) and the same
numpy-seeded batches go through three `make_train_step` steps of both
packages: AdamW with clipping and a warmup + cosine schedule, accumulation
over 2 micro-batches, on a 2-layer, d_model 32 RCPS Mamba-2 model (the JAX
side with ``use_kernel="xla"``, the port on the plain version of its SSD
kernels). Also: the weight-decay masks and the schedules agree, the
torch → flax parameter bridge inverts flax → torch, and remat leaves the
gradients as they are.
"""

import dataclasses
import functools

import flax.traverse_util as tu
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from caduceus_tpu.config import CaduceusConfig as JaxConfig
from caduceus_tpu.config import SSMConfig as JaxSSM
from caduceus_tpu.models.caduceus import CaduceusForMaskedLM as JaxLM
from caduceus_tpu.tokenization import CaduceusTokenizer
from caduceus_tpu.train import optim as jax_optim
from caduceus_tpu.train.metrics import cross_entropy_loss as jax_ce
from caduceus_tpu.train.trainer import TrainState as JaxState
from caduceus_tpu.train.trainer import make_train_step as jax_make_step
from caduceus_tpu_torch.config import CaduceusConfig
from caduceus_tpu_torch.models.caduceus import CaduceusForMaskedLM
from caduceus_tpu_torch.params import flax_path, from_jax_params, to_jax_params
from caduceus_tpu_torch.train import optim
from caduceus_tpu_torch.train.metrics import accuracy, cross_entropy_loss
from caduceus_tpu_torch.train.trainer import (
    TrainState,
    init_ema,
    make_train_step,
)

ACCUM, B, L = 2, 2, 64
OPT = dict(lr=8e-3, warmup_t=2, t_initial=10, weight_decay=0.1)


@functools.lru_cache(maxsize=None)
def make_case(seed=0, version=2, n_steps=3):
    tok = CaduceusTokenizer()
    ssm = (JaxSSM(version=2, d_state=16, headdim=16, ngroups=1,
                  ssd_chunk_size=16, use_kernel="xla") if version == 2
           else JaxSSM(version=1, d_state=8, use_kernel="xla"))
    cfg = JaxConfig(
        d_model=32, n_layer=2, vocab_size=tok.vocab_size, rcps=True,
        complement_map=tok.complement_map, residual_in_fp32=False,
        dtype="float32", param_dtype="float32", ssm_cfg=ssm)
    rng = np.random.default_rng(seed)
    batches = []
    for _ in range(n_steps):
        ids = rng.integers(7, 11, (ACCUM * B, L)).astype(np.int32)
        tgt = rng.integers(0, 12, (ACCUM * B, L)).astype(np.int32)
        batches.append((ids, tgt))   # targets 4 (PAD) are ignored
    variables = jax.jit(JaxLM(cfg).init)(jax.random.PRNGKey(seed),
                                         jnp.asarray(batches[0][0][:1]))
    flat = {k: np.asarray(v) for k, v in
            tu.flatten_dict(variables["params"], sep="/").items()}
    for k, v in flat.items():   # non-trivial norm weights and D
        if "norm" in k or k.endswith("/D"):
            flat[k] = (v + 0.1 * rng.standard_normal(v.shape)).astype(
                np.float32)
    return cfg, batches, flat


def port_model(cfg, flat, **over):
    pc = CaduceusConfig.from_dict({**dataclasses.asdict(cfg), **over})
    model = CaduceusForMaskedLM(pc, device="cpu")
    model.load_state_dict(from_jax_params(flat, pc))
    return model


def _recording(tx):
    """``tx`` that also keeps the gradient it is given in its state: the
    step's mean gradient over the micro-batches, before clipping (the
    clipping is part of ``tx``). One compile of the JAX step then gives
    both the trajectory and its gradients."""
    def init(params):
        return tx.init(params), jax.tree_util.tree_map(jnp.zeros_like, params)

    def update(g, state, params=None):
        updates, inner = tx.update(g, state[0], params)
        return updates, (inner, g)

    return optax.GradientTransformation(init, update)


def jax_trajectory(cfg, batches, flat):
    """Per step: (metrics, mean gradient before clipping, params after)."""
    model = JaxLM(cfg)
    tx, _ = jax_optim.make_optimizer(**OPT)
    tx = _recording(tx)
    params = {"params": tu.unflatten_dict(flat, sep="/")}
    state = JaxState(params, tx.init(params), jnp.zeros((), jnp.int32))
    step = jax.jit(jax_make_step(model.apply, tx, accum_steps=ACCUM))
    out = []
    for ids, tgt in batches:
        state, m = step(state, {"input_ids": jnp.asarray(ids),
                                "targets": jnp.asarray(tgt)})
        g = state.opt_state[1]
        flat_p = {k: np.asarray(v) for k, v in tu.flatten_dict(
            state.params["params"], sep="/").items()}
        flat_g = {k: np.asarray(v) for k, v in tu.flatten_dict(
            g["params"], sep="/").items()}
        out.append(({k: float(v) for k, v in m.items()}, flat_g, flat_p))
    return out


def _hold_trajectory(cfg, batches, flat):
    want = jax_trajectory(cfg, batches, flat)
    model = port_model(cfg, flat)
    opt, _ = optim.make_optimizer(model.named_parameters(), **OPT)
    state = TrainState(model, opt)
    step = make_train_step(accum_steps=ACCUM)
    settled = {}
    for k, ((ids, tgt), (m_j, g_j, p_j)) in enumerate(zip(batches, want)):
        # the port's step clips .grad in place: hold the mean gradient
        # before clipping, from the clipped one and grad_norm
        state, m = step(state, {"input_ids": torch.from_numpy(ids).long(),
                                "targets": torch.from_numpy(tgt).long()})
        assert state.step == k + 1
        for name in ("loss", "grad_norm", "acc", "loss_sum"):
            np.testing.assert_allclose(float(m[name]), m_j[name], rtol=1e-5,
                                       err_msg=f"step {k}: {name}")
        assert int(m["count"]) == int(m_j["count"])
        unclip = max(1.0, float(m["grad_norm"]))
        grads = to_jax_params({n: p.grad * unclip
                               for n, p in model.named_parameters()})
        params = to_jax_params(model.state_dict())
        assert grads.keys() == g_j.keys() == params.keys() == p_j.keys()
        for path, g in grads.items():
            s = np.abs(g_j[path]).max() + 1e-12
            np.testing.assert_allclose(g / s, g_j[path] / s, atol=1e-4,
                                       err_msg=f"step {k}: grad {path}")
            big = np.abs(g_j[path]) > 1e-4 * s
            settled[path] = settled.get(path, big) & big
            d = np.abs(params[path] - p_j[path])
            lim = np.where(settled[path], 1e-5 * (1 + np.abs(p_j[path])),
                           2 * OPT["lr"] * (k + 1))
            assert (d <= lim).all(), (k, path, float(d.max()))


def test_train_steps_match_jax():
    """Three steps, accum 2. Tolerances: loss, grad_norm, acc and loss_sum
    1e-5 relative (two fp32 programs that chunk the scan differently); each
    gradient 1e-4 of its largest element; each updated parameter within
    1e-5 · (1 + |p|) where the step's gradient is well above Adam's eps
    (|g| > 1e-4 · max|g| of that leaf, for every step so far). At a
    gradient near zero Adam's first update g / (|g| + eps) turns on the
    sign of g, so there it is held to the step bound 2·lr per step."""
    _hold_trajectory(*make_case())


def test_v1_train_steps_match_jax():
    """Two steps, accum 2, of the v1 (Mamba-1) RCPS model, at the same
    tolerances. The port's CPU backward runs the explicit plain adjoint
    (`ops/selective_scan.py selective_scan_bwd`) behind `_BidirScanFn`, so
    this also holds it against jax.grad end to end."""
    _hold_trajectory(*make_case(version=1, n_steps=2))


def test_weight_decay_mask_and_schedules_match_jax():
    cfg, _, flat = make_case()
    want = jax_optim.weight_decay_mask({"params": tu.unflatten_dict(
        flat, sep="/")})
    want = tu.flatten_dict(want["params"], sep="/")
    got = optim.weight_decay_mask(port_model(cfg, flat).named_parameters())
    assert {flax_path(k): v for k, v in got.items()} == want
    assert want["backbone/layers_0/mixer/fwd/conv_w"]
    assert not want["backbone/embedding"]
    steps = [0, 1, 5, 99, 100, 101, 5000, 50_099, 50_100, 60_000]
    cases = [
        ("cosine_warmup", dict(lr=8e-3, warmup_t=100, t_initial=50_000,
                               lr_min=1e-5, warmup_lr_init=1e-6)),
        ("constant", dict(lr=3e-4)),
        ("constant_warmup", dict(lr=3e-4, warmup_t=100)),
        ("linear_warmup", dict(lr=8e-3, warmup_t=100, t_initial=50_000)),
        ("inv_sqrt", dict(lr=8e-3, warmup_t=100)),
        ("multistep", dict(lr=1e-3, milestones=(100, 5000))),
    ]
    for name, kw in cases:
        f_j = jax_optim.SCHEDULE_REGISTRY[name](**kw)
        f_t = optim.SCHEDULE_REGISTRY[name](**kw)
        # the JAX schedules compute in fp32: terms of size lr carry
        # roundings of ~1e-7·lr, which near the end of a decay are large
        # against the value itself
        np.testing.assert_allclose([f_t(s) for s in steps],
                                   [float(f_j(s)) for s in steps],
                                   rtol=1e-6, atol=1e-7 * kw["lr"],
                                   err_msg=name)


def test_loss_and_accuracy_match_jax():
    from caduceus_tpu.train.metrics import accuracy as jax_acc

    rng = np.random.default_rng(2)
    logits = rng.standard_normal((2, 9, 16)).astype(np.float32)
    tgt = rng.integers(0, 12, (2, 9)).astype(np.int32)
    w = rng.random((2, 9)).astype(np.float32)
    for lw in (None, w):
        got, aux = cross_entropy_loss(
            torch.from_numpy(logits), torch.from_numpy(tgt),
            loss_weights=None if lw is None else torch.from_numpy(lw))
        want, aux_j = jax.jit(lambda a, t, *v: jax_ce(
            a, t, loss_weights=v[0] if v else None))(
                logits, tgt, *(() if lw is None else (lw,)))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
        np.testing.assert_allclose(float(aux["loss_sum"]),
                                   float(aux_j["loss_sum"]), rtol=1e-6)
        assert int(aux["count"]) == int(aux_j["count"])
    for ii in (None, 4):
        np.testing.assert_allclose(
            float(accuracy(torch.from_numpy(logits), torch.from_numpy(tgt),
                           ii)),
            float(jax.jit(lambda a, t: jax_acc(a, t, ii))(logits, tgt)),
            rtol=1e-6)


def test_param_bridge_round_trip():
    cfg, _, flat = make_case()
    model = port_model(cfg, flat)
    back = to_jax_params(model.state_dict())
    assert back.keys() == flat.keys()
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v)


def test_v1_param_bridge_round_trip():
    """flax -> torch -> flax gives back every array of the v1 tree
    (mixer/fwd/x_proj_w, mixer/rev/A_log, ...) with no new rule."""
    cfg, _, flat = make_case(version=1, n_steps=2)
    assert "backbone/layers_1/mixer/rev/x_proj_w" in flat
    back = to_jax_params(port_model(cfg, flat).state_dict())
    assert back.keys() == flat.keys()
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v)


@pytest.mark.parametrize("span", [1, 2])
def test_remat_keeps_gradients(span):
    """Checkpointed spans recompute the same forward: the same gradients,
    and an EMA step and the optimizer run as without remat."""
    cfg, batches, flat = make_case()
    ids, tgt = (torch.from_numpy(a).long() for a in batches[0])
    grads = []
    for remat in (False, True):
        model = port_model(cfg, flat, remat=remat, remat_span=span)
        assert model.cfg.remat == remat
        opt, _ = optim.make_optimizer(model.named_parameters(), **OPT)
        state = TrainState(model, opt, ema_params=init_ema(model))
        step = make_train_step(accum_steps=ACCUM, ema_decay=0.9)
        state, m = step(state, {"input_ids": ids, "targets": tgt})
        grads.append({n: p.grad.clone() for n, p in model.named_parameters()})
        ema = state.ema_params["backbone.norm_f_w"]
        p0 = torch.from_numpy(flat["backbone/norm_f_w"])
        p1 = model.backbone.norm_f_w.detach()
        torch.testing.assert_close(ema, 0.9 * p0 + 0.1 * p1)
    for n in grads[0]:
        torch.testing.assert_close(grads[1][n], grads[0][n], rtol=0,
                                   atol=1e-7, msg=n)
