"""Tensor parallelism of the port (`caduceus_tpu_torch/parallel/sharding.py`,
the tensor-parallel branches of the mixers, the Hyena family, `Trainer(
tensor_parallel=True)`, `cli.py pretrain --tensor-parallel`) and the
multi-process VEP, on the CPU.

The ranks run as threads (`tests/test_torch_parallel.py run_ranks`: one
`ProcessGroupGloo` per rank and axis over a shared `HashStore`). A
tensor-parallel run computes what the unsharded model computes, so the
JAX side of every model check is the unsharded JAX model
(``use_kernel="xla"``) on the same weights and inputs, in fp32:

- the rules: `param_partition_specs` splits the dimension the JAX
  `param_partition_specs` splits wherever a JAX rule matches;
  `gather_params(shard_params(p))` is ``p`` bit for bit (v1, v2 with
  ngroups 1 and 2 over 2 and 4 ranks, Hyena);
- `copy_to_axis` / `reduce_from_axis` and their gradients against the
  single-rank sums, exactly;
- v1 over 2 ranks (the four weight-tie x combine configurations, RCPS off,
  the unidirectional mixer), v2 over 2 and 4 ranks with ngroups 1 and 2
  (tests/test_ssd.py:422-450), CP x TP on a (1, 2, 2) grid through the
  fused and the unfused route (tests/test_ssd.py:453, :583) and the Hyena
  LM over 2 ranks: logits within 2e-4 abs / 1e-4 rel and the gathered
  parameter gradients of sum(logits^2) within 5e-4 of their largest
  element (tests/test_ssd.py:449-450, :496);
- a step of v2 on a (data 2, model 2) grid against JAX's `make_train_step`
  on one device (tests/test_ssd.py:383): loss within rtol 1e-5, the
  gathered parameters within rtol 1e-4 / atol 1e-6; the `Trainer` step on
  that grid against one rank's, its checkpoint resumed on one rank and a
  one-rank checkpoint resumed under tensor parallelism;
- `cli.py pretrain --mesh-model 2 --tensor-parallel` in two processes
  (gloo) against one process, its model_config.json with
  ``tensor_parallel_axis: null`` (tests/test_train.py:465);
- `cli.py vep` in two processes against one: every variant's embedding
  within 1e-6.
"""

import dataclasses
import functools
import json
import os
import subprocess
import sys

import flax.traverse_util as tu
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_parallel import one_thread, run_ranks  # noqa: F401

from caduceus_tpu.config import CaduceusConfig as JaxConfig
from caduceus_tpu.config import SSMConfig as JaxSSM
from caduceus_tpu.models import hyena as jax_hyena
from caduceus_tpu.models.caduceus import CaduceusForMaskedLM as JaxLM
from caduceus_tpu.parallel.sharding import (
    param_partition_specs as jax_specs,
)
from caduceus_tpu.tokenization import CaduceusTokenizer
from caduceus_tpu.train import optim as jax_optim
from caduceus_tpu.train.trainer import TrainState as JaxState
from caduceus_tpu.train.trainer import make_train_step as jax_make_step
from caduceus_tpu_torch.config import CaduceusConfig
from caduceus_tpu_torch.models.caduceus import CaduceusForMaskedLM
from caduceus_tpu_torch.models.hyena import HyenaLMHeadModel
from caduceus_tpu_torch.params import from_jax_params, to_jax_params
from caduceus_tpu_torch.parallel import comm
from caduceus_tpu_torch.parallel.sharding import (
    gather_params,
    param_partition_specs,
    shard_module_,
    shard_params,
)
from caduceus_tpu_torch.train.optim import make_optimizer
from caduceus_tpu_torch.train.trainer import (
    Trainer,
    TrainerConfig,
    TrainState,
    make_train_step,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = dict(atol=2e-4, rtol=1e-4)
G_TOL = 5e-4

V1 = {"tie_add": {}, "tie_mul": {"bidirectional_strategy": "ew_multiply"},
      "untied_add": {"bidirectional_weight_tie": False},
      "untied_mul": {"bidirectional_weight_tie": False,
                     "bidirectional_strategy": "ew_multiply"},
      "no_rcps": {"rcps": False},
      "mixer": {"rcps": False, "bidirectional": False}}


def _jax_cfg(version, ngroups=1, **over):
    tok = CaduceusTokenizer()
    ssm = (JaxSSM(version=2, d_state=16, headdim=8, ngroups=ngroups,
                  ssd_chunk_size=16, ssd_seg_chunks=2, use_kernel="xla")
           if version == 2 else JaxSSM(d_state=4, use_kernel="xla"))
    return JaxConfig(**{**dict(
        d_model=16, n_layer=2, vocab_size=tok.vocab_size, rcps=True,
        complement_map=tok.complement_map, dtype="float32",
        param_dtype="float32", ssm_cfg=ssm), **over})


def _flat(tree):
    return {k: np.asarray(v) for k, v in
            tu.flatten_dict(tree["params"], sep="/").items()}


def _ids(L, seed=0, B=2):
    return np.random.default_rng(seed).integers(7, 11, (B, L)).astype(
        np.int32)


@functools.lru_cache(maxsize=None)
def _jax_model(version, ngroups=1, variant="tie_add", L=64):
    """(config, ids, flat params, logits, flat gradient of sum(logits^2))
    of the unsharded JAX model: the port's seeded init through the bridge
    (no JAX init to compile), one jitted forward + VJP."""
    cfg = _jax_cfg(version, ngroups, **V1.get(variant, {}))
    ids = _ids(L)
    init = CaduceusForMaskedLM(_port_cfg(cfg), device="cpu",
                               generator=torch.Generator().manual_seed(0))
    flat = to_jax_params(init.state_dict())
    params = {"params": tu.unflatten_dict(
        {tuple(k.split("/")): jnp.asarray(v) for k, v in flat.items()})}
    model = JaxLM(cfg)

    @jax.jit
    def run(p, i):
        logits, vjp = jax.vjp(lambda q: model.apply(q, i), p)
        return logits, vjp(2 * logits)[0]

    logits, grads = run(params, jnp.asarray(ids))
    return cfg, ids, flat, np.asarray(logits), _flat(grads)


def _port_cfg(cfg, **over):
    return CaduceusConfig.from_dict({**dataclasses.asdict(cfg), **over})


def _close_scaled(got, want, atol, what):
    s = float(np.abs(want).max()) + 1e-9
    np.testing.assert_allclose(np.asarray(got) / s, np.asarray(want) / s,
                               atol=atol, err_msg=what)


def _hold_tp_model(cfg, ids, flat, jlogits, jgrads, model=2, seq=1,
                   grads=True, **over):
    """The port's model cut over ``model`` ranks (and, with ``seq``, its
    sequence over ``seq`` ranks) against the JAX logits and gradients."""
    tcfg = _port_cfg(cfg, tensor_parallel_axis="model",
                     context_parallel_axis="seq" if seq > 1 else None,
                     **over)
    sd = from_jax_params(flat, tcfg)

    def rank(mesh):
        m = CaduceusForMaskedLM(tcfg, device="cpu")
        m.load_state_dict(sd)
        plan = shard_module_(m, mesh)
        out = m(torch.from_numpy(ids.astype(np.int64)))
        if not grads:
            return out.detach(), None
        out.square().sum().backward()
        g = plan.gather_state({k: p.grad for k, p in m.named_parameters()})
        if seq > 1:
            for t in g.values():
                comm.all_reduce_(t, mesh.axis("seq"))
        return out.detach(), g

    res = run_ranks(rank, model=model, seq=seq)
    # the model ranks hold the same logits; the seq ranks their columns
    logits = torch.cat([res[s][0] for s in range(seq)], 1)
    for m in range(1, model):
        assert torch.equal(res[m * seq][0], res[0][0])
    np.testing.assert_allclose(logits.numpy(), jlogits, **OUT)
    if grads:
        got = to_jax_params(res[0][1])
        assert got.keys() == jgrads.keys()
        for k, want in jgrads.items():
            _close_scaled(got[k], want, G_TOL, k)
            for r in res[1:]:   # every rank gathers the same gradient
                assert torch.equal(r[1][_tkey(k)], res[0][1][_tkey(k)]), k


def _tkey(path):
    from caduceus_tpu_torch.params import torch_key

    return torch_key(path)


# -- the rules ------------------------------------------------------------------

HY_KW = dict(d_model=16, n_layer=2, vocab_size=12, l_max=64,
             attn_layer_idx=(1,), num_heads=2)


@functools.lru_cache(maxsize=None)
def _jax_hyena_cached():
    """(kwargs, ids, flat params, logits, flat gradient of sum(logits^2))
    of the unsharded JAX Hyena LM (dropout off: no rng)."""
    jm = jax_hyena.HyenaLMHeadModel(**HY_KW)
    ids = _ids(64, seed=5)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), ids)

    @jax.jit
    def run(p):
        out, vjp = jax.vjp(lambda q: jm.apply(q, ids), p)
        return out, vjp(2 * out)[0]

    logits, grads = run(params)
    return HY_KW, ids, _flat(params), np.asarray(logits), _flat(grads)


def _jax_spec_dims(flat):
    """{path: split dimension} where a JAX rule matches (P() omitted)."""
    tree = {"params": tu.unflatten_dict(flat, sep="/")}
    specs = tu.flatten_dict(jax_specs(tree)["params"], sep="/")
    out = {}
    for k, spec in specs.items():
        dims = [i for i, a in enumerate(spec) if a is not None]
        if dims:
            out[k] = dims[0]
    return out


def test_partition_specs_match_jax_and_gather_inverts_shard(one_thread):
    """For v1, v2 (ngroups 1 and 2) and the Hyena LM: the split dimension
    of every path a JAX rule matches is the JAX one; paths the JAX specs
    leave whole are whole here too, except the port's slices (a rank holds
    the slice it uses); `gather_params` of every rank's `shard_params` is
    the tree bit for bit, over 2 and (v2) 4 ranks."""
    port_only = ("norm_w", "dt_bias", "A_log", "in_proj/bias",
                 "short_filter_w", "short_filter_b")
    cases = [(_port_cfg(_jax_cfg(1)), _jax_model(1)[2], (2,)),
             (_port_cfg(_jax_cfg(2, 1)), _jax_model(2, 1, L=128)[2], (2, 4)),
             (_port_cfg(_jax_cfg(2, 2)), _jax_model(2, 2, L=128)[2], (2, 4))]
    hy_flat = _jax_hyena_cached()[2]
    hy = HyenaLMHeadModel(device="cpu", **HY_KW)
    cases.append((hy, hy_flat, (2,)))
    for cfg, flat, sizes in cases:
        want = _jax_spec_dims(flat)
        got = param_partition_specs(flat)
        assert want, "the JAX rules match nothing"
        for k, d in want.items():
            assert got[k] == d, (k, got[k], d)
        for k, d in got.items():
            if d is not None and k not in want:
                assert any(s in k for s in port_only), k
        assert got["backbone/embedding"] is None
        for size in sizes:
            def rank(mesh):
                part = shard_params(mesh, flat, cfg)
                back = gather_params(mesh, part, cfg)
                return part, back

            res = run_ranks(rank, model=size)
            for part, back in res:
                assert back.keys() == flat.keys()
                for k, v in flat.items():
                    assert back[k].dtype == v.dtype
                    assert np.array_equal(back[k], v), (size, k)
            cut = [k for k, d in got.items() if d is not None]
            assert cut and all(res[0][0][k].size < flat[k].size for k in cut)


def test_exchanges_and_their_gradients(one_thread):
    """`copy_to_axis` (identity; the gradient summed) and
    `reduce_from_axis` (the sum; the gradient passed through) on 3 ranks,
    in fp32 and bf16 (summed in fp32, rounded once), exactly."""
    def rank(mesh):
        ax = mesh.axis("model")
        r = ax.rank
        out = []
        for dt in (torch.float32, torch.bfloat16):
            x = torch.full((2, 3), 1.0 + r / 3, dtype=dt, requires_grad=True)
            c = comm.copy_to_axis(x, ax)
            s = comm.reduce_from_axis(x, ax)
            w = torch.tensor([1.0, 10.0, 100.0])[r]
            ((c * w).sum() + 7 * (s * w).sum()).backward()
            out.append((c.detach(), s.detach(), x.grad.clone()))
        return out

    res = run_ranks(rank, model=3)
    for dt_i, dt in enumerate((torch.float32, torch.bfloat16)):
        xs = [torch.full((2, 3), 1.0 + r / 3, dtype=dt) for r in range(3)]
        total = sum(x.float() for x in xs).to(dt)
        for r, per_dt in enumerate(res):
            c, s, g = per_dt[dt_i]
            assert torch.equal(c, xs[r])
            assert torch.equal(s, total)
            # copy: every rank's weight summed; reduce: this rank's weight
            want = (torch.full((2, 3), 111.0) + 7 * [1.0, 10.0, 100.0][r])
            assert torch.equal(g, want.to(dt))


# -- the models -------------------------------------------------------------------

@pytest.mark.parametrize("variant", list(V1))
def test_v1_tensor_parallel_matches_jax(variant, one_thread):
    """v1 over 2 ranks (each its d_inner / 2 channels; #9 / #8 and the
    unidirectional #7 on the card) against the unsharded JAX model:
    logits and every gathered parameter gradient."""
    cfg, ids, flat, logits, grads = _jax_model(1, variant=variant)
    _hold_tp_model(cfg, ids, flat, logits, grads)


@pytest.mark.parametrize("ntp,ngroups", [(2, 1), (2, 2), (4, 1), (4, 2)])
def test_v2_tensor_parallel_matches_jax(ntp, ngroups, one_thread):
    """v2 over ``ntp`` ranks (H / ntp heads each; B / C cut by groups when
    ngroups is a multiple of ntp, else whole and the rank's group sliced)
    against the unsharded JAX model (tests/test_ssd.py:422-450); at ntp 2
    also the gathered gradients, and the per-head route (use_kernel
    "pallas", #5 / #6 on the card) at ngroups 1."""
    cfg, ids, flat, logits, grads = _jax_model(2, ngroups, L=128)
    _hold_tp_model(cfg, ids, flat, logits, grads, model=ntp,
                   grads=ntp == 2)
    if ntp == 2 and ngroups == 1:
        over = {"ssm_cfg": {**dataclasses.asdict(cfg.ssm_cfg),
                            "use_kernel": "pallas"}}
        _hold_tp_model(cfg, ids, flat, logits, grads, **over)


@pytest.mark.parametrize("route", ["fused", "unfused"])
@pytest.mark.parametrize("ngroups", [1, 2])
def test_v2_cp_tp_matches_jax(route, ngroups, one_thread):
    """CP x TP on a (data 1, model 2, seq 2) grid of 4 threaded ranks (the
    heads over 'model', the sequence over 'seq'): the fused route (the CP
    entry at dims (H / 2, P, NG_loc, N)) at L = 128, the unfused composed
    route forced by an unaligned shard (L = 96: 48 rows a shard, chunk 16
    x 2; tests/test_ssd.py test_v2_cp_fused_fallback_unaligned_shard),
    against the unsharded JAX model (tests/test_ssd.py:453, :583)."""
    L = 128 if route == "fused" else 96
    cfg, ids, flat, logits, grads = _jax_model(2, ngroups, L=L)
    _hold_tp_model(cfg, ids, flat, logits, grads, model=2, seq=2)


def test_hyena_tensor_parallel_matches_jax(one_thread):
    """The Hyena LM (MHA at layer 1) over 2 ranks (the operator's channels,
    the MHA's heads, the MLP's hidden units) against the unsharded JAX
    model with dropout off; with dropout on, every site draws the mask of
    one rank (the port's unsharded model with the same key)."""
    kw, ids, flat, jlogits, jgrads = _jax_hyena_cached()
    x = torch.from_numpy(ids.astype(np.int64))

    def build():
        m = HyenaLMHeadModel(device="cpu", **kw)
        m.load_state_dict(from_jax_params(flat, None, model=m))
        for mod in m.modules():
            if hasattr(mod, "order"):
                mod.dropout = 0.3    # the operator's recurrence dropout
        return m

    whole = build()
    key = (1, 2, 3)
    ref = whole(x, key)
    ref.square().sum().backward()

    def rank(mesh):
        m = build()
        plan = shard_module_(m, mesh)
        out = m(x)
        out.square().sum().backward()
        g = plan.gather_state({k: p.grad for k, p in m.named_parameters()})
        m.zero_grad()
        out_d = m(x, key)
        out_d.square().sum().backward()
        gd = plan.gather_state({k: p.grad for k, p in m.named_parameters()})
        return out.detach(), g, out_d.detach(), gd

    res = run_ranks(rank)
    np.testing.assert_allclose(res[0][0].numpy(), jlogits, **OUT)
    got = to_jax_params(res[0][1])
    for k, want in jgrads.items():
        _close_scaled(got[k], want, G_TOL, k)
    s = ref.abs().max().item()
    assert (res[0][2] - ref.detach()).abs().max().item() <= 1e-5 * s
    for k, p in whole.named_parameters():
        _close_scaled(res[0][3][k].numpy(), p.grad.numpy(), 1e-4,
                      f"dropout {k}")


# -- the step, the Trainer and its checkpoints -----------------------------------

OPT = dict(lr=8e-3, warmup_t=0, t_initial=100, weight_decay=0.1)


def _batch(L=64):
    rng = np.random.default_rng(3)
    batch = {"input_ids": rng.integers(7, 11, (4, L)).astype(np.int64),
             "targets": rng.integers(0, 12, (4, L)).astype(np.int64)}
    batch["targets"][:, ::5] = 4   # ignored positions
    return batch


@functools.lru_cache(maxsize=None)
def _jax_step():
    """One JAX `make_train_step` (accum 1) of the unsharded v2 model on
    one device: (metrics, flat params after)."""
    cfg, _, flat, _, _ = _jax_model(2, 1, L=128)
    batch = _batch()
    tx, _ = jax_optim.make_optimizer(**OPT)
    params = {"params": tu.unflatten_dict(flat, sep="/")}
    state = JaxState(params, tx.init(params), jnp.zeros((), jnp.int32))
    state, m = jax.jit(jax_make_step(JaxLM(cfg).apply, tx))(
        state, {k: jnp.asarray(v.astype(np.int32)) for k, v in batch.items()})
    return ({k: float(v) for k, v in m.items()}, _flat(state.params))


def _trainer(cfg, flat, mesh, run_dir, tp=True, ema=0.9):
    tcfg = _port_cfg(cfg, tensor_parallel_axis="model" if tp else None)
    model = CaduceusForMaskedLM(tcfg, device="cpu")
    model.load_state_dict(from_jax_params(flat, tcfg))
    tr = Trainer(model, TrainerConfig(
        run_dir=run_dir, max_steps=100, warmup_frac=0.0, ema_decay=ema,
        lr=OPT["lr"], weight_decay=OPT["weight_decay"], lr_min=0.0),
        None, mesh=mesh, tensor_parallel=tp)
    tr.init_state()
    return tr


def _one_step(tr, batch, mesh=None):
    from caduceus_tpu_torch.parallel.mesh import shard_batch

    b = batch if mesh is None else shard_batch(mesh, batch)
    tr.state, m = tr._train_step(tr.state, {k: torch.from_numpy(v)
                                            for k, v in b.items()})
    return {k: float(v) for k, v in m.items()}


def test_tp_step_matches_jax_and_resumes_either_way(tmp_path, one_thread):
    """On a (data 2, model 2) grid: one `make_train_step` step with the
    model cut over 'model' against JAX's step on one device (loss rtol
    1e-5, gathered parameters rtol 1e-4 / atol 1e-6; tests/test_ssd.py:383),
    then the `Trainer` step against one rank's `Trainer` step on the same
    batch; the tensor-parallel checkpoint resumed on one rank, and the
    one-rank checkpoint resumed under tensor parallelism, take the same
    next step (loss and grad norm within 1e-6 relative, parameters within
    1e-6 (1 + |p|) where the gradient is settled) and keep the one-rank
    format."""
    cfg, _, flat, _, _ = _jax_model(2, 1, L=128)
    batch = _batch()
    jm, jp = _jax_step()

    def rank(mesh):
        tcfg = _port_cfg(cfg, tensor_parallel_axis="model")
        model = CaduceusForMaskedLM(tcfg, device="cpu")
        model.load_state_dict(from_jax_params(flat, tcfg))
        plan = shard_module_(model, mesh)
        opt, _ = make_optimizer(model.named_parameters(), **OPT)
        from caduceus_tpu_torch.parallel.mesh import shard_batch

        b = shard_batch(mesh, batch)
        _, m = make_train_step(mesh=mesh, tp_plan=plan)(
            TrainState(model, opt), {k: torch.from_numpy(v)
                                     for k, v in b.items()})
        return float(m["loss"]), to_jax_params(
            plan.gather_state(model.state_dict()))

    for loss, params in run_ranks(rank, data=2, model=2):
        np.testing.assert_allclose(loss, jm["loss"], rtol=1e-5)
        for k, v in jp.items():
            np.testing.assert_allclose(params[k], v, rtol=1e-4, atol=1e-6,
                                       err_msg=k)

    # the Trainer: one rank, then the grid; each saves its step 1
    one = _trainer(cfg, flat, None, str(tmp_path / "one"), tp=False)
    m1 = _one_step(one, batch)
    settled = {k: p.grad.abs() > 1e-3 * p.grad.abs().max()
               for k, p in one.model.named_parameters()}
    one.save_checkpoint()
    m1b = _one_step(one, batch)
    p1b = {k: v.detach().clone() for k, v in one.model.state_dict().items()}
    for k, p in one.model.named_parameters():
        settled[k] &= p.grad.abs() > 1e-3 * p.grad.abs().max()

    def params_close(got, what):
        """Within 1e-6 (1 + |p|) where both steps' gradients are settled
        (above 1e-3 of their largest element); elsewhere Adam's update
        turns on the last digits of a gradient near 0, so there within
        2 lr a step."""
        for k, v in p1b.items():
            lim = torch.where(settled[k], 1e-6 * (1 + v.abs()),
                              torch.full_like(v, 4 * OPT["lr"]))
            assert bool(((got[k] - v).abs() <= lim).all()), (what, k)

    def grid(mesh):
        tr = _trainer(cfg, flat, mesh, str(tmp_path / "tp"))
        m = _one_step(tr, batch, mesh)
        tr.save_checkpoint()
        # resume the one-rank checkpoint under tensor parallelism
        tr2 = _trainer(cfg, flat, mesh, str(tmp_path / "one"))
        assert tr2.restore_checkpoint() and tr2.state.step == 1
        m2 = _one_step(tr2, batch, mesh)
        p2 = tr2.tp_plan.gather_state(tr2.model.state_dict())
        return m, m2, p2

    res = run_ranks(grid, data=2, model=2)
    for m, m2, p2 in res:
        for k in ("loss", "grad_norm", "acc"):
            assert abs(m[k] - m1[k]) <= 1e-6 * abs(m1[k]), (k, m[k], m1[k])
            assert abs(m2[k] - m1b[k]) <= 1e-6 * abs(m1b[k]), k
        assert m["count"] == m1["count"]
        params_close(p2, "one-rank checkpoint resumed under TP")
    # the tensor-parallel checkpoint is the one-rank format: it resumes on
    # one rank with the same next step
    back = _trainer(cfg, flat, None, str(tmp_path / "tp"), tp=False)
    assert back.restore_checkpoint() and back.state.step == 1
    mb = _one_step(back, batch)
    for k in ("loss", "grad_norm"):
        assert abs(mb[k] - m1b[k]) <= 1e-6 * abs(m1b[k]), k
    params_close(back.model.state_dict(), "TP checkpoint resumed on one rank")


# -- the CLI and VEP in several processes ---------------------------------------

def _launch(n):
    return [sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc_per_node", str(n), "-m", "caduceus_tpu_torch.cli"]


ENV = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": REPO}


@pytest.fixture(scope="module")
def genome(tmp_path_factory):
    from caduceus_tpu_torch.data.synthetic import make_synthetic_genome

    d = tmp_path_factory.mktemp("tp_genome")
    return make_synthetic_genome(str(d / "g"), chrom_len=1 << 13,
                                 window=1 << 11)


def test_cli_pretrain_tensor_parallel_two_processes(genome, tmp_path):
    """`cli.py pretrain --mesh-model 2 --tensor-parallel --dist-backend gloo
    --device cpu` under `torch.distributed.run` (2 processes) logs the
    losses, grad norms and eval of the same run on one process (1e-5
    relative); its model_config.json keeps tensor_parallel_axis null and
    its checkpoint is the one-rank format, which `cli.py eval` reads on
    one process."""
    from caduceus_tpu_torch.cli import main as cli_main

    fasta, bed = genome
    cfg_path = str(tmp_path / "cfg.json")
    _port_cfg(_jax_cfg(2, 1)).save(cfg_path)
    common = ["pretrain", "--fasta", fasta, "--bed", bed, "--max-length",
              "128", "--batch-size", "2", "--max-steps", "2",
              "--config-path", cfg_path, "--log-every", "1",
              "--eval-every", "2", "--eval-batches", "1",
              "--checkpoint-every", "2", "--device", "cpu", "--prefetch",
              "0"]
    runs = {}
    for name, launch, extra in (
            ("one", [sys.executable, "-m", "caduceus_tpu_torch.cli"], []),
            ("two", _launch(2), ["--mesh-model", "2", "--tensor-parallel",
                                 "--dist-backend", "gloo"])):
        run = str(tmp_path / name)
        p = subprocess.run(launch + common + ["--run-dir", run] + extra,
                           cwd=REPO, env=ENV, capture_output=True, text=True,
                           timeout=300)
        assert p.returncode == 0, p.stdout[-2000:] + p.stderr[-4000:]
        with open(os.path.join(run, "metrics.jsonl")) as f:
            runs[name] = [json.loads(ln) for ln in f]
    run2 = str(tmp_path / "two")
    with open(os.path.join(run2, "model_config.json")) as f:
        meta = json.load(f)
    assert meta["tensor_parallel_axis"] is None
    assert meta["context_parallel_axis"] is None
    assert len(runs["one"]) == len(runs["two"])
    for a, b in zip(runs["one"], runs["two"]):
        assert a.keys() == b.keys()
        for k, v in a.items():
            if (k not in ("tokens_per_sec", "input_wait_s")
                    and isinstance(v, float)):
                assert abs(b[k] - v) <= 1e-5 * max(abs(v), 1e-6), (k, v, b[k])
    import contextlib
    import io

    out = {}
    for name in ("one", "two"):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli_main(["eval", "--fasta", fasta, "--bed", bed, "--run-dir",
                      str(tmp_path / name), "--max-length", "128",
                      "--batch-size", "2", "--max-batches", "1",
                      "--device", "cpu"])
        out[name] = json.loads(buf.getvalue().strip().splitlines()[-1])
    for k, v in out["one"].items():
        assert abs(out["two"][k] - v) <= 1e-5 * max(abs(v), 1e-6), k


def test_vep_two_processes_match_one(tmp_path):
    """`cli.py vep --device cpu` under `torch.distributed.run` (2
    processes: variants[rank::2], a barrier, rank 0 combines) against one
    process: the same variants, each embedding within 1e-6 (fp32)."""
    from caduceus_tpu_torch.data.fasta import FastaFile
    from caduceus_tpu_torch.data.synthetic import make_synthetic_genome

    fa, _ = make_synthetic_genome(str(tmp_path / "g"), n_chromosomes=2,
                                  chrom_len=4096, window=1024, n_frac=0.0)
    fasta = FastaFile(fa)
    rng = np.random.default_rng(0)
    rows = []
    for i, pos in enumerate(int(p) for p in rng.integers(300, 3800, 9)):
        chrom = f"chr{1 + i % 2}"
        ref = fasta.fetch(chrom, pos, pos + 1)
        alt = "ACGT"[("ACGT".index(ref) + 1) % 4]
        rows.append(f"{chrom}\t{pos}\t{ref}\t{alt}\t{i % 2}\t{1000 * i}")
    fasta.close()
    variants = tmp_path / "variants.tsv"
    variants.write_text("# chrom\tpos\tref\talt\tlabel\ttss_distance\n"
                        + "\n".join(rows) + "\n")
    run = tmp_path / "run"
    run.mkdir()
    cfg = _port_cfg(_jax_cfg(2, 1))
    cfg.save(str(run / "model_config.json"))
    model = CaduceusForMaskedLM(cfg, device="cpu",
                                generator=torch.Generator().manual_seed(0))
    np.savez(run / "params.npz", **to_jax_params(model.state_dict()))
    import contextlib
    import io

    from caduceus_tpu_torch.cli import main as cli_main

    got = {}
    for n in (1, 2):
        out = str(tmp_path / f"emb{n}")
        argv = ["vep", "--fasta", fa, "--variants", str(variants),
                "--run-dir", str(run), "--out", out, "--seq-len", "256",
                "--batch-size", "2", "--device", "cpu"]
        if n == 1:
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                cli_main(argv)
            stdout = buf.getvalue()
        else:
            p = subprocess.run(_launch(2) + argv, cwd=REPO, env=ENV,
                               capture_output=True, text=True, timeout=300)
            assert p.returncode == 0, p.stdout[-2000:] + p.stderr[-4000:]
            stdout = p.stdout
        lines = [json.loads(ln) for ln in stdout.strip().splitlines()
                 if ln.startswith("{")]
        assert [ln["embeddings"] for ln in lines
                if "embeddings" in ln] == [out + ".npz"]
        got[n] = dict(np.load(out + ".npz"))
    # rank-major order: rank 0 has variants 0, 2, 4, ..., rank 1 1, 3, ...
    order = list(range(0, 9, 2)) + list(range(1, 9, 2))
    one, two = got[1], got[2]
    assert two["features"].shape == one["features"].shape
    np.testing.assert_array_equal(two["labels"], one["labels"][order])
    np.testing.assert_array_equal(two["tss_distance"],
                                  one["tss_distance"][order])
    np.testing.assert_allclose(two["features"], one["features"][order],
                               atol=1e-6, rtol=0)
