"""The port's Hyena family (`caduceus_tpu_torch/models/hyena.py`,
`ops/attention.py`, `ops/fft_conv.py`, the filter lr groups of
`train/optim.py`, dropout in `train/trainer.py`, `cli.py pretrain --model
hyena` / `eval`) against `caduceus_tpu`, on the CPU.

Inputs come from seeded numpy generators and reach both sides as arrays;
weights reach the port through the bridge (`params.py from_jax_params`).
The JAX attention runs its exact route, ``use_kernel="xla"``
(`jax.nn.dot_product_attention`): its Pallas flash kernel has no interpret
mode. The models are fp32, d_model 32, 2 layers, the MHA at layer 1 with 2
heads, L = 64. Dropout bits cannot match JAX's: the comparisons run with
dropout off, and dropout itself is held to its keep rate and to the same
mask on a recompute and on a resumed run.
"""

import contextlib
import io
import json
import os

import flax.linen as fnn
import flax.traverse_util as tu
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from caduceus_tpu.models import hyena as jax_hyena
from caduceus_tpu.ops.attention import mha_attention as jax_mha
from caduceus_tpu.ops.fft_conv import fft_conv as jax_fft_conv
from caduceus_tpu.train.checkpoint import save_checkpoint as jax_save
from caduceus_tpu.train.optim import hyena_lr_overrides as jax_overrides
from caduceus_tpu.train.optim import make_optimizer as jax_make_optimizer
from caduceus_tpu.train.trainer import TrainState as JaxState
from caduceus_tpu_torch.cli import main as cli_main
from caduceus_tpu_torch.data.synthetic import make_synthetic_genome
from caduceus_tpu_torch.models import hyena
from caduceus_tpu_torch.ops import attention
from caduceus_tpu_torch.ops.fft_conv import fft_conv
from caduceus_tpu_torch.params import (
    from_jax_params,
    load_hyena_run_dir,
    load_run_dir,
    to_jax_params,
)
from caduceus_tpu_torch.train import trainer as port_trainer
from caduceus_tpu_torch.train.optim import hyena_lr_overrides, make_optimizer

L = 64
KW = dict(d_model=32, n_layer=2, vocab_size=12, l_max=L,
          attn_layer_idx=(1,), num_heads=2)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: these tensors are tiny, and the other test
    workers load every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def flatten(tree):
    return {k: np.asarray(v) for k, v in tu.flatten_dict(tree, sep="/").items()}


def close_to_max(got, want, tol, label=""):
    """Each array within ``tol`` of its largest element."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, label
    err = np.abs(got - want).max() / (np.abs(want).max() + 1e-30)
    assert err <= tol, f"{label}: {err:.2e} > {tol:.0e}"


# --- attention ---------------------------------------------------------

@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("length", [64, 37])
def test_plain_attention_matches_jax(causal, length):
    """The plain version (`_AttentionFn` on CPU tensors: the chunked
    forward and its adjoint from the saved logsumexp, chunks of 5 and 7
    rows) against ``mha_attention(use_kernel="xla")``: forward and VJP
    within 1e-5, at an aligned and a ragged length."""
    rng = np.random.default_rng(length + causal)
    q, k, v, g = (rng.standard_normal((2, length, 3, 16)).astype(np.float32)
                  for _ in range(4))
    f = jax.jit(lambda q, k, v, g: jax.vjp(
        lambda *a: jax_mha(*a, causal=causal, use_kernel="xla"),
        q, k, v)[1](g))
    want_o = jax_mha(q, k, v, causal=causal, use_kernel="xla")
    want = f(q, k, v, g)
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    o = attention.mha_attention(tq, tk, tv, causal=causal)
    o.backward(torch.tensor(g))
    np.testing.assert_allclose(o.detach().numpy(), want_o, atol=1e-5,
                               rtol=1e-5)
    for got, w in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(got.numpy(), w, atol=1e-5, rtol=1e-5)
    scale = 16 ** -0.5
    args = [torch.tensor(a) for a in (q, k, v)]
    o5, lse = attention.attention_fwd_plain(*args, causal, scale, chunk=5)
    np.testing.assert_allclose(o5.numpy(), want_o, atol=1e-5, rtol=1e-5)
    grads = attention.attention_bwd_plain(*args, o5, lse, torch.tensor(g),
                                          causal, scale, chunk=7)
    for got, w in zip(grads, want):
        np.testing.assert_allclose(got.numpy(), w, atol=1e-5, rtol=1e-5)


def test_attention_routes():
    """The JAX shape rule of "pallas" (raise unless L % 128 == 0); the
    kernel wrappers refuse a CPU tensor for the CUDA-only entries; every
    route runs the plain version on the CPU."""
    assert attention.resolve_attention_kernel("auto", 256) == "pallas"
    assert attention.resolve_attention_kernel("auto", 251) == "xla"
    with pytest.raises(ValueError, match="% 128"):
        attention.resolve_attention_kernel("pallas", 251)
    with pytest.raises(ValueError):
        attention.resolve_attention_kernel("flash", 256)
    x = torch.randn(1, 8, 1, 16)
    with pytest.raises(ValueError, match="CUDA tensor"):
        attention.attention_bwd_dkv(x, x, x, x, torch.zeros(1, 1, 8), x,
                                    True, 0.25)
    outs = [attention.mha_attention(x, x, x, use_kernel=r)
            for r in ("auto", "xla")]
    assert torch.equal(outs[0], outs[1])


# --- FFT conv, filter, operator, blocks ---------------------------------

def test_fft_conv_matches_jax():
    rng = np.random.default_rng(0)
    u = rng.standard_normal((2, 50, 6)).astype(np.float32)
    k = rng.standard_normal((50, 6)).astype(np.float32)
    D = rng.standard_normal(6).astype(np.float32)
    for kw in ({}, {"D": D}, {"D": D, "gelu": True}):
        want = jax.jit(lambda u, k, **a: jax_fft_conv(u, k, **a),
                       static_argnames=("gelu",))(u, k, **kw)
        got = fft_conv(torch.tensor(u), torch.tensor(k),
                       **{a: (torch.tensor(b) if a == "D" else b)
                          for a, b in kw.items()})
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def _module_vjp(jmod, tmod, x, cot):
    """(JAX out, port out, JAX grads, port grads by flax path, JAX input
    grad, port input grad) of a module on input ``x`` and cotangent
    ``cot``, the port module loaded with the JAX init."""
    params = jax.jit(jmod.init)(jax.random.PRNGKey(3), x)
    tmod.load_state_dict(from_jax_params(flatten(params["params"]), None,
                                         model=tmod))
    f = jax.jit(lambda p, x: jax.vjp(lambda p, x: jmod.apply(p, x), p, x))
    out, vjp = f(params, x)
    gp, gx = vjp(cot)
    tx = torch.tensor(x, requires_grad=True)
    tout = tmod(tx)
    tout.backward(torch.tensor(cot))
    tg = to_jax_params({n: p.grad for n, p in tmod.named_parameters()})
    return out, tout, flatten(gp["params"]), tg, gx, tx.grad


def test_filter_and_operator_match_jax():
    """`HyenaFilter` (taps and bias at L = 50 of l_max 64: only the first
    rows are computed) and `HyenaOperator` (in_proj, short conv, the "l (v
    o)" split, FFT conv, out_proj) forward within 1e-5 and their parameter
    and input gradients within 1e-4 of each one's largest element."""
    class JFilter(fnn.Module):
        @fnn.compact
        def __call__(self, x):
            k, b = jax_hyena.HyenaFilter(d_output=32, seq_len=L,
                                         name="f")(50)
            return k * x + b

    class TFilter(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.f = hyena.HyenaFilter(32, L)

        def forward(self, x):
            k, b = self.f(50)
            return k * x + b

    rng = np.random.default_rng(1)
    x = rng.standard_normal((50, 32)).astype(np.float32)
    out, tout, gp, tg, _, _ = _module_vjp(JFilter(), TFilter(), x, x)
    np.testing.assert_allclose(tout.detach().numpy(), out, atol=1e-5,
                               rtol=1e-5)
    assert tg.keys() == gp.keys()
    for k in gp:
        close_to_max(tg[k], gp[k], 1e-4, k)

    u = rng.standard_normal((2, L, 32)).astype(np.float32)
    cot = rng.standard_normal((2, L, 32)).astype(np.float32)
    out, tout, gp, tg, gx, tgx = _module_vjp(
        jax_hyena.HyenaOperator(32, L), hyena.HyenaOperator(32, L), u, cot)
    np.testing.assert_allclose(tout.detach().numpy(), out, atol=1e-5,
                               rtol=1e-5)
    close_to_max(tgx.numpy(), gx, 1e-4, "u")
    assert tg.keys() == gp.keys()
    for k in gp:
        close_to_max(tg[k], gp[k], 1e-4, k)


def test_bf16_layernorm_mlp_and_mha_match_flax():
    """bf16 compute over fp32 parameters: flax ``LayerNorm(dtype=bf16)``
    (fp32 statistics) and the tanh-GELU `Mlp` and the `MHA` block against
    the port's, within the bf16 rounding of their outputs (a few steps of
    2^-8 of the largest element)."""
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((2, L, 32)) * 3 + 1).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    for jmod, tmod in (
            (fnn.LayerNorm(dtype=jnp.bfloat16), hyena.LayerNorm(32)),
            (jax_hyena.Mlp(32, dtype="bfloat16"),
             hyena.Mlp(32, dtype="bfloat16")),
            (jax_hyena.MHA(32, 2, use_kernel="xla", dtype="bfloat16"),
             hyena.MHA(32, 2, dtype="bfloat16"))):
        params = jax.jit(jmod.init)(jax.random.PRNGKey(4), xb)
        if isinstance(tmod, hyena.LayerNorm):
            params = jax.tree_util.tree_map(
                lambda a: a + jnp.asarray(rng.standard_normal(a.shape),
                                          a.dtype) * 0.1, params)
        tmod.load_state_dict(from_jax_params(flatten(params["params"]),
                                             None, model=tmod))
        want = np.asarray(jax.jit(jmod.apply)(params, xb), np.float32)
        with torch.inference_mode():
            got = tmod(torch.tensor(x).to(torch.bfloat16))
        assert got.dtype == torch.bfloat16
        close_to_max(got.float().numpy(), want, 2 ** -6, type(tmod).__name__)


@pytest.fixture(scope="module")
def lm():
    """The JAX model, its init, a batch, a cotangent of the logits, and
    one jitted call for the logits and the parameter gradients."""
    jm = jax_hyena.HyenaLMHeadModel(**KW)
    rng = np.random.default_rng(5)
    ids = rng.integers(0, 12, (2, L)).astype(np.int32)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), ids)
    cot = rng.standard_normal((2, L, 12)).astype(np.float32)

    @jax.jit
    def f(p):
        out, vjp = jax.vjp(lambda p: jm.apply(p, ids), p)
        return out, vjp(cot)[0]

    logits, grads = f(params)
    return dict(jm=jm, ids=ids, params=params, flat=flatten(params["params"]),
                cot=cot, logits=np.asarray(logits),
                grads=flatten(grads["params"]))


def port_lm(flat, **kw):
    model = hyena.HyenaLMHeadModel(device="cpu", **{**KW, **kw})
    model.load_state_dict(from_jax_params(flat, None, model=model))
    return model


@pytest.mark.parametrize("ckpt", [False, True])
def test_lm_head_model_matches_jax(lm, ckpt):
    """`HyenaLMHeadModel` (2 layers, MHA at layer 1) against the JAX model:
    fp32 logits and every parameter gradient within 1e-4 of its largest
    element, without and with ``checkpoint_mixer`` / ``checkpoint_mlp``
    (recompute in the backward: the same numbers)."""
    model = port_lm(lm["flat"], checkpoint_mixer=ckpt, checkpoint_mlp=ckpt)
    logits = model(torch.from_numpy(lm["ids"].astype(np.int64)))
    assert logits.dtype == torch.float32
    close_to_max(logits.detach().numpy(), lm["logits"], 1e-4, "logits")
    logits.backward(torch.tensor(lm["cot"]))
    got = to_jax_params({n: p.grad for n, p in model.named_parameters()})
    assert got.keys() == lm["grads"].keys()
    for k, want in lm["grads"].items():
        close_to_max(got[k], want, 1e-4, k)


def test_dropout_rate_repeatability_and_recompute(lm):
    """Dropout keeps 1 - p of the elements, scaled by 1 / (1 - p); the same
    key draws the same mask, another key another; a model with every
    dropout on gives the same logits and gradients with and without the
    checkpoint flags (the recompute draws the masks again from the same
    keys), and other logits than with dropout off."""
    x = torch.ones(1000, 1000)
    y = hyena.dropout(x, 0.3, (7, 1, 0))
    kept = (y != 0).float().mean().item()
    assert abs(kept - 0.7) < 3e-3
    assert torch.allclose(y[y != 0], torch.full_like(y[y != 0], 1 / 0.7))
    assert torch.equal(y, hyena.dropout(x, 0.3, (7, 1, 0)))
    assert not torch.equal(y, hyena.dropout(x, 0.3, (7, 1, 1)))
    assert hyena.dropout(x, 0.3, None) is x
    drops = dict(embed_dropout=0.1, resid_dropout=0.2,
                 hyena_kwargs={"dropout": 0.2})
    ids = torch.from_numpy(lm["ids"].astype(np.int64))
    outs = []
    for ckpt in (False, True):
        model = port_lm(lm["flat"], checkpoint_mixer=ckpt,
                        checkpoint_mlp=ckpt, **drops)
        model.backbone.mixer_1.dropout = 0.2
        logits = model(ids, dropout_key=(1, 2, 0, 0))
        logits.backward(torch.tensor(lm["cot"]))
        outs.append((logits.detach(), {n: p.grad for n, p in
                                       model.named_parameters()}))
    assert torch.equal(outs[0][0], outs[1][0])
    for n, g in outs[0][1].items():
        assert torch.equal(g, outs[1][1][n]), n
    with torch.no_grad():
        assert not torch.allclose(outs[0][0], model(ids), atol=1e-3)


def test_optimizer_step_with_filter_groups_matches_optax(lm):
    """One step of `make_optimizer(lr_overrides=hyena_lr_overrides(lr))`
    against the JAX chain on the same gradients (clipped: their norm is
    above 1): every parameter within 1e-6 of optax's; the frozen leaves
    (pos_emb_z, deltas) unchanged; the filter MLP at the base lr without
    weight decay (a filter weight moves less than with decay)."""
    lr, wd = 6e-4, 0.1
    params = lm["params"]
    rng = np.random.default_rng(6)
    grads = jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.standard_normal(a.shape), a.dtype), params)
    tx, _ = jax_make_optimizer(lr=lr, weight_decay=wd, warmup_t=0,
                               t_initial=10, params_example=params,
                               lr_overrides=jax_overrides(lr))
    want = flatten(jax.jit(lambda g, p: optax.apply_updates(
        p, tx.update(g, tx.init(p), p)[0]))(grads, params)["params"])

    model = port_lm(lm["flat"])
    opt, _ = make_optimizer(model.named_parameters(), lr=lr,
                            weight_decay=wd, warmup_t=0, t_initial=10,
                            lr_overrides=hyena_lr_overrides(lr))
    gflat = flatten(grads["params"])
    gsd = from_jax_params(gflat, None, model=model)
    for n, p in model.named_parameters():
        p.grad = gsd[n].clone()
    opt.step()
    got = to_jax_params(dict(model.named_parameters()))
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-6, rtol=0,
                                   err_msg=k)
        if k.endswith(("pos_emb_z", "deltas")):
            assert np.array_equal(got[k], lm["flat"][k]), k
    groups = {(g["weight_decay"], g["lr_factor"])
              for g in opt.opt.param_groups}
    assert groups == {(wd, 1.0), (0.0, 1.0), (0.0, 0.0)}


# --- the CLI -----------------------------------------------------------

@pytest.fixture(scope="module")
def genome(tmp_path_factory):
    d = tmp_path_factory.mktemp("hyena_genome")
    return make_synthetic_genome(str(d / "genome"), n_chromosomes=2,
                                 chrom_len=1 << 13, window=1 << 10)


class _Killed(Exception):
    pass


def _pretrain(genome, run, *extra):
    fa, bed = genome
    argv = ["pretrain", "--model", "hyena", "--ntp", "--fasta", fa, "--bed",
            bed, "--device", "cpu", "--max-length", str(L), "--batch-size",
            "4", "--accum-steps", "2", "--d-model", "32", "--n-layer", "2",
            "--attn-layer-idx", "1", "--num-heads", "2", "--hyena-checkpoint",
            "--dtype", "float32", "--lr", "6e-4", "--max-steps", "4",
            "--log-every", "1", "--eval-every", "1000", "--checkpoint-every",
            "2", "--run-dir", run, "--prefetch", "0", *extra]
    with contextlib.redirect_stdout(io.StringIO()):
        cli_main(argv)


def _steps(run):
    with open(os.path.join(run, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    # ppl streams over the process's logged steps: a resumed process
    # starts it anew
    return [{k: v for k, v in r.items()
             if k not in ("tokens_per_sec", "input_wait_s", "ppl")}
            for r in recs if "loss" in r]


def test_cli_pretrain_kill_resume_eval(genome, tmp_path, monkeypatch):
    """``pretrain --model hyena --ntp`` (embedding dropout on, MHA at layer
    1, ``--hyena-checkpoint``, accum 2) writes the JAX CLI's Hyena
    model_config.json; a run killed after its step-2 checkpoint and
    resumed logs the uninterrupted run's steps 3 and 4 and ends on its
    parameters, bit for bit; ``eval`` scores it. Context parallelism is
    refused for Hyena."""
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    _pretrain(genome, a)
    with open(os.path.join(a, "model_config.json")) as f:
        meta = json.load(f)
    assert meta == {"model_type": "hyena", "objective": "ntp", "lr": 6e-4,
                    "d_model": 32, "n_layer": 2, "vocab_size": 12,
                    "l_max": L, "attn_layer_idx": [1], "num_heads": 2,
                    "checkpoint_mixer": True, "checkpoint_mlp": True,
                    "dtype": "float32"}
    save = port_trainer.Trainer.save_checkpoint

    def killed_after_step_2(self, *args, **kw):
        out = save(self, *args, **kw)
        if self.state.step == 2:
            raise _Killed
        return out

    with monkeypatch.context() as mp:
        mp.setattr(port_trainer.Trainer, "save_checkpoint",
                   killed_after_step_2)
        with pytest.raises(_Killed):
            _pretrain(genome, b)
    _pretrain(genome, b, "--resume")
    assert _steps(b) == _steps(a) and len(_steps(a)) == 4
    _, pa = load_hyena_run_dir(a)
    _, pb = load_hyena_run_dir(b)
    for k in pa:
        assert torch.equal(pa[k], pb[k]), k
    fa, bed = genome
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli_main(["eval", "--fasta", fa, "--bed", bed, "--run-dir", a,
                  "--max-length", str(L), "--batch-size", "4",
                  "--max-batches", "1", "--device", "cpu"])
    got = json.loads(out.getvalue().strip().splitlines()[-1])
    assert np.isfinite(got["test/loss"]) and got["test/ppl"] > 1
    with pytest.raises(SystemExit), contextlib.redirect_stderr(io.StringIO()):
        _pretrain(genome, str(tmp_path / "c"), "--context-parallel",
                  "--mesh-model", "2")


def test_jax_hyena_run_dir_loads(lm, genome, tmp_path):
    """A Hyena run dir the JAX package writes (its CLI's model_config.json
    and Orbax checkpoints): `load_hyena_run_dir` gives the latest step's weights
    and the port's model on them the JAX model's logits within 1e-5;
    ``eval`` reads it; generation refuses it by name."""
    run = tmp_path / "jax_run"
    run.mkdir()
    with open(run / "model_config.json", "w") as f:
        json.dump({"model_type": "hyena", "objective": "ntp", "lr": 6e-4,
                   **{**KW, "attn_layer_idx": [1]}}, f)
    params = lm["params"]
    shifted = jax.tree_util.tree_map(lambda x: x * 0.5, params)
    opt = optax.adamw(1e-3).init(params)
    for step, p in ((1, shifted), (2, params)):
        jax_save(str(run / "checkpoints"),
                 JaxState(p, opt, jnp.asarray(step, jnp.int32), None), None)
    kw, sd = load_hyena_run_dir(str(run))
    assert kw == {**KW, "attn_layer_idx": (1,)}
    model = hyena.HyenaLMHeadModel(device="cpu", **kw)
    model.load_state_dict(sd)
    with torch.inference_mode():
        got = model(torch.from_numpy(lm["ids"].astype(np.int64))).numpy()
    np.testing.assert_allclose(got, lm["logits"], atol=1e-5, rtol=1e-5)
    fa, bed = genome
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli_main(["eval", "--fasta", fa, "--bed", bed, "--run-dir",
                  str(run), "--max-length", str(L), "--batch-size", "2",
                  "--max-batches", "1", "--device", "cpu"])
    assert np.isfinite(json.loads(out.getvalue().splitlines()[-1])[
        "test/loss"])
    with pytest.raises(NotImplementedError, match="Hyena"):
        cli_main(["generate", "--run-dir", str(run), "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="Hyena"):
        load_run_dir(str(run))
