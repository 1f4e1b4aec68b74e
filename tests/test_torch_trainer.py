"""The port's training loop (`caduceus_tpu_torch/train/trainer.py
Trainer`, `train/checkpoint.py`, `cli.py pretrain` / `eval`) against
`caduceus_tpu.train`, on the CPU.

A synthetic genome of 2^12-base windows (the port's
`make_synthetic_genome`), windows of 256 tokens, batches of 4 in 2
micro-batches, the 2-layer, d_model 32 RCPS Mamba-2 model (JAX side
``use_kernel="xla"``). One JAX `Trainer` (module fixture) and the port's
`Trainer` start from the same weights (the JAX init through
`from_jax_params`) with EMA on and take 3 steps each; their logged
metrics and evals agree within 1e-5. The port's resume is exact; a run dir
the JAX package wrote (Orbax) loads with its EMA weights; the CLI writes a
run dir that `eval`, `generate` and the server read.
"""

import contextlib
import dataclasses
import io
import json
import os
import sys
import warnings

import flax.traverse_util as tu
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from caduceus_tpu.config import CaduceusConfig as JaxConfig
from caduceus_tpu.config import SSMConfig as JaxSSM
from caduceus_tpu.data.hg38 import HG38DataModule as JaxDM
from caduceus_tpu.models.caduceus import CaduceusForMaskedLM as JaxLM
from caduceus_tpu.parallel.mesh import make_mesh
from caduceus_tpu.train.checkpoint import save_checkpoint as jax_save
from caduceus_tpu.train.trainer import Trainer as JaxTrainer
from caduceus_tpu.train.trainer import TrainerConfig as JaxTC
from caduceus_tpu.train.trainer import TrainState as JaxState
from caduceus_tpu_torch.cli import main as cli_main
from caduceus_tpu_torch.config import CaduceusConfig
from caduceus_tpu_torch.data.hg38 import HG38DataModule
from caduceus_tpu_torch.data.synthetic import make_synthetic_genome
from caduceus_tpu_torch.models.caduceus import CaduceusForMaskedLM
from caduceus_tpu_torch.params import from_jax_params, load_run_dir
from caduceus_tpu_torch.serve import InferenceService
from caduceus_tpu_torch.tokenization import CaduceusTokenizer
from caduceus_tpu_torch.train import checkpoint
from caduceus_tpu_torch.train.trainer import (
    Trainer,
    TrainerConfig,
    make_eval_step,
    to_device,
)

L, BATCH = 256, 4
TC = dict(max_steps=4, log_every=1, eval_every=3, eval_batches=2,
          checkpoint_every=1000, accum_steps=2, ema_decay=0.9, lr=8e-3,
          warmup_frac=0.25, eval_last_k=64, eval_per_token=True)
METRICS = ("loss", "acc", "grad_norm", "ppl")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: these tensors are tiny, and the other test
    workers load every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_config(version=2):
    tok = CaduceusTokenizer()
    ssm = (JaxSSM(version=2, d_state=16, headdim=16, ngroups=1,
                  ssd_chunk_size=16, use_kernel="xla") if version == 2
           else JaxSSM(version=1, d_state=8, use_kernel="xla"))
    return JaxConfig(
        d_model=32, n_layer=2, vocab_size=tok.vocab_size, rcps=True,
        complement_map=tok.complement_map, residual_in_fp32=False,
        dtype="float32", param_dtype="float32", ssm_cfg=ssm)


def port_model(jcfg, flat):
    cfg = CaduceusConfig.from_dict(dataclasses.asdict(jcfg))
    model = CaduceusForMaskedLM(cfg, device="cpu")
    model.load_state_dict(from_jax_params(flat, cfg))
    return model


def flatten(params):
    return {k: np.asarray(v) for k, v in
            tu.flatten_dict(params["params"], sep="/").items()}


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """The JAX Trainer after 3 steps of fit, its records, and the port's
    Trainer after 3 steps from the same init and the same genome."""
    d = tmp_path_factory.mktemp("trainer")
    fa, bed = make_synthetic_genome(str(d / "genome"), n_chromosomes=2,
                                    chrom_len=1 << 14, window=1 << 12)
    jcfg = jax_config()
    records = {"jax": [], "port": []}
    dm = JaxDM(bed, fa, max_length=L, batch_size=BATCH, seed=3)
    jt = JaxTrainer(JaxLM(jcfg), JaxTC(run_dir=str(d / "jax"), **TC),
                    dm.train_loader(), dm.eval_loader("valid"),
                    mesh=make_mesh(devices=jax.devices()[:1]),
                    log_fn=records["jax"].append)
    # an example batch from another loader: the fit starts at batch 0
    jt.init_state(next(iter(JaxDM(bed, fa, max_length=L, batch_size=BATCH,
                                  seed=3).train_loader())))
    flat0 = flatten(jt.state.params)
    jt.fit(3)
    pdm = HG38DataModule(bed, fa, max_length=L, batch_size=BATCH, seed=3)
    pt = Trainer(port_model(jcfg, flat0),
                 TrainerConfig(run_dir=str(d / "port"), **TC),
                 pdm.train_loader(), pdm.eval_loader("valid"),
                 log_fn=records["port"].append)
    pt.init_state()
    pt.fit(3)
    return dict(dir=d, fa=fa, bed=bed, jcfg=jcfg, jt=jt, pt=pt, flat0=flat0,
                records=records)


def test_fit_matches_jax_trainer(case):
    """Per step: loss, acc, grad_norm and the streaming ppl within 1e-5
    relative (the tolerance of test_train_steps_match_jax), the lr within
    1e-6 (the JAX schedule computes in fp32); the eval at step 3 (val and
    val/ema, with the last-64 ppl) within 1e-5; the per-token ppl curves
    within 1e-5."""
    rec = case["records"]
    steps = {k: [r for r in v if "step" in r] for k, v in rec.items()}
    evals = {k: [r for r in v if "val/loss" in r and "step" not in r]
             for k, v in rec.items()}
    assert [r["step"] for r in steps["port"]] == [1, 2, 3]
    assert [r["step"] for r in steps["jax"]] == [1, 2, 3]
    for want, got in zip(steps["jax"], steps["port"]):
        for k in METRICS:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                       err_msg=f"step {got['step']}: {k}")
        np.testing.assert_allclose(got["lr"], want["lr"], rtol=1e-6)
    assert len(evals["port"]) == len(evals["jax"]) == 1
    want, got = evals["jax"][0], evals["port"][0]
    assert {k for k in got if "file" not in k} == {
        k for k in want if "file" not in k}
    assert "val/ema/last_64_ppl" in got
    for k in got:
        if k.endswith("_file"):
            np.testing.assert_allclose(np.load(got[k]), np.load(want[k]),
                                       rtol=1e-5, err_msg=k)
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)


def test_eval_step_matches_jax(case):
    """`make_eval_step` (last 64 positions, per-token sums) on the weights
    after 3 steps against the JAX Trainer's jitted eval step on the same
    batch: every metric within 1e-5."""
    jt = case["jt"]
    batch = next(iter(HG38DataModule(case["bed"], case["fa"], max_length=L,
                                     batch_size=BATCH).eval_loader("test")))
    want = jax.device_get(jt._eval_step(jt.state.params, jax.device_put(batch)))
    model = port_model(case["jcfg"], flatten(jt.state.params))
    step = make_eval_step(model, last_k=64, per_token=True)
    got = step(None, to_device(batch, torch.device("cpu")))
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-5,
                                   atol=1e-6, err_msg=k)


def _fit(case, tmp, version=2, **over):
    """A port Trainer (its state initialised) and its log: the v2 model
    from the JAX init, the v1 model from the port's seeded init."""
    if version == 2:
        model = port_model(case["jcfg"], case["flat0"])
    else:
        cfg = CaduceusConfig.from_dict(dataclasses.asdict(jax_config(1)))
        model = CaduceusForMaskedLM(
            cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    records = []
    dm = HG38DataModule(case["bed"], case["fa"], max_length=L,
                        batch_size=BATCH, seed=3)
    t = Trainer(model,
                TrainerConfig(run_dir=str(tmp), **{**TC, "eval_every": 2,
                                                   "eval_per_token": False,
                                                   **over}),
                dm.train_loader(), dm.eval_loader("valid"),
                log_fn=records.append)
    t.init_state()
    return t, records


def _state(t):
    return ({k: v.clone() for k, v in t.model.state_dict().items()},
            None if t.state.ema_params is None else
            {k: v.clone() for k, v in t.state.ema_params.items()},
            t.train_loader.state_dict())


@pytest.mark.parametrize("version", [2, 1])
def test_resume_is_exact(case, tmp_path, version):
    """fit(4) in one go against fit(2), save, a fresh Trainer, restore,
    fit(4) (``max_steps=4`` in both, so the schedule is the same): steps 3
    and 4 log the same loss, acc and grad_norm, the evals after step 4 are
    equal, and so are the parameters, the EMA and the loader position, bit
    for bit. Leftover temporary step dirs (a killed writer's, Orbax's, a
    step dir without its meta.json) are not picked."""
    whole, rec_w = _fit(case, tmp_path / "whole", version)
    whole.fit(4)
    first, _ = _fit(case, tmp_path / "cut", version)
    first.fit(2)
    ck = tmp_path / "cut" / "checkpoints"
    assert checkpoint.latest_step(str(ck)) is None
    first.save_checkpoint()
    for junk in (".tmp-4-99999", "6.orbax-checkpoint-tmp-1", "8"):
        os.makedirs(ck / junk)
    (ck / ".tmp-4-99999" / "meta.json").write_text('{"step": 4}')
    second, rec_r = _fit(case, tmp_path / "cut", version)
    assert second.restore_checkpoint()
    assert second.state.step == 2
    second.fit(4)
    steps_w = [r for r in rec_w if r.get("step", 0) > 2]
    steps_r = [r for r in rec_r if "step" in r]
    assert [r["step"] for r in steps_r] == [3, 4]
    for a, b in zip(steps_w, steps_r):
        for k in ("loss", "acc", "grad_norm", "lr"):
            assert a[k] == b[k], (a["step"], k)
    evals_w = [r for r in rec_w if "val/loss" in r and "step" not in r]
    evals_r = [r for r in rec_r if "val/loss" in r and "step" not in r]
    assert evals_w[-1] == evals_r[-1]
    (pw, ew, lw), (pr, er, lr) = _state(whole), _state(second)
    assert lw == lr and second.state.step == whole.state.step == 4
    for k in pw:
        assert torch.equal(pw[k], pr[k]), k
        assert torch.equal(ew[k], er[k]), k
    # the same trainer, fit again: the loader continues where fit stopped
    # (its thread had built batches past the last one consumed)
    assert whole._consumed_loader_state == lw


def test_resume_follows_the_callers_ema(case, tmp_path):
    """A run saved with EMA, resumed with EMA off, drops it; a run saved
    without EMA, resumed with EMA on, starts it from the restored weights;
    optimizer count and step come back in both."""
    with_ema, _ = _fit(case, tmp_path / "a")
    with_ema.fit(2)
    with_ema.save_checkpoint()
    off, _ = _fit(case, tmp_path / "a", ema_decay=0.0)
    assert off.restore_checkpoint()
    assert off.state.ema_params is None and off.state.optimizer.count == 2
    assert not any("val/ema/loss" in k for k in off.evaluate())
    for k, v in with_ema.model.state_dict().items():
        assert torch.equal(off.model.state_dict()[k], v)

    no_ema, _ = _fit(case, tmp_path / "b", ema_decay=0.0)
    no_ema.fit(2)
    no_ema.save_checkpoint()
    assert not os.path.exists(tmp_path / "b" / "checkpoints" / "2" /
                              "ema_params.npz")
    on, _ = _fit(case, tmp_path / "b")
    assert on.restore_checkpoint() and on.state.step == 2
    for k, p in on.model.named_parameters():
        assert torch.equal(on.state.ema_params[k], p.detach()), k
    assert "val/ema/loss" in on.evaluate()


def _write_jax_run(run_dir, jcfg, states):
    os.makedirs(run_dir)
    meta = dataclasses.asdict(jcfg)
    meta["objective"] = "mlm"
    with open(os.path.join(run_dir, "model_config.json"), "w") as f:
        json.dump(meta, f)
    for st in states:
        jax_save(os.path.join(run_dir, "checkpoints"), st, None)


def test_jax_run_dir_loads(case, tmp_path, monkeypatch):
    """Orbax checkpoints that `caduceus_tpu.train.checkpoint` writes, read
    with tensorstore: the latest step, its EMA weights when it has them
    (else its params); logits within 1e-5 of the JAX model's; the port's
    ``eval`` on the run dir gives the JAX Trainer's evaluate of those
    weights within 1e-5. Without tensorstore the error names it and the
    params.npz way round; a run dir with no parameters raises."""
    jt, jcfg = case["jt"], case["jcfg"]
    p, opt = jt.state.params, jt.state.opt_state
    shift = lambda tree, c: jax.tree_util.tree_map(lambda x: x + c, tree)
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    _write_jax_run(a, jcfg, [
        JaxState(shift(p, 0.5), opt, jnp.asarray(1, jnp.int32), shift(p, 1.0)),
        JaxState(p, opt, jnp.asarray(2, jnp.int32), jt.state.ema_params)])
    _write_jax_run(b, jcfg, [JaxState(p, opt, jnp.asarray(3, jnp.int32),
                                      None)])
    for run, want in ((a, jt.state.ema_params), (b, p)):
        cfg, sd = load_run_dir(run)
        ref = from_jax_params(flatten(want), cfg)
        assert sd.keys() == ref.keys()
        for k in sd:
            assert torch.equal(sd[k], ref[k]), (run, k)
    cfg, sd = load_run_dir(a)
    model = CaduceusForMaskedLM(cfg, device="cpu")
    model.load_state_dict(sd)
    ids = np.random.default_rng(0).integers(7, 11, (2, 64)).astype(np.int32)
    with torch.inference_mode():
        got = model(torch.from_numpy(ids)).numpy()
    want = np.asarray(jax.jit(JaxLM(jcfg).apply)(jt.state.ema_params, ids))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli_main(["eval", "--fasta", case["fa"], "--bed", case["bed"],
                  "--run-dir", a, "--split", "test", "--max-length", str(L),
                  "--batch-size", str(BATCH), "--max-batches", "2",
                  "--device", "cpu"])
    got = json.loads(out.getvalue().strip().splitlines()[-1])
    saved = (jt.state, jt.eval_loader)
    jt.state = JaxState(jt.state.ema_params, opt, jt.state.step, None)
    jt.eval_loader = JaxDM(case["bed"], case["fa"], max_length=L,
                           batch_size=BATCH).eval_loader("test")
    try:
        want = jt.evaluate(max_batches=2, prefix="test")
    finally:
        jt.state, jt.eval_loader = saved
    assert got.keys() == {k for k in want if "file" not in k
                          and "last_64" not in k}
    for k in got:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)

    monkeypatch.setitem(sys.modules, "tensorstore", None)
    with pytest.raises(ImportError, match="tensorstore.*params.npz"):
        load_run_dir(b)
    empty = tmp_path / "empty"
    empty.mkdir()
    jcfg.save(str(empty / "model_config.json"))
    with pytest.raises(FileNotFoundError, match="params.npz"):
        load_run_dir(str(empty))


def test_cli_pretrain_eval_serve_on_cpu(case, tmp_path):
    """``cli pretrain --device cpu`` (native loader, EMA) writes
    model_config.json, metrics.jsonl and two checkpoints; ``--resume``
    continues from the last; ``eval`` scores it and the server loads its
    EMA weights from the checkpoint alone. ``--model mamba --ntp`` trains
    a causal model that ``generate`` reads back. What is not ported, and a
    missing card, are refused."""
    run = str(tmp_path / "run")
    common = ["--fasta", case["fa"], "--bed", case["bed"], "--device", "cpu",
              "--max-length", str(L), "--batch-size", str(BATCH),
              "--d-model", "32", "--n-layer", "2", "--dtype", "float32",
              "--log-every", "1", "--eval-every", "2", "--eval-batches", "1",
              "--checkpoint-every", "1", "--run-dir", run]
    with contextlib.redirect_stdout(io.StringIO()):
        cli_main(["pretrain", *common, "--max-steps", "2", "--ema-decay",
                  "0.5", "--use-native-loader", "--accum-steps", "2"])
        cli_main(["pretrain", *common, "--max-steps", "3", "--ema-decay",
                  "0.5", "--resume", "--accum-steps", "2"])
    with open(os.path.join(run, "model_config.json")) as f:
        meta = json.load(f)
    assert meta["objective"] == "mlm" and meta["n_layer"] == 2
    with open(os.path.join(run, "metrics.jsonl")) as f:
        logged = [json.loads(line) for line in f]
    assert [r["step"] for r in logged if "loss" in r] == [1, 2, 3]
    ck = os.path.join(run, "checkpoints")
    assert sorted(os.listdir(ck)) == ["2", "3", "loader_state_2.json",
                                      "loader_state_3.json"]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli_main(["eval", "--fasta", case["fa"], "--bed", case["bed"],
                  "--run-dir", run, "--max-length", str(L), "--batch-size",
                  str(BATCH), "--max-batches", "1", "--device", "cpu"])
    got = json.loads(out.getvalue().strip().splitlines()[-1])
    assert np.isfinite(got["test/loss"]) and got["test/ppl"] > 1
    svc = InferenceService.from_run_dir(run, device="cpu", max_batch=2,
                                        min_bucket=16, max_length=64)
    ema = checkpoint.read_latest_params(run)[0]
    ref = from_jax_params(ema, svc.cfg)
    for k, v in svc.model.state_dict().items():
        assert torch.equal(v, ref[k]), k

    causal = str(tmp_path / "causal")
    with contextlib.redirect_stdout(io.StringIO()):
        cli_main(["pretrain", *common[:-1], causal, "--model", "mamba",
                  "--ntp", "--max-steps", "1"])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli_main(["generate", "--run-dir", causal, "--prompt", "ACGTAC",
                  "--max-new-tokens", "4", "--device", "cpu"])
    assert len(json.loads(out.getvalue())["generated"]) == 4
    cfg, _ = load_run_dir(causal)
    assert not cfg.rcps and not cfg.bidirectional

    for bad in (["--model", "hyena", "--ntp"], ["--mesh-model", "2"],
                ["--context-parallel"]):
        with pytest.raises(SystemExit), contextlib.redirect_stderr(
                io.StringIO()):
            cli_main(["pretrain", *common, *bad])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli_main(["pretrain", *[a if a != "cpu" else "cuda"
                                    for a in common]])


def test_evaluate_warns_once_without_a_resettable_sampler(case):
    batches = list(HG38DataModule(case["bed"], case["fa"], max_length=L,
                                  batch_size=BATCH).eval_loader("valid"))
    t = Trainer(case["pt"].model, TrainerConfig(eval_batches=1), None,
                batches, log_fn=lambda m: None)
    with pytest.warns(UserWarning, match="no resettable sampler"):
        a = t.evaluate()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        b = t.evaluate()
    assert a == b   # a list is iterated from its start each time


class _Windows:
    """A dataset of 7 fixed 32-token windows (3 batches of 2 per epoch,
    the last window dropped), the same for every epoch."""

    def __init__(self):
        rng = np.random.default_rng(4)
        self.x = rng.integers(7, 11, (7, 32)).astype(np.int32)
        self.y = rng.integers(0, 12, (7, 32)).astype(np.int32)

    def __len__(self):
        return 7

    def get(self, idx, epoch=0):
        return self.x[idx], self.y[idx]


def test_fit_continues_the_stream_across_calls_and_epochs():
    """fit(2); fit(5); fit(7) on one Trainer equals fit(7) in one go over
    3 epochs of 3 batches: the loop rewinds the loader past the batches
    its prefetch thread built and did not consume, and rolls epochs."""
    from caduceus_tpu_torch.data.hg38 import DataLoaderIterator
    from caduceus_tpu_torch.data.sampler import ShardedShuffleSampler

    tok = CaduceusTokenizer()
    cfg = CaduceusConfig.from_dict(dict(
        d_model=16, n_layer=1, vocab_size=tok.vocab_size, rcps=True,
        complement_map=tok.complement_map, dtype="float32",
        ssm_cfg=dict(version=1, d_state=4)))
    runs = []
    for stops in ((7,), (2, 5, 7)):
        loader = DataLoaderIterator(
            _Windows(), ShardedShuffleSampler(7, seed=1, drop_last=True), 2)
        model = CaduceusForMaskedLM(cfg, device="cpu",
                                    generator=torch.Generator().manual_seed(1))
        records = []
        t = Trainer(model, TrainerConfig(max_steps=7, log_every=1,
                                         checkpoint_every=100, prefetch=2),
                    loader, log_fn=records.append)
        t.init_state()
        for s in stops:
            t.fit(s)
        runs.append(([r["loss"] for r in records], loader.state_dict(),
                     model.state_dict()))
    (loss_a, st_a, p_a), (loss_b, st_b, p_b) = runs
    assert len(loss_a) == 7 and loss_a == loss_b
    assert st_a == st_b == {"sampler": {"epoch": 2, "counter": 2}}
    for k in p_a:
        assert torch.equal(p_a[k], p_b[k]), k


@pytest.mark.parametrize("name", ["cosine_warmup_timm", "constant",
                                  "constant_warmup", "linear_warmup",
                                  "inv_sqrt"])
def test_schedule_name_matches_jax(name):
    """`make_optimizer(schedule_name=...)` picks the JAX package's schedule
    for every name it takes (fp32 on the JAX side: 1e-6 relative)."""
    from caduceus_tpu.train.optim import make_optimizer as jax_make
    from caduceus_tpu_torch.train.optim import make_optimizer

    kw = dict(lr=8e-3, warmup_t=10, t_initial=100, lr_min=1e-4)
    _, want = jax_make(schedule_name=name, **kw)
    w = torch.nn.Parameter(torch.zeros(2, 2))
    _, got = make_optimizer([("w", w)], schedule_name=name, **kw)
    for step in (0, 1, 9, 10, 11, 50, 110, 500):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6,
                                   atol=1e-9, err_msg=f"{name} {step}")
    with pytest.raises(KeyError):
        make_optimizer([("w", w)], schedule_name="multistep")


def test_metrics_and_logging_match_jax(case, tmp_path):
    """`last_k_ppl`, `per_token_ppl`, `Perplexity` and `NumTokens` against
    the JAX package's; `param_count` against its count of the same
    parameters; `make_logger` writes metrics.jsonl on rank 0 only."""
    from caduceus_tpu.train import metrics as jm
    from caduceus_tpu.utils.logging import param_count as jax_count
    from caduceus_tpu_torch.train import metrics
    from caduceus_tpu_torch.utils.logging import make_logger, param_count

    rng = np.random.default_rng(1)
    logits = rng.standard_normal((2, 40, 16)).astype(np.float32)
    tgt = rng.integers(0, 12, (2, 40)).astype(np.int32)
    ppl, aux = metrics.last_k_ppl(torch.from_numpy(logits),
                                  torch.from_numpy(tgt), k=8)
    ppl_j, aux_j = jm.last_k_ppl(logits, tgt, k=8)
    np.testing.assert_allclose(float(ppl), float(ppl_j), rtol=1e-6)
    assert int(aux["count"]) == int(aux_j["count"])
    nll, mask = metrics.per_token_ppl(torch.from_numpy(logits),
                                      torch.from_numpy(tgt))
    nll_j, mask_j = jm.per_token_ppl(logits, tgt)
    np.testing.assert_allclose(nll.numpy(), np.asarray(nll_j), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(mask_j))
    acc = (metrics.Perplexity(), jm.Perplexity(), metrics.NumTokens(),
           jm.NumTokens())
    for ls, c in ((3.5, 2), (10.0, 7)):
        for a in acc[:2]:
            a.update(ls, c)
        for a in acc[2:]:
            a.update(c)
    assert acc[0].compute() == acc[1].compute()
    assert acc[2].compute() == acc[3].compute() == 9

    assert param_count(case["pt"].model) == jax_count(case["jt"].state.params)
    with contextlib.redirect_stdout(io.StringIO()) as out:
        make_logger(str(tmp_path / "r0"))({"step": 1})
        make_logger(str(tmp_path / "r1"), rank=1)({"step": 1})
    assert out.getvalue() == '{"step": 1}\n'
    assert (tmp_path / "r0" / "metrics.jsonl").read_text() == '{"step": 1}\n'
    assert not (tmp_path / "r1").exists()


def test_trainer_refuses_what_is_not_ported(case):
    model = case["pt"].model
    with pytest.raises(NotImplementedError, match="item 7"):
        Trainer(model, TrainerConfig(dropout=True), None)
    for kw in (dict(mesh=object()), dict(tensor_parallel=True),
               dict(context_parallel=True)):
        with pytest.raises(NotImplementedError, match="item 8"):
            Trainer(model, TrainerConfig(), None, **kw)
    with pytest.raises(RuntimeError, match="init_state"):
        Trainer(model, TrainerConfig(), None).fit(1)
