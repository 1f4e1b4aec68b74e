"""Data and context parallelism of the port (`caduceus_tpu_torch/parallel`,
the CP entry `ops/ssd_batched.py ssd_batched_fused_cp`), on the CPU.

The ranks run as threads of this process, one `ProcessGroupGloo` per rank
and mesh axis over a shared `HashStore` (`parallel/mesh.py
Mesh.from_store`): no process is spawned. Each part is held against the JAX
function it ports on a 2-device mesh of the conftest's 8 CPU devices (the
JAX context-parallel axis there is "data"; the port's is "model"), with the
same numpy inputs, in fp32:

- the CP entry's plain version (one shard, random edge_hist and h_init)
  against `ssd_pallas_batched_fused_cp(interpret=True)`: y and hN within
  1e-4, every gradient (g_edge and g_h0 included) within 2e-5 of its
  largest value (tests/test_ssd_pallas_batched.py's tolerances), the
  explicit plain adjoint `ssd_chunked_fused_bwd` too;
- `sequence_parallel_scan`, `sequence_parallel_ssd` and
  `sequence_parallel_ssd_fused` on 2 ranks against `seq_scan.py`'s: y
  within 2e-4 (tests/test_seq_scan.py), gradients within 5e-4 of their
  largest value (tests/test_ssd.py's CP gradient tolerance);
- the CP model (2 ranks, v2 through the fused CP route and v1) against the
  JAX model with ``context_parallel_axis`` (logits within atol 2e-4 /
  rtol 1e-4, gradients within 5e-4 of their largest value,
  tests/test_ssd.py:344) and against the port's unsplit model (logits
  within 1e-5 of max|logit|, gradients within 1e-4 of their largest);
- a data-parallel step, and a 2 x 2 (data, model) step, against the
  single-rank step on the same batch: loss and grad norm within 1e-6
  relative, updated parameters within 1e-6;
- the exchanges of `parallel/comm.py` and their gradients, exactly;
- the CLI's flag checks (tests/test_train.py:488) and one `cli.py
  pretrain --mesh-model 2 --context-parallel` under `torch.distributed.run`
  (two CPU processes, gloo) against the same run on one process.
"""

import dataclasses
import functools
import os
import subprocess
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from caduceus_tpu.config import CaduceusConfig as JaxConfig
from caduceus_tpu.config import SSMConfig as JaxSSM
from caduceus_tpu.models.caduceus import CaduceusForMaskedLM as JaxLM
from caduceus_tpu.ops.ssd_pallas_batched import ssd_pallas_batched_fused_cp
from caduceus_tpu.parallel import seq_scan as jax_seq
from caduceus_tpu.parallel.mesh import make_mesh as jax_make_mesh
from caduceus_tpu.parallel.mesh import with_mesh as jax_with_mesh
from caduceus_tpu.tokenization import CaduceusTokenizer
from caduceus_tpu_torch.config import CaduceusConfig
from caduceus_tpu_torch.models.caduceus import CaduceusForMaskedLM
from caduceus_tpu_torch.ops.ssd import ssd_chunked_fused, ssd_chunked_fused_bwd
from caduceus_tpu_torch.ops.ssd_batched import ssd_batched_fused_cp
from caduceus_tpu_torch.params import from_jax_params
from caduceus_tpu_torch.parallel import comm
from caduceus_tpu_torch.parallel.mesh import Mesh, with_mesh
from caduceus_tpu_torch.parallel.seq_scan import (
    sequence_parallel_scan,
    sequence_parallel_ssd,
    sequence_parallel_ssd_fused,
)
from caduceus_tpu_torch.train.optim import make_optimizer
from caduceus_tpu_torch.train.trainer import TrainState, make_train_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FWD = dict(rtol=1e-4, atol=1e-4)
SEQ = dict(rtol=2e-4, atol=2e-4)
G_ENTRY, G_SEQ, G_JAX_MODEL = 2e-5, 5e-4, 5e-4


@pytest.fixture
def one_thread():
    """One intra-op thread for these tiny tensors (the ranks are threads
    too)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run_ranks(fn, data=1, model=2, seq=1):
    """``fn(mesh)`` on every rank of a (data, model[, seq]) grid, one
    thread each with the rank's mesh set as the ambient one; the results in
    rank order. An exception in a rank is raised here."""
    store = dist.HashStore()
    n = data * model * seq
    out, err = [None] * n, []

    def rank(r):
        try:
            mesh = Mesh.from_store(store, r, data, model, timeout_s=60,
                                   seq=seq)
            with with_mesh(mesh):
                out[r] = fn(mesh)
        except BaseException as e:  # noqa: BLE001 (raised below)
            err.append(e)

    threads = [threading.Thread(target=rank, args=(r,)) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if err:
        raise err[0]
    return out


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), requires_grad=grad)


def _close_scaled(got, want, atol, what):
    s = float(np.abs(want).max()) + 1e-9
    np.testing.assert_allclose(np.asarray(got) / s, np.asarray(want) / s,
                               atol=atol, err_msg=what)


@functools.lru_cache(maxsize=None)
def _mesh2():
    return jax_make_mesh(jax.devices()[:2])


# -- the exchanges -------------------------------------------------------------

def test_exchanges_and_their_gradients(one_thread):
    """all_gather, halo_shift (both ways) and reverse_shards on 3 ranks:
    values and the gradients that travel back, exactly."""
    def rank(mesh):
        ax = mesh.axis("model")
        r = ax.rank
        x = torch.full((2, 3), float(r + 1), requires_grad=True)
        g = comm.all_gather(x, ax)
        nxt = comm.halo_shift(x, ax, to_next=True)
        prv = comm.halo_shift(x, ax, to_next=False)
        rev = comm.reverse_shards(x, ax)
        w = torch.tensor([1.0, 10.0, 100.0])
        loss = ((g * w[:, None, None]).sum() + 2 * nxt.sum()
                + 3 * prv.sum() + 5 * rev.sum())
        loss.backward()
        return (g.detach(), nxt.detach(), prv.detach(), rev.detach(),
                x.grad.clone())

    res = run_ranks(rank, model=3)
    for r, (g, nxt, prv, rev, grad) in enumerate(res):
        assert torch.equal(g[:, 0, 0], torch.tensor([1.0, 2.0, 3.0]))
        assert float(nxt[0, 0]) == (r if r > 0 else 0.0)
        assert float(prv[0, 0]) == (r + 2 if r < 2 else 0.0)
        assert float(rev[0, 0]) == 3 - r
        # d/dx: the all_gather's weight of this rank summed over the 3
        # ranks, the halos' weights where a neighbour took x, the flip's
        want = (3 * [1.0, 10.0, 100.0][r] + 2 * (r < 2) + 3 * (r > 0) + 5)
        assert torch.equal(grad, torch.full((2, 3), float(want)))


# -- the CP entry of the fused kernels ----------------------------------------

ENTRY = dict(G=2, L=32, H=4, P=8, NG=1, N=16, K=4)


def _entry_inputs(seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s, sc=1.0: (rng.standard_normal(s) * sc).astype(np.float32)
    c = ENTRY
    Wc = c["H"] * c["P"] + 2 * c["NG"] * c["N"]
    return dict(
        xBC=f(c["G"], c["L"], Wc), dt=f(c["G"], c["L"], c["H"], sc=0.5),
        A=-np.exp(f(c["H"], sc=0.5)), conv_w=f(c["K"], Wc, sc=0.5),
        conv_b=f(Wc, sc=0.1), D=f(c["H"]), dt_bias=f(c["H"], sc=0.1),
        h_init=f(c["G"], c["H"], c["N"], c["P"]),
        edge=f(c["G"], 8, Wc),
        g_y=f(c["G"], c["L"], c["H"], c["P"]),
        g_hN=f(c["G"], c["H"], c["N"], c["P"]))


ENTRY_ARGS = ("xBC", "dt", "A", "conv_w", "conv_b", "D", "dt_bias", "h_init",
              "edge")
ENTRY_KW = dict(dims=(4, 8, 1, 16), dt_softplus=True, chunk_size=8,
                seg_chunks=4)


@functools.lru_cache(maxsize=None)
def _jax_entry(reverse):
    """y, hN and the VJP of every input of the JAX CP entry in interpret
    mode (one compiled program per direction)."""
    inp = _entry_inputs()

    def run(args, g_y, g_hN):
        f = lambda *a: ssd_pallas_batched_fused_cp(
            *a, reverse=reverse, interpret=True, **ENTRY_KW)
        (y, hN), vjp = jax.vjp(f, *args)
        return y, hN, vjp((g_y, g_hN))

    out = jax.jit(run)(tuple(jnp.asarray(inp[k]) for k in ENTRY_ARGS),
                       jnp.asarray(inp["g_y"]), jnp.asarray(inp["g_hN"]))
    return jax.tree_util.tree_map(np.asarray, out)


@pytest.mark.parametrize("reverse", [False, True])
def test_cp_entry_matches_jax(reverse, one_thread):
    """`ssd_batched_fused_cp` on a CPU tensor (the plain version with the
    edge rows, differentiated by autograd) and the explicit plain adjoint
    with the edge rows against the JAX CP entry in interpret mode."""
    inp = _entry_inputs()
    args = [_t(inp[k], grad=True) for k in ENTRY_ARGS]
    y, hN = ssd_batched_fused_cp(*args, reverse=reverse,
                                 cp_chunk_size=8, **ENTRY_KW)
    loss = (y * _t(inp["g_y"])).sum() + (hN * _t(inp["g_hN"])).sum()
    grads = torch.autograd.grad(loss, args)
    jy, jhN, jg = _jax_entry(reverse)
    np.testing.assert_allclose(y.detach().numpy(), jy, **FWD)
    np.testing.assert_allclose(hN.detach().numpy(), jhN, **FWD)
    for name, a, b in zip(ENTRY_ARGS, grads, jg):
        _close_scaled(a.numpy(), b, G_ENTRY, f"autograd {name}")
    # the explicit plain adjoint from the carries (the kernels' oracle)
    t = {k: _t(inp[k]) for k in inp}
    _, _, car = ssd_chunked_fused(
        t["xBC"], t["dt"], t["A"], t["conv_w"], t["conv_b"], t["D"],
        t["dt_bias"], dims=ENTRY_KW["dims"], dt_softplus=True,
        reverse=reverse, chunk_size=8, h_init=t["h_init"],
        return_carries=True, edge_hist=t["edge"])
    explicit = ssd_chunked_fused_bwd(
        t["xBC"], t["dt"], t["A"], t["conv_w"], t["conv_b"], t["D"],
        t["dt_bias"], t["g_y"], car, t["g_hN"], ENTRY_KW["dims"], True,
        reverse, 8, edge_hist=t["edge"])
    order = ("xBC", "dt", "A", "conv_w", "conv_b", "D", "dt_bias", "h_init",
             "edge")
    for name, a in zip(order, explicit):
        _close_scaled(a.numpy(), jg[ENTRY_ARGS.index(name)], G_ENTRY,
                      f"explicit {name}")


def test_cp_entry_refuses_a_padded_shard():
    inp = _entry_inputs()
    args = [_t(inp[k])[:, :20] if k in ("xBC", "dt") else _t(inp[k])
            for k in ENTRY_ARGS]
    with pytest.raises(ValueError, match="no tail"):
        ssd_batched_fused_cp(*args, cp_chunk_size=8, **ENTRY_KW)


# -- the sequence-parallel scans ----------------------------------------------

def _seq_inputs(kind, seed=1):
    rng = np.random.default_rng(seed)
    f = lambda *s, sc=1.0: (rng.standard_normal(s) * sc).astype(np.float32)
    G, L = 2, 64
    if kind == "scan":
        d, N = 8, 4
        return {"u": f(G, L, d), "delta": f(G, L, d, sc=0.5),
                "A": -np.exp(f(d, N, sc=0.5)), "B": f(G, L, N),
                "C": f(G, L, N), "D": f(d), "bias": f(d, sc=0.1),
                "g_y": f(G, L, d)}
    H, P, NG, N = 4, 8, 1, 16
    if kind == "ssd":
        return {"x": f(G, L, H, P), "dt": f(G, L, H, sc=0.5),
                "A": -np.exp(f(H, sc=0.5)), "B": f(G, L, NG, N),
                "C": f(G, L, NG, N), "D": f(H), "bias": f(H, sc=0.1),
                "g_y": f(G, L, H, P)}
    Wc = H * P + 2 * NG * N
    return {"xBC": f(G, L, Wc), "dt": f(G, L, H, sc=0.5),
            "A": -np.exp(f(H, sc=0.5)), "conv_w": f(4, Wc, sc=0.5),
            "conv_b": f(Wc, sc=0.1), "D": f(H), "bias": f(H, sc=0.1),
            "g_y": f(G, L, H, P)}


# per kind: the inputs sharded over the sequence (the rest whole)
SHARDED = {"scan": ("u", "delta", "B", "C"), "ssd": ("x", "dt", "B", "C"),
           "fused": ("xBC", "dt")}
DIMS = (4, 8, 1, 16)


def _jax_seq_call(kind, reverse, a):
    mesh = _mesh2()
    if kind == "scan":
        return jax_seq.sequence_parallel_scan(
            a["u"], a["delta"], a["A"], a["B"], a["C"], D=a["D"],
            delta_bias=a["bias"], delta_softplus=True, reverse=reverse,
            mesh=mesh, axis="data", chunk_size=16)
    if kind == "ssd":
        return jax_seq.sequence_parallel_ssd(
            a["x"], a["dt"], a["A"], a["B"], a["C"], D=a["D"],
            dt_bias=a["bias"], dt_softplus=True, reverse=reverse, mesh=mesh,
            axis="data", chunk_size=8, seg_chunks=2, local_impl="xla")
    return jax_seq.sequence_parallel_ssd_fused(
        a["xBC"], a["dt"], a["A"], a["conv_w"], conv_b=a["conv_b"], D=a["D"],
        dt_bias=a["bias"], dims=DIMS, dt_softplus=True, reverse=reverse,
        mesh=mesh, axis="data", chunk_size=8, seg_chunks=2, interpret=True)


@functools.lru_cache(maxsize=None)
def _jax_seq(kind, reverse):
    inp = _seq_inputs(kind)
    names = [k for k in inp if k != "g_y"]

    def run(args, g_y):
        f = lambda *xs: _jax_seq_call(kind, reverse, dict(zip(names, xs)))
        y, vjp = jax.vjp(f, *args)
        return y, vjp(g_y)

    out = jax.jit(run)(tuple(jnp.asarray(inp[k]) for k in names),
                       jnp.asarray(inp["g_y"]))
    return names, jax.tree_util.tree_map(np.asarray, out)


def _port_seq_call(kind, reverse, a, ax):
    if kind == "scan":
        return sequence_parallel_scan(
            a["u"], a["delta"], a["A"], a["B"], a["C"], D=a["D"],
            delta_bias=a["bias"], delta_softplus=True, reverse=reverse,
            axis=ax)
    if kind == "ssd":
        return sequence_parallel_ssd(
            a["x"], a["dt"], a["A"], a["B"], a["C"], D=a["D"],
            dt_bias=a["bias"], dt_softplus=True, reverse=reverse, axis=ax,
            chunk_size=8)
    return sequence_parallel_ssd_fused(
        a["xBC"], a["dt"], a["A"], a["conv_w"], conv_b=a["conv_b"], D=a["D"],
        dt_bias=a["bias"], dims=DIMS, dt_softplus=True, reverse=reverse,
        axis=ax, chunk_size=8, seg_chunks=2, cp_chunk_size=8)


@pytest.mark.parametrize("kind", ["scan", "ssd", "fused"])
@pytest.mark.parametrize("reverse", [False, True])
def test_sequence_parallel_matches_jax(kind, reverse, one_thread):
    """Each sequence-parallel scan on 2 threaded ranks (this rank's shard of
    the sequence, the parameters whole) against the JAX function on a
    2-device mesh: y and the gradient of every input (the ranks' parameter
    gradients summed)."""
    inp = _seq_inputs(kind)
    names, (jy, jg) = _jax_seq(kind, reverse)

    def rank(mesh):
        ax = mesh.axis("model")
        n = inp["g_y"].shape[1] // ax.size
        sl = slice(ax.rank * n, (ax.rank + 1) * n)
        a = {k: _t(inp[k][:, sl] if k in SHARDED[kind] else inp[k],
                   grad=True) for k in names}
        y = _port_seq_call(kind, reverse, a, ax)
        (y * _t(inp["g_y"][:, sl])).sum().backward()
        return y.detach().numpy(), {k: a[k].grad.numpy() for k in names}

    res = run_ranks(rank)
    y = np.concatenate([r[0] for r in res], 1)
    np.testing.assert_allclose(y, jy, **SEQ)
    for k, want in zip(names, jg):
        if k in SHARDED[kind]:
            got = np.concatenate([r[1][k] for r in res], 1)
        else:
            got = sum(r[1][k] for r in res)
        _close_scaled(got, want, G_SEQ, f"{kind} g_{k}")


# -- the context-parallel model -------------------------------------------------

def _model_case(version):
    tok = CaduceusTokenizer()
    ssm = (JaxSSM(version=2, d_state=16, headdim=16, ngroups=1,
                  ssd_chunk_size=16, ssd_seg_chunks=2, use_kernel="xla")
           if version == 2 else JaxSSM(d_state=4, use_kernel="xla"))
    cfg = JaxConfig(
        d_model=16, n_layer=2, vocab_size=tok.vocab_size, rcps=True,
        complement_map=tok.complement_map, dtype="float32",
        param_dtype="float32", ssm_cfg=ssm)
    ids = np.random.default_rng(0).integers(7, 11, (2, 64)).astype(np.int32)
    return cfg, ids


@functools.lru_cache(maxsize=None)
def _jax_cp_model(version):
    """Init, then logits and the gradient of sum(logits^2) of the JAX model
    with context_parallel_axis on the 2-device mesh."""
    from jax.sharding import NamedSharding, PartitionSpec as P
    import flax.traverse_util as tu

    cfg, ids = _model_case(version)
    params = jax.jit(JaxLM(cfg).init)(jax.random.PRNGKey(0), jnp.asarray(ids))
    cp = JaxLM(dataclasses.replace(cfg, context_parallel_axis="data"))
    mesh = _mesh2()
    x = jax.device_put(jnp.asarray(ids), NamedSharding(mesh, P(None, "data")))

    def run(p, i):
        logits, vjp = jax.vjp(lambda q: cp.apply(q, i), p)
        return logits, vjp(2 * logits)[0]

    with jax_with_mesh(mesh):
        logits, grads = jax.jit(run)(params, x)
    flat = lambda t: {k: np.asarray(v) for k, v in
                      tu.flatten_dict(t["params"], sep="/").items()}
    return flat(params), np.asarray(logits), flat(grads)


@pytest.mark.parametrize("version", [2, 1])
def test_cp_model_matches_jax_and_unsplit(version, one_thread):
    """The port's model with context_parallel_axis on 2 threaded ranks
    (remat on: the recomputed forward's exchanges run in the backward)
    against the JAX model with context_parallel_axis and against the
    port's unsplit model, forward and the gradient of sum(logits^2)."""
    cfg, ids = _model_case(version)
    flat, jlogits, jgrads = _jax_cp_model(version)
    pcfg = CaduceusConfig.from_dict(dataclasses.asdict(cfg))
    pcfg.remat = True
    sd = from_jax_params(flat, pcfg)
    whole = CaduceusForMaskedLM(pcfg, device="cpu")
    whole.load_state_dict(sd)
    ref = whole(torch.from_numpy(ids.astype(np.int64)))
    ref.square().sum().backward()
    ccfg = dataclasses.replace(pcfg, context_parallel_axis="model")

    def rank(mesh):
        m = CaduceusForMaskedLM(ccfg, device="cpu")
        m.load_state_dict(sd)
        out = m(torch.from_numpy(ids.astype(np.int64)))
        out.square().sum().backward()
        return out.detach(), {k: p.grad for k, p in m.named_parameters()}

    res = run_ranks(rank)
    logits = torch.cat([r[0] for r in res], 1)
    np.testing.assert_allclose(logits.numpy(), jlogits, atol=2e-4, rtol=1e-4)
    s = ref.abs().max().item()
    assert (logits - ref.detach()).abs().max().item() <= 1e-5 * s
    jg = from_jax_params(jgrads, pcfg)
    for k, p in whole.named_parameters():
        got = sum(r[1][k] for r in res).numpy()
        _close_scaled(got, jg[k].numpy(), G_JAX_MODEL, f"vs JAX {k}")
        _close_scaled(got, p.grad.numpy(), 1e-4, f"vs unsplit {k}")


# -- data parallelism: one step -------------------------------------------------

def _dp_case():
    tok = CaduceusTokenizer()
    cfg = CaduceusConfig(
        d_model=16, n_layer=2, vocab_size=tok.vocab_size, rcps=True,
        complement_map=tok.complement_map, dtype="float32",
        ssm_cfg=dict(version=2, d_state=16, headdim=16, ssd_chunk_size=16,
                     ssd_seg_chunks=2))
    rng = np.random.default_rng(3)
    batch = {"input_ids": rng.integers(7, 11, (4, 64)).astype(np.int64),
             "targets": rng.integers(0, 12, (4, 64)).astype(np.int64)}
    batch["targets"][:, ::5] = 4   # ignored positions
    return cfg, batch


def _step(cfg, batch, mesh=None, cp=False):
    from caduceus_tpu_torch.parallel.mesh import shard_batch

    if cp:
        cfg = dataclasses.replace(cfg, context_parallel_axis="model")
    model = CaduceusForMaskedLM(cfg, device="cpu",
                                generator=torch.Generator().manual_seed(5))
    opt, _ = make_optimizer(model.named_parameters(), lr=8e-3, warmup_t=0,
                            t_initial=100)
    if mesh is not None:
        batch = shard_batch(mesh, batch, cp=cp, accum_steps=2)
    step = make_train_step(accum_steps=2, mesh=mesh)
    _, m = step(TrainState(model, opt),
                {k: torch.from_numpy(v) for k, v in batch.items()})
    return ({k: float(v) for k, v in m.items()},
            {k: p.detach().clone() for k, p in model.named_parameters()})


@pytest.mark.parametrize("grid", [(2, 1), (2, 2)], ids=["dp2", "dp2xcp2"])
def test_parallel_step_matches_one_rank(grid, one_thread):
    """One train step (accum 2) on a (data, model) grid of threaded ranks,
    each with its rows of every micro-batch (and, under CP, its sequence
    columns), against the step on one rank with the whole batch."""
    cfg, batch = _dp_case()
    m1, p1 = _step(cfg, batch)
    data, model = grid
    res = run_ranks(lambda mesh: _step(cfg, batch, mesh, cp=model > 1),
                    data=data, model=model)
    for m, p in res:
        for k in ("loss", "grad_norm", "acc"):
            assert abs(m[k] - m1[k]) <= 1e-6 * abs(m1[k]), (k, m[k], m1[k])
        assert m["count"] == m1["count"]
        for k in p1:
            assert (p[k] - p1[k]).abs().max().item() <= 1e-6, k
    # every rank holds the same parameters, bit for bit
    for m, p in res[1:]:
        assert all(torch.equal(p[k], res[0][1][k]) for k in p)


# -- the CLI ------------------------------------------------------------------

def test_cli_parallel_flag_checks(tmp_path):
    """The JAX CLI's checks (tests/test_train.py:488) fail at argparse
    time."""
    from caduceus_tpu_torch.cli import main as cli_main

    base = ["--fasta", "x", "--bed", "y", "--device", "cpu"]
    for cmd in ("pretrain", "eval"):
        extra = ["--run-dir", str(tmp_path)] if cmd == "eval" else []
        for bad in (["--mesh-model", "2", "--tensor-parallel",
                     "--context-parallel"],
                    ["--tensor-parallel"],
                    ["--mesh-model", "3", "--context-parallel",
                     "--max-length", "64"]):
            with pytest.raises(SystemExit):
                cli_main([cmd, *base, *extra, *bad])


def test_cli_pretrain_context_parallel_two_processes(tmp_path):
    """`cli.py pretrain --mesh-model 2 --context-parallel --dist-backend
    gloo --device cpu` under `torch.distributed.run` (2 processes) logs the
    losses, grad norms and eval of the same run on one process (1e-5
    relative); rank 0 alone writes metrics.jsonl and the checkpoint, whose
    model_config.json keeps context_parallel_axis null."""
    import json

    from caduceus_tpu_torch.data.synthetic import make_synthetic_genome

    fasta, bed = make_synthetic_genome(str(tmp_path / "g"),
                                       chrom_len=1 << 13, window=1 << 11)
    cfg, _ = _dp_case()
    cfg_path = str(tmp_path / "cfg.json")
    cfg.save(cfg_path)
    common = ["--fasta", fasta, "--bed", bed, "--max-length", "128",
              "--batch-size", "2", "--max-steps", "2", "--config-path",
              cfg_path, "--log-every", "1", "--eval-every", "2",
              "--eval-batches", "1", "--checkpoint-every", "2",
              "--device", "cpu", "--prefetch", "0"]
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": REPO}
    runs = {}
    for name, launch in (
            ("one", [sys.executable, "-m", "caduceus_tpu_torch.cli"]),
            ("two", [sys.executable, "-m", "torch.distributed.run",
                     "--standalone", "--nproc_per_node", "2", "-m",
                     "caduceus_tpu_torch.cli"])):
        run = str(tmp_path / name)
        argv = ["pretrain", *common, "--run-dir", run]
        if name == "two":
            argv += ["--mesh-model", "2", "--context-parallel",
                     "--dist-backend", "gloo"]
        p = subprocess.run(launch + argv, cwd=REPO, env=env,
                           capture_output=True, text=True, timeout=300)
        assert p.returncode == 0, p.stdout[-2000:] + p.stderr[-4000:]
        with open(os.path.join(run, "metrics.jsonl")) as f:
            runs[name] = [json.loads(ln) for ln in f]
        if name == "two":
            first = json.loads(p.stdout.strip().splitlines()[0])
            assert first["dist_backend"] == "gloo"
            assert first["mesh"] == {"data": 1, "model": 2}
            with open(os.path.join(run, "model_config.json")) as f:
                assert json.load(f)["context_parallel_axis"] is None
            assert os.path.isdir(os.path.join(run, "checkpoints", "2"))
    assert len(runs["one"]) == len(runs["two"])
    for a, b in zip(runs["one"], runs["two"]):
        assert a.keys() == b.keys()
        for k, v in a.items():
            if k in ("tokens_per_sec",) or not isinstance(v, float):
                continue
            assert abs(b[k] - v) <= 1e-5 * max(abs(v), 1e-6), (k, v, b[k])
