"""The port's server against the JAX server, over HTTP, on the CPU.

Both serve the same params (a JAX init written as ``params.npz`` +
``model_config.json``, read by the port through `params.py`); the same
requests must give the same /embed and /logits (fp32, 1e-5) and, for a
causal model of each family, the same greedy /generate text, which the
port's ``cli.py generate`` prints too. The LM warm-up counts the JAX
service's programs, leaves a request's bits as they are without it, and
``cli.py serve --warmup`` prints its count before the serving line. Also:
the bridge consumes every flax key exactly once, and nothing under
`caduceus_tpu_torch/` (nor `chip_smoke.py`) imports JAX or the JAX
package.
"""

import ast
import contextlib
import io
import json
import os
import urllib.error
import urllib.request

import flax.traverse_util as tu
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from caduceus_tpu.config import CaduceusConfig as JaxConfig
from caduceus_tpu.config import SSMConfig as JaxSSM
from caduceus_tpu.models.caduceus import CaduceusForMaskedLM as JaxLM
from caduceus_tpu.serve import InferenceServer as JaxServer
from caduceus_tpu.serve import InferenceService as JaxService
from caduceus_tpu.tokenization import CaduceusTokenizer
from caduceus_tpu_torch import resolve_device
from caduceus_tpu_torch.cli import main as cli_main
from caduceus_tpu_torch.config import CaduceusConfig
from caduceus_tpu_torch.models.caduceus import CaduceusForMaskedLM
from caduceus_tpu_torch.params import (
    from_jax_params,
    load_npz_params,
    to_jax_params,
)
from caduceus_tpu_torch.serve import InferenceServer, InferenceService

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BANNED = {"jax", "jaxlib", "flax", "orbax", "optax", "caduceus_tpu"}


def _post(port, path, obj):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(obj).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def _get(port, path):
    with urllib.request.urlopen(
            f"http://127.0.0.1:{port}{path}", timeout=30) as r:
        return json.loads(r.read())


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    tok = CaduceusTokenizer()
    cfg = JaxConfig(
        d_model=32, n_layer=2, vocab_size=tok.vocab_size, rcps=True,
        complement_map=tok.complement_map, residual_in_fp32=False,
        dtype="float32", param_dtype="float32",
        ssm_cfg=JaxSSM(version=2, d_state=16, headdim=16, ngroups=1,
                       ssd_chunk_size=16, use_kernel="xla"))
    params = jax.jit(JaxLM(cfg).init)(jax.random.PRNGKey(0),
                                      jnp.full((1, 16), 7, jnp.int32))
    run_dir = tmp_path_factory.mktemp("run")
    cfg.save(str(run_dir / "model_config.json"))
    flat = tu.flatten_dict(params["params"], sep="/")
    np.savez(run_dir / "params.npz", **{k: np.asarray(v)
                                        for k, v in flat.items()})
    kw = dict(max_batch=4, min_bucket=16, max_length=64, linger_ms=30.0)
    jax_server = JaxServer(JaxService(cfg, params, **kw), port=0).start()
    port_svc = InferenceService.from_run_dir(str(run_dir), device="cpu", **kw)
    port_server = InferenceServer(port_svc, port=0).start()
    yield jax_server, port_server, str(run_dir)
    jax_server.stop()
    port_server.stop()


SEQS = ["ACGTACGTAC", "ACGT", "GATTACAGATTACAGATTACA"]  # buckets 16, 16, 32


@pytest.mark.parametrize("path", ["/embed", "/logits"])
def test_endpoint_matches_jax_server(servers, path):
    jax_server, port_server, _ = servers
    want = _post(jax_server.port, path, {"sequences": SEQS})[path[1:]]
    got = _post(port_server.port, path, {"sequences": SEQS})[path[1:]]
    assert len(got) == len(SEQS)
    for s, g, w in zip(SEQS, got, want):
        g, w = np.asarray(g, np.float32), np.asarray(w, np.float32)
        assert g.shape == w.shape
        if path == "/logits":
            assert g.shape[0] == len(s)  # padding stripped
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)


def test_healthz_and_single_dispatch(servers):
    _, port_server, _ = servers
    h = _get(port_server.port, "/healthz")
    assert h["status"] == "ok" and h["model"]["rcps"] is True
    assert h["device"] == "cpu"
    svc = port_server.service
    before = svc.n_dispatches
    out = _post(port_server.port, "/embed",
                {"sequences": ["ACGT", "ACGTA", "ACGTAC"]})["embed"]
    assert len(out) == 3 and svc.n_dispatches - before == 1


def test_errors_are_json(servers):
    _, port_server, _ = servers
    for path, body, code in [
            ("/logits", {"sequences": []}, 400),
            ("/logits", {"sequences": ["A" * 100]}, 400),   # > max_length
            ("/generate", {"prompt": "ACGT"}, 500),         # RCPS: not causal
            ("/classify", {"sequences": ["ACGT"]}, 400),    # not finetuned
            ("/nope", {}, 404)]:
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(port_server.port, path, body)
        assert e.value.code == code
        assert "error" in json.loads(e.value.read())


def _write_run(run_dir, cfg, seed):
    """A JAX init of ``cfg`` as ``model_config.json`` + ``params.npz``."""
    params = jax.jit(JaxLM(cfg).init)(jax.random.PRNGKey(seed),
                                      jnp.full((1, 16), 7, jnp.int32))
    cfg.save(str(run_dir / "model_config.json"))
    flat = tu.flatten_dict(params["params"], sep="/")
    np.savez(run_dir / "params.npz", **{k: np.asarray(v)
                                        for k, v in flat.items()})
    return params


@pytest.fixture(scope="module")
def causal_runs(tmp_path_factory):
    """Run dirs of a small causal model of each family (what `cli.py
    pretrain --model mamba` builds): {family: (cfg, params, run dir)}."""
    tok = CaduceusTokenizer()
    out = {}
    for name, ssm in (("v1", JaxSSM(version=1, d_state=8, use_kernel="xla")),
                      ("v2", JaxSSM(version=2, d_state=16, headdim=16,
                                    ngroups=1, ssd_chunk_size=16,
                                    use_kernel="xla"))):
        cfg = JaxConfig(d_model=32, n_layer=2, vocab_size=tok.vocab_size,
                        rcps=False, bidirectional=False,
                        complement_map=tok.complement_map, dtype="float32",
                        param_dtype="float32", ssm_cfg=ssm)
        run_dir = tmp_path_factory.mktemp(f"causal_{name}")
        out[name] = (cfg, _write_run(run_dir, cfg, 4), str(run_dir))
    return out


@pytest.mark.parametrize("name", ["v1", "v2"])
def test_generate_matches_jax_server(causal_runs, name):
    """Greedy /generate on the port's CPU server gives the JAX server's
    text for the same params and prompt; ``cli.py generate --device cpu``
    prints the same."""
    cfg, params, run_dir = causal_runs[name]
    kw = dict(max_batch=2, min_bucket=16, max_length=64)
    body = {"prompt": "ACGTTGCAGGA", "max_new_tokens": 8}
    jax_server = JaxServer(JaxService(cfg, params, **kw), port=0).start()
    port_server = InferenceServer(InferenceService.from_run_dir(
        run_dir, device="cpu", **kw), port=0).start()
    try:
        want = _post(jax_server.port, "/generate", body)
        got = _post(port_server.port, "/generate", body)
        seeded = [_post(port_server.port, "/generate", {
            **body, "temperature": 1.0, "top_k": 4, "seed": 3})["generated"]
            for _ in range(2)]
    finally:
        jax_server.stop()
        port_server.stop()
    assert got == want and got["generated"]
    assert seeded[0] == seeded[1]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli_main(["generate", "--run-dir", run_dir, "--prompt",
                  body["prompt"], "--max-new-tokens", "8", "--device", "cpu"])
    assert json.loads(out.getvalue()) == want


def test_bridge_consumes_every_key_once(servers, causal_runs):
    _, _, run_dir = servers
    for name, (_, _, causal_dir) in causal_runs.items():
        # a causal model's tree (`layers_i/mixer/mamba_fwd/...`) crosses
        flat = load_npz_params(os.path.join(causal_dir, "params.npz"))
        cfg = CaduceusConfig.load(os.path.join(causal_dir,
                                               "model_config.json"))
        sd = from_jax_params(flat, cfg)
        assert len(sd) == len(flat), name
        w = flat["backbone/layers_1/mixer/mamba_fwd/in_proj/kernel"]
        assert torch.equal(sd["backbone.layers.1.mixer.mamba_fwd.in_proj."
                              "weight"], torch.from_numpy(w.T))
    flat = load_npz_params(os.path.join(run_dir, "params.npz"))
    cfg = CaduceusConfig.load(os.path.join(run_dir, "model_config.json"))
    sd = from_jax_params(flat, cfg)
    assert len(sd) == len(flat)
    w = flat["backbone/layers_0/mixer/in_proj/kernel"]
    assert torch.equal(sd["backbone.layers.0.mixer.in_proj.weight"],
                       torch.from_numpy(w.T))  # Dense kernel is transposed
    with pytest.raises(KeyError, match="left unused"):
        from_jax_params({**flat, "backbone/extra": w}, cfg)
    with pytest.raises(KeyError, match="lack"):
        from_jax_params({k: v for k, v in flat.items()
                         if not k.endswith("/A_log")}, cfg)
    with pytest.raises(KeyError, match="left unused"):  # untied head
        from_jax_params({**flat, "lm_head": flat["backbone/embedding"]}, cfg)
    bad = dict(flat)
    bad["backbone/norm_f_w"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError):
        from_jax_params(bad, cfg)


def test_port_imports_no_jax():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "caduceus_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 10
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for m in mods:
                assert m.split(".")[0] not in BANNED, f"{path} imports {m}"


def test_cpu_is_explicit():
    assert resolve_device("cpu").type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            resolve_device("cuda")
    with pytest.raises(SystemExit):
        cli_main([])


def test_v1_run_dir_serves_the_model_on_cpu(tmp_path):
    """A v1 (Mamba-1) run dir: `from_run_dir` builds `BiMamba` layers and
    /logits returns the model's own logits for a padded dispatch (two
    sequences in the 32 bucket), and /embed its pooled hidden states. The
    run dir is the JAX package's: ``model_config.json`` written by its
    config, ``params.npz`` as flat flax paths (the port's seeded init
    through `to_jax_params`, which saves a JAX compile; a JAX-made v1 tree
    crosses the bridge in tests/test_torch_train.py)."""
    tok = CaduceusTokenizer()
    JaxConfig(
        d_model=32, n_layer=2, vocab_size=tok.vocab_size, rcps=True,
        complement_map=tok.complement_map, residual_in_fp32=False,
        dtype="float32", param_dtype="float32",
        ssm_cfg=JaxSSM(version=1, d_state=8, use_kernel="xla")).save(
            str(tmp_path / "model_config.json"))
    cfg = CaduceusConfig.load(str(tmp_path / "model_config.json"))
    model = CaduceusForMaskedLM(cfg, device="cpu",
                                generator=torch.Generator().manual_seed(1))
    np.savez(tmp_path / "params.npz", **to_jax_params(model.state_dict()))
    svc = InferenceService.from_run_dir(str(tmp_path), device="cpu",
                                        max_batch=4, min_bucket=16,
                                        max_length=64, linger_ms=30.0)
    assert type(svc.model.backbone.layers[0].mixer).__name__ == "BiMamba"
    server = InferenceServer(svc, port=0).start()
    try:
        seqs = ["GATTACAGATTACAGATTACA", "ACGTACGTACGTACGTAC"]
        got = _post(server.port, "/logits", {"sequences": seqs})["logits"]
        emb = _post(server.port, "/embed", {"sequences": seqs[:1]})["embed"]
    finally:
        server.stop()
    ids = torch.full((2, 32), tok.pad_token_id, dtype=torch.long)
    for i, s in enumerate(seqs):
        ids[i, :len(s)] = torch.from_numpy(tok.encode(s).astype(np.int64))
    with torch.inference_mode():
        want = svc.model(ids).numpy()
        h = svc._embed(ids[:1, :32], ids[:1, :32] != tok.pad_token_id)
    for i, s in enumerate(seqs):
        np.testing.assert_allclose(np.asarray(got[i], np.float32),
                                   want[i, :len(s)], rtol=0, atol=1e-6)
    np.testing.assert_allclose(np.asarray(emb[0], np.float32), h[0].numpy(),
                               rtol=0, atol=1e-6)


def test_lm_warmup_count_matches_jax(servers):
    """`warmup` of an LM service counts the JAX service's programs: an
    /embed and a /logits dispatch per (bucket, batch size), on a one-bucket
    grid; with the defaults every power-of-two bucket in [min_bucket,
    max_length] x the batch sizes 1, 2 and max_batch (4)."""
    jax_server, port_server, _ = servers
    kw = dict(buckets=[128], batch_sizes=[1, 2])
    assert port_server.service.warmup(**kw) == jax_server.service.warmup(
        **kw) == 4
    assert port_server.service.warmup() == 3 * 3 * 2   # buckets 16, 32, 64


def test_request_after_warmup_equals_one_without(servers):
    """The same /logits and /embed request, to a service without a warm-up
    and to one after it, gives the same bits."""
    _, _, run_dir = servers
    kw = dict(device="cpu", max_batch=4, min_bucket=16, max_length=64,
              linger_ms=30.0)
    out = []
    for warm in (False, True):
        svc = InferenceService.from_run_dir(run_dir, **kw)
        if warm:
            assert svc.warmup(buckets=[32]) == 6
        server = InferenceServer(svc, port=0).start()
        try:
            out.append([_post(server.port, path, {"sequences": SEQS})[path[1:]]
                        for path in ("/logits", "/embed")])
        finally:
            server.stop()
    assert out[0] == out[1]


def test_cli_serve_warmup_prints_its_line(servers, monkeypatch):
    """``cli.py serve --warmup`` prints ``{"warmed_programs": n}`` before
    the ``serving`` line (the JAX CLI's order, `caduceus_tpu/cli.py:
    497-501`)."""
    _, _, run_dir = servers
    monkeypatch.setattr(InferenceServer, "serve_forever",
                        lambda self: self.httpd.server_close())
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli_main(["serve", "--run-dir", run_dir, "--device", "cpu",
                  "--port", "0", "--max-batch", "2", "--min-bucket", "16",
                  "--max-length", "32", "--warmup"])
    lines = [json.loads(x) for x in out.getvalue().splitlines()]
    assert lines[0] == {"warmed_programs": 2 * 2 * 2}
    assert "serving" in lines[1] and len(lines) == 2
