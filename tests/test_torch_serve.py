"""The port's server against the JAX server, over HTTP, on the CPU.

Both serve the same params (a JAX init written as ``params.npz`` +
``model_config.json``, read by the port through `params.py`); the same
requests must give the same /embed and /logits (fp32, 1e-5). Also: the
bridge consumes every flax key exactly once, and nothing under
`caduceus_tpu_torch/` (nor `chip_smoke.py`) imports JAX or the JAX package.
"""

import ast
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
from caduceus_tpu_torch.params import from_jax_params, load_npz_params
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
            ("/generate", {"prompt": "ACGT"}, 501),         # not ported yet
            ("/classify", {"sequences": ["ACGT"]}, 501),
            ("/nope", {}, 404)]:
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(port_server.port, path, body)
        assert e.value.code == code
        assert "error" in json.loads(e.value.read())


def test_bridge_consumes_every_key_once(servers):
    _, _, run_dir = servers
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
    sequences in the 32 bucket), and /embed its pooled hidden states."""
    tok = CaduceusTokenizer()
    cfg = JaxConfig(
        d_model=32, n_layer=2, vocab_size=tok.vocab_size, rcps=True,
        complement_map=tok.complement_map, residual_in_fp32=False,
        dtype="float32", param_dtype="float32",
        ssm_cfg=JaxSSM(version=1, d_state=8, use_kernel="xla"))
    params = jax.jit(JaxLM(cfg).init)(jax.random.PRNGKey(1),
                                      jnp.full((1, 16), 7, jnp.int32))
    cfg.save(str(tmp_path / "model_config.json"))
    flat = tu.flatten_dict(params["params"], sep="/")
    np.savez(tmp_path / "params.npz", **{k: np.asarray(v)
                                         for k, v in flat.items()})
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
