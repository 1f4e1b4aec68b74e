"""The reference against the port at a tiny size on the CPU, in fp32: the
scans against their recurrences, the MLM logits of v1 and v2, and whole
runs of every cell (the loss of the first steps, the first gradient, the
update, the classifier, the VEP features)."""

import pytest
import torch

from tiny import run, tiny_cell
from benchmark.reference import scan as ref_scan
from benchmark.reference import ssd as ref_ssd
from benchmark.reference.model import Model
from benchmark.weights import make_weights


def test_scan_against_its_recurrence(monkeypatch):
    monkeypatch.setattr(ref_scan, "CHUNK", 16)
    g = torch.Generator().manual_seed(1)
    G, L, d, N = 3, 150, 5, 4
    args = [torch.randn(G, L, d, generator=g),
            torch.rand(G, L, d, generator=g) * 0.3,
            -torch.rand(d, N, generator=g) * 3 - 0.1,
            torch.randn(G, L, N, generator=g),
            torch.randn(G, L, N, generator=g)]
    a1 = [t.clone().requires_grad_() for t in args]
    a2 = [t.double().requires_grad_() for t in args]
    y1 = ref_scan.selective_scan(*a1)
    y2 = ref_scan.selective_scan_sequential(*a2)
    gy = torch.randn(y1.shape, generator=g)
    g1 = torch.autograd.grad(y1, a1, gy)
    g2 = torch.autograd.grad(y2, a2, gy.double())
    torch.testing.assert_close(y1.double(), y2, rtol=1e-5, atol=1e-5)
    for u, v in zip(g1, g2):
        torch.testing.assert_close(u.double(), v, rtol=1e-5, atol=1e-4)


def test_ssd_against_its_recurrence(monkeypatch):
    monkeypatch.setattr(ref_ssd, "CHUNK", 16)
    g = torch.Generator().manual_seed(2)
    G, L, H, P, NG, N = 2, 70, 4, 3, 2, 5
    args = [torch.randn(G, L, H, P, generator=g),
            torch.rand(G, L, H, generator=g) * 0.5,
            -torch.rand(H, generator=g) * 4,
            torch.randn(G, L, NG, N, generator=g),
            torch.randn(G, L, NG, N, generator=g)]
    a1 = [t.clone().requires_grad_() for t in args]
    a2 = [t.double().requires_grad_() for t in args]
    y1 = ref_ssd.ssd(*a1)
    y2 = ref_ssd.ssd_sequential(*a2)
    gy = torch.randn(y1.shape, generator=g)
    g1 = torch.autograd.grad(y1, a1, gy)
    g2 = torch.autograd.grad(y2, a2, gy.double())
    torch.testing.assert_close(y1.double(), y2, rtol=1e-5, atol=1e-5)
    for u, v in zip(g1, g2):
        torch.testing.assert_close(u.double(), v, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("cell", ["v2_pretrain_131k", "v1_vep_131k"])
def test_mlm_logits_against_the_port(cell):
    from caduceus_tpu_torch.config import CaduceusConfig
    from caduceus_tpu_torch.models.caduceus import CaduceusForMaskedLM

    c = tiny_cell(cell, L=300)
    mc = c.model_cfg
    model = CaduceusForMaskedLM(CaduceusConfig(**mc), device="cpu")
    w = make_weights([(n, p.shape) for n, p in model.named_parameters()],
                     mc, 11, "cpu")
    model.load_state_dict(w)
    ids = torch.randint(7, 11, (2, 300), generator=torch.Generator()
                        .manual_seed(3))
    with torch.no_grad():
        got = model(ids)
        want = Model(mc, w).mlm_logits(ids)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("cell,config", [
    ("v2_pretrain_131k", None), ("v2_pretrain_131k", "caduceus_v1"),
    ("v1_vep_131k", None), ("v2_finetune_gb", None)])
def test_cell_against_the_reference(cell, config):
    c = tiny_cell(cell, config=config)
    c.settings["limits"] = {k: 1e-4 for k in c.settings["limits"]}
    result, lines = run(c)
    assert result["correct"], lines[-4:]
    assert result["failed"] == 0 and result["attempted"] >= 1
