"""The port's adaptive embedding and projected adaptive log-softmax
(`caduceus_tpu_torch/models/adaptive_softmax.py`) against
`caduceus_tpu.models.adaptive_softmax`, on the CPU: the four cases of
`tests/test_adaptive_softmax.py` on the port's modules (the training case
with `torch.optim.Adam`), and the log-probabilities, the NLL and every
gradient of the JAX modules' parameters, bridged by `params.py
from_jax_params`, within 1e-5.
"""

import flax.traverse_util as tu
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from caduceus_tpu.models import adaptive_softmax as jas
from caduceus_tpu_torch.models.adaptive_softmax import (
    AdaptiveEmbedding,
    ProjectedAdaptiveLogSoftmax,
)
from caduceus_tpu_torch.params import from_jax_params

gen = lambda seed: torch.Generator().manual_seed(seed)


def test_log_probs_normalize():
    m = ProjectedAdaptiveLogSoftmax(n_token=40, d_embed=16, d_proj=16,
                                    cutoffs=(8, 24), div_val=2,
                                    generator=gen(1))
    h = torch.randn(6, 16, generator=gen(0))
    lp = m.log_prob(h)
    assert lp.shape == (6, 40)
    np.testing.assert_allclose(lp.exp().sum(-1).detach().numpy(), 1.0,
                               rtol=1e-5)


def test_no_cutoffs_equals_dense_softmax():
    """With no tail clusters the head is a dense softmax over the vocab."""
    m = ProjectedAdaptiveLogSoftmax(n_token=12, d_embed=16, d_proj=16,
                                    generator=gen(1))
    h = torch.randn(4, 16, generator=gen(2))
    tgt = torch.randint(0, 12, (4,), generator=gen(3))
    want = torch.log_softmax(h @ m.out_0.t() + m.bias_0, dim=-1)
    with torch.no_grad():
        np.testing.assert_allclose(m.log_prob(h).numpy(), want.numpy(),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(
            m(h, tgt).numpy(),
            -want.gather(-1, tgt[:, None])[:, 0].numpy(), rtol=1e-5)


def test_adaptive_embedding_shapes_and_clusters():
    m = AdaptiveEmbedding(n_token=40, d_embed=16, d_proj=8, cutoffs=(8, 24),
                          div_val=2, generator=gen(0))
    ids = torch.tensor([[0, 7, 8, 23, 24, 39]])
    out = m(ids).detach()
    assert out.shape == (1, 6, 8)
    # per-cluster tables of shrinking widths 16, 8, 4
    assert m.emb_0.shape == (8, 16)
    assert m.emb_1.shape == (16, 8)
    assert m.emb_2.shape == (16, 4)
    o = out[0].numpy()
    assert not np.allclose(o[0], o[2]) and not np.allclose(o[2], o[4])


def test_adaptive_lm_task_trains():
    """An AdaptiveLMTask-style training loop (`src/tasks/tasks.py:335-382`)
    lowers the NLL: embedding, a Linear, the adaptive softmax, Adam."""
    V, D = 32, 16
    torch.manual_seed(0)
    emb = AdaptiveEmbedding(V, D, D, (8,), 2, generator=gen(0))
    lin = torch.nn.Linear(D, D)
    head = ProjectedAdaptiveLogSoftmax(V, D, D, (8,), 2, generator=gen(1))
    ids = torch.from_numpy(np.random.default_rng(0).integers(0, V, (8, 16)))
    params = [*emb.parameters(), *lin.parameters(), *head.parameters()]
    opt = torch.optim.Adam(params, lr=1e-2)
    loss_fn = lambda: head(lin(emb(ids)), ids).mean()
    loss0 = float(loss_fn().detach())
    for _ in range(30):
        opt.zero_grad()
        loss = loss_fn()
        loss.backward()
        opt.step()
    assert float(loss.detach()) < loss0 - 0.5


@pytest.mark.parametrize("d_proj,cutoffs", [(16, (8, 24)), (12, (8, 24)),
                                            (16, ())],
                         ids=["tied-width", "projected", "dense"])
def test_matches_jax_on_bridged_weights(d_proj, cutoffs):
    """Both modules from the JAX init (`from_jax_params`): the embedding's
    output, the log-probabilities and the NLL within 1e-5, and the
    gradients of a weighted NLL sum with respect to every parameter and
    the hidden states within 1e-5 of their max."""
    V, D = 40, 16
    kw = dict(n_token=V, d_embed=D, d_proj=d_proj, cutoffs=cutoffs,
              div_val=2)
    rng = np.random.default_rng(7)
    h = rng.standard_normal((3, 5, d_proj)).astype(np.float32)
    tgt = rng.integers(0, V, (3, 5)).astype(np.int32)
    w = rng.standard_normal((3, 5)).astype(np.float32)

    jhead, jemb = jas.ProjectedAdaptiveLogSoftmax(**kw), \
        jas.AdaptiveEmbedding(**kw)
    hp = jhead.init(jax.random.PRNGKey(0), h, tgt)
    ep = jemb.init(jax.random.PRNGKey(1), tgt)
    head = ProjectedAdaptiveLogSoftmax(**kw)
    head.load_state_dict(from_jax_params(
        tu.flatten_dict(hp["params"], sep="/"), None, model=head))
    emb = AdaptiveEmbedding(**kw)
    emb.load_state_dict(from_jax_params(
        tu.flatten_dict(ep["params"], sep="/"), None, model=emb))

    def jax_loss(p, x):
        return jnp.sum(jhead.apply(p, x, tgt) * w)

    want_lp = np.asarray(jhead.apply(hp, h, method=jhead.log_prob))
    want_nll = np.asarray(jhead.apply(hp, h, tgt))
    g_p, g_h = jax.grad(jax_loss, argnums=(0, 1))(hp, h)
    ht = torch.from_numpy(h).requires_grad_(True)
    lp = head.log_prob(ht)
    nll = head(ht, torch.from_numpy(tgt))
    (nll * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(lp.detach().numpy(), want_lp, rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(nll.detach().numpy(), want_nll, rtol=0,
                               atol=1e-5)
    grads = {"hidden": (ht.grad.numpy(), np.asarray(g_h))}
    g_flat = tu.flatten_dict(g_p["params"], sep="/")
    for n, p in head.named_parameters():
        grads[n] = (p.grad.numpy(), np.asarray(g_flat[n]))
    for n, (got, want) in grads.items():
        scale = max(np.abs(want).max(), 1e-30)
        np.testing.assert_allclose(got / scale, want / scale, rtol=0,
                                   atol=1e-5, err_msg=n)
    with torch.no_grad():
        np.testing.assert_allclose(
            emb(torch.from_numpy(tgt).long()).numpy(),
            np.asarray(jemb.apply(ep, tgt)), rtol=0, atol=1e-5)
