# -*- coding: utf-8 -*-
"""The port's training side of the diffusion against the JAX package's.

`q_sample`, `kl_term`, `kl_term_sparse` and the L_fd weight `w_t`
elementwise on the same numpy inputs (float32, rtol 1e-5; the KL gradients
with respect to the logits too, atol 1e-6 of their largest magnitude), and
exact small-K marginals of `sample_xt_tokens` (tests/test_diffusion.py's
checks: K=2 at near-full corruption separates keep-with-ab-else-uniform
from the double-counting decomposition)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fddm_asr_tpu import diffusion as JD
from fddm_asr_tpu_torch import diffusion as TD

K, T = 40, 200


def _case(rng, B=3, L=9):
    x0 = rng.integers(0, K, (B, L))
    xt = np.where(rng.random((B, L)) < 0.5, x0, rng.integers(0, K, (B, L)))
    logits = (3 * rng.standard_normal((B, L, K))).astype(np.float32)
    t = np.array([1, 57, T])  # the t=1 boundary (M_0 = I) and the last step
    mask = np.ones((B, L), bool)
    mask[2, 5:] = False
    return x0, xt, logits, t, mask


def test_w_t_and_q_sample_match_jax(rng):
    js, ts = JD.make_schedule(K, T, 0.2), TD.make_schedule(K, T, 0.2)
    t = np.array([1, 2, 100, T])
    np.testing.assert_array_equal(ts.w_t(torch.from_numpy(t)).numpy(), np.asarray(js.w_t(t)))
    np.testing.assert_array_equal(ts.w_prefix.numpy(), np.asarray(js.w_prefix))
    x0 = np.eye(K, dtype=np.float32)[rng.integers(0, K, (4, 6))]
    x0[1] = rng.dirichlet(np.ones(K), 6)  # probability rows too
    np.testing.assert_allclose(TD.q_sample(ts, torch.from_numpy(x0), torch.from_numpy(t)).numpy(),
                               np.asarray(JD.q_sample(js, jnp.asarray(x0), jnp.asarray(t))),
                               rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("kind", ["kl_term", "kl_term_sparse"])
@pytest.mark.parametrize("with_mask", [True, False], ids=["mask", "nomask"])
def test_kl_matches_jax(rng, kind, with_mask):
    js, ts = JD.make_schedule(K, T, 0.2), TD.make_schedule(K, T, 0.2)
    x0, xt, logits, t, mask = _case(rng)
    m = mask if with_mask else None
    jfn, tfn = getattr(JD, kind), getattr(TD, kind)

    def jloss(lg):
        return jfn(js, jnp.asarray(xt), jnp.asarray(x0), lg, jnp.asarray(t),
                   None if m is None else jnp.asarray(m))

    want, want_grad = jax.value_and_grad(jloss)(jnp.asarray(logits))
    lg = torch.from_numpy(logits).requires_grad_()
    got = tfn(ts, torch.from_numpy(xt), torch.from_numpy(x0), lg, torch.from_numpy(t),
              None if m is None else torch.from_numpy(m))
    (grad,) = torch.autograd.grad(got, lg)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    scale = float(np.abs(np.asarray(want_grad)).max())
    np.testing.assert_allclose(grad.numpy(), np.asarray(want_grad), atol=1e-6 * scale, rtol=0)


def test_sparse_and_dense_kl_agree(rng):
    """To the JAX package's own tolerance (tests/test_diffusion.py): the two
    forms place the 1e-8 guards differently (kl_term_sparse's docstring)."""
    ts = TD.make_schedule(K, T, 0.2)
    x0 = torch.from_numpy(rng.integers(0, K, (4, 16)))
    t = torch.from_numpy(rng.integers(1, T + 1, (4,)))
    xt = TD.sample_xt_tokens(ts, x0, t, torch.Generator().manual_seed(2))
    logits = torch.from_numpy(rng.standard_normal((4, 16, K)).astype(np.float32) * 3)
    mask = torch.from_numpy(rng.random((4, 16)) > 0.2)
    dense = float(TD.kl_term(ts, xt, x0, logits, t, mask))
    sparse = float(TD.kl_term_sparse(ts, xt, x0, logits, t, mask))
    assert abs(dense - sparse) < 5e-4 * max(1.0, abs(dense))


def _keep_rate(sched, t, n, seed):
    x0 = torch.zeros(1, n, dtype=torch.long)
    gen = torch.Generator().manual_seed(seed)
    xt = TD.sample_xt_tokens(sched, x0, torch.tensor([t]), gen)
    return float((xt == 0).float().mean())


def test_sample_xt_tokens_exact_small_vocab():
    """P(x_t = x0) = ab + (1 - ab) / K exactly: at K=2 and ab ~ 0 that is
    ~1/2 (the double-counting decomposition gives ~3/4), and at K=5 for
    every t."""
    n = 200_000
    s2 = TD.make_schedule(2, 20, 0.999)
    ab = float(s2.alpha_bar_ext[20])
    assert ab < 0.05
    assert abs(_keep_rate(s2, 20, n, 3) - (ab + (1 - ab) / 2)) < 0.005
    s5 = TD.make_schedule(5, 20, 0.6)
    for t in (1, 10, 20):
        ab = float(s5.alpha_bar_ext[t])
        assert abs(_keep_rate(s5, t, n, 100 + t) - (ab + (1 - ab) / 5)) < 0.005, t


def test_sample_xt_tokens_follows_its_generator():
    s = TD.make_schedule(K, T, 0.2)
    x0 = torch.arange(60).reshape(3, 20) % K
    t = torch.tensor([5, 100, 200])

    def draw(seed):
        return TD.sample_xt_tokens(s, x0, t, torch.Generator().manual_seed(seed))

    assert torch.equal(draw(7), draw(7)) and not torch.equal(draw(7), draw(8))
    assert draw(7).dtype == x0.dtype and ((draw(7) >= 0) & (draw(7) < K)).all()
