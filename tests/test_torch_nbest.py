# -*- coding: utf-8 -*-
"""Best-of-N in the port (`sample_nbest`, `transcribe_nbest`,
`transcribe_with_ids(num_candidates=N)` and its async form) against an
oracle from the JAX package's own pieces: `make_sample_fn(x_init=...)` on
`jnp.repeat(c, N)` (candidates folded into the batch, rows [u0c0, u0c1, ...,
u1c0, ...]) and `batch_confidence_device`, on the tiny pipelines of
`test_torch_pipeline.py` at one injected [B*N, L] x_init.

Ids and their order are exact; confidences within 1e-5 (the two encoders
differ by f32 rounding)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fddm_asr_tpu import sampler as JS
from fddm_asr_tpu.eval import batch_confidence_device
from test_torch_pipeline import B, K, _wave, pipelines  # noqa: F401  (module fixture)

N, L = 4, 12
SAMPLING = dict(T_infer=20, r=5, greedy=True, posterior_mode="map")


@pytest.fixture(scope="module")
def oracle(pipelines):
    """(wave, x_init, JAX ids [B, N, L], JAX confidences [B, N])."""
    jp, *_ = pipelines
    rng = np.random.default_rng(11)
    wav = _wave(rng)
    x_init = rng.integers(0, K, (B * N, L))
    c, c_mask = jp.encode_waveform(wav)
    scfg = JS.SamplerConfig(K=K, T_train=200, **SAMPLING)

    def decoder_apply(params, xt, t, cond, cm):
        return jp.decoder.apply(params, xt, t, cond, None, cm, deterministic=True)

    ids, p = jax.jit(JS.make_sample_fn(decoder_apply, jp.sched, scfg), static_argnums=3)(
        jp.decoder_params, jax.random.key(0), jnp.repeat(c, N, axis=0), L, None,
        jnp.asarray(x_init))
    conf = batch_confidence_device(ids, p, jp.pad_id, jp.special_ids)
    return wav, x_init, np.asarray(ids).reshape(B, N, L), np.asarray(conf).reshape(B, N)


def test_transcribe_nbest_matches_the_jax_oracle(pipelines, oracle):
    jp, tp, *_ = pipelines
    wav, x_init, j_ids, j_conf = oracle
    assert len({tuple(r) for r in j_ids.reshape(B * N, L)}) > 1  # candidates differ
    got = tp.transcribe_nbest(wav, seq_len=L, num_candidates=N, x_init=x_init, **SAMPLING)
    assert len(got) == B
    for b, cands in enumerate(got):
        order = sorted(range(N), key=lambda j: -j_conf[b, j])  # stable, as the JAX sort
        assert [c[1] for c in cands] == [j_ids[b, j].tolist() for j in order]
        assert [c[0] for c in cands] == [jp.ids_to_text(j_ids[b, j]) for j in order]
        np.testing.assert_allclose([c[2] for c in cands], j_conf[b, order], rtol=0, atol=1e-5)


def test_sample_nbest_folds_candidates_like_jnp_repeat(pipelines, oracle):
    _, tp, *_ = pipelines
    wav, x_init, j_ids, _ = oracle
    c, c_mask = tp.encode_waveform(wav)
    ids, p = tp.sample_nbest(c, L, N, c_mask, x_init=x_init, **SAMPLING)
    assert tuple(ids.shape) == (B, N, L) and tuple(p.shape) == (B, N, L, K)
    np.testing.assert_array_equal(ids.numpy(), j_ids)


@pytest.mark.parametrize("with_confidence", [False, True])
def test_best_of_n_keeps_the_most_confident_and_async_agrees(pipelines, oracle,
                                                             with_confidence):
    jp, tp, *_ = pipelines
    wav, x_init, j_ids, j_conf = oracle
    kw = dict(seq_len=L, num_candidates=N, x_init=x_init, with_confidence=with_confidence,
              **SAMPLING)
    rows = tp.transcribe_with_ids(wav, **kw)
    finalize = tp.transcribe_with_ids_async(wav, **kw)
    assert callable(finalize) and finalize() == rows
    for b, row in enumerate(rows):
        k = int(np.argmax(j_conf[b]))
        assert row[1] == j_ids[b, k].tolist() and row[0] == jp.ids_to_text(j_ids[b, k])
        assert len(row) == (3 if with_confidence else 2)
        if with_confidence:
            assert row[2] == pytest.approx(j_conf[b, k], abs=1e-5)


def test_single_candidate_async_agrees_with_sync(pipelines, oracle):
    _, tp, *_ = pipelines
    wav, x_init, *_ = oracle
    kw = dict(seq_len=L, x_init=x_init[:B], with_confidence=True, **SAMPLING)
    assert tp.transcribe_with_ids_async(wav, **kw)() == tp.transcribe_with_ids(wav, **kw)


def test_x_T_of_all_candidates_is_one_draw_of_the_generator(pipelines, oracle):
    """Without x_init, the B*N rows' x_T is one [B*N, L] draw of the
    caller's generator: the same as passing that draw as x_init."""
    _, tp, *_ = pipelines
    wav, *_ = oracle
    drawn = tp.transcribe_nbest(wav, seq_len=L, num_candidates=N,
                                generator=torch.Generator().manual_seed(5), **SAMPLING)
    x_init = torch.randint(0, K, (B * N, L), generator=torch.Generator().manual_seed(5))
    given = tp.transcribe_nbest(wav, seq_len=L, num_candidates=N, x_init=x_init, **SAMPLING)
    assert drawn == given


def test_confidence_ties_go_to_the_first_candidate(pipelines, oracle, monkeypatch):
    """Equal confidences pick the first candidate (np.argmax), as in JAX."""
    _, tp, *_ = pipelines
    wav, *_ = oracle
    ids = torch.arange(B * N)[:, None].repeat(1, L) % (K - 4) + 4  # every row its own token
    p = torch.full((B * N, L, K), 1.0 / K)
    monkeypatch.setattr(tp, "sample", lambda c, seq_len, c_mask=None, generator=None,
                        x_init=None, **sc: (ids, p))
    rows = tp.transcribe_with_ids(wav, seq_len=L, num_candidates=N, with_confidence=True)
    assert [r[1] for r in rows] == [ids[b * N].tolist() for b in range(B)]


@pytest.mark.parametrize("call", ["sample_nbest", "transcribe_nbest", "transcribe_with_ids",
                                  "transcribe_with_ids_async"])
def test_zero_candidates_raise(pipelines, oracle, call):
    _, tp, *_ = pipelines
    wav, *_ = oracle
    with pytest.raises(ValueError, match="num_candidates must be >= 1"):
        if call == "sample_nbest":
            tp.sample_nbest(torch.zeros(B, 4, 32), L, 0)
        else:
            getattr(tp, call)(wav, seq_len=L, num_candidates=0)
