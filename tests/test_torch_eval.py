# -*- coding: utf-8 -*-
"""The port's metrics, confidence and evaluators (`fddm_asr_tpu_torch.eval`)
against the JAX package's (`fddm_asr_tpu.eval`), on the tiny pipelines of
`test_torch_pipeline.py` (same weights on both sides).

CER, WER and the edit distance are exact; the confidence functions agree
within 1e-6 (f32 logs); `evaluate_validation_loss` within rtol 1e-5 (it is
deterministic; the two encoders differ by f32 rounding), and
`evaluate_validation_kl_sampled` within rtol 1e-5 at the same injected
(t, x_t).  The sampling evaluators are held exactly equal with the sampler
of both pipelines stubbed on the instance to return the same canned
(ids, p): that isolates the evaluators' own logic (the sampler's parity is
`test_torch_pipeline.py`'s and `test_torch_nbest.py`'s)."""
from collections import namedtuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from fddm_asr_tpu import diffusion as JD
from fddm_asr_tpu import eval as JE
from fddm_asr_tpu.config import Config as JaxConfig
from fddm_asr_tpu_torch import diffusion as TD
from fddm_asr_tpu_torch import eval as TE
from fddm_asr_tpu_torch.config import Config
from test_torch_pipeline import B, K, T, _wave, pipelines  # noqa: F401  (module fixture)

L = 12
Batch = namedtuple("Batch", "wave wave_lengths tokens")
SPECIAL = {"pad_id": 3, "bos_id": 1, "eos_id": 2, "unk_id": None}


def _batches(seed, n=2):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        tokens = rng.integers(4, K, (B, L))
        tokens[0, 8] = 2                       # eos, then pad
        tokens[0, 9:] = 3
        tokens[1, 10:] = 3
        out.append(Batch(_wave(rng), np.asarray([T, T // 2]), tokens))
    return out


# ------------------------------------------------------------------ metrics
_text = st.text(st.sampled_from("abcde 的是了一"), max_size=24)


@settings(max_examples=300, deadline=None)
@given(_text, _text)
def test_cer_wer_and_edit_distance_equal_the_jax_functions(ref, hyp):
    assert TE._levenshtein(ref, hyp) == JE._levenshtein(ref, hyp)
    assert TE._levenshtein(ref.split(), hyp.split()) == JE._levenshtein(ref.split(), hyp.split())
    assert TE.calculate_cer(ref, hyp) == JE.calculate_cer(ref, hyp)
    assert TE.calculate_wer(ref, hyp) == JE.calculate_wer(ref, hyp)


@pytest.mark.parametrize("ref,hyp,d", [("", "", 0), ("", "abc", 3), ("abc", "", 3),
                                       ("kitten", "sitting", 3), ("abc", "abc", 0)])
def test_edit_distance_known_values(ref, hyp, d):
    assert TE._levenshtein(ref, hyp) == d == JE._levenshtein(ref, hyp)


def test_confidence_functions_match(rng):
    ids = rng.integers(0, K, (6, L))
    ids[0, 3] = 2                      # eos mid-row
    ids[1] = 3                         # all pad: nothing decoded
    ids[2, :2] = 1                     # bos at the front
    p = rng.dirichlet(np.ones(K), (6, L)).astype(np.float32)
    want = np.asarray(JE.batch_confidence_device(jnp.asarray(ids), jnp.asarray(p), 3, SPECIAL))
    got = TE.batch_confidence(torch.as_tensor(ids), torch.as_tensor(p), 3, SPECIAL).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert got[1] == 0.0
    for i in range(6):
        np.testing.assert_array_equal(TE.decoded_span_mask(ids[i], 3, SPECIAL),
                                      JE.decoded_span_mask(ids[i], 3, SPECIAL))
        assert TE.utterance_confidence(ids[i], p[i], 3, SPECIAL) == pytest.approx(
            JE.utterance_confidence(ids[i], p[i], 3, SPECIAL), rel=1e-6)


def test_logits_to_text_matches(pipelines, rng):
    jp, tp, *_ = pipelines
    logits = rng.standard_normal((3, L, K)).astype(np.float32)
    assert TE.logits_to_text(logits, tp.tokenizer, 3, 1, 2) == JE.logits_to_text(
        logits, jp.tokenizer, 3, 1, 2)


def test_logprob_voting_ignores_post_eos_tail():
    """The JAX package's case (tests/test_eval_pipeline.py): the decoded span
    alone is scored, so a confident post-eos tail cannot win a vote."""
    class _P:
        special_ids = {"eos_id": 2, "bos_id": 1}
        pad_id = 0

    ids_a, p_a = np.asarray([5, 6, 2, 9, 9, 9]), np.asarray([0.9, 0.9, 0.5, 1e-6, 1e-6, 1e-6])
    ids_b, p_b = np.asarray([7, 8, 2, 4, 4, 4]), np.asarray([0.2, 0.2, 0.5, 1.0, 1.0, 1.0])
    score_a = TE._decoded_span_logprob_mean(ids_a, p_a, _P())
    score_b = TE._decoded_span_logprob_mean(ids_b, p_b, _P())
    assert score_a > score_b
    assert score_a == JE._decoded_span_logprob_mean(ids_a, p_a, _P())
    assert score_b == JE._decoded_span_logprob_mean(ids_b, p_b, _P())
    np.testing.assert_allclose(score_a, np.log([0.9, 0.9]).mean(), rtol=1e-6)
    assert TE._decoded_span_logprob_mean(np.zeros(6, np.int64), p_a, _P()) == -np.inf


# --------------------------------------------------------------- evaluators
def test_validation_loss_matches(pipelines):
    jp, tp, *_ = pipelines
    batches = _batches(0)
    want = JE.evaluate_validation_loss(jp, batches)
    got = TE.evaluate_validation_loss(tp, batches)
    assert np.isfinite(got) and got > 0
    assert got == pytest.approx(want, rel=1e-5)


def test_validation_kl_sampled_matches_at_injected_draws(pipelines, monkeypatch):
    """Both evaluators draw t and x_t from their own generators; here both
    get the same (t, x_t) per batch, so the values must agree."""
    jp, tp, *_ = pipelines
    batches = _batches(1)
    rng = np.random.default_rng(7)
    draws = [(rng.integers(1, 201, (B,)), rng.integers(0, K, (B, L))) for _ in batches]

    j_queue, t_queue = list(draws), list(draws)
    monkeypatch.setattr(jax.random, "randint",
                        lambda key, shape, lo, hi, *a, **k: jnp.asarray(j_queue[0][0]))
    monkeypatch.setattr(JD, "sample_xt_tokens",
                        lambda sched, key, x0, t: jnp.asarray(j_queue.pop(0)[1]))
    want = JE.evaluate_validation_kl_sampled(jp, batches)
    monkeypatch.setattr(torch, "randint",
                        lambda lo, hi, size, generator=None, device=None: torch.as_tensor(
                            t_queue[0][0], device=device))
    monkeypatch.setattr(TD, "sample_xt_tokens",
                        lambda sched, x0, t, generator=None: torch.as_tensor(t_queue.pop(0)[1]))
    got = TE.evaluate_validation_kl_sampled(tp, batches)
    assert not j_queue and not t_queue
    assert np.isfinite(got) and got > 0
    assert got == pytest.approx(want, rel=1e-5)


def _canned(seed, n):
    """`n` (ids, p) draws of a batch: ids over six values (so per-position
    votes both win and tie), an eos in one row with a tail after it."""
    rng = np.random.default_rng(seed)
    out = []
    for s in range(n):
        ids = rng.integers(4, 10, (B, L))
        ids[s % B, 5] = 2                      # an eos in one row, a tail after it
        p = rng.dirichlet(np.ones(K), (B, L)).astype(np.float32)
        out.append((ids, p))
    return out


def _stub_samplers(monkeypatch, jp, tp, canned):
    """Both pipelines' samplers return the canned draws in order and record
    the sampling keywords they were given."""
    seen = {"jax": [], "torch": []}
    j_queue, t_queue = list(canned), list(canned)

    def j_draw(sc):
        seen["jax"].append(sc)
        return j_queue.pop(0)

    def t_draw(sc):
        seen["torch"].append(sc)
        ids, p = t_queue.pop(0)
        return torch.as_tensor(ids), torch.as_tensor(p)

    monkeypatch.setattr(jp, "_sample_raw",
                        lambda rng, c, seq_len, c_mask=None, **sc: j_draw(sc), raising=False)
    monkeypatch.setattr(jp, "sample",
                        lambda rng, c, seq_len, c_mask=None, **sc: j_draw(sc), raising=False)
    monkeypatch.setattr(tp, "sample", lambda c, seq_len, c_mask=None, generator=None,
                        x_init=None, **sc: t_draw(sc), raising=False)
    return seen


CFG_INF = {"inference": {"T_infer": 10, "temperature": 1.5}}  # no r, no posterior_mode


@pytest.mark.parametrize("which", ["full", "jumpy", "wer", "full_overrides"])
def test_sampling_evaluators_match_with_stubbed_samplers(pipelines, monkeypatch, which):
    jp, tp, *_ = pipelines
    batches = _batches(2)
    seen = _stub_samplers(monkeypatch, jp, tp, _canned(3, len(batches)))
    jcfg, tcfg = JaxConfig(CFG_INF), Config(CFG_INF)
    if which == "full":
        want = JE.evaluate_cer_with_full_sampling(jp, batches, jcfg)
        got = TE.evaluate_cer_with_full_sampling(tp, batches, tcfg)
    elif which == "full_overrides":
        over = {"r": 4, "greedy": None, "repeat_penalty": 0.5}
        want = JE.evaluate_cer_with_full_sampling(jp, batches, jcfg, over)
        got = TE.evaluate_cer_with_full_sampling(tp, batches, tcfg, over)
    elif which == "jumpy":
        want = JE.evaluate_cer_with_jumpy_sampling(jp, batches, None)
        got = TE.evaluate_cer_with_jumpy_sampling(tp, batches, None)
    else:
        want = JE.evaluate_wer_with_jumpy_sampling(jp, batches, jcfg)
        got = TE.evaluate_wer_with_jumpy_sampling(tp, batches, tcfg)
    assert got == want and 0 < got
    assert seen["torch"] == seen["jax"] and len(seen["torch"]) == len(batches)


@pytest.mark.parametrize("voting", ["first", "majority", "logprob"])
@pytest.mark.parametrize("sampling_config", [None, {"T_infer": 6}])
def test_multi_sample_votes_match_with_stubbed_samplers(pipelines, monkeypatch, voting,
                                                         sampling_config):
    """All three votings, with the reference's all-or-nothing defaults (r=2,
    posterior_mode "average" only when sampling_config is None)."""
    jp, tp, *_ = pipelines
    batches = _batches(4)
    canned = _canned(5, 3 * len(batches))
    seen = _stub_samplers(monkeypatch, jp, tp, canned)
    want = JE.evaluate_cer_with_multi_sample(jp, batches, JaxConfig(CFG_INF), sampling_config,
                                             num_samples=3, voting=voting)
    got = TE.evaluate_cer_with_multi_sample(tp, batches, Config(CFG_INF), sampling_config,
                                            num_samples=3, voting=voting)
    assert got == want and 0 < got
    assert seen["torch"] == seen["jax"]
    r, mode = (2, "average") if sampling_config is None else (5, "map")
    assert seen["torch"][0]["r"] == r and seen["torch"][0]["posterior_mode"] == mode
    assert seen["torch"][0]["greedy"] is False


def test_votes_differ_so_the_cases_above_discriminate(pipelines, monkeypatch):
    """The canned draws make the three votings disagree, so matching each
    JAX value checks the voting and not only the plumbing; majority ties go
    to the smallest id, as np.unique orders them."""
    jp, tp, *_ = pipelines
    batches = _batches(4)
    canned = _canned(5, 3 * len(batches))
    values = {}
    for voting in ("first", "majority", "logprob"):
        _stub_samplers(monkeypatch, jp, tp, canned)
        values[voting] = TE.evaluate_cer_with_multi_sample(tp, batches, num_samples=3,
                                                           voting=voting)
    assert len(set(values.values())) == 3, values

    tied = [(np.full((B, L), v), np.full((B, L, K), 1.0 / K, np.float32)) for v in (9, 5, 7)]
    decoded = []
    monkeypatch.setattr(tp, "ids_to_text", lambda ids: decoded.append(np.asarray(ids)) or "")
    _stub_samplers(monkeypatch, jp, tp, tied)
    TE.evaluate_cer_with_multi_sample(tp, batches[:1], num_samples=3, voting="majority")
    assert (decoded[0] == 5).all()
