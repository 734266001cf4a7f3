# -*- coding: utf-8 -*-
"""Long-form transcription in the port: `silence_cut` and
`plan_silence_chunks` (`fddm_asr_tpu_torch.data.audio_io`) equal the JAX
package's exactly (both are numpy), and the CLI's `infer_long` gives the
JAX CLI's result (keys, spans, window texts) on the tiny pipelines of
`test_torch_pipeline.py` when both samplers start from the same injected
x_T per batch of windows."""
import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import inference as jax_cli
from fddm_asr_tpu import sampler as JS
from fddm_asr_tpu.data import audio_io as JA
from fddm_asr_tpu_torch import inference as cli
from fddm_asr_tpu_torch.data import audio_io as TA
from test_torch_pipeline import K, pipelines  # noqa: F401  (module fixture)

SR = 16000


def _speech_with_pauses(seconds, seed):
    """Noise bursts with near-silent gaps of 0.1-0.5 s at random places."""
    rng = np.random.default_rng(seed)
    n = int(seconds * SR)
    x = (0.3 * rng.standard_normal(n)).astype(np.float32)
    for _ in range(max(1, int(seconds))):
        s = int(rng.integers(0, n))
        x[s:s + int(rng.integers(1600, 8000))] *= 0.01
    return x


@pytest.mark.parametrize("seconds,win_s", [(31.0, 5.0), (63.3, 20.0), (7.7, 1.0)])
def test_plan_silence_chunks_equals_jax(seconds, win_s):
    x = _speech_with_pauses(seconds, seed=int(seconds))
    win = int(win_s * SR)
    spans = TA.plan_silence_chunks(x, win)
    assert spans == JA.plan_silence_chunks(x, win)
    assert len(spans) > 1 and all(0 < e - s <= win for s, e in spans)
    assert spans[0][0] == 0 and spans[-1][1] == len(x)
    for search, frame in ((8000, 400), (400, 160), (100, 400)):
        assert (TA.plan_silence_chunks(x, win, search, frame)
                == JA.plan_silence_chunks(x, win, search, frame))


@pytest.mark.parametrize("n", ["win-1", "win", "win+1", "399", "1", "0"])
def test_plan_silence_chunks_at_the_edges(n):
    win = 4000
    length = {"win-1": win - 1, "win": win, "win+1": win + 1, "399": 399, "1": 1, "0": 0}[n]
    x = _speech_with_pauses(1.0, seed=3)[:length]
    assert TA.plan_silence_chunks(x, win) == JA.plan_silence_chunks(x, win)
    for w in (399, 400, 401):
        assert TA.plan_silence_chunks(x, w) == JA.plan_silence_chunks(x, w)


@pytest.mark.parametrize("win", [399, 400, 401, 1600, 16000, 64000])
def test_silence_cut_equals_jax(win):
    x = _speech_with_pauses(5.0, seed=win)
    for offset in (0, 17, 4000):
        window = x[offset:offset + win]
        got = TA.silence_cut(window, win)
        assert got == JA.silence_cut(window, win) and 400 <= got <= max(400, win)


def test_save_wav_writes_what_jax_writes(tmp_path):
    x = _speech_with_pauses(0.5, seed=1) * 4  # clips
    TA.save_wav(str(tmp_path / "t.wav"), x, SR)
    JA.save_wav(str(tmp_path / "j.wav"), x, SR)
    assert (tmp_path / "t.wav").read_bytes() == (tmp_path / "j.wav").read_bytes()
    got, sr = TA.load_wav(str(tmp_path / "t.wav"))
    assert sr == SR and len(got) == len(x)


def _inject(monkeypatch, jp, tp, x_inits):
    """Both pipelines sample every batch from the next x_init in `x_inits`
    (ids [rows, L]); returns the two queues, empty once both are used up."""
    j_queue, t_queue = list(x_inits), list(x_inits)
    sample_fns = {}

    def j_sample_raw(rng, c, seq_len, c_mask=None, **sc):
        key = tuple(sorted(sc.items()))
        if key not in sample_fns:
            def decoder_apply(params, xt, t, cond, cm):
                return jp.decoder.apply(params, xt, t, cond, None, cm, deterministic=True)

            fn = JS.make_sample_fn(decoder_apply, jp.sched,
                                   JS.SamplerConfig(K=K, T_train=200, **sc))
            sample_fns[key] = jax.jit(fn, static_argnums=3)
        x = j_queue.pop(0)
        return sample_fns[key](jp.decoder_params, rng, c, seq_len, c_mask, jnp.asarray(x))

    original = tp.sample

    def t_sample(c, seq_len, c_mask=None, generator=None, x_init=None, **sc):
        return original(c, seq_len, c_mask, generator=generator, x_init=t_queue.pop(0), **sc)

    monkeypatch.setattr(jp, "_sample_raw", j_sample_raw, raising=False)
    monkeypatch.setattr(tp, "sample", t_sample, raising=False)
    return j_queue, t_queue


@pytest.mark.parametrize("align", ["silence", "fixed"])
def test_infer_long_matches_the_jax_cli(pipelines, monkeypatch, tmp_path, align):
    """A 2.3 s WAV in 0.5 s windows (five fixed, six cut at pauses), three
    windows a batch: the port's result has the JAX CLI's keys, spans and,
    at the same injected x_T, the same window texts and ids."""
    jp, tp, *_ = pipelines
    path = str(tmp_path / "long.wav")
    TA.save_wav(path, _speech_with_pauses(2.3, seed=9), SR)
    args = cli.parse_args(["--wav", path, "--ckpt", "x", "--main-config", "x",
                           "--diffusion-config", "x", "--tokenizer", "x", "--greedy",
                           "--seq-len", "8", "--chunk-seconds", "0.5", "--chunk-align", align,
                           "--batch-size", "3"])
    wav, _ = TA.load_audio(path, target_sr=SR)
    n_spans = len(cli.chunk_spans(wav, 8000, align))
    assert n_spans == (len(JA.plan_silence_chunks(wav, 8000)) if align == "silence" else 5)
    assert n_spans > 3  # more than one batch of windows
    rng = np.random.default_rng(4)
    x_inits = [rng.integers(0, K, (min(3, n_spans - s), 8)) for s in range(0, n_spans, 3)]
    j_queue, t_queue = _inject(monkeypatch, jp, tp, x_inits)
    for p in (jp, tp):
        p.use_condition_mask = True
    try:
        want = jax_cli.infer_long(jp, path, argparse.Namespace(**vars(args)), jax.random.key(0))
        got = cli.infer_long(tp, path, args, torch.Generator().manual_seed(0))
    finally:
        for p in (jp, tp):
            p.use_condition_mask = False
    assert not j_queue and not t_queue
    assert set(got) == set(want) and len(got["chunks"]) == len(want["chunks"]) == n_spans
    assert got == want
