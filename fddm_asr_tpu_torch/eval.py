# -*- coding: utf-8 -*-
"""Transcript decoding, CER/WER, per-utterance confidence and the dataset evaluators.

Counterpart of `fddm_asr_tpu/eval.py`.  The decoded span of an id row is
the positions before the first eos that are neither pad nor bos: exactly
the ids `ids_to_text` keeps, and the ids confidence and logprob voting
score.

Evaluators take any iterable of batches with `.wave`, `.wave_lengths` and
`.tokens` ([B, L] reference ids), and a `torch.Generator` where the JAX
package takes a key: one step generator is split off per batch (per sample
for multi-sample) as the JAX package splits its key, so a seed gives the
same draws batch after batch.  As there, `evaluate_validation_loss` keeps
the reference's degenerate t = 1, x_t = x_0 (its value is part of the log
format) and `evaluate_validation_kl_sampled` is the meaningful one.  Only
ids (and, for logprob voting, the chosen tokens' p, [B, L]) leave the
device; p_x0 [B, L, K] does not.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch

from fddm_asr_tpu_torch import diffusion as D
from fddm_asr_tpu_torch.sampler import split_generator

__all__ = [
    "calculate_cer", "calculate_wer", "ids_to_text", "logits_to_text", "batch_confidence",
    "decoded_span_mask", "utterance_confidence", "evaluate_validation_loss",
    "evaluate_validation_kl_sampled", "evaluate_cer_with_full_sampling",
    "evaluate_cer_with_jumpy_sampling", "evaluate_wer_with_jumpy_sampling",
    "evaluate_cer_with_multi_sample",
]


def _levenshtein(ref: Sequence, hyp: Sequence) -> int:
    """Edit distance over characters (strings) or words (lists), one numpy
    row at a time: a row's substitutions and deletions come from the row
    above as vectors, and its insertions as a running minimum along the
    row, min_k<=j (d[k] + j - k)."""
    if isinstance(ref, str) and isinstance(hyp, str):
        a = np.frombuffer(ref.encode("utf-32-le"), np.uint32)
        b = np.frombuffer(hyp.encode("utf-32-le"), np.uint32)
    else:  # words interned to ids shared by both sides
        vocab: Dict = {}
        a = np.asarray([vocab.setdefault(w, len(vocab)) for w in ref], np.int64)
        b = np.asarray([vocab.setdefault(w, len(vocab)) for w in hyp], np.int64)
    n, m = len(a), len(b)
    if n == 0 or m == 0:
        return n + m
    j = np.arange(m + 1, dtype=np.int64)
    prev = j.copy()
    row = np.empty(m + 1, np.int64)
    for i in range(1, n + 1):
        row[0] = i
        np.minimum(prev[:-1] + (b != a[i - 1]), prev[1:] + 1, out=row[1:])
        prev = np.minimum.accumulate(row - j) + j
    return int(prev[-1])


def calculate_cer(ref: str, hyp: str) -> float:
    """Character error rate; an empty reference scores 0.0 against an empty
    hypothesis and 1.0 against any other."""
    if len(ref) == 0:
        return 0.0 if len(hyp) == 0 else 1.0
    return _levenshtein(ref, hyp) / float(len(ref))


def calculate_wer(ref: str, hyp: str) -> float:
    """Word error rate over whitespace-split words; 0.0 for an empty reference."""
    r = ref.strip().split()
    h = hyp.strip().split()
    if len(r) == 0:
        return 0.0
    return _levenshtein(r, h) / float(len(r))


def ids_to_text(ids: Sequence[int], tokenizer, pad_id: int,
                bos_id: Optional[int] = None, eos_id: Optional[int] = None) -> str:
    """Filter specials (skip pad/bos, stop at eos), then decode."""
    clean: List[int] = []
    for tid in np.asarray(ids).tolist():
        if tid == pad_id:
            continue
        if bos_id is not None and tid == bos_id:
            continue
        if eos_id is not None and tid == eos_id:
            break
        clean.append(int(tid))
    return tokenizer.DecodeIds(clean)


def logits_to_text(logits, tokenizer, pad_id, bos_id=None, eos_id=None) -> List[str]:
    """Argmax over the last axis of [B, L, K] logits, each row decoded."""
    pred = torch.as_tensor(logits).argmax(dim=-1).cpu().numpy()
    return [ids_to_text(row, tokenizer, pad_id, bos_id, eos_id) for row in pred]


def batch_confidence(ids: torch.Tensor, p: torch.Tensor, pad_id: int,
                     special_ids: Dict[str, Optional[int]]) -> torch.Tensor:
    """Per-utterance confidence on the tensors' device: [B, L] ids + [B, L, K]
    p_x0 -> [B], the geometric-mean probability (final-step p_x0) of the
    emitted tokens over the decoded span, 0.0 when nothing was decoded
    (`utterance_confidence`, batched so p_x0 never leaves the device)."""
    tok_p = torch.gather(p, -1, ids[..., None])[..., 0]
    eos = special_ids.get("eos_id")
    if eos is not None:
        valid = torch.cumsum((ids == eos).long(), dim=-1) == 0  # strictly before eos
    else:
        valid = torch.ones_like(ids, dtype=torch.bool)
    valid = valid & (ids != pad_id)
    bos = special_ids.get("bos_id")
    if bos is not None:
        valid = valid & (ids != bos)
    n = valid.sum(dim=-1)
    logs = torch.where(valid, tok_p.clamp(min=1e-12).log(), torch.zeros_like(tok_p))
    mean = logs.sum(dim=-1) / n.clamp(min=1)
    return torch.where(n > 0, mean.exp(), torch.zeros_like(mean))


def decoded_span_mask(ids_row, pad_id: int,
                      special_ids: Dict[str, Optional[int]]) -> np.ndarray:
    """Boolean mask of the decoded span of one id row: positions before the
    first eos that are neither pad nor bos."""
    ids_row = np.asarray(ids_row)
    end = len(ids_row)
    eos = special_ids.get("eos_id")
    if eos is not None:
        hits = np.nonzero(ids_row == eos)[0]
        if hits.size:
            end = int(hits[0])
    valid = np.zeros(len(ids_row), bool)
    valid[:end] = True
    valid &= ids_row != pad_id
    bos = special_ids.get("bos_id")
    if bos is not None:
        valid &= ids_row != bos
    return valid


def utterance_confidence(ids_row, p_row, pad_id: int,
                         special_ids: Dict[str, Optional[int]]) -> float:
    """Host form of `batch_confidence` for one row ([L] ids, [L, K] p_x0)."""
    ids_row = np.asarray(ids_row)
    tok_p = np.asarray(p_row)[np.arange(len(ids_row)), ids_row]
    valid = decoded_span_mask(ids_row, pad_id, special_ids)
    if not valid.any():
        return 0.0
    return float(np.exp(np.log(np.maximum(tok_p[valid], 1e-12)).mean()))


def _decoded_span_logprob_mean(ids_row, tok_p, pipeline) -> float:
    """Mean log p(token) over the decoded span ([L] ids, [L] chosen-token
    p); an empty span scores -inf so a sample with content wins."""
    valid = decoded_span_mask(ids_row, pipeline.pad_id, pipeline.special_ids)
    if not valid.any():
        return -np.inf
    return float(np.log(np.maximum(np.asarray(tok_p)[valid], 1e-20)).mean())


# --------------------------------------------------------------- evaluators
def _root_generator(generator: Optional[torch.Generator]) -> torch.Generator:
    return generator if generator is not None else torch.Generator().manual_seed(0)


def _batch_tokens(pipeline, batch) -> torch.Tensor:
    return torch.as_tensor(np.asarray(batch.tokens), device=pipeline.device).long()


def evaluate_validation_loss(pipeline, batches: Iterable) -> float:
    """Mean KL at t = 1 with x_t = x_0: the reference's degenerate
    validation loss, batch means weighted by batch size."""
    total, count = 0.0, 0
    for batch in batches:
        c, c_mask = pipeline.encode_waveform(batch.wave, batch.wave_lengths)
        x0 = _batch_tokens(pipeline, batch)
        B = x0.shape[0]
        t = torch.ones(B, dtype=torch.long, device=x0.device)
        x_mask = x0 != pipeline.pad_id
        with torch.inference_mode():
            logits = pipeline.decoder_forward(x0, t, c, x_mask, c_mask)
            loss = D.kl_term(pipeline.sched, x0, x0, logits, t, x_mask)
        total += float(loss) * B
        count += B
    return total / count if count else 0.0


def evaluate_validation_kl_sampled(pipeline, batches: Iterable,
                                   generator: Optional[torch.Generator] = None,
                                   mask_pad_loss: bool = True) -> float:
    """The training objective's KL on held-out batches: t ~ U{1..T} per
    example and x_t ~ q(x_t | x_0) (`kl_term_sparse`), from a fixed seed by
    default so successive evaluations compare.  Per batch, t and x_t each
    come from a step generator split off `generator`."""
    gen = _root_generator(generator)
    sched = pipeline.sched
    total, count = 0.0, 0
    for batch in batches:
        g_t = split_generator(gen, pipeline.device)
        g_q = split_generator(gen, pipeline.device)
        c, c_mask = pipeline.encode_waveform(batch.wave, batch.wave_lengths)
        x0 = _batch_tokens(pipeline, batch)
        B = x0.shape[0]
        t = torch.randint(1, sched.T + 1, (B,), generator=g_t, device=x0.device)
        xt = D.sample_xt_tokens(sched, x0, t, generator=g_q)
        x_mask = x0 != pipeline.pad_id
        loss_mask = x_mask if mask_pad_loss else torch.ones_like(x_mask)
        with torch.inference_mode():
            logits = pipeline.decoder_forward(xt, t, c, x_mask, c_mask)
            loss = D.kl_term_sparse(sched, xt, x0, logits, t, loss_mask)
        total += float(loss) * B
        count += B
    return total / count if count else 0.0


def _sampling_config_from_cfg(cfg, overrides: Optional[Dict] = None) -> Dict:
    """Sampler keywords from `cfg.inference` (T_infer 20, r 5, greedy,
    posterior_mode "map", exact, temperature 1, repeat_penalty 0 where it
    says nothing), then the non-None `overrides`."""
    inf = cfg.get("inference", {}) if cfg is not None else {}
    sc = {
        "T_infer": inf.get("T_infer", 20),
        "r": inf.get("r", 5),
        "greedy": inf.get("greedy", True),
        "posterior_mode": inf.get("posterior_mode", "map"),
        "sampling_mode": inf.get("sampling_mode", "exact"),
        "temperature": inf.get("temperature", 1.0),
        "repeat_penalty": float(inf.get("repeat_penalty", 0.0)),
    }
    if overrides:
        sc.update({k: v for k, v in overrides.items() if v is not None})
    return sc


def _refs(pipeline, batch) -> List[str]:
    tokens = np.asarray(batch.tokens)
    return [pipeline.ids_to_text(tokens[i]) for i in range(tokens.shape[0])]


def evaluate_cer_with_full_sampling(pipeline, batches: Iterable, cfg=None,
                                    sampling_config: Optional[Dict] = None,
                                    generator: Optional[torch.Generator] = None,
                                    metric: Callable[[str, str], float] = calculate_cer
                                    ) -> float:
    """Mean `metric` (CER) of batched jumpy-sampling transcripts against the
    decoded reference ids, per utterance; seq_len is the batch's L."""
    sc = _sampling_config_from_cfg(cfg, sampling_config)
    gen = _root_generator(generator)
    total, count = 0.0, 0
    for batch in batches:
        step = split_generator(gen, pipeline.device)
        c, c_mask = pipeline.encode_waveform(batch.wave, batch.wave_lengths)
        L = np.asarray(batch.tokens).shape[1]
        x_pred = pipeline.sample(c, L, c_mask, generator=step, **sc)[0].cpu().numpy()
        hyps = [pipeline.ids_to_text(x_pred[i]) for i in range(x_pred.shape[0])]
        for ref, hyp in zip(_refs(pipeline, batch), hyps):
            total += metric(ref, hyp)
            count += 1
    return total / count if count else 0.0


def evaluate_cer_with_jumpy_sampling(pipeline, batches, cfg=None, generator=None) -> float:
    return evaluate_cer_with_full_sampling(pipeline, batches, cfg, None, generator)


def evaluate_wer_with_jumpy_sampling(pipeline, batches, cfg=None, generator=None) -> float:
    sc = _sampling_config_from_cfg(cfg, {"greedy": True, "posterior_mode": "map"})
    return evaluate_cer_with_full_sampling(pipeline, batches, cfg, sc, generator,
                                           metric=calculate_wer)


def evaluate_cer_with_multi_sample(pipeline, batches, cfg=None, sampling_config=None,
                                   num_samples: int = 3,
                                   generator: Optional[torch.Generator] = None,
                                   voting: str = "first") -> float:
    """`num_samples` non-greedy samples per utterance, one voted transcript:
    "first" takes sample 0 (the reference's stubbed vote), "majority" the
    most frequent id per position (ties to the smallest id, as np.unique
    orders), "logprob" the whole sample with the highest mean log p over
    its decoded span (ties to the earliest sample).  Where
    `sampling_config` is None the reference's own defaults r = 2 and
    posterior_mode "average" apply (from cfg.inference where set); a given
    sampling_config, even a partial one, falls through to the generic
    defaults instead."""
    if sampling_config is None:
        inf = cfg.get("inference", {}) if cfg is not None else {}
        sampling_config = {"r": inf.get("r", 2),
                           "posterior_mode": inf.get("posterior_mode", "average")}
    sc = _sampling_config_from_cfg(cfg, sampling_config)
    sc["greedy"] = False
    gen = _root_generator(generator)
    total, count = 0.0, 0
    for batch in batches:
        c, c_mask = pipeline.encode_waveform(batch.wave, batch.wave_lengths)
        L = np.asarray(batch.tokens).shape[1]
        preds, scores = [], []
        for _ in range(num_samples):
            step = split_generator(gen, pipeline.device)
            ids, p = pipeline.sample(c, L, c_mask, generator=step, **sc)
            x_pred = ids.cpu().numpy()
            preds.append(x_pred)
            if voting == "logprob":
                tok_p = torch.gather(p, -1, ids[..., None].long())[..., 0].float().cpu().numpy()
                scores.append(np.asarray([_decoded_span_logprob_mean(x_pred[b], tok_p[b],
                                                                     pipeline)
                                          for b in range(x_pred.shape[0])]))
        if voting == "majority":
            stacked = np.stack(preds)                            # [N, B, L]

            def _mode(col):
                vals, counts = np.unique(col, return_counts=True)
                return vals[np.argmax(counts)]

            chosen = np.apply_along_axis(_mode, 0, stacked)
        elif voting == "logprob":
            stacked = np.stack(preds)
            best = np.argmax(np.stack(scores), axis=0)           # [B]
            chosen = stacked[best, np.arange(stacked.shape[1])]
        else:
            chosen = preds[0]
        hyps = [pipeline.ids_to_text(chosen[i]) for i in range(chosen.shape[0])]
        for ref, hyp in zip(_refs(pipeline, batch), hyps):
            total += calculate_cer(ref, hyp)
            count += 1
    return total / count if count else 0.0
