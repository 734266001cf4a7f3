# -*- coding: utf-8 -*-
"""The port's manifest dataset and batcher (`fddm_asr_tpu_torch.data.dataset`)
against the JAX package's: every batch bit-identical (waves, lengths,
tokens, indices) for shuffled and ordered epochs, several (seed, epoch),
`drop_last` on and off, both `shard` layouts, and bos/eos with truncation
at max_len; `shard_example_count` equal over a grid.  Also: a worker's
failure is raised in the consumer, and a consumer that leaves early leaves
no producer thread behind."""
import json
import threading

import numpy as np
import pytest

from fddm_asr_tpu.data.dataset import ManifestDataset as JaxDataset
from fddm_asr_tpu.data.dataset import make_batches as jax_make_batches
from fddm_asr_tpu.data.dataset import shard_example_count as jax_shard_example_count
from fddm_asr_tpu.tokenizer import load_tokenizer as jax_load_tokenizer
from fddm_asr_tpu_torch.data import dataset as TD
from fddm_asr_tpu_torch.data.audio_io import save_wav
from fddm_asr_tpu_torch.tokenizer import load_tokenizer

N = 11  # examples: odd, so drop_last and the shards leave remainders
SENTENCES = ["我們可以一起交流", "台灣的高速公路很大", "", "高速公路可以交流道"]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """N clips of 0.1-0.4 s (one longer than max_seconds, so it is cut) and
    a manifest with one missing clip, texts under `text`, `sentence` and
    `normalized_sentence`, and the toy tokenizer."""
    from scripts.make_synth_data import main as make

    root = tmp_path_factory.mktemp("corpus")
    make(["--out", str(root / "toy"), "--n", "1", "--seconds", "0.05"])
    tok = str(root / "toy/data/tokenizer/toy/spm_toy.model")
    rng = np.random.default_rng(0)
    records = []
    for i in range(N + 1):
        path = str(root / f"clip{i:02d}.wav")
        if i != 4:  # clip 4 is missing: the dataset leaves it out
            seconds = 0.5 if i == 7 else float(rng.uniform(0.1, 0.4))
            save_wav(path, (0.2 * rng.standard_normal(int(16000 * seconds))).astype(np.float32),
                     16000)
        key = ("text", "sentence", "normalized_sentence")[i % 3]
        records.append({"processed_path": path, key: SENTENCES[i % len(SENTENCES)]})
    manifest = str(root / "train.json")
    with open(manifest, "w", encoding="utf-8") as f:
        json.dump(records, f, ensure_ascii=False)
    return manifest, tok


def _datasets(corpus, **kw):
    manifest, tok = corpus
    args = dict(max_len=kw.pop("max_len", 12), pad_id=3, max_audio_seconds=0.45, **kw)
    return (JaxDataset(manifest, jax_load_tokenizer(tok), **args),
            TD.ManifestDataset(manifest, load_tokenizer(tok), **args))


def _fields(b):
    return (np.asarray(b.wave), b.wave_lengths, b.tokens, b.token_lengths, b.indices)


@pytest.mark.parametrize("kw", [
    dict(shuffle=False),
    dict(shuffle=True, seed=3, epoch=1),
    dict(shuffle=True, seed=3, epoch=2),
    dict(shuffle=True, seed=5, epoch=1, drop_last=False),
    dict(shuffle=True, seed=3, epoch=1, shard=(0, 2)),
    dict(shuffle=True, seed=3, epoch=1, shard=(1, 2)),
    dict(shuffle=True, seed=3, epoch=4, shard=(2, 3), drop_last=False),
    dict(shuffle=False, shard=(1, 3), drop_last=False),
], ids=["ordered", "s3e1", "s3e2", "s5e1-keep-last", "shard0of2", "shard1of2",
        "shard2of3-keep-last", "ordered-shard1of3-keep-last"])
def test_batches_bit_identical_to_jax(corpus, kw):
    jds, tds = _datasets(corpus)
    assert len(tds) == len(jds) == N
    want = list(jax_make_batches(jds, 2, num_workers=3, **kw))
    got = list(TD.make_batches(tds, 2, num_workers=3, **kw))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        for a, b in zip(_fields(g), _fields(w)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    n = sum(len(b.indices) for b in got)
    assert n == TD.shard_example_count(N, 2, kw.get("shard"), kw.get("drop_last", True))


def test_bos_eos_truncation_and_text_order(corpus):
    jds, tds = _datasets(corpus, bos_id=1, eos_id=2, max_len=5)
    for i in range(len(tds)):
        j, t = jds[i], tds[i]
        for key in j:
            np.testing.assert_array_equal(t[key], j[key])
    assert tds[0]["tokens"][0] == 1 and int(tds[0]["token_length"]) == 5
    for item in ({"text": "", "sentence": "b", "normalized_sentence": "c"},
                 {"normalized_sentence": "c"}, {"text": "a", "sentence": "b"}, {}):
        assert TD.ManifestDataset.text_of(item) == JaxDataset.text_of(item)


def test_shard_example_count_equals_jax():
    for n in range(0, 23):
        for bs in (1, 2, 3, 5):
            for shard in (None, (0, 1), (0, 2), (1, 2), (0, 3), (2, 3)):
                for drop_last in (False, True):
                    assert TD.shard_example_count(n, bs, shard, drop_last) == \
                        jax_shard_example_count(n, bs, shard, drop_last), (n, bs, shard)


def _producers():
    return [t for t in threading.enumerate() if t.name == "make_batches" and t.is_alive()]


def test_worker_failure_raises_in_the_consumer(corpus):
    _, tds = _datasets(corpus)

    class Failing(TD.ManifestDataset):
        def __getitem__(self, idx):
            if idx == 6:
                raise OSError("clip deleted")
            return super().__getitem__(idx)

    failing = Failing.__new__(Failing)
    failing.__dict__.update(tds.__dict__)
    seen = []
    with pytest.raises(RuntimeError, match="worker failed") as info:
        for b in TD.make_batches(failing, 2, num_workers=2):
            seen.append(b)
    assert isinstance(info.value.__cause__, OSError)
    assert len(seen) == 3  # the batches before the failing one came through
    assert not _producers()


def test_a_consumer_that_leaves_early_leaves_no_thread(corpus):
    _, tds = _datasets(corpus)
    it = TD.make_batches(tds, 1, num_workers=2, prefetch=1)
    next(it)
    assert _producers()  # the producer is ahead, blocked on the full queue
    it.close()
    assert not _producers()
    for i, _ in enumerate(TD.make_batches(tds, 1, num_workers=2, prefetch=1)):
        if i == 2:
            break  # the generator is closed when the loop drops it
    assert not _producers()
