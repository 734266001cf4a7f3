# -*- coding: utf-8 -*-
"""AOT artifacts on the card: each bucket replayed as a CUDA graph
(`fddm_asr_tpu_torch/aot.py`) against the same program run eagerly.

Marked `cuda`: skips on a host without a GPU.  This file imports no JAX, so
it also runs on the GPU machine, where JAX is absent and the tests'
conftest.py (which imports JAX) has to be left out:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_aot_cuda.py

A small bfloat16 model whose WavLM heads are 64 wide (so attention takes
the gated-attention kernel), and the same under `quant_dense: int8_fused`
and `fused_frontend` (the fused int8 matmul and conv kernels), exported at
two lengths: a replay gives the eager program's ids and confidences bit for
bit, two calls in flight on one bucket keep their own outputs, and a bucket
captured before another length's still reads its position-bias table."""
import numpy as np
import pytest
import torch

from fddm_asr_tpu_torch import aot
from fddm_asr_tpu_torch.config import Config
from fddm_asr_tpu_torch.ops import kernel_wrappers
from fddm_asr_tpu_torch.pipeline import FDDMPipeline
from fddm_asr_tpu_torch.tokenizer import load_tokenizer

K, SEQ_LEN = 64, 16
BUCKETS = [(2, 8000), (4, 8000), (2, 16000)]  # two lengths: 24 and 49 frames
SAMPLING = dict(T_infer=20, r=5, greedy=True, posterior_mode="map")
WAVLM = {"hidden_size": 128, "num_attention_heads": 2, "intermediate_size": 256}
FUSED = {**WAVLM, "quant_dense": "int8_fused", "fused_frontend": True, "gelu_approx_tanh": True}


@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    return torch.device("cuda")


@pytest.fixture(scope="module", params=["plain", "int8_fused"])
def loaded(request, cuda_device, tmp_path_factory):
    """(live pipeline on the card, the artifact loaded with its graphs)."""
    tmp = tmp_path_factory.mktemp(f"aot_cuda_{request.param}")
    vocab = tmp / "spm.vocab"
    vocab.write_text("\n".join(["<unk>\t0", "<s>\t0", "</s>\t0", "<pad>\t0"] + [
        f"{chr(0x4E00 + i)}\t{-(i + 1)}" for i in range(K - 4)]) + "\n", encoding="utf-8")
    cfg = Config({
        "seed": 0,
        "data": {"vocab_size": K, "pad_id": 3, "bos_id": 1, "eos_id": 2},
        "model": {"d_model": 96, "nhead": 4, "num_layers": 2, "dim_ff": 192,
                  "dtype": "bfloat16",
                  "encoder": {"wavlm_name": "tiny", "proj": "linear",
                              "wavlm_config": WAVLM if request.param == "plain" else FUSED}},
        "diffusion": {"T": 200, "beta_max": 0.2},
    })
    pipe = FDDMPipeline.from_config(cfg, tokenizer=load_tokenizer(str(vocab)), device="cuda",
                                    use_condition_mask=True)
    art = str(tmp / "artifact")
    aot.save_artifact(pipe, art, BUCKETS, seq_len=SEQ_LEN, sampling=SAMPLING,
                      tokenizer_path=str(vocab))
    return pipe, aot.ExportedPipeline.load(art), request.param


def _batch(rows, samples, seed):
    rng = np.random.default_rng(seed)
    wave = (0.3 * rng.standard_normal((rows, samples))).astype(np.float32)
    lengths = rng.integers(samples // 2, samples + 1, rows)
    return wave, lengths


def _eager(ep, bucket, wave, lengths, seed):
    """The bucket's program run eagerly (no graph) on the inputs a replay
    takes: the padded batch, its lengths and x_T from the seed."""
    b, n = bucket
    rows, samples = wave.shape
    x_T = torch.randint(0, K, (b, SEQ_LEN), device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(seed))
    wave_p = torch.zeros(b, n, device="cuda")
    wave_p[:rows, :samples] = torch.from_numpy(wave)
    len_p = torch.full((b,), 400, dtype=torch.long, device="cuda")
    len_p[:rows] = torch.from_numpy(lengths)
    with torch.inference_mode():
        ids, _p, conf = ep._call(bucket, (x_T, wave_p, len_p))
    return ids[:rows].cpu(), conf[:rows].cpu()


def _graph_dot(graph, path) -> str:
    """The captured graph's DOT dump, one line a node (a kernel node's line
    holds its mangled name)."""
    graph.debug_dump(str(path))
    return path.read_text()


@pytest.mark.cuda
def test_every_bucket_is_a_graph_whose_replay_equals_the_eager_program(loaded, tmp_path):
    pipe, ep, name = loaded
    assert set(ep.native) == set(BUCKETS)
    wrappers = kernel_wrappers()
    layers = pipe.encoder.config.num_hidden_layers
    for i, (b, n) in enumerate(BUCKETS):
        wave, lengths = _batch(b - 1, n - 100, seed=i)  # padded into the bucket
        before = {k: w.launches for k, w in wrappers.items()}
        got = ep.transcribe_with_ids(wave, lengths, seed=i, with_confidence=True)
        launched = {k: w.launches - before[k] for k, w in wrappers.items()}
        ids, conf = _eager(ep, (b, n), wave, lengths, seed=i)
        assert [g[1] for g in got] == ids.tolist()
        assert torch.equal(torch.tensor([g[2] for g in got]), conf)
        # the replay's launches are counted: B1 once a layer (B7 six, B8 six a call)
        assert launched["fwd"] == layers
        if name == "int8_fused":
            assert launched["int8_matmul_fused"] == 6 * layers
            assert launched["conv_ln_gelu"] == 6
        # the graph itself holds those kernels as nodes
        dot = _graph_dot(ep.native[(b, n)].graph, tmp_path / f"b{b}_n{n}.dot")
        nodes = {k: sum(kernel in x for x in dot.splitlines()) for k, kernel in (
            ("fwd", "gated_attention_bf16_kernel"),
            ("int8_matmul_fused", "int8_matmul_fused_kernel"),
            ("conv_ln_gelu", "conv_ln_gelu_bf16_kernel"))}
        assert nodes == {k: launched[k] for k in nodes}
        # and the live pipeline at the same padded batch gives the same ids
        padded = np.zeros((b, n), np.float32)
        padded[: b - 1, : n - 100] = wave
        live = pipe.transcribe_with_ids(
            padded, np.concatenate([lengths, [400]]), seq_len=SEQ_LEN,
            generator=torch.Generator(device="cuda").manual_seed(i), **SAMPLING)
        assert [g[1] for g in got] == [r[1] for r in live[: b - 1]]


@pytest.mark.cuda
def test_two_calls_in_flight_on_one_bucket_keep_their_outputs(loaded):
    _, ep, _ = loaded
    (w1, l1), (w2, l2) = _batch(2, 8000, seed=10), _batch(2, 8000, seed=11)
    want1 = ep.transcribe_with_ids(w1, l1, seed=1, with_confidence=True)
    want2 = ep.transcribe_with_ids(w2, l2, seed=2, with_confidence=True)
    fin1 = ep.transcribe_with_ids_async(w1, l1, seed=1, with_confidence=True)
    fin2 = ep.transcribe_with_ids_async(w2, l2, seed=2, with_confidence=True)
    assert fin2() == want2 and fin1() == want1
    assert want1 != want2


@pytest.mark.cuda
def test_a_bucket_captured_before_another_length_still_reads_its_bias_table(loaded):
    """Both lengths were captured; the live pipeline then builds tables of
    other lengths; the first bucket's replay still equals its eager run."""
    pipe, ep, _ = loaded
    wave, lengths = _batch(2, 8000, seed=20)
    first = ep.transcribe_with_ids(wave, lengths, seed=3, with_confidence=True)
    ep.transcribe_with_ids(*_batch(2, 16000, seed=21), seed=4)
    for samples in (4000, 12000, 24000):
        pipe.transcribe_with_ids(_batch(1, samples, seed=22)[0], seq_len=SEQ_LEN, **SAMPLING)
    torch.cuda.empty_cache()
    again = ep.transcribe_with_ids(wave, lengths, seed=3, with_confidence=True)
    ids, conf = _eager(ep, (2, 8000), wave, lengths, seed=3)
    assert again == first
    assert [g[1] for g in again] == ids.tolist()
