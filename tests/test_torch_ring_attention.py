# -*- coding: utf-8 -*-
"""The port's sequence-parallel ring attention against the JAX package's.

`fddm_asr_tpu_torch/ops/ring_attention.ring_gated_attention` runs in a
four-process gloo group on the CPU (`tests/torch_parallel_worker.py`,
started once for the module): at ring 4 over the world and at ring 2 over
ranks {0, 1}, each rank on its block of frames, on inputs drawn here from a
seed.  Its output blocks and the gradients of sum(out * dout) in q, k, v,
the bias rows and the gate, put back together, are held against the JAX
`ring_gated_attention` on a mesh of as many virtual CPU devices and against
`wavlm_gated_attention_xla`, unsharded, with jax.grad: within rtol and atol
2e-5 (`tests/test_ring_attention.py`'s tolerance), for key masks that keep
every key, ragged ones, and one whose second row keeps none (the uniform
average of the XLA softmax).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from fddm_asr_tpu.ops.flash_attention import wavlm_gated_attention_xla
from fddm_asr_tpu.ops.ring_attention import ring_gated_attention as jax_ring
from tests.torch_parallel_worker import collect, launch

B, L, H, DH = 2, 32, 2, 8
CASES = ("unmasked", "masked", "all-masked")
TOL = dict(rtol=2e-5, atol=2e-5)
# how the workers' blocks join: frames on axis 1, the gate's on axis 2
JOIN = {"out": 1, "dq": 1, "dk": 1, "dv": 1, "dbias": 1, "dgate": 2}


def _inputs(name, seed):
    rng = np.random.default_rng(seed)
    normal = lambda *shape: rng.standard_normal(shape).astype(np.float32)  # noqa: E731
    mask = np.ones((B, L), bool)
    if name == "masked":
        mask = np.arange(L)[None, :] < rng.integers(L // 4, L, size=B)[:, None]
    elif name == "all-masked":
        mask[1, :] = False
    return {"q": normal(B, L, H, DH), "k": normal(B, L, H, DH), "v": normal(B, L, H, DH),
            "bias": 0.5 * normal(H, L, L),
            "gate": rng.uniform(0.5, 2.0, (B, H, L)).astype(np.float32),
            "mask": mask, "dout": normal(B, L, H, DH)}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The four workers' outputs ({case/ringN: {out, dq, ...}} a rank) and
    the inputs."""
    root = str(tmp_path_factory.mktemp("ring"))
    inputs = {name: _inputs(name, seed) for seed, name in enumerate(CASES)}
    torch.save({name: {k: torch.from_numpy(v) for k, v in case.items()}
                for name, case in inputs.items()}, os.path.join(root, "ring_inputs.pt"))
    return collect(launch("ring", root, 4), "ring", root), inputs


def _jax_grads(fn, case):
    """fn's output and the gradients of sum(out * dout) in q, k, v, bias, gate."""
    def loss(q, k, v, bias, gate):
        return jnp.sum(fn(q, k, v, bias, gate, jnp.asarray(case["mask"])) * case["dout"])

    args = [jnp.asarray(case[k]) for k in ("q", "k", "v", "bias", "gate")]
    out = fn(*args, jnp.asarray(case["mask"]))
    grads = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(*args)
    return dict(zip(("out", "dq", "dk", "dv", "dbias", "dgate"),
                    (np.asarray(x) for x in (out, *grads))))


@pytest.mark.parametrize("ring", [2, 4])
@pytest.mark.parametrize("name", CASES)
def test_ring_matches_jax_ring_and_xla(ranks, name, ring):
    outputs, inputs = ranks
    case = inputs[name]
    key = f"{name}/ring{ring}"
    got = {k: torch.cat([o[key][k] for o in outputs[:ring]], dim=axis).numpy()
           for k, axis in JOIN.items()}
    mesh = Mesh(np.array(jax.devices()[:ring]).reshape(1, ring), ("data", "model"))
    want_ring = _jax_grads(lambda *a: jax_ring(*a, mesh=mesh, axis="model", batch_axis=None),
                           case)
    want_xla = _jax_grads(wavlm_gated_attention_xla, case)
    for what in JOIN:
        np.testing.assert_allclose(got[what], want_ring[what], err_msg=f"{what} vs JAX ring",
                                   **TOL)
        np.testing.assert_allclose(got[what], want_xla[what], err_msg=f"{what} vs XLA", **TOL)
    if name == "all-masked":  # the uniform average of the values
        np.testing.assert_allclose(got["out"][1], np.broadcast_to(
            case["v"][1].mean(axis=0), got["out"][1].shape), **TOL)


def test_both_rings_of_two_give_the_same_blocks(ranks):
    """Rings {0, 1} and {2, 3} ran the same cases on their own: rank r and
    rank r + 2 hold the same results, bit for bit."""
    outputs, _ = ranks
    for key in outputs[0]:
        if key.endswith("ring2"):
            for k in JOIN:
                assert torch.equal(outputs[0][key][k], outputs[2][key][k]), (key, k)
