# -*- coding: utf-8 -*-
"""The float32 backward kernels' arithmetic (B4 and B5 in f32), emulated on the CPU.

`csrc/gated_attention_bwd.cu` runs float32 B4 as one 3xTF32 kernel,
`bwd_dq_tf32x3_kernel`: one block per (batch row, head, 128 queries) that
walks 32-key steps, both halves of each 64-key tile holding a kept key (a
half wholly past L excepted): S = Q K^T and dP = dO V^T, P in the log2
domain, dS = P (dP - delta) at kept keys and 0 elsewhere by a select,
dgate += dS bias (each thread's keys 8j + 2t, 8j + 2t + 1 of a step in
order, then the quad's four sums by shuffles), and each step's dQ = dS K in
an accumulator of its own, added to a running f32 sum.  It runs float32 B5
as two 3xTF32 kernels:
(a) `bwd_dkv_tf32x3_kernel`, one block per (64-key tile, head, batch row)
walking the queries in steps of 32: S^T = K Q^T and dP^T = V dO^T, P^T and
dS^T in the log2 domain, then each step's dV = P^T dO and dK = dS^T Q in an
accumulator of its own, added to a running f32 sum; its two consumer
warpgroups take the even and the odd steps and add their sums at the end.
(b) `bwd_dbias_tf32x3_kernel`, one block per (64-key tile, 64-query tile,
head) that recomputes S and dP for each batch row keeping a key of the
tile, and sums dS gate over those rows, the even ones in one consumer and
the odd ones in the other, then the two sums.  Every operand is split into
tf32 hi = rna(x) and lo = rna(x - hi) and each product is hi.hi + hi.lo +
lo.hi with f32 sums; P, dS, delta and the gate stay f32.

Here that arithmetic, in torch on the CPU, is held against the JAX
package's `_train_backward` in float32 (Pallas interpret mode) on a ragged
and a full row, and against jax.grad of `wavlm_gated_attention_xla` with an
all-masked row as well (where the TPU kernels differ from the exact
gradient; there dq = dgate = 0), at L = 203, within 1e-5 of each
reference's largest magnitude; and plain 1xTF32 (hi.hi alone) misses that
tolerance.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fddm_asr_tpu.ops.flash_attention import (
    _train_backward,
    _train_forward,
    wavlm_gated_attention_xla,
)
from fddm_asr_tpu_torch.ops import flash_attention as FA
from test_torch_tf32_split import product

H, DH, L = 2, 64, 203
TOL = 1e-5
NEG = torch.finfo(torch.float32).min
LOG2E = 1.4426950408889634
KEY_TILE, QUERY_STEP = 64, 32
DQ_KEY_STEP = 32  # B4's keys a step


def emulated_dq(q, k, v, bias, gate, mask, lse, delta, dout, terms):
    """Kernel A (B4) on [B, H, L, dh] operands: dq [B, H, L, dh], dgate [B, H, L]."""
    n = q.shape[2]
    sl2 = 0.125 * LOG2E
    dq = torch.zeros_like(q)
    dgate = torch.zeros(gate.shape)
    for b in range(q.shape[0]):
        steps = [k0 + half for k0 in range(0, n, KEY_TILE) if bool(mask[b, k0:k0 + KEY_TILE].any())
                 for half in (0, DQ_KEY_STEP) if k0 + half < n]
        acc = torch.zeros_like(q[b])
        partial = torch.zeros(4, *gate.shape[1:], dtype=torch.float64)  # a sum per thread t
        for k0 in steps:
            ks = slice(k0, k0 + DQ_KEY_STEP)
            s = product(q[b], k[b, :, ks].transpose(-1, -2), terms)   # [H, query, key]
            dp = product(dout[b], v[b, :, ks].transpose(-1, -2), terms)
            p = torch.exp2(s * sl2 + (gate[b, :, :, None] * LOG2E) * bias[:, :, ks]
                           - (lse[b, :, :, None] * LOG2E))
            ds = torch.where(mask[b, None, None, ks], p * (dp - delta[b, :, :, None]),
                             torch.zeros(()))
            acc = acc + product(ds, k[b, :, ks], terms)  # the step's own accumulator
            # thread t holds keys 8j + 2t and 8j + 2t + 1, j = 0 .. 3: fmaf, in order
            dsb = ds.double() * bias[:, :, ks].double()
            for j in range(4):
                for t in range(4):
                    for x in range(2):
                        c = 8 * j + 2 * t + x
                        if c < dsb.shape[-1]:
                            partial[t] = (partial[t] + dsb[..., c]).float().double()
        dq[b] = acc * 0.125
        dgate[b] = ((partial[0] + partial[1]).float() + (partial[2] + partial[3]).float())
    return dq, dgate


def emulated_dkv(q, k, v, bias, gate, mask, lse, delta, dout, terms):
    """Kernel (a) on [B, H, L, dh] operands: dk, dv [B, H, L, dh]."""
    n = q.shape[2]
    sl2 = 0.125 * LOG2E
    keep = mask[:, None, :, None]                        # [B, 1, key, 1]
    all_masked = (lse == NEG)[:, :, None, :]             # [B, H, 1, query]
    sums = [[torch.zeros_like(k) for _ in range(2)] for _ in range(2)]  # [consumer][dk, dv]
    for i, q0 in enumerate(range(0, n, QUERY_STEP)):
        sl = slice(q0, q0 + QUERY_STEP)
        st = product(k, q[:, :, sl].transpose(-1, -2), terms)      # S^T [B, H, key, query]
        dpt = product(v, dout[:, :, sl].transpose(-1, -2), terms)  # dP^T
        bias_t = bias[None, :, sl, :].transpose(-1, -2)
        p = torch.exp2(st * sl2 + (gate[:, :, None, sl] * LOG2E) * bias_t
                       - (lse[:, :, None, sl] * LOG2E))
        inv_l = torch.where(all_masked[..., sl], torch.tensor(1.0 / n), torch.tensor(0.0))
        p = torch.where(keep, p, inv_l)
        ds = torch.where(keep, p * (dpt - delta[:, :, None, sl]), torch.zeros(()))
        mine = sums[i % 2]
        mine[1] = mine[1] + product(p, dout[:, :, sl], terms)
        mine[0] = mine[0] + product(ds, q[:, :, sl], terms)
    dk = (sums[0][0] + sums[1][0]) * 0.125
    return dk, sums[0][1] + sums[1][1]


def emulated_dbias(q, k, v, bias, gate, mask, lse, delta, dout, terms):
    """Kernel (b): dbias [H, L, L], summed over the rows that keep a key of
    each 64-key tile, alternately into two sums, in the block's order."""
    n = q.shape[2]
    sl2 = 0.125 * LOG2E
    s = product(q, k.transpose(-1, -2), terms)
    dp = product(dout, v.transpose(-1, -2), terms)
    p = torch.exp2(s * sl2 + (gate[..., None] * LOG2E) * bias[None] - (lse[..., None] * LOG2E))
    keep = mask[:, None, None, :]
    p = torch.where(keep, p, torch.zeros(()))
    rows = p * (dp * gate[..., None] - delta[..., None] * gate[..., None])  # [B, H, q, k]
    dbias = torch.zeros(H, n, n)
    for k0 in range(0, n, KEY_TILE):
        ks = slice(k0, k0 + KEY_TILE)
        listed = [b for b in range(q.shape[0]) if bool(mask[b, ks].any())]
        sums = [torch.zeros(H, n, rows[:, :, :, ks].shape[-1]) for _ in range(2)]
        for i, b in enumerate(listed):
            sums[i % 2] = sums[i % 2] + rows[b, :, :, ks]
        dbias[:, :, ks] = sums[0] + sums[1]
    return dbias


def emulated(q, k, v, bias, gate, mask, dout, terms):
    """(dq, dk, dv, dbias, dgate) of the three kernels from numpy [B, L,
    H*dh] inputs; lse and delta from the port's plain forward, as the
    kernels get them."""
    t = [torch.from_numpy(x) for x in (q, k, v, bias, gate, mask, dout)]
    qt, kt, vt, bt, gt, mt, dot = t
    out, lse = FA.wavlm_gated_attention_fwd_lse_plain(qt, kt, vt, bt, gt, mt, num_heads=H)
    b = q.shape[0]
    delta = (dot * out).reshape(b, L, H, DH).sum(-1).transpose(1, 2)

    def heads(x):
        return x.reshape(b, L, H, DH).transpose(1, 2)

    args = (heads(qt), heads(kt), heads(vt), bt, gt, mt, lse, delta, heads(dot))
    dq, dgate = emulated_dq(*args, terms)
    dk, dv = emulated_dkv(*args, terms)
    dbias = emulated_dbias(*args, terms)
    packed = [x.transpose(1, 2).reshape(b, L, H * DH).numpy() for x in (dq, dk, dv)]
    return (*packed, dbias.numpy(), dgate.numpy())


def _inputs():
    rng = np.random.default_rng(15)
    q, k, v, dout = (rng.standard_normal((3, L, H * DH)).astype(np.float32) for _ in range(4))
    bias = rng.standard_normal((H, L, L)).astype(np.float32)
    gate = rng.uniform(1.0, 2.0, (3, H, L)).astype(np.float32)
    mask = np.ones((3, L), bool)
    mask[0, 130:] = False  # ragged: inside a 64-key tile, then a tile with no kept key
    mask[2] = False        # all masked: P = 1/L on every key, dS = 0
    return q, k, v, bias, gate, mask, dout


def _max_rel(got, want) -> float:
    want = np.asarray(want, np.float32).reshape(np.shape(got))
    return float(np.abs(got - want).max() / max(float(np.abs(want).max()), 1e-9))


@pytest.fixture(scope="module")
def references():
    """{name: ((dq, dk, dv, dbias, dgate) of the reference, the rows it takes)}."""
    q, k, v, bias, gate, mask, dout = _inputs()
    two = [x[:2] for x in (q, k, v)] + [bias, gate[:2], mask[:2]]
    jargs = [jnp.asarray(x) for x in two]
    _, out_p, lse_p = _train_forward(*jargs, num_heads=H, block_q=128, interpret=True)
    pallas = _train_backward(*jargs, out_p, lse_p, jnp.asarray(dout[:2]), num_heads=H,
                             block_q=128, block_k=128, interpret=True)

    def loss(q, k, v, b, g):
        def heads(x):
            return x.reshape(3, L, H, DH)
        out = wavlm_gated_attention_xla(heads(q), heads(k), heads(v), b, g, jnp.asarray(mask))
        return jnp.sum(out.reshape(dout.shape) * dout)

    xla = jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3, 4)))(
        *(jnp.asarray(x) for x in (q, k, v, bias, gate)))
    return {"pallas_train_backward": (pallas, 2), "xla_grad": (xla, 3)}


def _errors(reference, references, names):
    """{terms: {name: largest error / largest magnitude}} of the emulation
    against the reference, for 3xTF32 and 1xTF32."""
    want, rows = references[reference]
    inputs = _inputs()
    args = [x[:rows] if x.ndim and x.shape[0] == 3 else x for x in inputs]
    errors = {}
    for terms in (3, 1):
        got = dict(zip(("dq", "dk", "dv", "dbias", "dgate"), emulated(*args, terms=terms)))
        ref = dict(zip(("dq", "dk", "dv", "dbias", "dgate"), want))
        errors[terms] = {name: _max_rel(got[name], ref[name]) for name in names}
    print(f"{reference}: largest error / largest magnitude, 3xTF32 {errors[3]}, "
          f"1xTF32 {errors[1]}")
    return errors


@pytest.mark.parametrize("reference", ["pallas_train_backward", "xla_grad"])
def test_tf32x3_backward_matches_jax_float32(references, reference):
    errors = _errors(reference, references, ("dk", "dv", "dbias"))
    for name, err in errors[3].items():
        assert np.isfinite(err) and err <= TOL, (name, err)
    # the cross terms are what keep float32 accuracy: 1xTF32 alone misses it
    assert max(errors[1].values()) > TOL


@pytest.mark.parametrize("reference", ["pallas_train_backward", "xla_grad"])
def test_tf32x3_dq_matches_jax_float32(references, reference):
    """B4: dq and dgate, on a ragged row (a 64-key tile with no kept key is
    skipped, and the second half of the last tile lies past L), a full row
    and (xla_grad) an all-masked row, which walks no step."""
    errors = _errors(reference, references, ("dq", "dgate"))
    for name, err in errors[3].items():
        assert np.isfinite(err) and err <= TOL, (name, err)
    assert max(errors[1].values()) > TOL
    if reference == "xla_grad":
        dq, dgate = (references[reference][0][i] for i in (0, 4))
        assert float(np.abs(np.asarray(dq)[2]).max()) == 0.0
        assert float(np.abs(np.asarray(dgate)[2]).max()) == 0.0
