"""Window driver: encoder fine-tuning, the step `train_lib.make_train_step`
returns (`train_encoder=True`).

Set-up builds one training state (the pipeline with the benchmark's
weights, the projection heads, AdamW and the EMA) and the step, sets its
update and step counters to `start_count` (the end of the learning-rate
warm-up, so every group, the encoder too, moves at its full rate), then
drives that same state through `followed_steps` steps, which are also the
warm-up of the shapes (an L_fd step among them), on batches whose rows all
differ; the window goes on from there. Each step's host batch (audio,
target ids, t, x_t and the SpecAugment time mask, all made from the seed)
is copied from pinned memory with non-blocking copies, as
`train_lib.run_training` copies its batches; t, x_t and the mask are passed
to the step, so the reference sees the same draws. The decoder's dropout
(the recipe's rate) draws inside the program: over the followed steps each
draw's keep mask is read from the program's own
`torch.nn.functional.dropout` calls (kept where the output is not zero or
the input was), and the reference applies the same masks at the same
places.

Traffic keys: metric, recipe (dotted paths into the program's config: the
fine-tune recipe), rows, clip_seconds, target_tokens ([low, high]: each
row's target length, stratified), pool_batches, followed_steps,
trace_steps, reference_rows, start_count.

The comparison (after the window, the program freed; PERF.md gives the
readings each limit was set from): the plain float32 reference
(`reference/train.py`, TF32 off) follows the followed steps from the same
weights and batches, and the numbers are
  loss_rel_err      the worst step's relative gap of the total loss;
  grad_norm_gap     the worst leaf's gap of the first gradient's norm, the
                    program's read from its AdamW state after step 1;
  change_norm_gap   the worst leaf's gap of the parameters' change over the
                    followed steps, over the leaves whose reference gradient
                    is at least a thousandth of the median leaf's (the
                    others, such as a key's bias under softmax, have a
                    gradient nought to rounding and move by it alone);
  ema_change_gap    the same of the EMA's change.
A gap is |norm - reference norm| over the larger of the reference's norm of
that leaf and of the median leaf.  `--variant fp8` puts the reference with
float8 operands in the program's place (the control); `--variant
half_batch` feeds the program's followed steps half the rows (a fault).
"""
from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

import counters
import synth
from models import port_config, reference_decoder, reference_encoder, weights
from reference import decoder as RD
from reference import train as RT

RATE = synth.SAMPLE_RATE


def _set(node: dict, path: str, value) -> None:
    *head, last = path.split(".")
    for key in head:
        node = node.setdefault(key, {})
    node[last] = value


def head_weights(cfg: dict, seed: int, device) -> dict:
    """The projection heads' state_dicts, made from the seed."""
    d, K, p = cfg["decoder"]["d_model"], cfg["decoder"]["vocab_size"], cfg["d_proj"]
    with torch.device("meta"):
        heads = {"s_proj": RT.SpeechProjector(d, p), "t_embed": RT.TextEmbedding(K, p),
                 "t_proj": RT.TextProjector(p)}
    return {k: synth.make_weights(m, seed, device, stream=10 + i)
            for i, (k, m) in enumerate(heads.items())}


class Driver:
    RANGES = ()

    def __init__(self, run):
        self.run = run
        self.traffic = run.cell.traffic
        self.config = dict(run.cell.config, d_proj=self.traffic["recipe"]["model.projector.d_proj"])
        self.device = torch.device(run.device)

    # ------------------------------------------------------------ set-up
    def _port_config(self, tokenizer: str) -> dict:
        port = port_config(self.config, tokenizer)
        for path, value in self.traffic["recipe"].items():
            _set(port, path, value)
        return port

    def _batches(self) -> list:
        """The pool: `pool_batches` batches of `rows` rows, all different."""
        tr, dev, seed = self.traffic, self.device, self.run.seed
        K, pad = self.config["decoder"]["vocab_size"], synth.SPECIAL_IDS["pad_id"]
        T = self.config["decoder"]["T"]
        B, n = tr["rows"], int(round(tr["clip_seconds"] * RATE))
        L = tr["target_tokens"][1]
        S = counters.conv_frames(n, self.config["wavlm"])[-1]
        enc = self.port["model"]["encoder"]
        spans = max(1, round(enc["mask_time_prob"] * S / enc["mask_time_length"]))
        g = synth.generator(seed, dev, stream=3)
        rng = np.random.default_rng(seed)
        abar = torch.tensor(np.cumprod(1.0 - self.sched_betas[1:]), device=dev)
        pool = []
        for _ in range(tr["pool_batches"]):
            lo, hi = tr["target_tokens"]
            lens = rng.permutation(np.round(lo + (np.arange(B) + 0.5) / B * (hi - lo)).astype(int))
            x0 = torch.randint(4, K, (B, L), generator=g, device=dev)
            x0[torch.arange(L, device=dev)[None, :] >= torch.tensor(lens, device=dev)[:, None]] = pad
            t = torch.randint(1, T + 1, (B,), generator=g, device=dev)
            keep = torch.rand(B, L, generator=g, device=dev) < abar[t - 1][:, None]
            xt = torch.where(keep, x0, torch.randint(0, K, (B, L), generator=g, device=dev))
            starts = torch.randint(0, S - enc["mask_time_length"] + 1, (B, spans), generator=g,
                                   device=dev)
            idx = (starts[..., None] + torch.arange(enc["mask_time_length"], device=dev))
            mask = torch.zeros(B, S, dtype=torch.bool, device=dev).scatter_(
                1, idx.reshape(B, -1), True)
            wave = synth.voiced_audio(B, n, g, dev)
            host = {"wave": wave, "x0": x0, "t": t, "xt": xt, "time_mask": mask,
                    "lengths": torch.full((B,), n, dtype=torch.int64, device=dev)}
            pin = (lambda x: x.cpu().pin_memory()) if dev.type == "cuda" else (lambda x: x.cpu())
            pool.append({k: pin(v) for k, v in host.items()})
        return pool

    def setup(self) -> None:
        from fddm_asr_tpu_torch import train_lib as TL
        from fddm_asr_tpu_torch.config import Config
        from fddm_asr_tpu_torch.tokenizer import load_tokenizer

        run, tr, dev = self.run, self.traffic, self.device
        tok = synth.write_tokenizer(run.workdir + "/tokenizer", self.config["decoder"]["vocab_size"])
        self.port = self._port_config(tok)
        cfg = Config(self.port)
        run.mark("imported")
        pipe = TL.training_pipeline(cfg, device=str(dev), tokenizer=load_tokenizer(tok))
        enc_sd, dec_sd = weights(self.config, run.seed, dev)
        pipe.encoder.load_state_dict(enc_sd, strict=True)
        pipe.decoder.load_state_dict(dec_sd, strict=True)
        del enc_sd, dec_sd
        heads = TL.make_projection_heads(cfg, pipe.device, pipe.decoder.dtype)
        for head, sd in zip(heads, head_weights(self.config, run.seed, dev).values()):
            head.load_state_dict(sd, strict=True)
        self.state = TL.init_train_state(pipe, cfg, train_encoder=True, heads=heads)
        self.step = TL.make_train_step(pipe, cfg, train_encoder=True)
        self.names = [f"{k}.{n}" for k, n in self.state.param_names()]
        self.pipe = pipe
        self.sched_betas = pipe.sched.betas_ext.cpu().numpy()
        run.mark("built")
        self.pool = self._batches()
        run.mark("inputs")
        # the followed steps, past the learning-rate warm-up; they warm up both
        # kinds of step (with L_fd and without)
        self.state.optimizer.count = self.state.step = tr["start_count"]
        self.followed = {"losses": [], "masks": [], "counts": []}
        for k in range(tr["followed_steps"]):
            half = run.variant == "half_batch"
            with _recording_dropout(self.followed["masks"], self.followed["counts"]):
                metrics = self._step(self.pool[k % len(self.pool)], half=half)
            self.followed["losses"].append(metrics["total_loss"])
            if k == 0:
                self.followed["mu"] = [m.detach().clone() for m in self.state.optimizer.mu]
        opt = self.state.optimizer
        self.followed["params"] = [p.detach().clone() for p in opt.params]
        self.followed["ema"] = [e.detach().clone() for e in self.state.ema]
        torch.cuda.synchronize() if dev.type == "cuda" else None
        run.mark("followed")

    def _step(self, host: dict, half: bool = False) -> dict:
        b = {k: v.to(self.device, non_blocking=True) for k, v in host.items()}
        if half:
            b = {k: v[:v.shape[0] // 2] for k, v in b.items()}
        return self.step(self.state, b["wave"], b["x0"], lengths=b["lengths"], t=b["t"],
                         xt=b["xt"], time_mask=b["time_mask"])

    def _flops(self) -> float:
        """Model FLOPs of one step: the frozen conv front-end forward, the rest
        of the encoder and the decoder forward and backward (3x), the heads
        on L_fd steps (counted at their share); valid frames and tokens."""
        c, d, tr = self.config, self.config["decoder"], self.traffic
        n = int(round(tr["clip_seconds"] * RATE))
        w = c["wavlm"]
        frames = counters.conv_frames(n, w)
        dims = [1] + list(w["conv_dim"])
        front = sum(2.0 * dims[i] * k * dims[i + 1] * frames[i]
                    for i, k in enumerate(w["conv_kernel"]))
        enc = counters.encoder_flops(n, w, d["d_model"]) - front
        lo, hi = tr["target_tokens"]
        B = tr["rows"]
        lens = lo + (np.arange(B) + 0.5) / B * (hi - lo)
        dec = sum(counters.decoder_flops(int(round(L)), frames[-1], d["d_model"], d["num_layers"],
                                         d["dim_ff"], d["vocab_size"]) for L in lens)
        p = c["d_proj"]
        heads = B * hi * (2.0 * d["vocab_size"] * p + 2.0 * p * p + 2.0 * d["d_model"] * p)
        every = self.port["lfd"]["n_step_fd"]
        return B * (front + 3 * enc) + 3 * dec + 3 * heads / every

    # ------------------------------------------------------------ window
    def window(self, seconds: float) -> dict:
        run = self.run
        k = len(self.followed["losses"])
        steps = 0
        t0 = time.perf_counter()
        while time.perf_counter() < t0 + seconds:
            self._step(self.pool[k % len(self.pool)])
            k += 1
            steps += 1
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        rows = steps * self.traffic["rows"]
        run.window = {"wall_s": wall, "attempted": rows, "failed": 0, "steps": steps,
                      "model_flops": steps * self._flops()}
        return {self.traffic["metric"]: rows / wall}

    def traced(self) -> None:
        """`trace_steps` steps under the profiler; B3, B4 and B5's launches and
        work are recorded for their rooflines."""
        from fddm_asr_tpu_torch.ops import kernel_wrappers

        wrappers = kernel_wrappers()
        for f in wrappers.values():
            f.launches = 0
        n = self.traffic["trace_steps"]
        k = len(self.followed["losses"])
        for j in range(n):
            self._step(self.pool[(k + j) % len(self.pool)])
        w, tr = self.config["wavlm"], self.traffic
        S = counters.conv_frames(int(round(tr["clip_seconds"] * RATE)), w)[-1]
        mult = self.pipe.encoder.config.seq_pad_multiple
        L = -(-S // mult) * mult
        for kernel, kind, name in (("B3", "fwd_lse", r"gated_attention_(bf16|tf32x3)_kernel"),
                                   ("B4", "bwd_dq", r"bwd_dq_\w+_kernel"),
                                   ("B5", "bwd_dkv", r"bwd_(dkv|dbias)_\w+_kernel")):
            launches = wrappers[kind].launches
            one = counters.gated_attention(kind, tr["rows"], L, S, w["num_attention_heads"], 2)
            self.run.kernel_work[kernel] = {"ops": one["ops"] * launches,
                                            "bytes": one["bytes"] * launches, "calls": launches,
                                            "launches": launches, "kernel": name,
                                            "kernels_per_launch": 2 if kernel == "B5" else 1,
                                            "peak": "bf16_flops"}

    def release(self) -> None:
        opt = self.state.optimizer
        self.program = {"params": dict(zip(self.names, self.followed["params"])),
                        "ema": dict(zip(self.names, self.followed["ema"])),
                        "grad": {n: m.float() / (1 - opt.b1)
                                 for n, m in zip(self.names, self.followed["mu"])},
                        "losses": [float(v) for v in self.followed["losses"]]}
        self.masks, self.mask_counts = self.followed["masks"], self.followed["counts"]
        del self.state, self.step, self.pipe, self.followed

    # ------------------------------------------------------------ comparison
    def check(self) -> list:
        prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            ref = self._follow(fp8=False)
            got = self._follow(fp8=True) if self.run.variant == "fp8" else self.program
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
        init = ref["init"]
        names = list(ref["grad"])
        gnorm = {n: float(ref["grad"][n].norm()) for n in names}
        median = float(np.median(list(gnorm.values())))
        # a leaf moves unless its gradient is nought to rounding in the reference
        moved = [n for n in names if gnorm[n] >= 1e-3 * median]
        delta = lambda s, key: {n: s[key][n] - init[n] for n in moved}  # noqa: E731
        err = {
            "loss_rel_err": max(abs(a - b) / abs(b) for a, b in zip(got["losses"], ref["losses"])),
            "grad_norm_gap": RT.leaf_gaps(got["grad"], ref["grad"], names),
            "change_norm_gap": RT.leaf_gaps(delta(got, "params"), delta(ref, "params"), moved),
            "ema_change_gap": RT.leaf_gaps(delta(got, "ema"), delta(ref, "ema"), moved),
        }
        self.run.notes["numbers"] = err
        # what an encoder left where it was (its update skipped) reads, by the
        # same measure: the reference's change against nothing
        enc_moved = [n for n in moved if n.startswith("encoder.")]
        if enc_moved:
            ref_delta = delta(ref, "params")
            self.run.notes["encoder_unchanged_reads"] = RT.leaf_gaps(
                {n: torch.zeros_like(d) if n in enc_moved else d for n, d in ref_delta.items()},
                ref_delta, moved)
        self.run.notes["leaves"] = {"compared": len(names), "moving": len(moved),
                                    "encoder_moving": sum(n.startswith("encoder.")
                                                          for n in moved)}
        kept, drawn = (sum(float(c[i]) for c in self.mask_counts) for i in (0, 1))
        self.run.notes["dropout"] = {"draws": len(self.masks),
                                     "kept_share": kept / max(drawn, 1.0)}
        self.run.notes["losses"] = {"program": got["losses"], "reference": ref["losses"]}
        limits = self.run.cell.limits
        return [(name, err.get(name), limit) for name, limit in limits.items()]

    def _follow(self, fp8: bool) -> dict:
        """The reference's followed steps from the seed's weights: its losses,
        first gradient, parameters and EMA after them, and the start."""
        cfg, dev, run = self.config, self.device, self.run
        enc_sd, dec_sd = weights(cfg, run.seed, dev)
        enc, dec = reference_encoder(cfg, dev), reference_decoder(cfg, dev)
        enc.load_state_dict(enc_sd, strict=True)
        dec.load_state_dict(dec_sd, strict=True)
        del enc_sd, dec_sd
        d, K, p = cfg["decoder"]["d_model"], cfg["decoder"]["vocab_size"], cfg["d_proj"]
        heads = {"s_proj": RT.SpeechProjector(d, p), "t_embed": RT.TextEmbedding(K, p),
                 "t_proj": RT.TextProjector(p)}
        for (name, head), sd in zip(heads.items(), head_weights(cfg, run.seed, dev).values()):
            head.to(dev).load_state_dict(sd, strict=True)
        sched = RD.Schedule(K, cfg["decoder"]["T"], cfg["decoder"]["beta_max"], dev)
        optim, lfd = self.port["optim"], self.port["lfd"]
        recipe = dict(optim, lambda_offdiag=lfd["lambda_offdiag"], tau=lfd["tau"],
                      grad_clip=optim.get("grad_clip", 5.0))
        trainer = RT.Trainer(enc, dec, heads, sched.betas, sched.abar, recipe,
                             rows=self.traffic["reference_rows"], fp8=fp8)
        trainer.count = start = self.traffic["start_count"]
        init = {n: q.detach().clone() for n, q in trainer.params.items()}
        losses = []
        drop = RD.GivenDropout(self._full_masks(), self.port["model"]["dropout"])
        for k in range(self.traffic["followed_steps"]):
            b = {key: v.to(dev) for key, v in self.pool[k % len(self.pool)].items()}
            out = trainer.step(b["wave"], b["x0"], b["t"], b["xt"], b["time_mask"],
                               apply_lfd=(start + k + 1) % lfd["n_step_fd"] == 0, drop=drop)
            losses.append(out["total_loss"])
        if drop.used != len(self.masks):
            raise RuntimeError(f"the reference took {drop.used} dropout masks of "
                               f"{len(self.masks)} the program drew")
        result = {"init": init, "losses": losses, "grad": trainer.first_grads,
                  "params": {n: q.detach().clone() for n, q in trainer.params.items()},
                  "ema": dict(trainer.ema)}
        del trainer, enc, dec, heads
        return result

    def _full_masks(self):
        """The program's keep masks; under the half-batch fault, whose step
        drew them for half the rows, the missing rows keep everything."""
        for m in self.masks:
            rows = self.traffic["rows"]
            if m.shape[0] < rows:
                m = torch.cat([m, m.new_ones((rows - m.shape[0],) + m.shape[1:])])
            yield m


@contextlib.contextmanager
def _recording_dropout(masks: list, counts: list):
    """Read each dropout the program draws (rate above 0, training) while it
    runs: its keep mask, where the output is not zero or the input was, goes
    to `masks` on the host, in the order drawn, and the elements kept and
    drawn where the input is not zero to `counts`.  The program's own result
    is passed on unchanged."""
    functional = torch.nn.functional
    dropout = functional.dropout

    def recording(input, p=0.5, training=True, inplace=False):
        if not (training and p > 0.0) or inplace:
            return dropout(input, p, training, inplace)
        out = dropout(input, p, training, inplace)
        nonzero = input != 0
        masks.append(((out != 0) | ~nonzero).to("cpu"))
        counts.append(torch.stack([((out != 0) & nonzero).sum(), nonzero.sum()]).cpu())
        return out

    functional.dropout = recording
    try:
        yield
    finally:
        functional.dropout = dropout
