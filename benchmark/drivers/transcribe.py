"""Window driver: offline batch transcription.

The window drives `FDDMPipeline.transcribe_with_ids_async` with `depth`
batches in flight (the server engine's depth), finalizing the oldest each
time, over a pool of batches made from the seed and visited in a seed-drawn
order; each batch's audio goes from pinned host memory to the card with a
non-blocking copy, as the engine sends it.

Traffic keys: rows, clip_seconds ({"kind": "fixed", "seconds"} or
{"kind": "uniform", "low", "high"}), bucket_seconds (clips are grouped by
whole-bucket length; a batch is padded to its longest clip, as the
inference CLI pads without a condition mask), pool_batches, depth, seq_len,
sampling (the pipeline's keywords), check_batches and check_among (how many
of the window's first batches the comparison samples from), trace_calls.

Every seed gets the same set of clip lengths (stratified over each bucket)
in another order, so the work of a window does not change with the seed.

The comparison (after the window, with the program freed; see PERF.md for
the readings each limit was set from).  For each sampled batch the plain
float32 reference (TF32 off) recomputes every stage of the timed path from
the program's own input to that stage, at `check_rows` sampled rows where
the stage is per row, so that each stage is held alone and no stage goes
unheld:
  frontend_rel_err   the conv front-end and feature projection, from the audio;
  posconv_rel_err    the positional conv embedding;
  norm_rel_err       every LayerNorm: each encoder layer's two and the
                     encoder's final one, each from the residual sum that
                     feeds it (so the residual adds are held too), and each
                     decoder block's three, from its sublayer's residual sum;
  attention_rel_err  each encoder layer's attention (the gate, B1, the projections);
  ffn_rel_err        each encoder layer's feed-forward;
  encoder_proj_rel_err  the projection of the encoder's output to d_model;
  embed_rel_err      the decoder's input: the token embedding plus the time
                     embedding's MLP and projection, and each block's RoPE;
  decoder_attention_rel_err  each decoder block's self- and cross-attention;
  film_rel_err       each block's FiLM, from the program's condition;
  decoder_ffn_rel_err  each block's feed-forward;
  head_rel_err       the logits, from the program's last decoder block;
  id_gap_nats        the widest gap by which a token the program chose (each
                     jump's x, then the ids it returned) lies below the best
                     under the reference's posterior from those logits.
Each `*_rel_err` is the worst batch row's relative L2 error. The chain as a
whole (`encoder_from_audio_rel_err`, `logit_rel_err`) goes to the notes,
not compared: bfloat16's own rounding of the residual stream is most of its
error, so the int8 control moves it by 1.2-2x only. A cell compares the
numbers its limits file names. The control (`--variant int8`) is the
program's own int8 path for the encoder's layers and the decoder's
attention, feed-forward and head and, for the stages that path leaves in
bfloat16 (front-end, positional conv, norms, the encoder's projection, the
decoder's input and FiLM), the reference one precision below: float8
operands in the front-end and positional conv, elsewhere the reference's
own output rounded to float8.
"""
from __future__ import annotations

import collections
import contextlib
import math
import time

import numpy as np
import torch

import counters
import synth
from models import port_config, reference_decoder, reference_encoder, weights
from reference import decoder as RD
from reference import wavlm as RW

RATE = synth.SAMPLE_RATE


def plan_lengths(traffic: dict, seed: int) -> list:
    """The pool: a list of batches, each a list of clip lengths in samples.
    Fixed clips: every batch `rows` clips of that length.  Uniform clips:
    batches split over the whole-bucket lengths by the distribution's share
    of each, each batch's lengths stratified over its bucket (the same set
    for every seed), shuffled across rows by the seed."""
    rows, n = traffic["rows"], traffic["pool_batches"]
    clips = traffic["clip_seconds"]
    rng = np.random.default_rng(seed)
    if clips["kind"] == "fixed":
        return [[int(round(clips["seconds"] * RATE))] * rows for _ in range(n)]
    lo, hi, b = clips["low"], clips["high"], traffic["bucket_seconds"]
    edges = np.arange(math.floor(lo / b) * b, hi + b, b)
    spans = [(max(lo, e0), min(hi, e0 + b)) for e0 in edges[:-1] if min(hi, e0 + b) > max(lo, e0)]
    shares = np.array([s1 - s0 for s0, s1 in spans]) / (hi - lo)
    counts = np.maximum(1, np.round(shares * n)).astype(int)
    plan = []
    for (s0, s1), c in zip(spans, counts):
        for _ in range(c):
            secs = s0 + (np.arange(rows) + 0.5) / rows * (s1 - s0)
            lengths = np.round(secs * RATE).astype(int)
            plan.append([int(x) for x in rng.permutation(lengths)])
    return plan


class Driver:
    # the ranges whose device time the readers take; every `bench.*` range
    # also labels the trace's idle gaps
    RANGES = ("bench.encode", "bench.sample")

    def __init__(self, run):
        self.run = run
        self.config = run.cell.config
        self.traffic = run.cell.traffic
        self.device = torch.device(run.device)
        self.capture = None  # a checked batch's stage inputs and outputs, while dispatched
        self.captured = {}   # window batch index -> the capture, its pool entry and ids

    # ------------------------------------------------------------ set-up
    def setup(self) -> None:
        from fddm_asr_tpu_torch.config import Config
        from fddm_asr_tpu_torch.pipeline import FDDMPipeline
        from fddm_asr_tpu_torch.tokenizer import load_tokenizer

        run, tr, dev = self.run, self.traffic, self.device
        tok = synth.write_tokenizer(run.workdir + "/tokenizer", self.config["decoder"]["vocab_size"])
        cfg = Config(port_config(self.config, tok, run.variant))
        run.mark("imported")
        pipe = FDDMPipeline.from_config(cfg, tokenizer=load_tokenizer(tok), device=str(dev),
                                        seed=run.seed % (1 << 62))
        enc_sd, dec_sd = weights(self.config, run.seed, dev)
        pipe.encoder.load_state_dict(enc_sd, strict=True)
        pipe.decoder.load_state_dict(dec_sd, strict=True)
        del enc_sd, dec_sd
        self.pipe = pipe
        self._instrument(pipe)
        run.mark("built")

        # the pool of batches: audio on the card from the seed, kept pinned on the host
        g = synth.generator(run.seed, dev, stream=3)
        K, L = self.config["decoder"]["vocab_size"], tr["seq_len"]
        self.pool = []
        for lengths in plan_lengths(tr, run.seed):
            wave = torch.zeros(len(lengths), max(lengths), device=dev)
            for i, n in enumerate(lengths):
                wave[i, :n] = synth.voiced_audio(1, n, g, dev)[0]
            lens = torch.tensor(lengths, dtype=torch.int64)
            pin = (lambda t: t.pin_memory()) if dev.type == "cuda" else (lambda t: t)
            self.pool.append({"wave": pin(wave.cpu()), "lengths": pin(lens),
                              "x_init": torch.randint(0, K, (len(lengths), L), generator=g,
                                                      device=dev),
                              "audio_s": sum(lengths) / RATE, "n": lengths,
                              "flops": self._flops(lengths)})
        rng = np.random.default_rng(run.seed)
        self.order = [int(i) for i in rng.permutation(len(self.pool))]
        self.checked = {int(k) for k in rng.choice(tr["check_among"], tr["check_batches"],
                                                    replace=False)}
        self.sampling = dict(tr["sampling"])
        run.mark("inputs")
        # warm-up: every shape of the pool, twice, with batches in flight
        shapes = {}
        for i in self.order:
            shapes.setdefault(tuple(self.pool[i]["wave"].shape), i)
        for w in range(2):
            self._drive(iter([shapes[s] for s in sorted(shapes)]))
            run.mark(f"warm{w}")

    def _instrument(self, pipe) -> None:
        """The benchmark's ranges around the pipeline's encode and sample."""
        encode, sample_nbest = pipe.encode_waveform, pipe.sample_nbest

        def encode_waveform(wave, lengths=None):
            with torch.profiler.record_function("bench.encode"):
                out = encode(wave, lengths)
            if self.capture is not None:
                self.capture["c"] = out[0]
            return out

        def sample(*args, **kwargs):
            with torch.profiler.record_function("bench.sample"):
                return sample_nbest(*args, **kwargs)

        pipe.encode_waveform, pipe.sample_nbest = encode_waveform, sample

    @contextlib.contextmanager
    def _capturing(self, capture: dict):
        """While a checked batch is dispatched: forward hooks, and a recording
        wrapper of the decoder module's `_linear`, that keep each stage's
        input and output at the batch's sampled rows (`capture["rows"]`).
        Encoder: the front-end's output, the positional conv's input and
        output, each layer's input and its attention's and feed-forward's
        inputs and outputs, the final norm's output.
        Decoder, each call: x_t and t, the logits, the last block's output
        (every row, for the tokens' scores), and each block's input, the
        rotated input of its self-attention, both attentions' inputs and
        outputs, FiLM's input and output, the FFN's output and the block's
        output.  Nothing of this is installed outside a checked batch, and
        each wrapper passes the program's own result on unchanged."""
        from fddm_asr_tpu_torch.models import decoder as decoder_module

        pipe = self.pipe
        enc = pipe.encoder.backbone.encoder
        sel = capture["rows"]

        def rows(x):
            return x.index_select(0, sel) if torch.is_tensor(x) else x

        def keep(key, i, *tensors):
            capture.setdefault(key, {})[i] = tuple(rows(t) for t in tensors)

        def block_of(j):
            return capture["calls"][-1]["blocks"].setdefault(j, {})

        handles = [
            pipe.encoder.backbone.feature_projection.register_forward_hook(
                lambda m, a, o: capture.__setitem__("front", o)),
            enc.pos_conv_embed.register_forward_hook(
                lambda m, a, o: keep("posconv", 0, a[0], o)),
            enc.register_forward_hook(lambda m, a, o: keep("final_norm", 0, o)),
            pipe.decoder.register_forward_pre_hook(
                lambda m, a: capture["calls"].append({"blocks": {}})),
            pipe.decoder.register_forward_hook(
                lambda m, a, o: capture["calls"][-1].update(xt=a[0], t=a[1], logits=rows(o))),
        ]
        for i, layer in enumerate(enc.layers):
            handles += [
                layer.attention.register_forward_hook(
                    lambda m, a, o, i=i: keep("attention", i, a[0], o[0])),
                layer.feed_forward.register_forward_hook(
                    lambda m, a, o, i=i: keep("ffn", i, a[0], o)),
                layer.register_forward_pre_hook(lambda m, a, i=i: keep("layer", i, a[0]))]
        last = len(pipe.decoder.blocks) - 1
        ffn_out = {}
        for j, blk in enumerate(pipe.decoder.blocks):
            ffn_out[id(blk.ff[3])] = j

            def block_in(m, a, j=j):
                block_of(j)["in"] = rows(a[0])

            def block_out(m, a, o, j=j):
                block_of(j)["out"] = rows(o)
                if j == last:
                    capture["calls"][-1]["last"] = o

            def attention(kind, j=j):
                return lambda m, a, o: block_of(j).__setitem__(
                    kind, (tuple(rows(t) for t in a[:4]), rows(o)))

            handles += [blk.register_forward_pre_hook(block_in),
                        blk.register_forward_hook(block_out),
                        blk.self_attn.register_forward_hook(attention("self_attn")),
                        blk.cross_attn.register_forward_hook(attention("cross_attn")),
                        blk.film_layer.register_forward_hook(attention("film"))]
        linear = decoder_module._linear

        def recording_linear(layer, *args, **kwargs):
            out = linear(layer, *args, **kwargs)
            if id(layer) in ffn_out:
                block_of(ffn_out[id(layer)])["ffn"] = rows(out)
            return out

        decoder_module._linear = recording_linear
        try:
            yield
        finally:
            decoder_module._linear = linear
            for h in handles:
                h.remove()

    def _flops(self, lengths) -> float:
        c, d = self.config, self.config["decoder"]
        calls = len(RD.jumps(self.traffic["sampling"]["T_infer"], self.traffic["sampling"]["r"]))
        f = 0.0
        for n in lengths:
            S = counters.conv_frames(n, c["wavlm"])[-1]
            f += counters.encoder_flops(n, c["wavlm"], d["d_model"])
            f += calls * counters.decoder_flops(self.traffic["seq_len"], S, d["d_model"],
                                                d["num_layers"], d["dim_ff"], d["vocab_size"])
        return f

    # ------------------------------------------------------------ window
    def _dispatch(self, k: int, i: int, checked=()):
        entry, dev = self.pool[i], self.device
        wave = entry["wave"].to(dev, non_blocking=True)
        lengths = entry["lengths"].to(dev, non_blocking=True)
        capture = None
        if k in checked:
            sel = np.random.default_rng(self.run.seed + 7 * k).choice(
                len(entry["n"]), self.traffic["check_rows"], replace=False)
            capture = {"calls": [], "rows": torch.tensor(sorted(sel), device=dev)}
        self.capture = capture
        t0 = time.perf_counter()
        with torch.profiler.record_function("bench.dispatch"), \
                (self._capturing(capture) if capture is not None else contextlib.nullcontext()):
            fin = self.pipe.transcribe_with_ids_async(
                wave, lengths, seq_len=self.traffic["seq_len"], x_init=entry["x_init"],
                **self.sampling)
        dt = time.perf_counter() - t0
        self.capture = None
        return (k, i, fin, capture), dt

    def _finish(self, item) -> None:
        k, i, fin, capture = item
        with torch.profiler.record_function("bench.finalize"):
            out = fin()
        if capture is not None:
            self.captured[k] = dict(capture, pool=i, ids=[r[1] for r in out])

    def _drive(self, indices, deadline=None, checked=(), spans=None) -> dict:
        """Dispatch pool entries from `indices` with `depth` in flight, the
        oldest finalized each time, until the iterator ends or `deadline`
        (perf_counter) passes and every `checked` batch is dispatched (a
        slow program is late, never unchecked); returns the totals."""
        depth = self.traffic["depth"]
        inflight = collections.deque()
        done = {"batches": 0, "rows": 0, "audio_s": 0.0, "model_flops": 0.0}
        last = max(checked, default=-1)
        for k, i in enumerate(indices):
            if deadline is not None and time.perf_counter() >= deadline and k > last:
                break
            item, dt = self._dispatch(k, i, checked)
            if spans is not None:
                spans.append(dt)
            inflight.append(item)
            if len(inflight) >= depth:
                self._finish(inflight.popleft())
            entry = self.pool[i]
            done["batches"] += 1
            done["rows"] += len(entry["n"])
            done["audio_s"] += entry["audio_s"]
            done["model_flops"] += entry["flops"]
        while inflight:
            self._finish(inflight.popleft())
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        return done

    def _cycle(self):
        k = 0
        while True:
            yield self.order[k % len(self.order)]
            k += 1

    def window(self, seconds: float) -> dict:
        run = self.run
        t0 = time.perf_counter()
        done = self._drive(self._cycle(), deadline=t0 + seconds, checked=self.checked,
                           spans=run.spans.setdefault("dispatch", []))
        wall = time.perf_counter() - t0
        run.window = dict(done, wall_s=wall, attempted=done["rows"], failed=0)
        return {self.traffic["metric"]: done["audio_s"] / wall}

    def traced(self) -> None:
        """`trace_calls` batches under the profiler; B1's launches and work
        are recorded for its roofline."""
        from fddm_asr_tpu_torch.ops import kernel_wrappers

        wrappers = kernel_wrappers()
        for f in wrappers.values():
            f.launches = 0
        n = self.traffic["trace_calls"]
        indices = [self.order[k % len(self.order)] for k in range(n)]
        done = self._drive(iter(indices))
        self.run.window["traced_audio_s"] = done["audio_s"]
        w = self.config["wavlm"]
        elem = 2 if self.config["dtype"] in ("bfloat16", "bf16") else 4
        mult = self.pipe.encoder.config.seq_pad_multiple
        work = []
        for i in indices:
            entry = self.pool[i]
            S = counters.conv_frames(entry["wave"].shape[1], w)[-1]
            work += [counters.gated_attention("fwd", len(entry["n"]), -(-S // mult) * mult, S,
                                              w["num_attention_heads"], elem)
                     ] * w["num_hidden_layers"]
        self.run.kernel_work["B1"] = dict(counters.sum_work(work), calls=len(work),
                                          launches=wrappers["fwd"].launches,
                                          kernel=r"gated_attention_(bf16|tf32x3)_kernel",
                                          peak="bf16_flops" if elem == 2 else "tf32_flops")

    def release(self) -> None:
        del self.pipe
        self.capture = None

    # ------------------------------------------------------------ comparison
    @torch.no_grad()
    def check(self) -> list:
        run = self.run
        prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            err = self._compare()
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
        run.notes["numbers"] = err
        run.notes["batches_checked"] = sorted(self.captured)
        limits = run.cell.limits
        if not self.captured or self.checked - set(self.captured):
            return [("batches_checked", None, limits.get("batches_checked"))]
        return [(name, err.get(name), limit) for name, limit in limits.items()]

    def _compare(self) -> dict:
        dev, cfg, run = self.device, self.config, self.run
        blocks = self.traffic.get("reference_rows", 4)
        control = run.variant is not None
        err = collections.defaultdict(float)

        def worst(name, got, want):
            err[name] = max(err[name], _worst_row_rel(got.float(), want))

        def stage(name, got, want):
            """A stage the control's int8 path leaves in bfloat16: under the
            control, the reference's own output rounded to float8 stands in
            for the program's."""
            worst(name, RW._fp8(want) if control else got, want)

        enc_sd, dec_sd = weights(cfg, run.seed, dev)
        enc = reference_encoder(cfg, dev)
        enc.load_state_dict(enc_sd, strict=True)
        del enc_sd
        for k, got in sorted(self.captured.items()):
            wave = self.pool[got["pool"]]["wave"].to(dev).float()
            front = RW.in_blocks(enc.frontend, wave, blocks)
            if control:  # the reference's front-end one precision below
                worst("frontend_rel_err",
                      RW.in_blocks(lambda w: enc.frontend(w, fp8=True), wave, blocks), front)
            else:
                worst("frontend_rel_err", got["front"], front)
            S = front.shape[1]
            x, out = got["posconv"][0]
            x = x[:, :S].float()
            if control:  # as for the front-end
                worst("posconv_rel_err", enc.posconv(x, fp8=True), enc.posconv(x))
            else:
                worst("posconv_rel_err", out[:, :S], enc.posconv(x))
            # each layer from the program's tensors: its first norm from the
            # residual sum that forms its input (the positional conv's, then
            # the previous layer's), its second norm from its own residual
            # sum, its attention (the gate, B1, the projections) and
            # feed-forward from the program's normed inputs to them
            resid = x + out[:, :S].float()
            bias = enc.position_bias(S, dev)
            layers = enc.backbone.encoder.layers
            for i, (x,) in sorted(got["layer"].items()):
                x = x[:, :S].float()
                a_in, a_out = (t[:, :S] for t in got["attention"][i])
                f_in, f_out = (t[:, :S] for t in got["ffn"][i])
                stage("norm_rel_err", a_in, layers[i].layer_norm(resid))
                stage("norm_rel_err", f_in, layers[i].final_layer_norm(x + a_out.float()))
                worst("attention_rel_err", a_out, enc.attention_branch(i, a_in.float(), bias))
                worst("ffn_rel_err", f_out, enc.ffn_branch(i, f_in.float()))
                resid = x + a_out.float() + f_out.float()
            # the final norm, from the last layer's residual sum, and the
            # projection to d_model from the program's normed output
            (final,) = got["final_norm"][0]
            stage("norm_rel_err", final, enc.backbone.encoder.layer_norm(resid))
            c_rows = got["c"].index_select(0, got["rows"])
            if hasattr(enc, "proj"):
                stage("encoder_proj_rel_err", c_rows, enc.proj(final.float()))
            worst("encoder_from_audio_rel_err", got["c"], RW.in_blocks(enc.layers, front, blocks))
        del enc
        dec = reference_decoder(cfg, dev)
        dec.load_state_dict(dec_sd, strict=True)
        del dec_sd
        sched = RD.Schedule(cfg["decoder"]["vocab_size"], cfg["decoder"]["T"],
                            cfg["decoder"]["beta_max"], dev)
        jumps = RD.jumps(self.sampling["T_infer"], self.sampling["r"])
        for k, got in sorted(self.captured.items()):
            calls = got["calls"]
            if len(calls) != len(jumps):
                raise RuntimeError(f"batch {k}: {len(calls)} decoder calls, expected {len(jumps)}")
            final = torch.tensor(got["ids"], device=dev)
            sel = got["rows"]
            cond = got["c"].index_select(0, sel).float()
            for j, (call, (t_ref, delta)) in enumerate(zip(calls, jumps)):
                xt, t = call["xt"], call["t"]
                if not bool((t == t_ref).all()):
                    raise RuntimeError(f"batch {k}: jump {j} at t={t.tolist()}, expected {t_ref}")
                xs = xt.index_select(0, sel)
                # every stage of every block from the program's own input to it
                stage("embed_rel_err", call["blocks"][0]["in"],
                      dec.embed(xs, t.index_select(0, sel)))
                for b, got_b in sorted(call["blocks"].items()):
                    blk = dec.blocks[b]
                    x = got_b["in"].float()
                    (q, k_, v, _), sa = got_b["self_attn"]
                    stage("embed_rel_err", q, dec.rope(x))
                    worst("decoder_attention_rel_err", sa,
                          blk.self_attn(q.float(), k_.float(), v.float(), dec.mask(xs)))
                    (q2, k2, v2, c_mask), ca = got_b["cross_attn"]
                    stage("norm_rel_err", q2, blk.norm1(x + sa.float()))
                    worst("decoder_attention_rel_err", ca,
                          blk.cross_attn(q2.float(), k2.float(), v2.float(), c_mask))
                    (f_in, _, _), f_out = got_b["film"]
                    stage("norm_rel_err", f_in, blk.norm2(q2.float() + ca.float()))
                    stage("film_rel_err", f_out,
                          blk.film_layer(f_in.float(), dec.pool(cond, c_mask)))
                    worst("decoder_ffn_rel_err", got_b["ffn"], dec.ffn(b, f_out.float()))
                    stage("norm_rel_err", got_b["out"],
                          blk.norm3(f_out.float() + got_b["ffn"].float()))
                logits = dec.head(call["last"].float())
                worst("head_rel_err", call["logits"], logits.index_select(0, sel))
                worst("logit_rel_err", call["logits"], dec(xs, t.index_select(0, sel), cond))
                if j + 1 < len(calls):
                    score = sched.posterior(xt, torch.softmax(logits, dim=-1), t_ref,
                                            delta).log()
                    chosen = calls[j + 1]["xt"]
                else:
                    score, chosen = torch.log_softmax(logits, dim=-1), final
                gap = score.max(-1).values - score.gather(-1, chosen[..., None])[..., 0]
                err["id_gap_nats"] = max(err["id_gap_nats"], float(gap.max()))
        return dict(err)


def _worst_row_rel(got: torch.Tensor, want: torch.Tensor) -> float:
    """max over batch rows of ||got - want|| / ||want||."""
    num = (got - want).flatten(1).norm(dim=1)
    den = want.flatten(1).norm(dim=1)
    return float((num / den).max())
