"""FDDM-ASR in PyTorch with hand-written CUDA kernels for NVIDIA Hopper.

The port of `fddm_asr_tpu` (JAX on TPU): the same modules under the same
names, written in PyTorch idiom.  It imports torch, numpy and the standard
library only, never JAX or the JAX package.  Entry points run on CUDA and
raise when no GPU is present unless the caller passes ``device="cpu"``.

Layer map (bottom-up):
  - `diffusion`         discrete-diffusion schedule + posteriors
  - `ops`               decoder attention; WavLM gated attention (CUDA kernel)
  - `models`            WavLM encoder, acoustic encoder, denoising decoder
  - `sampler`           jumpy sampler
  - `tokenizer`         SentencePiece-compatible encoding, decoding, `.model`
                        writing and BPE training (`tokenizer.train_bpe`)
  - `convert`           weights from the JAX package's trees and reference .pt
  - `pipeline`          FDDMPipeline: waveform -> transcript
  - `parallel`          several GPUs: process group, ("data", "model") mesh,
                        gradient reduction (the ring: `ops/ring_attention`)
  - `inference`         CLI (`python -m fddm_asr_tpu_torch.inference`)
  - `serve`             batching HTTP server (`python -m fddm_asr_tpu_torch.serve`)
  - `aot`, `export_model`  AOT artifacts: `torch.export` programs replayed
                        as CUDA graphs (`python -m fddm_asr_tpu_torch.export_model`)
  - `scripts`           the offline workflow and the user scripts
                        (`python -m fddm_asr_tpu_torch.scripts.<name>`)
"""

__version__ = "0.1.0"

# Samples covered by the conv front-end's first output frame (kernel 10
# stride 5, then six stride-2 stages): shorter inputs give zero encoder
# frames, so callers clamp per-row lengths to this floor.
CONV_RECEPTIVE_FIELD = 400
