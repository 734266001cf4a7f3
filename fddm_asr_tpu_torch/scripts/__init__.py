"""The offline workflow and the user scripts, each run as
``python -m fddm_asr_tpu_torch.scripts.<name>``, with the flags and output
files of the repository's `scripts/<name>.py`:

  - `preprocess`           Common Voice dumps -> 16 kHz WAVs + manifests
  - `tokenizer_train`      BPE tokenizer from the manifests
  - `make_synth_data`      a synthetic corpus, tokenizer and config
  - `init_random_ckpt`     a random-init checkpoint of a config
  - `average_checkpoints`  the mean of several checkpoints' weights
  - `sweep`                hyperparameter trials over `train_lib.run_training`
  - `precompute_features`  the frozen encoder's feature cache
  - `validate_quant`       int8 / wire-encoding transcript gate
  - `profile_step`         torch.profiler window of the flagship transcribe
  - `profile_finetune`     torch.profiler window of the encoder fine-tune step
  - `profile_frontend`     the conv front-end's variants, timed
  - `bench_train`          train-step throughput, TFLOP/s and MFU
  - `bench_serve`          serving load: RTFx, latency, streaming, the engine
  - `stream_client`        one stream through POST /v1/transcribe/stream
  - `make_longform`        manifest clips joined into one long WAV + reference
  - `inspect_transcripts`  ref against hyp a row, collapse diagnostics
  - `convergence_report`   a training log's epoch summaries as one JSON
  - `sanity_check_scheduler`  the diffusion schedule's rows sum to 1
  - `sanity_forward`       encoder, decoder, heads and L_fd in one forward

The scripts that touch a model run on CUDA and raise without a GPU unless
given ``--device cpu`` (``--cpu`` for `sanity_forward`, as its JAX flag is
named); `make_longform`, `stream_client` and `convergence_report` run on
the host only.
"""


class StepTokenizer:
    """The tokenizer `profile_finetune` and `bench_train` give a pipeline
    whose synthetic steps never call it."""

    def encode(self, text):
        return [5, 6, 7]
