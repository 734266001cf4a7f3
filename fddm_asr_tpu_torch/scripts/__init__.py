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

The scripts that touch a model run on CUDA and raise without a GPU unless
given ``--device cpu``.
"""
