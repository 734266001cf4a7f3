"""SentencePiece-compatible tokenizer (loading, encoding and decoding; the
BPE trainer is `tokenizer.train_bpe`)."""
from fddm_asr_tpu_torch.tokenizer.spm import SentencePieceProcessor, load_tokenizer

__all__ = ["SentencePieceProcessor", "load_tokenizer"]
