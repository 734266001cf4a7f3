"""SentencePiece-compatible tokenizer (loading, encoding and decoding)."""
from fddm_asr_tpu_torch.tokenizer.spm import SentencePieceProcessor, load_tokenizer

__all__ = ["SentencePieceProcessor", "load_tokenizer"]
