# -*- coding: utf-8 -*-
"""Text normalization for manifest building.

Counterpart of `fddm_asr_tpu/data/text.py`, with its operation order and
quirks: parenthesised spans are dropped, the text lowercased, whitespace
collapsed and stripped, then every character that is not a word
character, whitespace or a CJK ideograph (U+4E00..U+9FFF) is removed.
Only ASCII parentheses are stripped, and whitespace is not collapsed again
after the last filter, so "a , b" gives "a  b".
"""
from __future__ import annotations

import re

__all__ = ["normalize_text"]

_PARENS = re.compile(r"\([^)]*\)")
_KEEP = re.compile(r"[^\w\s一-鿿]")
_WS = re.compile(r"\s+")


def normalize_text(text: str) -> str:
    """The manifest's `text` field from a raw sentence ("" for a non-str)."""
    if not isinstance(text, str):
        return ""
    text = _PARENS.sub("", text)
    text = text.lower()
    text = _WS.sub(" ", text).strip()
    return _KEEP.sub("", text)
