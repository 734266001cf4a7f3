# -*- coding: utf-8 -*-
"""Reader and writer of the SentencePiece ModelProto (`.model`) format.

Counterpart of `fddm_asr_tpu/tokenizer/model_proto.py`: a hand-rolled
subset of the protobuf wire format covering the fields the codec and the
BPE trainer need (the sentencepiece wheel is not a dependency).  The
writer gives the JAX package's bytes for the same model.

  ModelProto:
    repeated SentencePiece pieces = 1 { piece = 1; score = 2; type = 3; }
    TrainerSpec trainer_spec = 2      { model_type = 3 (2 = BPE); vocab_size = 4;
                                        unk_id = 40; bos_id = 41; eos_id = 42; pad_id = 43; }
    NormalizerSpec normalizer_spec = 3 { name = 1; add_dummy_prefix = 3;
                                         remove_extra_whitespaces = 4;
                                         escape_whitespaces = 5; }

  SentencePiece.Type: NORMAL=1 UNKNOWN=2 CONTROL=3 USER_DEFINED=4 UNUSED=5 BYTE=6
"""
from __future__ import annotations

import dataclasses
import struct
from typing import Dict, List, Tuple

NORMAL, UNKNOWN, CONTROL, USER_DEFINED, UNUSED, BYTE = 1, 2, 3, 4, 5, 6

_U64 = 1 << 64


@dataclasses.dataclass
class Piece:
    piece: str
    score: float
    type: int = NORMAL


@dataclasses.dataclass
class SPModel:
    pieces: List[Piece]
    model_type: int = 2  # BPE
    unk_id: int = 0
    bos_id: int = 1
    eos_id: int = 2
    pad_id: int = 3
    add_dummy_prefix: bool = True
    remove_extra_whitespaces: bool = True
    escape_whitespaces: bool = True
    normalizer_name: str = "nmt_nfkc"
    character_coverage: float = 0.9995  # the trainer's; not serialized


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _write_varint(out: bytearray, value: int) -> None:
    if value < 0:  # int32/int64 fields: a negative is 64-bit two's complement
        value += _U64
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _signed(value: int) -> int:
    """Undo the two's-complement varint encoding of a negative int field."""
    return value - _U64 if value >= (1 << 63) else value


def _iter_fields(buf: bytes):
    pos = 0
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:
            val, pos = _read_varint(buf, pos)
        elif wire == 1:
            val, pos = buf[pos:pos + 8], pos + 8
        elif wire == 2:
            length, pos = _read_varint(buf, pos)
            val, pos = buf[pos:pos + length], pos + length
        elif wire == 5:
            val, pos = buf[pos:pos + 4], pos + 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


def _field(out: bytearray, field: int, wire: int) -> None:
    _write_varint(out, (field << 3) | wire)


def _put_bytes(out: bytearray, field: int, data: bytes) -> None:
    _field(out, field, 2)
    _write_varint(out, len(data))
    out.extend(data)


def _put_varint_field(out: bytearray, field: int, value: int) -> None:
    _field(out, field, 0)
    _write_varint(out, value)


def _put_float(out: bytearray, field: int, value: float) -> None:
    _field(out, field, 5)
    out.extend(struct.pack("<f", value))


def parse_model(data: bytes) -> SPModel:
    pieces: List[Piece] = []
    trainer: Dict[int, int] = {}
    normalizer: Dict[int, object] = {}
    for field, wire, val in _iter_fields(data):
        if field == 1 and wire == 2:
            piece, score, ptype = "", 0.0, NORMAL
            for f2, _, v2 in _iter_fields(val):
                if f2 == 1:
                    piece = v2.decode("utf-8")
                elif f2 == 2:
                    score = struct.unpack("<f", v2)[0]
                elif f2 == 3:
                    ptype = v2
            pieces.append(Piece(piece, score, ptype))
        elif field == 2 and wire == 2:
            trainer.update((f2, v2) for f2, w2, v2 in _iter_fields(val) if w2 == 0)
        elif field == 3 and wire == 2:
            normalizer.update((f2, v2) for f2, _, v2 in _iter_fields(val))
    name = normalizer.get(1)
    return SPModel(
        pieces=pieces,
        model_type=trainer.get(3, 2),
        unk_id=_signed(trainer.get(40, 0)),
        bos_id=_signed(trainer.get(41, 1)),
        eos_id=_signed(trainer.get(42, 2)),
        pad_id=_signed(trainer.get(43, 3)),
        add_dummy_prefix=bool(normalizer.get(3, 1)),
        remove_extra_whitespaces=bool(normalizer.get(4, 1)),
        escape_whitespaces=bool(normalizer.get(5, 1)),
        normalizer_name=(name.decode("utf-8", "replace") if isinstance(name, bytes)
                         else "nmt_nfkc"),
    )


def serialize_model(model: SPModel) -> bytes:
    out = bytearray()
    for p in model.pieces:
        sub = bytearray()
        _put_bytes(sub, 1, p.piece.encode("utf-8"))
        _put_float(sub, 2, p.score)
        if p.type != NORMAL:
            _put_varint_field(sub, 3, p.type)
        _put_bytes(out, 1, bytes(sub))
    trainer = bytearray()
    _put_varint_field(trainer, 3, model.model_type)
    _put_varint_field(trainer, 4, len(model.pieces))
    for field, value in ((40, model.unk_id), (41, model.bos_id), (42, model.eos_id),
                         (43, model.pad_id)):
        _put_varint_field(trainer, field, value)
    _put_bytes(out, 2, bytes(trainer))
    norm = bytearray()
    _put_bytes(norm, 1, model.normalizer_name.encode("utf-8"))
    _put_varint_field(norm, 3, int(model.add_dummy_prefix))
    _put_varint_field(norm, 4, int(model.remove_extra_whitespaces))
    _put_varint_field(norm, 5, int(model.escape_whitespaces))
    _put_bytes(out, 3, bytes(norm))
    return bytes(out)


def load_model(path: str) -> SPModel:
    with open(path, "rb") as f:
        return parse_model(f.read())


def save_model(model: SPModel, path: str) -> None:
    with open(path, "wb") as f:
        f.write(serialize_model(model))
