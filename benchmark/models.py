"""The benchmark's view of a configuration file (benchmark/configs/): the
program's configuration built from it, the weights made from the seed, and
the plain reference modules they load into.  Shared by the window drivers."""
from __future__ import annotations

import torch

import synth
from reference import decoder as RD
from reference import wavlm as RW


def port_config(config: dict, tokenizer_path: str, variant=None) -> dict:
    """The program's configuration dict from the benchmark's configuration
    file (with a named variant's changes, dotted paths)."""
    dec = config["decoder"]
    port = {
        "seed": 0,
        "data": {"vocab_size": dec["vocab_size"], "pad_id": synth.SPECIAL_IDS["pad_id"],
                 "tokenizer_path": tokenizer_path, "max_len": dec["max_len"]},
        "model": {"d_model": dec["d_model"], "nhead": dec["nhead"],
                  "num_layers": dec["num_layers"], "dim_ff": dec["dim_ff"],
                  "dtype": config["dtype"], "scan_blocks": dec.get("scan_blocks", False),
                  "encoder": dict(config["encoder"], wavlm_config=dict(config["wavlm"]))},
        "diffusion": {"T": dec["T"], "beta_max": dec["beta_max"]},
    }
    if variant is not None:
        for path, value in config["variants"][variant].items():
            node = port
            *head, last = path.split(".")
            for key in head:
                node = node[key]
            node[last] = value
    return port


def reference_encoder(config: dict, device) -> RW.AcousticEncoder:
    return RW.AcousticEncoder(config["wavlm"], config["decoder"]["d_model"]).to(device)


def reference_decoder(config: dict, device) -> RD.Decoder:
    d = config["decoder"]
    return RD.Decoder(d["vocab_size"], d["d_model"], d["nhead"], d["num_layers"], d["dim_ff"],
                      synth.SPECIAL_IDS["pad_id"]).to(device)


def weights(config: dict, seed: int, device) -> tuple:
    """(encoder, decoder) state_dicts made from the seed on `device`."""
    with torch.device("meta"):
        enc = RW.AcousticEncoder(config["wavlm"], config["decoder"]["d_model"])
        d = config["decoder"]
        dec = RD.Decoder(d["vocab_size"], d["d_model"], d["nhead"], d["num_layers"],
                         d["dim_ff"], synth.SPECIAL_IDS["pad_id"])
    rope = {"pos_emb.inv_freq": RD.Rope(d["d_model"]).inv_freq}
    return (synth.make_weights(enc, seed, device, stream=1),
            synth.make_weights(dec, seed, device, stream=2, buffers=rope))
