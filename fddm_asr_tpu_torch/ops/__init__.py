"""Ops: the decoder's plain attention and the port's CUDA kernels with their
wrappers (`kernel_wrappers` names each wrapper that launches a kernel)."""


def kernel_wrappers() -> dict:
    """Every kernel wrapper of the port, by the name its launches are
    reported under; each counts its launches in `.launches`."""
    from fddm_asr_tpu_torch.ops import conv_frontend as CF
    from fddm_asr_tpu_torch.ops import flash_attention as FA
    from fddm_asr_tpu_torch.ops import quant as Q

    return {"fwd": FA.wavlm_gated_attention_cuda,
            "fwd_lse": FA.wavlm_gated_attention_fwd_lse_cuda,
            "bwd_dq": FA.wavlm_gated_attention_bwd_dq_cuda,
            "bwd_dkv": FA.wavlm_gated_attention_bwd_dkv_cuda,
            "bhld": FA.wavlm_gated_attention_bhld_cuda,
            "int8_matmul_fused": Q.int8_matmul_fused_cuda, "conv_ln_gelu": CF.conv_ln_gelu_cuda}
