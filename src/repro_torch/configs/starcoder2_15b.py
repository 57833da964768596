"""starcoder2-15b [dense]: GQA, RoPE, 4k sliding window
[arXiv:2402.19173]. 40L d_model=6144 48H (GQA kv=4, head_dim=128)
d_ff=24576 vocab=49152, LayerNorm, a non-gated gelu FFN, bf16
parameters."""
from repro_torch.config import AttnConfig, ModelConfig


def config(**kw) -> ModelConfig:
    base = dict(
        name="starcoder2-15b", kind="decoder", family="dense",
        num_layers=40, d_model=6144, d_ff=24576, vocab_size=49152,
        attn=AttnConfig(num_heads=48, num_kv_heads=4, head_dim=128,
                        rope_theta=100_000.0, window_pattern=(4096,)),
        layer_ffn_pattern=("dense",),
        norm="ln", act="gelu", gated_mlp=False,
        param_dtype="bfloat16",
        citation="arXiv:2402.19173",
    )
    base.update(kw)
    return ModelConfig(**base)
