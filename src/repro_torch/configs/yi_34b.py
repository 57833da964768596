"""yi-34b [dense]: llama-arch GQA [arXiv:2403.04652]. 60L d_model=7168
56H (GQA kv=8, head_dim=128) d_ff=20480 vocab=64000, bf16 parameters."""
from repro_torch.config import AttnConfig, ModelConfig


def config(**kw) -> ModelConfig:
    base = dict(
        name="yi-34b", kind="decoder", family="dense",
        num_layers=60, d_model=7168, d_ff=20480, vocab_size=64000,
        attn=AttnConfig(num_heads=56, num_kv_heads=8, head_dim=128,
                        rope_theta=5_000_000.0),
        layer_ffn_pattern=("dense",),
        param_dtype="bfloat16",
        citation="arXiv:2403.04652",
    )
    base.update(kw)
    return ModelConfig(**base)
