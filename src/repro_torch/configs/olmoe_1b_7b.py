"""olmoe-1b-7b [moe]: 64 experts, top-8 [arXiv:2409.02060]. 16L
d_model=2048 16H (kv=16, head_dim=128) expert d_ff=1024 vocab=50304."""
from repro_torch.config import AttnConfig, ModelConfig, MoEConfig


def config(**kw) -> ModelConfig:
    base = dict(
        name="olmoe-1b-7b", kind="decoder", family="moe",
        num_layers=16, d_model=2048, d_ff=1024, vocab_size=50304,
        attn=AttnConfig(num_heads=16, num_kv_heads=16, head_dim=128),
        moe=MoEConfig(num_experts=64, top_k=8, d_ff=1024,
                      capacity_factor=1.25),
        layer_ffn_pattern=("moe",),
        citation="arXiv:2409.02060",
    )
    base.update(kw)
    return ModelConfig(**base)
