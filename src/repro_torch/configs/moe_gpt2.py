"""MoE-GPT2 (paper Table II): 12L d_model=768 d_hidden=3072, len 1024,
top-2. [paper Table II / GPT-2]."""
from repro_torch.config import AttnConfig, ModelConfig, MoEConfig


def config(num_experts: int = 16, **kw) -> ModelConfig:
    base = dict(
        name=f"moe-gpt2-{num_experts}e", kind="decoder", family="moe",
        num_layers=12, d_model=768, d_ff=3072, vocab_size=50257,
        attn=AttnConfig(num_heads=12, num_kv_heads=12, head_dim=64,
                        use_rope=False),
        moe=MoEConfig(num_experts=num_experts, top_k=2, d_ff=3072,
                      capacity_factor=2.0),
        layer_ffn_pattern=("moe",),
        norm="ln", act="gelu", gated_mlp=False, tie_embeddings=True,
        citation="paper Table II / GPT-2",
    )
    base.update(kw)
    return ModelConfig(**base)
