"""MoE-TransformerXL (paper Table II): 18L d_model=1024 d_hidden=4096,
len 250, top-2 gate, experts in {2,4,8,16}. [arXiv:1901.02860 + paper]."""
from repro_torch.config import AttnConfig, ModelConfig, MoEConfig


def config(num_experts: int = 16, **kw) -> ModelConfig:
    base = dict(
        name=f"moe-transformerxl-{num_experts}e", kind="decoder", family="moe",
        num_layers=18, d_model=1024, d_ff=4096, vocab_size=32000,
        attn=AttnConfig(num_heads=16, num_kv_heads=16, head_dim=64),
        moe=MoEConfig(num_experts=num_experts, top_k=2, d_ff=4096,
                      capacity_factor=2.0),
        layer_ffn_pattern=("moe",),
        norm="ln", act="gelu", gated_mlp=False,
        citation="paper Table II / arXiv:1901.02860",
    )
    base.update(kw)
    return ModelConfig(**base)
