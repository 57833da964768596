"""MoE-BERT-Large (paper Table II): 24L, len 512, top-2, bidirectional.

The paper's Table II prints d_model=768/d_hidden=3072 but its own "Size"
column (0.54/0.94/1.74/3.36 B) only reproduces with the real BERT-Large
dims d_model=1024 (16 heads) and expert d_ff=4096; the reference follows
the sizes, and so does this copy. [arXiv:1810.04805]."""
from repro_torch.config import AttnConfig, ModelConfig, MoEConfig


def config(num_experts: int = 16, **kw) -> ModelConfig:
    base = dict(
        name=f"moe-bert-large-{num_experts}e", kind="decoder", family="moe",
        num_layers=24, d_model=1024, d_ff=4096, vocab_size=30522,
        attn=AttnConfig(num_heads=16, num_kv_heads=16, head_dim=64,
                        use_rope=False),
        moe=MoEConfig(num_experts=num_experts, top_k=2, d_ff=4096,
                      capacity_factor=2.0),
        layer_ffn_pattern=("moe",),
        norm="ln", act="gelu", gated_mlp=False, causal=False,
        citation="paper Table II / arXiv:1810.04805",
    )
    base.update(kw)
    return ModelConfig(**base)
