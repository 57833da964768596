"""llama4-maverick-400b-a17b [moe]: 128 experts top-1 + shared expert,
iRoPE-style 3:1 chunked-local:global attention, early fusion (text path).
[hf:meta-llama/Llama-4-Scout-17B-16E scaled to the Maverick spec].
48L d_model=5120 40H (GQA kv=8) expert d_ff=8192 vocab=202048."""
from repro_torch.config import AttnConfig, ModelConfig, MoEConfig


def config(**kw) -> ModelConfig:
    base = dict(
        name="llama4-maverick-400b-a17b", kind="decoder", family="moe",
        num_layers=48, d_model=5120, d_ff=8192, vocab_size=202048,
        attn=AttnConfig(num_heads=40, num_kv_heads=8, head_dim=128,
                        rope_theta=500_000.0, chunked_local=True,
                        window_pattern=(8192, 8192, 8192, None)),
        moe=MoEConfig(num_experts=128, top_k=1, d_ff=8192,
                      capacity_factor=1.5, num_shared_experts=1),
        layer_ffn_pattern=("moe",),
        param_dtype="bfloat16",
        citation="hf:meta-llama/Llama-4-Scout-17B-16E",
    )
    base.update(kw)
    return ModelConfig(**base)
