"""gemma3-12b [dense]: 5:1 local:global attention, 128k context
[hf:google/gemma-3-1b-pt scaled to the 12B spec]. 48L d_model=3840 16H
(GQA kv=8, head_dim=256) d_ff=15360 vocab=262144, a tied vocabulary,
bf16 parameters."""
from repro_torch.config import AttnConfig, ModelConfig


def config(**kw) -> ModelConfig:
    base = dict(
        name="gemma3-12b", kind="decoder", family="dense",
        num_layers=48, d_model=3840, d_ff=15360, vocab_size=262144,
        attn=AttnConfig(num_heads=16, num_kv_heads=8, head_dim=256,
                        rope_theta=1_000_000.0,
                        window_pattern=(1024, 1024, 1024, 1024, 1024, None)),
        layer_ffn_pattern=("dense",),
        act="gelu", tie_embeddings=True,
        param_dtype="bfloat16",
        citation="hf:google/gemma-3-1b-pt",
    )
    base.update(kw)
    return ModelConfig(**base)
