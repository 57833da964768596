"""stablelm-12b [dense] [hf:stabilityai/stablelm-2-1_6b scaled to 12B].
40L d_model=5120 32H (GQA kv=8, head_dim=160) d_ff=13824 vocab=100352,
LayerNorm, bf16 parameters."""
from repro_torch.config import AttnConfig, ModelConfig


def config(**kw) -> ModelConfig:
    base = dict(
        name="stablelm-12b", kind="decoder", family="dense",
        num_layers=40, d_model=5120, d_ff=13824, vocab_size=100352,
        attn=AttnConfig(num_heads=32, num_kv_heads=8, head_dim=160),
        layer_ffn_pattern=("dense",),
        norm="ln",
        param_dtype="bfloat16",
        citation="hf:stabilityai/stablelm-2-1_6b",
    )
    base.update(kw)
    return ModelConfig(**base)
