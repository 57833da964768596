"""internvl2-2b [vlm]: InternViT + InternLM2 backbone [arXiv:2404.16821].
LM: 24L d_model=2048 16H (GQA kv=8, head_dim=128) d_ff=8192 vocab=92553.
The ViT is a stub: the caller gives 256 patch embeddings of width 1024
(``prefill(prefix=)``), projected to d_model before the tokens."""
from repro_torch.config import AttnConfig, ModelConfig


def config(**kw) -> ModelConfig:
    base = dict(
        name="internvl2-2b", kind="decoder", family="vlm",
        num_layers=24, d_model=2048, d_ff=8192, vocab_size=92553,
        attn=AttnConfig(num_heads=16, num_kv_heads=8, head_dim=128),
        layer_ffn_pattern=("dense",),
        prefix_slots=256, prefix_dim=1024,
        citation="arXiv:2404.16821",
    )
    base.update(kw)
    return ModelConfig(**base)
