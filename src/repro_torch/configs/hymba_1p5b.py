"""hymba-1.5b [hybrid]: parallel attention + Mamba heads, ssm_state=16
[arXiv:2411.13676]. 32L d_model=1600 25H (GQA kv=5) d_ff=5504
vocab=32001. Every attention layer has a 1024 sliding window; the
parallel Mamba branch carries the global context."""
from repro_torch.config import AttnConfig, ModelConfig, SSMConfig


def config(**kw) -> ModelConfig:
    base = dict(
        name="hymba-1.5b", kind="decoder", family="hybrid",
        num_layers=32, d_model=1600, d_ff=5504, vocab_size=32001,
        attn=AttnConfig(num_heads=25, num_kv_heads=5, head_dim=64,
                        window_pattern=(1024,)),
        ssm=SSMConfig(kind="mamba", state_dim=16, expand=2),
        parallel_ssm=True,
        layer_ffn_pattern=("dense",),
        citation="arXiv:2411.13676",
    )
    base.update(kw)
    return ModelConfig(**base)
