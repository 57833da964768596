"""rwkv6-3b [ssm]: RWKV-6 "Finch", attention-free, with a data-dependent
decay [arXiv:2404.05892]. 32L d_model=2560 d_ff=8960 vocab=65536, 40
heads of 64. Each layer is the time-mix (the WKV6 recurrence over a
64 x 64 state a head) and the channel-mix in place of the FFN, each with
its own token shift."""
from repro_torch.config import ModelConfig, SSMConfig


def config(**kw) -> ModelConfig:
    base = dict(
        name="rwkv6-3b", kind="decoder", family="ssm",
        num_layers=32, d_model=2560, d_ff=8960, vocab_size=65536,
        attn=None,
        ssm=SSMConfig(kind="rwkv6", head_dim=64),
        layer_ffn_pattern=("dense",),
        norm="ln", gated_mlp=False,
        citation="arXiv:2404.05892",
    )
    base.update(kw)
    return ModelConfig(**base)
