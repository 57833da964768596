"""seamless-m4t-large-v2 [audio]: an encoder-decoder backbone
[arXiv:2308.11596]. 24 decoder layers (+ 24 encoder layers), d_model
1024, 16 heads (kv 16) of 64, no RoPE, d_ff 8192, vocab 256206. The
conformer / mel frontend is a stub: the caller gives precomputed frame
embeddings of width 1024 (``prefill(enc_input=)``), projected by
``prefix_proj`` into the encoder."""
from repro_torch.config import AttnConfig, ModelConfig


def config(**kw) -> ModelConfig:
    base = dict(
        name="seamless-m4t-large-v2", kind="encdec", family="audio",
        num_layers=24, num_encoder_layers=24,
        d_model=1024, d_ff=8192, vocab_size=256206,
        attn=AttnConfig(num_heads=16, num_kv_heads=16, head_dim=64,
                        use_rope=False),
        layer_ffn_pattern=("dense",),
        norm="ln", act="gelu", gated_mlp=False,
        prefix_slots=1, prefix_dim=1024,
        citation="arXiv:2308.11596",
    )
    base.update(kw)
    return ModelConfig(**base)
