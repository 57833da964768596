"""Model, shape, technique and optimizer configuration (counterpart of
``repro/config.py``).

Only the fields and methods the ported slices read are kept. Field
names and defaults match the reference so a config converts field by
field.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class AttnConfig:
    num_heads: int
    num_kv_heads: int
    head_dim: int
    rope_theta: float = 10_000.0
    use_rope: bool = True
    # sliding-window pattern cycled over layers; None = full attention
    window_pattern: Tuple[Optional[int], ...] = (None,)
    chunked_local: bool = False
    softmax_scale: Optional[float] = None
    logit_cap: Optional[float] = None

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    def window_for_layer(self, layer: int) -> Optional[int]:
        return self.window_pattern[layer % len(self.window_pattern)]

    @property
    def subquadratic(self) -> bool:
        """True iff no layer does full quadratic attention."""
        return all(w is not None for w in self.window_pattern)


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff: int                      # hidden dim of EACH expert
    capacity_factor: float = 1.25
    num_shared_experts: int = 0    # always-on dense expert(s), llama4's
    router_aux_coef: float = 0.01  # load-balance loss coefficient
    router_jitter: float = 0.0     # unread, as in the reference


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-style selective SSM (hymba's parallel branch) or RWKV-6's
    time-mix (rwkv6-3b's token mixer, ``head_dim`` its head size)."""
    kind: str = "mamba"            # "mamba" | "rwkv6"
    state_dim: int = 16            # N: per-channel state size
    expand: int = 2                # d_inner = expand * d_model
    conv_dim: int = 4              # depthwise conv width
    head_dim: int = 64             # rwkv6 head size
    dt_rank: int = 0               # 0 => ceil(d_model / 16)


@dataclass(frozen=True)
class ModelConfig:
    name: str
    kind: str                      # "decoder" | "encdec"
    num_layers: int
    d_model: int
    d_ff: int
    vocab_size: int
    attn: Optional[AttnConfig] = None
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # hybrid (hymba): attention and SSM branches on one shared norm,
    # mean-fused
    parallel_ssm: bool = False
    layer_ffn_pattern: Tuple[str, ...] = ("dense",)
    norm: str = "rms"              # "rms" | "ln"
    act: str = "silu"              # "silu" | "gelu" (tanh approximation)
    gated_mlp: bool = True
    causal: bool = True            # False for encoder-style (MoE-BERT)
    tie_embeddings: bool = False
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: bool = True             # recompute each layer in the backward
    # the reference's family tag and source; both only describe the arch
    family: str = ""
    citation: str = ""
    # encoder depth of an encoder-decoder (seamless's 24)
    num_encoder_layers: int = 0
    # a modality frontend's stub: prefix_slots embeddings of width
    # prefix_dim (0: d_model), projected and put before the tokens
    # (internvl2's 256 patch embeddings of 1024)
    prefix_slots: int = 0
    prefix_dim: int = 0

    def ffn_kind(self, layer: int) -> str:
        return self.layer_ffn_pattern[layer % len(self.layer_ffn_pattern)]

    @property
    def uses_moe(self) -> bool:
        return self.moe is not None and "moe" in self.layer_ffn_pattern

    @property
    def supports_long_decode(self) -> bool:
        """May run the ``long_500k`` shape (the reference's rule): a pure
        SSM stack, a hybrid whose attention is all windowed, or an
        attention arch whose layers are mostly sliding-window / chunked.
        Full-attention archs and encoder-decoders skip it."""
        if self.kind == "encdec":
            return False
        if self.ssm is not None and self.attn is None:
            return True            # pure SSM
        if self.parallel_ssm:
            return self.attn.subquadratic
        wp = self.attn.window_pattern
        windowed = sum(1 for w in wp if w is not None)
        return windowed * 2 >= len(wp) and windowed > 0 \
            or self.attn.subquadratic


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    mode: str                      # "train" | "prefill" | "decode"


# the reference's assigned input shapes (the dry run's ``--shape``)
SHAPES = {
    "train_4k":    ShapeConfig("train_4k",    4_096,   256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768,  32,  "prefill"),
    "decode_32k":  ShapeConfig("decode_32k",  32_768,  128, "decode"),
    "long_500k":   ShapeConfig("long_500k",   524_288, 1,   "decode"),
}


@dataclass(frozen=True)
class LuffyConfig:
    """The paper's two techniques (§IV, §V) and how the expert-parallel
    exchange runs. Serving forces both off. On one device migration is
    the identity."""
    enable_condensation: bool = True
    enable_migration: bool = True
    # §V-A fast similarity: previous-block similarity > s1 => similar
    # (not measured), < s2 => dissimilar (not measured)
    s1: float = 0.8
    s2: float = 0.2
    # §V-B adaptive threshold (Eq. 2); static_threshold when off
    adaptive_threshold: bool = True
    static_threshold: float = 0.5
    # similarity backend (condense/backends.py): "exact" measures every
    # uncertain pair; "lsh" only those whose lsh_bits-bit signed random
    # projection codes (a fixed matrix drawn from lsh_seed) collide
    similarity_backend: str = "exact"
    lsh_bits: int = 8
    lsh_seed: int = 0
    # cross-sublayer condense-plan reuse (condense/plan.py): "off"
    # rebuilds every MoE sublayer; "signature" reuses the carried rep map
    # while the primary experts match and every sequence's age is under
    # condense_reuse_max_age; "always" skips the expert compare
    condense_reuse: str = "off"
    condense_reuse_max_age: int = 4
    # condensation-rate buckets: capacity C' = ceil(C * (1 - rate))
    rate_buckets: Tuple[float, ...] = (0.0, 0.25, 0.5)
    # §IV-A: top-q candidate ranks per sequence, and the attention cost
    # model's speed term P (FLOP/s) of Eq. 1
    q: int = 3
    gpu_speed: float = 1.0e13
    # per-chunk pipeline issue cost (ms) of the overlap pricing
    # (sched/cost.py); <= 0 takes DEFAULT_CHUNK_OVERHEAD_MS
    chunk_overhead_ms: float = -1.0
    # condensation group size G and combine-buffer slack under migration
    condense_group: int = 128
    combine_slack: float = 1.0
    # expert-parallel collectives: "flat" all-to-all or "hier" two-phase
    # over (node, local); "hier_dedup" "on" ships one row per (token,
    # destination node) (repro_torch.condense.wire)
    comm_mode: str = "flat"
    hier_dedup: str = "off"
    # "sync" runs dispatch -> expert FFN -> combine in order; "pipeline"
    # splits the dispatch capacity into pipeline_chunks 8-aligned chunks
    # and runs each chunk's collectives on a side stream against the
    # previous chunk's expert FFN (repro_torch.sched): the forward is
    # sync's bit for bit, weight gradients add up per chunk. One rank
    # runs sync. "decode_overlap" runs as sync: the reference overlaps
    # its decode combine all-reduce with the shared-expert FFN, and the
    # port's decode is the one-device one, with no collective to hide.
    exec_mode: str = "sync"
    # capacity chunks of exec_mode="pipeline"; <= 0 takes the chunk
    # count of the exchange estimate's 1..16 search
    pipeline_chunks: int = 4
    # only "traffic" is ported (item 7). plan_reuse (plan/exchange.py):
    # "off" replans every MoE sublayer; "signature" skips the greedy when
    # the routing signature matches the carried plan's; "always" trusts
    # the carried plan
    plan_objective: str = "traffic"
    plan_reuse: str = "off"
    # precision rows cross nodes at: "f32" (the compute dtype), "bf16"
    # or "f8e4m3" with per-32-element f32 scales (repro_torch.comm.dtypes)
    wire_dtype: str = "f32"
    # carry each token's wire quantization residual into the next step's
    # shipped payload (plan/exchange.py::execute_plan); the residual is 0
    # on an exact wire or one rank
    wire_error_feedback: bool = False


def resolve_pipeline_chunks(pipeline_chunks: Optional[int],
                            plan_objective: str) -> int:
    """The launchers' ``--pipeline-chunks`` (None = unset): 0, the
    estimated count, under the "overlap" objective, else 4. An explicit
    value wins."""
    if pipeline_chunks is not None:
        return pipeline_chunks
    return 0 if plan_objective == "overlap" else 4


@dataclass(frozen=True)
class OptimConfig:
    name: str = "adamw"
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    zero1: bool = True             # unread, as in the reference


def reduced(model: ModelConfig, *, num_layers: int = 2, d_model: int = 256,
            max_experts: int = 4, seq_len_hint: int = 128) -> ModelConfig:
    """Smoke-test variant of the same family (``repro.config.reduced``):
    <=2 layers, d_model<=512, <=4 experts, vocab<=1024."""
    d_model = min(d_model, 512)
    attn = model.attn
    if attn is not None:
        heads = max(2, min(4, attn.num_heads))
        kv = max(1, min(heads, attn.num_kv_heads))
        head_dim = max(8, d_model // heads)
        win = tuple((None if w is None else min(w, seq_len_hint // 2))
                    for w in attn.window_pattern)
        attn = dataclasses.replace(
            attn, num_heads=heads, num_kv_heads=kv, head_dim=head_dim,
            window_pattern=win)
    moe = model.moe
    if moe is not None:
        experts = min(max_experts, moe.num_experts)
        moe = dataclasses.replace(
            moe, num_experts=experts, top_k=min(moe.top_k, experts),
            d_ff=min(moe.d_ff, 2 * d_model),
            num_shared_experts=min(moe.num_shared_experts, 1))
    period = math.lcm(len(attn.window_pattern) if attn else 1,
                      len(model.layer_ffn_pattern))
    num_layers = max(num_layers, period)
    return dataclasses.replace(
        model,
        name=model.name + "-smoke",
        num_layers=num_layers,
        num_encoder_layers=min(model.num_encoder_layers, num_layers)
        if model.num_encoder_layers else 0,
        d_model=d_model,
        d_ff=min(model.d_ff, 2 * d_model),
        vocab_size=min(model.vocab_size, 1024),
        attn=attn, moe=moe, ssm=model.ssm,
        prefix_slots=min(model.prefix_slots, 8),
        prefix_dim=min(model.prefix_dim, d_model) if model.prefix_dim else 0,
        remat=False,
    )
