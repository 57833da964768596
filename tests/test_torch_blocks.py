"""repro_torch.models.blocks against repro.models.blocks on the same
numpy inputs: norms, attention masks, masked attention (with RoPE, and
through K5's core), and the dense FFN (f32 compute, 1e-5)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import AttnConfig as JAttn
from repro.config import ModelConfig as JModel
from repro.models import blocks as jb
from repro_torch.config import AttnConfig, ModelConfig
from repro_torch.models import blocks as tb

R = np.random.default_rng(11)


def _close(got, want, atol=1e-5):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=atol)


@pytest.mark.parametrize("kind", ["rms", "ln"])
def test_norm_apply(kind):
    x = (R.standard_normal((3, 5, 48)) * 3 + 1).astype(np.float32)
    p = {"scale": R.standard_normal(48).astype(np.float32),
         "bias": R.standard_normal(48).astype(np.float32)}
    _close(tb.norm_apply({k: torch.as_tensor(v) for k, v in p.items()},
                         torch.as_tensor(x), kind),
           jb.norm_apply({k: jnp.asarray(v) for k, v in p.items()},
                         jnp.asarray(x), kind))


@pytest.mark.parametrize("causal,window,chunked",
                         [(True, None, False), (True, 3, False),
                          (True, 4, True), (False, 2, False)])
def test_mask_and_attend(causal, window, chunked):
    pos = np.arange(9)
    mask = tb.make_attn_mask(torch.as_tensor(pos), torch.as_tensor(pos),
                             causal=causal, window=window, chunked=chunked)
    jmask = jb.make_attn_mask(jnp.asarray(pos), jnp.asarray(pos),
                              causal=causal, window=window, chunked=chunked)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    q, k, v = (R.standard_normal((2, 9, 4, 8)).astype(np.float32)
               for _ in range(3))
    kv2 = [a[:, :, :2] for a in (k, v)]            # grouped kv heads
    _close(tb.attend(torch.as_tensor(q), *map(torch.as_tensor, kv2), mask,
                     0.35),
           jb.attend(jnp.asarray(q), *map(jnp.asarray, kv2), jmask, 0.35))


@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_ffn_apply(gated, act):
    kw = dict(name="t", kind="decoder", num_layers=2, d_model=32, d_ff=64,
              vocab_size=16, act=act, gated_mlp=gated,
              compute_dtype="float32")
    tcfg = ModelConfig(**kw)
    jcfg = JModel(family="dense", **kw)
    p = {"w_up": R.standard_normal((32, 64)).astype(np.float32) * 0.2,
         "w_gate": R.standard_normal((32, 64)).astype(np.float32) * 0.2,
         "w_down": R.standard_normal((64, 32)).astype(np.float32) * 0.2}
    x = R.standard_normal((2, 5, 32)).astype(np.float32)
    _close(tb.ffn_apply({k: torch.as_tensor(v) for k, v in p.items()}, tcfg,
                        torch.as_tensor(x)),
           jb.ffn_apply({k: jnp.asarray(v) for k, v in p.items()}, jcfg,
                        jnp.asarray(x)))


def test_attn_apply_prefill():
    """Direct-path self-attention with the output projection, and the
    k/v it hands to the cache; then the same with RoPE (hymba's
    attention), where the cached k is the rotated one. f32 cos/sin of
    the same angles differ by a few ulps between XLA and torch, hence
    the tolerance and not bitwise."""
    a = dict(num_heads=4, num_kv_heads=2, head_dim=8, use_rope=False)
    kw = dict(name="t", kind="decoder", num_layers=2, d_model=32, d_ff=64,
              vocab_size=16, compute_dtype="float32")
    p = {n: R.standard_normal(s).astype(np.float32) * 0.2 for n, s in
         (("wq", (32, 32)), ("wk", (32, 16)), ("wv", (32, 16)),
          ("wo", (32, 32)))}
    x = R.standard_normal((2, 7, 32)).astype(np.float32)
    pos = np.tile(np.arange(7), (2, 1))
    for rope in (False, True):
        ac = {**a, "use_rope": rope}
        tcfg = ModelConfig(attn=AttnConfig(**ac), **kw)
        jcfg = JModel(family="dense", attn=JAttn(**ac), **kw)
        out, (k, v) = tb.attn_apply(
            {n: torch.as_tensor(w) for n, w in p.items()}, tcfg,
            torch.as_tensor(x), torch.as_tensor(pos), layer=0)
        jout, (jk, jv) = jb.attn_apply(
            {n: jnp.asarray(w) for n, w in p.items()}, jcfg, jnp.asarray(x),
            jnp.asarray(pos), layer=0)
        for got, want in ((out, jout), (k, jk), (v, jv)):
            _close(got, want)


@pytest.mark.parametrize("window", [None, 3])
def test_attn_apply_flash_core(window):
    """The K5 core (on the CPU its plain version) in place of ``attend``:
    RoPE, GQA and a sliding window, against the reference's attn_apply
    (f32, sums in another order)."""
    a = dict(num_heads=4, num_kv_heads=2, head_dim=8,
             window_pattern=(window,))
    kw = dict(name="t", kind="decoder", num_layers=2, d_model=32, d_ff=64,
              vocab_size=16, compute_dtype="float32")
    tcfg = ModelConfig(attn=AttnConfig(**a), **kw)
    jcfg = JModel(family="dense", attn=JAttn(**a), **kw)
    p = {n: R.standard_normal(s).astype(np.float32) * 0.2 for n, s in
         (("wq", (32, 32)), ("wk", (32, 16)), ("wv", (32, 16)),
          ("wo", (32, 32)))}
    x = R.standard_normal((2, 9, 32)).astype(np.float32)
    pos = np.tile(np.arange(9), (2, 1))
    out, _ = tb.attn_apply({n: torch.as_tensor(w) for n, w in p.items()},
                           tcfg, torch.as_tensor(x), torch.as_tensor(pos),
                           layer=0, flash=True)
    jout, _ = jb.attn_apply({n: jnp.asarray(w) for n, w in p.items()}, jcfg,
                            jnp.asarray(x), jnp.asarray(pos), layer=0)
    _close(out, jout)
    with pytest.raises(NotImplementedError, match="K5"):
        tb.attn_apply({n: torch.as_tensor(w) for n, w in p.items()},
                      dataclasses.replace(tcfg, attn=AttnConfig(
                          **a, logit_cap=30.0)),
                      torch.as_tensor(x), torch.as_tensor(pos), layer=0,
                      flash=True)
