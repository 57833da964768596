"""The port's streaming attention (``repro_torch.models.blocks.
attend_chunked``) against the reference's on the same numpy inputs, at
small chunks (16 queries, 32 keys, S 128), and ``attn_apply`` past
``ATTN_DIRECT_MAX`` (S 3072), where both packages route to it.

Tolerances: f32 within 2e-6 (outputs of order one; the f32 products are
summed in another order than XLA's: 8.3e-7 measured); bf16 within one
bf16 ulp of each element (each key chunk's P V product is rounded to
bf16 inside each framework's matmul, which sums in its own order; most
cases are bitwise, the worst off by one ulp); ``attn_apply``'s output,
through the projections, within 4e-6 (2.0e-6 measured)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import AttnConfig as JAttn
from repro.config import ModelConfig as JModel
from repro.models import blocks as jb
from repro_torch.config import AttnConfig, ModelConfig
from repro_torch.models import blocks as tb

B, S, H, KV, HD = 2, 128, 4, 2, 16
CHUNKS = dict(chunk_q=16, chunk_k=32)
CASES = {
    "causal": dict(causal=True, window=None, chunked_window=False),
    "window": dict(causal=True, window=20, chunked_window=False),
    "chunked_window": dict(causal=True, window=32, chunked_window=True),
    "window_noncausal": dict(causal=False, window=20, chunked_window=False),
    "logit_cap": dict(causal=True, window=None, chunked_window=False,
                      logit_cap=2.0),
    # non-causal, with a key mask
    "kv_valid": dict(causal=False, window=None, chunked_window=False),
}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's side on one thread: the suite runs in several processes
    at once, and torch's thread pool spread over every core in each slows
    these small ops twentyfold (a reduced gemma3's serve, 2.1 s on one
    thread against 56.0 s on eight, with seven other processes busy)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _assert_close(got, want, dtype):
    g = got.float().numpy()
    w = np.asarray(want.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(g, w, atol=2e-6, rtol=0)
        return
    # one bf16 ulp of the larger magnitude of the two
    _, e = np.frexp(np.maximum(np.abs(g), np.abs(w)))
    ulp = np.ldexp(1.0, e - 8)
    assert (np.abs(g - w) <= ulp).all(), np.abs(g - w).max()


@pytest.mark.parametrize("case,dtype", [(c, "float32") for c in CASES] + [
    (c, "bfloat16") for c in ("causal", "chunked_window", "kv_valid")])
def test_attend_chunked_matches_reference(case, dtype):
    r = np.random.default_rng(len(case))
    q = r.standard_normal((B, S, H, HD)).astype(np.float32) * 2
    k = r.standard_normal((B, S, KV, HD)).astype(np.float32)
    v = r.standard_normal((B, S, KV, HD)).astype(np.float32)
    pos = np.arange(S)
    kv = (np.arange(S)[None, :] < np.array([[100], [77]])
          if case == "kv_valid" else None)
    jd, td = DTYPES[dtype]
    want = jb.attend_chunked(
        jnp.asarray(q, jd), jnp.asarray(k, jd), jnp.asarray(v, jd),
        jnp.asarray(pos), jnp.asarray(pos), 0.25,
        kv_valid=None if kv is None else jnp.asarray(kv), **CHUNKS,
        **CASES[case])
    got = tb.attend_chunked(
        torch.tensor(q).to(td), torch.tensor(k).to(td),
        torch.tensor(v).to(td), torch.tensor(pos), torch.tensor(pos), 0.25,
        kv_valid=None if kv is None else torch.tensor(kv), **CHUNKS,
        **CASES[case])
    assert got.dtype == td and got.shape == (B, S, H, HD)
    _assert_close(got, want, dtype)


def test_attend_chunked_equals_direct_attend():
    """The streaming path computes the direct path's function (f32, a
    sliding window and GQA): the port's own two routes agree."""
    r = np.random.default_rng(3)
    q, k, v = (torch.tensor(r.standard_normal(s).astype(np.float32))
               for s in ((B, S, H, HD), (B, S, KV, HD), (B, S, KV, HD)))
    pos = torch.arange(S)
    got = tb.attend_chunked(q, k, v, pos, pos, 0.25, causal=True, window=40,
                            chunked_window=False, **CHUNKS)
    mask = tb.make_attn_mask(pos, pos, causal=True, window=40)
    want = tb.attend(q, k, v, mask, 0.25)
    torch.testing.assert_close(got, want, atol=2e-6, rtol=0)


def test_attend_chunked_rejects_ragged_chunks():
    q = torch.zeros((1, 40, 2, 8))
    k = torch.zeros((1, 40, 1, 8))
    with pytest.raises(ValueError, match="multiples of their chunks"):
        tb.attend_chunked(q, k, k, torch.arange(40), torch.arange(40), 1.0,
                          causal=True, window=None, chunked_window=False,
                          chunk_q=16, chunk_k=32)


@pytest.mark.parametrize("window", [1024])
def test_attn_apply_streams_past_direct_max(window):
    """S = 3072 > ATTN_DIRECT_MAX on a tiny width: both packages take
    their streaming path (RoPE, GQA, a banded window), f32 compute. A
    global layer at 3072 is held end to end in
    ``test_torch_archs.py::test_gemma3_prefill_streams_at_3072``."""
    S_ = 3072
    assert S_ > tb.ATTN_DIRECT_MAX
    a = dict(num_heads=2, num_kv_heads=1, head_dim=8,
             window_pattern=(window,))
    kw = dict(name="t", kind="decoder", num_layers=2, d_model=16, d_ff=32,
              vocab_size=16, compute_dtype="float32")
    tcfg = ModelConfig(attn=AttnConfig(**a), **kw)
    jcfg = JModel(family="dense", attn=JAttn(**a), **kw)
    r = np.random.default_rng(7)
    p = {n: r.standard_normal(s).astype(np.float32) * 0.3 for n, s in
         (("wq", (16, 16)), ("wk", (16, 8)), ("wv", (16, 8)),
          ("wo", (16, 16)))}
    x = r.standard_normal((1, S_, 16)).astype(np.float32)
    pos = np.arange(S_)[None]
    out, (k, _) = tb.attn_apply({n: torch.as_tensor(w) for n, w in
                                 p.items()}, tcfg, torch.as_tensor(x),
                                torch.as_tensor(pos), layer=0)
    jout, (jk, _) = jax.jit(lambda pp, xx, ps: jb.attn_apply(
        pp, jcfg, xx, ps, layer=0))({n: jnp.asarray(w) for n, w in p.items()},
                                    jnp.asarray(x), jnp.asarray(pos))
    # through the wq / wo products too: outputs up to ~3
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=4e-6,
                               rtol=0)
    np.testing.assert_allclose(k.numpy(), np.asarray(jk), atol=1e-6, rtol=0)
    assert dataclasses.replace(tcfg).attn.window_for_layer(0) == window
